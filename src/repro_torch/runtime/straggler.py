"""Straggler detection: per-host step-time EMA vs fleet median.

On a real multi-host deployment every host reports its step wall time; a
host whose EMA exceeds ``threshold`` x the fleet median for ``patience``
consecutive windows is flagged (the orchestrator then drains/replaces it,
or the data pipeline rebalances — hooks below).  Single-process here, but
the logic is host-count-generic and unit-tested with a fake clock.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set


@dataclass
class StragglerDetector:
    n_hosts: int
    alpha: float = 0.2          # EMA coefficient
    threshold: float = 1.5      # x median
    patience: int = 3           # consecutive flagged windows
    ema: List[Optional[float]] = field(default_factory=list)
    strikes: List[int] = field(default_factory=list)

    def __post_init__(self):
        self.ema = [None] * self.n_hosts
        self.strikes = [0] * self.n_hosts

    def observe(self, step_times: Dict[int, float]) -> Set[int]:
        """Feed one step's per-host wall times; returns hosts currently
        flagged as stragglers."""
        for h, t in step_times.items():
            prev = self.ema[h]
            self.ema[h] = t if prev is None else (1 - self.alpha) * prev + self.alpha * t
        vals = sorted(e for e in self.ema if e is not None)
        if not vals:
            return set()
        med = vals[len(vals) // 2]
        flagged = set()
        for h in range(self.n_hosts):
            e = self.ema[h]
            if e is not None and e > self.threshold * med:
                self.strikes[h] += 1
            else:
                self.strikes[h] = 0
            if self.strikes[h] >= self.patience:
                flagged.add(h)
        return flagged

    def reset_host(self, host: int):
        """Call after the orchestrator replaces/restarts a host."""
        self.ema[host] = None
        self.strikes[host] = 0
