"""Placement-aware hot/cold expert cache for MoE serving.

A copy of the JAX package's ``serve/expert_cache.py``.  CompAir's hybrid
tiering applied to routed experts: per layer a small "resident" set lives
in the sub-10 ns SRAM-PIM tier while the rest stay in high-capacity
DRAM-PIM, and every promotion moves the expert's weights over the
CXL/NoC link.  The cache is a host-side model: like the engine's
``BlockAllocator`` it never touches a device tensor.  It consumes the
per-dispatch expert-load telemetry (``models/model.py``'s
``expert_stats``) and accounts what a placement-aware memory system would
have done (hits, misses, migrations, bytes), priced by
``core.noc.expert_placement_cost``.  On the card the experts' banks stay
in the card's memory: the tiers are the paper's model, not the H100's.

Policy:

* **LRU residency**: within a layer the resident set is ordered by last
  touch; the eviction victim is the least recently used expert.
* **EMA promotion**: per-expert routing counts feed an exponential moving
  average; the hottest non-resident expert by EMA is each tick's
  promotion candidate, gated by ``noc.expert_promotion_worthwhile`` (its
  predicted traffic must amortize the link transfer) and by being hotter
  than the LRU victim.
* **Prefetch and double buffering**: with ``prefetch=True`` a promotion is
  staged into a per-layer shadow buffer and becomes resident at the next
  tick's buffer swap, so an expert in flight is never served from SRAM
  (lookups against it stay misses until the swap).  One shadow buffer a
  layer: at most one promotion in flight per layer and tick.
* **Static placement** (``adaptive=False``), the A/B baseline: residency
  stays the initial set (experts ``[0, capacity)``), only the hit/miss
  accounting runs, and nothing ever migrates.

Accounting invariants: ``hits + misses == lookups`` (in routed tokens)
and, because the cache starts full (the initial residents are placed, not
migrated), every committed promotion evicts exactly one victim, so
``promotions == demotions`` and ``migration_bytes == demotions *
expert_bytes``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import noc

COUNTER_KEYS = ("lookups", "hits", "misses", "promotions", "demotions",
                "migrations", "migration_bytes", "prefetches")


class ExpertCache:
    """Per-layer LRU cache of SRAM-PIM-resident experts (see the module
    docstring).

    Args:
      n_layers: MoE layers tracked (one resident set and EMA row each).
      n_experts: routed experts per layer (the padded count the dispatch
        telemetry reports).
      capacity: SRAM-resident experts per layer, clamped to ``[1,
        n_experts]``; the initial resident set is ``[0, capacity)``.
      expert_bytes: one routed expert's weights in bytes (prices every
        migration).
      ema_decay: the routing-count EMA's decay per tick (0.8: a horizon of
        ~5 ticks).
      prefetch: double-buffered staging (promotions land next tick), or a
        commit at the end of the tick.
      adaptive: False freezes the initial placement (the static baseline).
    """

    def __init__(self, n_layers: int, n_experts: int, capacity: int,
                 expert_bytes: int, *, ema_decay: float = 0.8,
                 prefetch: bool = True, adaptive: bool = True):
        if n_layers < 1 or n_experts < 1:
            raise ValueError(f"need n_layers, n_experts >= 1, got "
                             f"{n_layers}, {n_experts}")
        if not (0.0 <= ema_decay < 1.0):
            raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
        self.n_layers = int(n_layers)
        self.n_experts = int(n_experts)
        self.capacity = max(1, min(int(capacity), self.n_experts))
        self.expert_bytes = int(expert_bytes)
        self.ema_decay = float(ema_decay)
        self.prefetch = bool(prefetch)
        self.adaptive = bool(adaptive)
        # residency: one OrderedDict a layer, LRU first, MRU last
        self._resident: List[OrderedDict] = [
            OrderedDict((e, None) for e in range(self.capacity))
            for _ in range(self.n_layers)]
        # the shadow buffer: at most one staged promotion a layer
        self._staged: List[Optional[int]] = [None] * self.n_layers
        self.ema = np.zeros((self.n_layers, self.n_experts), np.float64)
        self.counters: Dict[str, float] = {k: 0 for k in COUNTER_KEYS}

    def is_resident(self, layer: int, expert: int) -> bool:
        """SRAM residency, read without accounting.  A staged expert is not
        resident: it is in flight until the buffer swap."""
        return expert in self._resident[layer]

    def residents(self, layer: int) -> List[int]:
        """Resident experts, LRU first (index 0 is the next victim)."""
        return list(self._resident[layer])

    def staged(self, layer: int) -> Optional[int]:
        return self._staged[layer]

    @property
    def sram_hit_rate(self) -> float:
        lk = self.counters["lookups"]
        return self.counters["hits"] / lk if lk else 0.0

    def reset_counters(self) -> None:
        """Zero the accounting; residency, staging and the EMA stay (the
        engine's ``reset_stats`` contract)."""
        self.counters = {k: 0 for k in COUNTER_KEYS}

    def _commit(self, layer: int, expert: int, tick: Dict[str, float]):
        """Make a promoted expert resident, evicting the LRU victim."""
        res = self._resident[layer]
        victim, _ = res.popitem(last=False)            # the LRU head
        res[expert] = None                             # in as the MRU
        tick["promotions"] += 1
        tick["demotions"] += 1
        tick["migrations"] += 1
        tick["migration_bytes"] += self.expert_bytes
        return victim

    def observe(self, counts) -> Dict[str, float]:
        """Account one dispatch's routing against the placement.

        ``counts`` [n_layers, n_experts]: routed-token counts per expert and
        layer (the ``expert_load`` of one decode step or prefill chunk).
        Order within the tick: (1) the previous tick's staged prefetches
        become resident (the buffer swap); (2) this tick's tokens count as
        SRAM hits or DRAM misses against the residency now; (3) the EMA
        advances; (4) the next promotion is staged (or, without
        ``prefetch``, committed).  Returns this tick's counter deltas."""
        counts = np.asarray(counts, np.float64)
        if counts.shape != (self.n_layers, self.n_experts):
            raise ValueError(f"counts shape {counts.shape} != "
                             f"{(self.n_layers, self.n_experts)}")
        tick: Dict[str, float] = {k: 0 for k in COUNTER_KEYS}
        for li in range(self.n_layers):
            res = self._resident[li]
            # (1) the buffer swap: last tick's staged expert lands now
            if self._staged[li] is not None:
                self._commit(li, self._staged[li], tick)
                self._staged[li] = None
            # (2) hits and misses, a touched resident moved to the MRU end
            row = counts[li]
            for e in np.nonzero(row)[0]:
                c = float(row[e])
                tick["lookups"] += c
                if int(e) in res:
                    tick["hits"] += c
                    res.move_to_end(int(e))
                else:
                    tick["misses"] += c
            # (3) the EMA of routing counts: the hotness predictor
            self.ema[li] = (self.ema_decay * self.ema[li]
                            + (1.0 - self.ema_decay) * row)
            # (4) the placement decision
            if not self.adaptive:
                continue
            cand = self._hottest_cold(li)
            if cand is None:
                continue
            victim = next(iter(res))                   # the LRU head
            if self.ema[li, cand] <= self.ema[li, victim]:
                continue                               # not hotter: stay
            if not noc.expert_promotion_worthwhile(self.expert_bytes,
                                                   self.ema[li, cand]):
                continue                               # the link won't pay
            if self.prefetch:
                self._staged[li] = cand                # lands next tick
                tick["prefetches"] += 1
            else:
                self._commit(li, cand, tick)
        for k in COUNTER_KEYS:
            self.counters[k] += tick[k]
        return tick

    def _hottest_cold(self, layer: int) -> Optional[int]:
        """The first expert by descending EMA that is neither resident nor
        staged, if its EMA is positive (the JAX loop's order: ``np.argsort``
        of -EMA, stopping at the first cold expert)."""
        res = self._resident[layer]
        best, best_ema = None, 0.0
        for e in np.argsort(-self.ema[layer]):
            e = int(e)
            if e in res or e == self._staged[layer]:
                continue
            if self.ema[layer, e] > best_ema:
                best, best_ema = e, self.ema[layer, e]
            break
        return best
