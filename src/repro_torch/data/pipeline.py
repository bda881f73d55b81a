"""Deterministic synthetic token pipeline with prefetch and skip-resume
(a copy of the JAX package's ``data/pipeline.py``: pure numpy, so batches
are bit-identical to the JAX package's for the same ``(seed, step)``).

Production shape without external deps: every batch is a pure function of
(seed, step), so (i) restarts resume bit-exactly by step index, (ii) every
data-parallel host can independently materialize its shard (no network),
(iii) elastic rescale re-shards by recomputing the same global batch.

A real deployment swaps ``SyntheticLM`` for a tokenized corpus reader with
the same Batch protocol; everything downstream is unchanged.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeSpec


@dataclass
class SyntheticLM:
    """Markov-ish synthetic LM data: structured enough that loss decreases
    (next token depends on current), deterministic per (seed, step)."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: str = "none"      # 'audio'/'vlm' archs get stub embeds
    d_model: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        # order-1 structure: x_{t+1} = (a * x_t + noise) % v
        x0 = rng.integers(0, v, size=(b, 1))
        mult = 1 + (rng.integers(0, 7, size=(b, 1)) * 2)
        noise = rng.integers(0, max(v // 64, 2), size=(b, s))
        toks = np.zeros((b, s + 1), np.int32)
        toks[:, :1] = x0
        for t in range(s):
            toks[:, t + 1] = (toks[:, t] * mult[:, 0] + noise[:, t]) % v
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if self.frontend != "none":
            # stub frontend: embeddings provided instead of tokens
            emb = rng.standard_normal((b, s, self.d_model)).astype(np.float32)
            out["embeds"] = (emb * self.d_model ** -0.5).astype(np.float32)
            del out["tokens"]
        return out

    def shard(self, batch: Dict[str, np.ndarray], host: int, n_hosts: int):
        per = self.global_batch // n_hosts
        return {k: v[host * per:(host + 1) * per] for k, v in batch.items()}


def for_cell(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0) -> SyntheticLM:
    return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                       global_batch=shape.global_batch, seed=seed,
                       frontend=cfg.frontend, d_model=cfg.d_model)


class Prefetcher:
    """Background-thread prefetch of ``depth`` batches, resumable at any
    step (``start_step``), with clean shutdown."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.ds = ds
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.ds.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration
                continue

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
