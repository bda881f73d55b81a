"""Disaggregated prefill/decode serving: two role-restricted engines and the
priced page handoff between them.

Port of the JAX package's ``serve/disagg.py``.  CompAir splits work by
memory-compute intensity (prefill's matrix work on the SRAM-PIM lane,
bandwidth-bound decode on DRAM-PIM); the serving counterpart is role
disaggregation, so that prefill bursts do not stall decode.  A
:class:`DisaggServer` owns

* a **prefill engine** (``ServeEngine(role="prefill")``) that admits
  prompts, runs chunked prefill, samples each request's first token and
  then parks the request instead of decoding it;
* a **decode engine** (``ServeEngine(role="decode")``) that admits only
  staged :class:`~repro_torch.serve.swap.HandoffHandle`s and runs the
  batched decode (restores and preemption as usual);
* the **transfer channel** between them: a
  :class:`~repro_torch.serve.swap.SwapArena` the server owns (pinned host
  slabs when the pools are on the card; an int8 pool's scales ride along).
  A parked prefill is staged all or nothing: the uncached remainder of its
  page chain and any slot-state blob, each handoff priced by
  ``core.noc.handoff_cost`` (int8 pages at storage width; pages the decode
  pool already holds registered never cross).

One request's handoff::

    submit() -> prefill admit -> chunked prefill -> first token sampled
      -> the slot parks (_await_handoff)
      -> the server matches its digest chain against the DECODE pool's
         registry and acquires the hits (the LRU cannot take them in flight)
      -> stage_handoff(): the uncached rest extracted into the arena, the
         prefill slot retired (its registered pages park in its LRU)
      -> submit_handoff(): the decode engine adopts the rid and queues it
      -> decode _admit_handoff(): cached pages shared by reference, the rest
         copied in from the arena, the slot state inserted, decode resumes
         from the prefill side's token; no sampled token is replayed.

Backpressure runs end to end: a full decode pool defers admission
(``decode.stats["handoff_stalls"]``), which keeps arena slots taken; a full
arena defers staging (``stats["arena_stalls"]``), which keeps the parked
request's pages in the prefill pool and throttles prefill admission through
ordinary pool pressure.  ``submit`` returns a ``RequestFuture`` whose
``result()`` / ``stream()`` drive :meth:`DisaggServer.step`.  Greedy outputs
are token-identical to one monolithic ``ServeEngine``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from repro_torch.core import noc
from repro_torch.serve import swap
from repro_torch.serve.engine import Request, RequestFuture, ServeEngine


class DisaggServer:
    """A prefill-role and a decode-role :class:`ServeEngine` over one set of
    parameters, and the handoff arena between them, behind the one-engine
    API (``submit`` / ``step`` / ``run_until_drained`` / futures)."""

    def __init__(self, cfg, params, *, prefill: Optional[Dict] = None,
                 decode: Optional[Dict] = None,
                 handoff_pages: Optional[int] = None, handoff_hops: int = 1,
                 **shared):
        """Stand up the pair over ``params``.

        ``prefill`` / ``decode``: per-role ``ServeEngine`` keywords (slots,
        num_blocks, max_tokens_per_tick, seq_shards, ...) over the
        ``shared`` ones (block_size, kv_dtype, prefix_caching, ...); the
        server sets ``role`` itself.  ``handoff_pages``: the arena's
        capacity in pages (the handoffs in flight; default the prefill
        pool's full slot coverage, so staging alone never deadlocks the
        prefill side).  ``handoff_hops``: the link's hops between the two
        workers (pricing only)."""
        pkw = dict(shared)
        pkw.update(prefill or {})
        dkw = dict(shared)
        dkw.update(decode or {})
        for kw in (pkw, dkw):
            if kw.pop("role", None) is not None:
                raise ValueError("DisaggServer assigns engine roles itself")
        self.prefill = ServeEngine(cfg, params, role="prefill", **pkw)
        self.decode = ServeEngine(cfg, params, role="decode", **dkw)
        if self.prefill.paged != self.decode.paged:
            raise ValueError("prefill and decode engines must agree on "
                             "paged vs slot-state-only serving")
        if self.prefill.paged:
            if self.prefill.block_size != self.decode.block_size:
                raise ValueError(
                    f"handoff pages must be layout-identical: prefill "
                    f"block_size={self.prefill.block_size} != decode "
                    f"block_size={self.decode.block_size}")
            if self.prefill.kv_dtype != self.decode.kv_dtype:
                raise ValueError(
                    f"handoff pages must be layout-identical: prefill "
                    f"kv_dtype={self.prefill.kv_dtype!r} != decode "
                    f"kv_dtype={self.decode.kv_dtype!r}")
        self.handoff_pages = (int(handoff_pages) if handoff_pages is not None
                              else (self.prefill.slots
                                    * self.prefill.blocks_per_slot
                                    if self.prefill.paged else 0))
        self.handoff_hops = int(handoff_hops)
        self._arena: Optional[swap.SwapArena] = None
        # the handoff ledger (the link traffic the paper's model prices) and
        # each role's worker seconds: the two engines stand for two
        # workers, so the decode worker's clock never holds prefill compute
        self.stats: Dict[str, float] = {
            "handoffs": 0, "handoff_pages": 0, "handoff_cached_pages": 0,
            "handoff_bytes": 0, "handoff_hops": 0,
            "handoff_seconds": 0.0, "handoff_energy_pj": 0.0,
            "arena_stalls": 0,
            "decode_step_seconds": 0.0, "prefill_step_seconds": 0.0,
        }

    # -- submission (the front door) -----------------------------------
    def submit(self, prompt, **kw) -> RequestFuture:
        """Queue one request on the prefill role -> a future over this
        server (its ``result()`` / ``stream()`` drive both engines and the
        staging)."""
        rid = int(self.prefill.submit(prompt, **kw))
        return RequestFuture(rid, self)

    # -- handoff staging -----------------------------------------------
    def _get_arena(self) -> swap.SwapArena:
        if self._arena is None:
            pre = self.prefill
            quant = pre.kv_dtype == "int8"
            self._arena = swap.SwapArena(
                self.handoff_pages, pre.runner.page_shape(pre.block_size),
                torch.int8 if quant else pre.dtype, quantized=quant,
                device=pre.device)
        return self._arena

    def _stage_handoffs(self) -> None:
        """Move every parked prefill that fits the arena to the decode
        engine's queue, its digest chain matched against the decode pool's
        registry first, so pages already there never cross."""
        for slot in self.prefill.poll_handoffs():
            req = self.prefill.active[slot]
            cached: List[int] = []
            if (self.prefill.paged and self.decode.prefix_caching
                    and req._digests):
                full = int(self.prefill.lengths[slot]) // self.prefill.block_size
                for dg in req._digests[:full]:
                    page = self.decode.alloc.lookup(dg)
                    if page is None:
                        break
                    cached.append(page)
                # acquire each hit now: a parked registered page could be
                # evicted between this match and the decode side's admission
                for page in cached:
                    self.decode.alloc.acquire(page)
            arena = self._get_arena() if self.prefill.paged else None
            handle = self.prefill.stage_handoff(slot, arena, cached)
            if handle is None:
                # arena full: the slot stays parked with its pages, retried
                for page in cached:
                    self.decode.alloc.unpin(page)
                self.stats["arena_stalls"] += 1
                continue
            page_bytes = (self.prefill._page_kv_bytes()
                          if self.prefill.paged else 0)
            c = noc.handoff_cost(handle.total_pages, page_bytes,
                                 state_bytes=handle.state_bytes,
                                 cached_pages=len(handle.cached),
                                 n_hops=self.handoff_hops)
            self.stats["handoffs"] += 1
            self.stats["handoff_pages"] += handle.n_pages
            self.stats["handoff_cached_pages"] += len(handle.cached)
            self.stats["handoff_bytes"] += c["bytes"]
            self.stats["handoff_hops"] += c["hops"]
            self.stats["handoff_seconds"] += c["seconds"]
            self.stats["handoff_energy_pj"] += c["energy_pj"]
            self.decode.submit_handoff(handle)

    # -- server tick ---------------------------------------------------
    def step(self) -> List[Request]:
        """One tick: stage parked prefills, then tick decode, then prefill.
        Returns every request finished this tick (decode completions and
        the prefill side's immediate finishes, EOS on the first token)."""
        self._stage_handoffs()
        t0 = time.perf_counter()
        done = self.decode.step()
        t1 = time.perf_counter()
        done.extend(self.prefill.step())
        self.stats["decode_step_seconds"] += t1 - t0
        self.stats["prefill_step_seconds"] += time.perf_counter() - t1
        return done

    def run_until_drained(self, max_ticks: int = 10_000,
                          strict: bool = True) -> List[Request]:
        """Step until both engines are idle and nothing is parked or in
        flight -> every finished request.  With ``strict`` a server that
        cannot drain within ``max_ticks`` raises."""
        done: List[Request] = []
        for _ in range(max_ticks):
            done.extend(self.step())
            if self._drained():
                return done
        if strict:
            raise RuntimeError(
                f"disagg server not drained after {max_ticks} ticks "
                f"(prefill queued={self.prefill.queued} "
                f"active={sum(r is not None for r in self.prefill.active)} "
                f"parked={len(self.prefill.poll_handoffs())}, decode "
                f"queued={self.decode.queued} "
                f"active={sum(r is not None for r in self.decode.active)}, "
                f"arena_stalls={self.stats['arena_stalls']:.0f}, "
                f"handoff_stalls="
                f"{self.decode.stats['handoff_stalls']:.0f})")
        return done

    def _drained(self) -> bool:
        for eng in (self.prefill, self.decode):
            if (eng.queued or eng.restore_queue
                    or any(r is not None for r in eng.active)):
                return False
        return True

    def reset_stats(self) -> None:
        """Zero the handoff ledger and both engines' counters."""
        for k in self.stats:
            self.stats[k] = 0
        self.prefill.reset_stats()
        self.decode.reset_stats()

    # -- async future driver protocol ----------------------------------
    def _lookup(self, rid: int) -> Request:
        # a handed-off rid lives in both engines' registries and the decode
        # copy owns the token stream; a prefill-only rid is still
        # prefilling, staged but not admitted, or finished before its
        # handoff (EOS or a one-token request)
        req = self.decode._reqs.get(rid)
        if req is not None:
            return req
        return self.prefill._reqs[rid]

    def _future_done(self, rid: int) -> bool:
        return self._lookup(rid).done

    def _future_tokens(self, rid: int) -> List[int]:
        return self._lookup(rid).out_tokens

    def _future_step(self) -> None:
        self.step()
