"""Host-side KV page arena for progress-preserving preemption.

Port of the JAX package's ``serve/swap.py`` (``SwapHandle`` :32-64,
``SwapArena`` :122-193).  When the engine preempts a victim under page-pool
pressure and the swap arm is taken (``core.noc.preempt_decision``), the
victim's live KV pages are copied device -> host into this arena and the
device pages are released; at re-admission they are copied back into fresh
device pages and decode resumes where it stopped.

The arena is preallocated: one slab for K and one for V (and, for an int8
pool, one per-page-per-head f32 scale slab for each), so a swap-out never
allocates on the critical path, and a bounded arena gives the engine its
fallback (arena full -> that victim takes the recompute arm).  On the card
the slabs are pinned host tensors: a page moves with one DMA copy each way.
A device -> host copy is complete before :meth:`SwapArena.write` returns
(the copies are queued on the current stream, then the stream is
synchronized), so the caller may free or reuse the device pages at once.
A host -> device copy (:meth:`SwapArena.read`) is queued on the current
stream behind any earlier write, so a slot freed after its read can be
written again safely.

Layout: arena slot ``i`` holds one physical page ``[A, KvH, BS, hd]`` (A
attention applications: L layers, or the hybrid's G), the page axis of the
device pool ``[A, KvH, NB, BS, hd]`` moved outermost.

A :class:`HandoffHandle` (the JAX package's, ``serve/swap.py:67-119``) is
one finished prefill staged for a decode-role engine (``serve/disagg.py``):
the same page mechanics as a :class:`SwapHandle`, in an arena the
``DisaggServer`` owns, plus what the decode side needs to admit the request
without re-running its prefill or re-sampling its first token.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch


@dataclass
class SwapHandle:
    """One preempted request's parked progress.

    ``slots[i]`` is the arena slot holding the victim's logical block
    ``len(pinned) + i``: restore allocates device pages in the same logical
    order.  ``tokens`` counts the KV rows the parked progress covers (the
    live length at eviction).  ``pinned``: leading pages registered in the
    prefix cache under the victim's own digest chain, held by reference
    (never copied) and re-attached at restore.  ``state``: a slot-state
    family's blob (host tensors by state key), ``state_bytes`` its size."""
    slots: List[int] = field(default_factory=list)
    tokens: int = 0
    pinned: List[int] = field(default_factory=list)
    state: Optional[Dict[str, torch.Tensor]] = None
    state_bytes: int = 0

    @property
    def n_pages(self) -> int:
        return len(self.slots)


@dataclass
class HandoffHandle:
    """One finished prefill staged for a decode-role engine.

    ``slots`` park the transferred remainder of the page chain in
    ``arena``; ``state`` / ``state_bytes`` carry a slot-state family's blob.
    ``out_tokens``: the token(s) sampled on the prefill side; the decode
    side admits with them and feeds the last through decode, so no sampled
    token is replayed or re-sampled across the handoff.  ``tokens``: the KV
    rows the staged chain covers (the clamped prompt); decode resumes at
    exactly this position.  ``digests``: the chained full-page digests; the
    leading ``cached`` pages (decode-pool page ids, acquired at staging so
    the LRU cannot take them while the handoff waits) were already
    registered in the decode pool, were never copied into the arena, and
    are re-attached by reference at admission.  The scheduling and SLO
    fields (``priority``, ``deadline_ms``, ``t_submit``, ``ttft``) ride
    along."""
    rid: int = 0
    prompt: Optional[object] = None
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    priority: str = "interactive"
    deadline_ms: Optional[float] = None
    out_tokens: List[int] = field(default_factory=list)
    tokens: int = 0
    digests: List[bytes] = field(default_factory=list)
    cached: List[int] = field(default_factory=list)
    slots: List[int] = field(default_factory=list)
    arena: Optional["SwapArena"] = None
    state: Optional[Dict[str, torch.Tensor]] = None
    state_bytes: int = 0
    t_submit: float = 0.0
    ttft: Optional[float] = None

    @property
    def n_pages(self) -> int:
        """Pages staged in the arena (the transferred remainder)."""
        return len(self.slots)

    @property
    def total_pages(self) -> int:
        """The whole chain: cached (by reference) and transferred pages."""
        return len(self.cached) + len(self.slots)


def _host_empty(shape, dtype, pin: bool, fill=0) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, pin_memory=pin)
    return t.fill_(fill)


class SwapArena:
    """Fixed-capacity host arena of KV pages (the swap tier).

    ``capacity`` pages of ``page_shape = (A, KvH, BS, hd)`` each, for K and
    V, in ``dtype`` (the pool's storage type: the engine dtype, or int8 with
    ``quantized`` scales).  ``device``: the pool's device; the slabs are
    pinned when it is a card.  ``alloc`` is all-or-nothing: a victim parks
    every live page or none (a half-swapped victim could neither resume nor
    free its device pages); the engine treats ``alloc() -> None`` as "arena
    full" and takes the recompute arm for that victim."""

    def __init__(self, capacity: int, page_shape: Tuple[int, ...], dtype,
                 quantized: bool = False, device="cpu"):
        if capacity < 1:
            raise ValueError(f"swap arena needs capacity >= 1, got {capacity}")
        self.capacity = capacity
        self.page_shape = tuple(page_shape)
        self.quantized = quantized
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self._k = _host_empty((capacity,) + self.page_shape, dtype, pin)
        self._v = _host_empty((capacity,) + self.page_shape, dtype, pin)
        if quantized:
            # per-page-per-head scales [A, KvH] ride with each parked page
            sshape = (capacity,) + self.page_shape[:2]
            self._ks = _host_empty(sshape, torch.float32, pin, 1.0)
            self._vs = _host_empty(sshape, torch.float32, pin, 1.0)
        else:
            self._ks = self._vs = None
        self._free = list(range(capacity - 1, -1, -1))  # pop lowest id first

    @property
    def page_bytes(self) -> int:
        """Bytes of ONE page, K and V (and a quantized arena's scales)."""
        n = 2 * self._k[0].numel() * self._k.element_size()
        if self.quantized:
            n += 2 * self._ks[0].numel() * 4
        return n

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n_pages: int) -> Optional[SwapHandle]:
        """Reserve ``n_pages`` arena slots, or None if they do not all fit."""
        if n_pages < 1 or n_pages > len(self._free):
            return None
        return SwapHandle([self._free.pop() for _ in range(n_pages)])

    def _slabs(self):
        return ((self._k, self._v, self._ks, self._vs) if self.quantized
                else (self._k, self._v))

    def write(self, slots: List[int], k: torch.Tensor, v: torch.Tensor,
              k_scales: Optional[torch.Tensor] = None,
              v_scales: Optional[torch.Tensor] = None) -> None:
        """Park pages: ``k`` / ``v`` ``[n, A, KvH, BS, hd]`` (page axis
        leading; ``k_scales`` / ``v_scales`` ``[n, A, KvH]`` for a
        quantized arena), on the pool's device.  The copies are complete on
        return."""
        srcs = (k, v, k_scales, v_scales) if self.quantized else (k, v)
        for slab, src in zip(self._slabs(), srcs):
            for i, s in enumerate(slots):
                slab[s].copy_(src[i], non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def read(self, slots: List[int]):
        """Page data for ``slots`` on the pool's device, page axis leading:
        ``(k, v)``, or ``(k, v, k_scales, v_scales)`` when quantized.  The
        host -> device copies are queued on the current stream."""
        out = []
        for slab in self._slabs():
            dst = torch.empty((len(slots),) + tuple(slab.shape[1:]),
                              dtype=slab.dtype, device=self.device)
            for i, s in enumerate(slots):
                dst[i].copy_(slab[s], non_blocking=True)
            out.append(dst)
        return tuple(out)

    def free(self, handle: SwapHandle) -> None:
        self._free.extend(handle.slots)
        handle.slots = []
