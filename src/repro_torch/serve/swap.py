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
device pool ``[A, KvH, NB, BS, hd]`` moved outermost.  ``HandoffHandle``
(prefill -> decode handoff) comes with the disaggregation slice (ROADMAP
A.5).
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
