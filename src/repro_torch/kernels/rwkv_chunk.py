"""RWKV-6 wkv recurrence, chunked — hand-written CUDA kernels for Hopper
(``csrc/rwkv6.cu``): the forward and its deterministic backward.

Replaces the TPU kernel ``src/repro/kernels/rwkv_chunk.py``
(``rwkv6_chunked``, ``pallas_call`` at :87).  One block per (batch, head)
carries the f32 state S [D, D] in shared memory across 32-token chunks;
r, k, v, w are read in their ``[B, S, H, D]`` layout (no host-side
transpose or padding: the ragged last chunk is masked in the kernel), and
every decay exponent is <= 0 (the pairwise term is computed for u < t
only).  For training the forward also writes the state at each chunk's
entry, ``[B, H, ceil(S/32), D, D]`` f32, which the backward reads instead
of recomputing; under remat it lives only while one layer is recomputed.
The backward is one reverse pass over the chunks per (batch, head) without
atomics (``du``'s sum over the batch is taken here in a fixed order), so
two runs give the same bits.  Bound on the H100 by bytes; this first
version runs B * H blocks (80 at rwkv6-3b's B = 2, H = 40) on 132 SMs.

The plain versions are ``kernels/ref.py:rwkv6_scan_chunked`` and
``rwkv6_bwd``; ``kernels/ops.py`` sends CPU tensors there.  These wrappers
take CUDA tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0       # forward kernel launches through this module
bwd_launches = 0   # backward launches (one per rwkv6_bwd call)

HEAD_DIMS = (16, 32, 64)   # the head dims the kernel is built for
CHUNK = 32                 # rows per chunk (kChunk of csrc/rwkv6.cu)


def n_chunks(s: int) -> int:
    return -(-s // CHUNK)


def _check(name: str, r, k, v, w, u):
    b, s, h, d = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"{name}: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)} must all be "
                         f"[B, S, H, D]")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if not (r.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: r, k, v dtypes {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32 or u.shape != (h, d):
        raise ValueError(f"{name}: w must be float32 and u [{h}, {d}] float32, "
                         f"got w {w.dtype}, u {tuple(u.shape)} {u.dtype}")
    return b, s, h, d


def rwkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, *, save_states: bool = False):
    """r, k, v [B, S, H, D]; w [B, S, H, D] f32; u [H, D] f32 -> (o like r,
    S_final [B, H, D, D] f32, chunk-entry states [B, H, NC, D, D] f32 or
    None)."""
    global launches
    b, s, h, d = _check("rwkv6", r, k, v, w, u)
    _build.require_cuda("rwkv6", r=r, k=k, v=v, w=w, u=u)
    o = torch.empty_like(r)
    sf = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    states = (torch.empty((b, h, n_chunks(s), d, d), dtype=torch.float32,
                          device=r.device) if save_states else None)
    lib = _build.load()
    code = lib.repro_rwkv6_fwd(_build.dtype_code(r), r.data_ptr(), k.data_ptr(),
                               v.data_ptr(), w.data_ptr(), u.data_ptr(),
                               o.data_ptr(), sf.data_ptr(),
                               states.data_ptr() if save_states else None,
                               b, s, h, d, _build.stream_ptr(r))
    launches += 1
    _build.check("rwkv6", code)
    return o, sf, states


def rwkv6_bwd(r, k, v, w, u, do, states):
    """Gradients (dr, dk, dv, dw, du) of :func:`rwkv6_fwd`'s ``o`` for the
    output gradient ``do`` (S_final's gradient taken as zero), from the
    chunk-entry ``states`` that the forward wrote."""
    global bwd_launches
    b, s, h, d = _check("rwkv6_bwd", r, k, v, w, u)
    if do.shape != r.shape or do.dtype != r.dtype:
        raise ValueError(f"rwkv6_bwd: do {tuple(do.shape)} {do.dtype} must be "
                         f"like r")
    if states is None or states.shape != (b, h, n_chunks(s), d, d) \
            or states.dtype != torch.float32:
        raise ValueError("rwkv6_bwd: states must be the forward's chunk-entry "
                         f"states [{b}, {h}, {n_chunks(s)}, {d}, {d}] float32")
    _build.require_cuda("rwkv6_bwd", r=r, k=k, v=v, w=w, u=u, do=do,
                        states=states)
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty_like(w)
    du_part = torch.empty((b, h, d), dtype=torch.float32, device=r.device)
    lib = _build.load()
    code = lib.repro_rwkv6_bwd(_build.dtype_code(r), r.data_ptr(), k.data_ptr(),
                               v.data_ptr(), w.data_ptr(), u.data_ptr(),
                               do.data_ptr(), states.data_ptr(), dr.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                               du_part.data_ptr(), b, s, h, d,
                               _build.stream_ptr(r))
    bwd_launches += 1
    _build.check("rwkv6_bwd", code)
    du = du_part[0].clone()
    for i in range(1, b):                     # the sum over B in batch order
        du += du_part[i]
    return dr, dk, dv, dw, du
