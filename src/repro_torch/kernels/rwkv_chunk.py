"""RWKV-6 wkv recurrence, chunked — hand-written CUDA kernels for Hopper
(``csrc/rwkv6.cu``): the forward and its deterministic backward.

Replaces the TPU kernel ``src/repro/kernels/rwkv_chunk.py``
(``rwkv6_chunked``, ``pallas_call`` at :87).  r, k, v, w are read in their
``[B, S, H, D]`` layout (no host-side transpose or padding: the ragged last
chunk is masked in the kernel), and every decay exponent is <= 0.  For
training the forward also writes the state at each chunk's entry, ``[B, H,
NC, D, D]`` f32, which the backward reads instead of recomputing; under
remat it lives only while one layer is recomputed.

bf16 runs on the tensor cores (``mma.sync``) in chunks of 64 rows
(``TC_CHUNK``), every pass but one chunk-parallel, one block per (batch,
chunk, head): the forward writes each chunk's state increment, scans the
chunks in place (one thread per four state values, so the slots end holding
the chunk-entry states), then computes each chunk's output from its entry
state; the backward writes each chunk's gradient increment, scans them in
reverse into the gradient of each chunk's exit state, then computes every
gradient of a chunk from its entry state and that gradient alone, the
decay's too (no running sum across chunks).  The f32 operand of each
product (decays, states, their gradients, do . v) enters as a bf16 hi + lo
pair beside an exact bf16 one.  f32 (the fp32 parity runs) keeps the
CUDA-core kernels: one block per (batch, head) walks chunks of 32
(``CHUNK``).  No atomics: ``du``'s sum over the (batch, chunk) or batch
partials runs in a fixed order, so two runs give the same bits.
``launches`` and ``bwd_launches`` count calls of the wrappers, and
``tc_launches`` / ``tc_bwd_launches`` those of them on the bf16 route; a
bf16 call launches 3 CUDA kernels forward and 4 backward, an f32 call 1
and 2.

The forward also starts from a state ``s0`` the caller carries in
(recurrent serving: a slot's wkv state between prefill chunks), where the
JAX package runs its plain chunked scan on the TPU too
(``src/repro/kernels/ops.py:247-253``): the bf16 route's in-place scan
starts its carried value at S0, the f32 kernel loads S0 into the block's
state, and everything downstream (each chunk-entry state, S_final, the
output) follows.  ``s0_launches`` counts the forwards that took one; a
forward without ``s0`` is the zero-state kernel, bit for bit.

The plain versions are ``kernels/ref.py:rwkv6_scan_chunked`` and
``rwkv6_bwd``; ``kernels/ops.py`` sends CPU tensors there.  These wrappers
take CUDA tensors only; on the bf16 route r, k, v, w (and do) must start on
a 16-byte boundary.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0         # forward kernel launches through this module
bwd_launches = 0     # backward launches (one per rwkv6_bwd call)
tc_launches = 0      # forwards on the bf16 tensor-core route
tc_bwd_launches = 0  # backwards on the bf16 tensor-core route
s0_launches = 0      # forwards from a carried initial state s0

HEAD_DIMS = (16, 32, 64)   # the head dims the kernels are built for
CHUNK = 32                 # rows per chunk of the f32 kernels (kChunk of csrc/rwkv6.cu)
TC_CHUNK = 64              # ... and of the bf16 ones (kTcChunk)


def chunk_of(dtype: torch.dtype) -> int:
    """Rows per chunk of the kernels that take ``dtype``."""
    return TC_CHUNK if dtype == torch.bfloat16 else CHUNK


def n_chunks(s: int, chunk: int = CHUNK) -> int:
    return -(-s // chunk)


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


def _aligned(name: str, **tensors):
    """The bf16 route copies rows 16 bytes at a time (cp.async)."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte boundary")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def rwkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, *, s0=None,
              save_states: bool = False):
    """r, k, v [B, S, H, D]; w [B, S, H, D] f32; u [H, D] f32; s0 [B, H, D,
    D] f32 (key dim first) or None (zeros) -> (o like r, S_final
    [B, H, D, D] f32, chunk-entry states [B, H, NC, D, D] f32 or None), NC =
    ceil(S / chunk_of(r.dtype))."""
    global launches, tc_launches, s0_launches
    b, s, h, d = _check("rwkv6", r, k, v, w, u)
    if s0 is not None and (s0.shape != (b, h, d, d) or s0.dtype != torch.float32):
        raise ValueError(f"rwkv6: s0 must be [{b}, {h}, {d}, {d}] float32, got "
                         f"{tuple(s0.shape)} {s0.dtype}")
    extra = {} if s0 is None else {"s0": s0}
    _build.require_cuda("rwkv6", r=r, k=k, v=v, w=w, u=u, **extra)
    tc = r.dtype == torch.bfloat16
    if tc:
        _aligned("rwkv6", r=r, k=k, v=v, w=w, **extra)
    nc = n_chunks(s, chunk_of(r.dtype))
    f32 = dict(dtype=torch.float32, device=r.device)
    o = torch.empty_like(r)
    sf = torch.empty((b, h, d, d), **f32)
    # the bf16 route scans the states in place: a scratch when not saved
    states = torch.empty((b, h, nc, d, d), **f32) if save_states or tc else None
    dec = torch.empty((b, h, nc, d), **f32) if tc else None
    lib = _build.load()
    code = lib.repro_rwkv6_fwd(_build.dtype_code(r), r.data_ptr(), k.data_ptr(),
                               v.data_ptr(), w.data_ptr(), u.data_ptr(),
                               _ptr(s0), o.data_ptr(), sf.data_ptr(), _ptr(states),
                               _ptr(dec), b, s, h, d, _build.stream_ptr(r))
    launches += 1
    tc_launches += tc
    s0_launches += s0 is not None
    _build.check("rwkv6", code)
    return o, sf, states if save_states else None


def rwkv6_bwd(r, k, v, w, u, do, states):
    """Gradients (dr, dk, dv, dw, du) of :func:`rwkv6_fwd`'s ``o`` for the
    output gradient ``do`` (S_final's gradient taken as zero), from the
    chunk-entry ``states`` that the forward wrote."""
    global bwd_launches, tc_bwd_launches
    b, s, h, d = _check("rwkv6_bwd", r, k, v, w, u)
    nc = n_chunks(s, chunk_of(r.dtype))
    if do.shape != r.shape or do.dtype != r.dtype:
        raise ValueError(f"rwkv6_bwd: do {tuple(do.shape)} {do.dtype} must be "
                         f"like r")
    if states is None or states.shape != (b, h, nc, d, d) \
            or states.dtype != torch.float32:
        raise ValueError("rwkv6_bwd: states must be the forward's chunk-entry "
                         f"states [{b}, {h}, {nc}, {d}, {d}] float32")
    _build.require_cuda("rwkv6_bwd", r=r, k=k, v=v, w=w, u=u, do=do,
                        states=states)
    tc = r.dtype == torch.bfloat16
    if tc:
        _aligned("rwkv6_bwd", r=r, k=k, v=v, w=w, do=do)
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty_like(w)
    du = torch.empty((h, d), **f32)
    du_part = torch.empty((b * nc if tc else b, h, d), **f32)
    dstates = torch.empty_like(states) if tc else None
    dec = torch.empty((b, h, nc, d), **f32) if tc else None
    lib = _build.load()
    code = lib.repro_rwkv6_bwd(_build.dtype_code(r), r.data_ptr(), k.data_ptr(),
                               v.data_ptr(), w.data_ptr(), u.data_ptr(),
                               do.data_ptr(), states.data_ptr(), dr.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                               du_part.data_ptr(), du.data_ptr(), _ptr(dstates),
                               _ptr(dec), b, s, h, d, _build.stream_ptr(r))
    bwd_launches += 1
    tc_bwd_launches += tc
    _build.check("rwkv6_bwd", code)
    return dr, dk, dv, dw, du
