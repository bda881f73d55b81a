"""Mamba2 SSD chunked scan — hand-written CUDA kernels for Hopper
(``csrc/mamba2.cu``): the forward and its deterministic backward.

Replaces the TPU kernel ``src/repro/kernels/mamba_chunk.py``
(``mamba2_chunked``, ``pallas_call`` at :86).  One block per (batch, head)
carries the f32 state h [P, N] in shared memory across 64-row chunks; x
``[B, S, H, P]``, dt ``[B, S, H]`` and B, C ``[B, S, N]`` are read in their
layouts (no host-side transpose or padding: the ragged last chunk is masked
in the kernel), and every decay exponent is <= 0 (the pair term is computed
for u <= t only).  For training the forward also writes the state at each
chunk's entry, ``[B, H, ceil(S/64), P, N]`` f32 (235 MB a layer at
zamba2-7b's full width and 2 x 4096 tokens), which the backward reads
instead of recomputing; under remat it lives only while one layer is
recomputed.  The backward is one reverse pass over the chunks per (batch,
head) without atomics: dB and dC are per-head partials summed over the
heads in order by a second kernel, and dA's per-(batch, head) partials are
summed over the batch here in a fixed order, so two runs give the same
bits.  Bound on the H100 by bytes; this first version runs B * H blocks
(224 at zamba2-7b's B = 2, H = 112) on 132 SMs and recomputes C B^T per
head.

The plain versions are ``kernels/ref.py:mamba2_scan`` and ``mamba2_bwd``;
``kernels/ops.py`` sends CPU tensors there.  These wrappers take CUDA
tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0       # forward kernel launches through this module
bwd_launches = 0   # backward launches (one per mamba2_bwd call)

SHAPES = ((64, 64), (16, 8))   # (head dim P, state N) the kernel is built for
CHUNK = 64                     # rows per chunk (kChunk of csrc/mamba2.cu)


def n_chunks(s: int) -> int:
    return -(-s // CHUNK)


def _check(name: str, x, dt, A, B, C):
    if x.dim() != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be [B, S, H, P]")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n) \
            or C.shape != B.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} must be [B,S,H,P], [B,S,H], [H], "
                         f"[B,S,N] x2")
    if (p, n) not in SHAPES:
        raise ValueError(f"{name}: (head dim, state) ({p}, {n}) not in {SHAPES}")
    if not (x.dtype == B.dtype == C.dtype):
        raise ValueError(f"{name}: x, B, C dtypes {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"{name}: dt and A must be float32, got {dt.dtype}, "
                         f"{A.dtype}")
    return b, s, h, p, n


def mamba2_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, *, save_states: bool = False):
    """x [B, S, H, P]; dt [B, S, H] f32; A [H] f32; B, C [B, S, N] -> (y like
    x, h_final [B, H, P, N] f32, chunk-entry states [B, H, NC, P, N] f32 or
    None)."""
    global launches
    b, s, h, p, n = _check("mamba2", x, dt, A, B, C)
    _build.require_cuda("mamba2", x=x, dt=dt, A=A, B=B, C=C)
    y = torch.empty_like(x)
    hf = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    states = (torch.empty((b, h, n_chunks(s), p, n), dtype=torch.float32,
                          device=x.device) if save_states else None)
    lib = _build.load()
    code = lib.repro_mamba2_fwd(_build.dtype_code(x), x.data_ptr(), dt.data_ptr(),
                                A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                y.data_ptr(), hf.data_ptr(),
                                states.data_ptr() if save_states else None,
                                b, s, h, p, n, _build.stream_ptr(x))
    launches += 1
    _build.check("mamba2", code)
    return y, hf, states


def mamba2_bwd(x, dt, A, B, C, dy, states):
    """Gradients (dx, ddt, dA, dB, dC) of :func:`mamba2_fwd`'s ``y`` for the
    output gradient ``dy`` (h_final's gradient taken as zero), from the
    chunk-entry ``states`` that the forward wrote."""
    global bwd_launches
    b, s, h, p, n = _check("mamba2_bwd", x, dt, A, B, C)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"mamba2_bwd: dy {tuple(dy.shape)} {dy.dtype} must be "
                         f"like x")
    if states is None or states.shape != (b, h, n_chunks(s), p, n) \
            or states.dtype != torch.float32:
        raise ValueError("mamba2_bwd: states must be the forward's chunk-entry "
                         f"states [{b}, {h}, {n_chunks(s)}, {p}, {n}] float32")
    _build.require_cuda("mamba2_bwd", x=x, dt=dt, A=A, B=B, C=C, dy=dy,
                        states=states)
    dev = x.device
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dB_part = torch.empty((b, s, h, n), dtype=torch.float32, device=dev)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty((b, h), dtype=torch.float32, device=dev)
    lib = _build.load()
    code = lib.repro_mamba2_bwd(_build.dtype_code(x), x.data_ptr(), dt.data_ptr(),
                                A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                dy.data_ptr(), states.data_ptr(), dx.data_ptr(),
                                ddt.data_ptr(), dB_part.data_ptr(),
                                dC_part.data_ptr(), dA_part.data_ptr(),
                                dB.data_ptr(), dC.data_ptr(), b, s, h, p, n,
                                _build.stream_ptr(x))
    bwd_launches += 1
    _build.check("mamba2_bwd", code)
    dA = dA_part[0].clone()
    for i in range(1, b):                     # the sum over B in batch order
        dA += dA_part[i]
    return dx, ddt, dA, dB, dC
