"""Weight-stationary GEMM — a hand-written CUDA kernel for Hopper
(``csrc/matmul.cu``).

Replaces the TPU kernel ``src/repro/kernels/matmul.py``
(``weight_stationary_matmul``, ``pallas_call`` at :50), the paper's SRAM-PIM
lane: x [M, K] @ w [K, N] with f32 accumulation over all of K and one
rounding to ``out_dtype``.  The TPU kernel holds a [K, bn] weight panel in
VMEM across the m tiles; on the H100 a panel does not fit shared memory, so
the kernel keeps the reference's grid order (m tiles inner, n panels outer)
and the panel stays in L2 across the m tiles.  bf16 runs on the tensor cores
(``mma.sync``), f32 as FFMA on the CUDA cores.  Ragged M, N and K are masked
inside the kernel: the host pads nothing.  No split of K and no atomics, so
two launches give the same bits.

The plain version is ``kernels/ref.py:matmul``; ``kernels/ops.py:matmul``
routes by the reference's rule.  This wrapper takes CUDA tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0       # kernel launches through this module


NARROW_M = 16     # bf16 calls with at most this many rows take the narrow tile


def weight_stationary_matmul(x: torch.Tensor, w: torch.Tensor,
                             out_dtype=None, narrow=None) -> torch.Tensor:
    """x [M, K] @ w [K, N] -> [M, N] of ``out_dtype`` (default x's dtype);
    x and w of one dtype, bf16 or f32; the output bf16 or f32.  ``narrow``
    picks the bf16 kernel's tile, 16 x 32 or 64 x 64 (default: the narrow
    one for M <= ``NARROW_M``); f32 has one tile and refuses ``narrow=True``."""
    global launches
    _build.require_cuda("weight_stationary_matmul", x=x, w=w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"weight_stationary_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [M, K] and [K, N]")
    if x.dtype != w.dtype:
        raise TypeError(f"weight_stationary_matmul: x {x.dtype} and w "
                        f"{w.dtype} must share a dtype")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"weight_stationary_matmul: out_dtype {out_dtype}; the "
                        f"kernel writes {list(_build.DTYPE_CODES)}")
    (m, k), n = x.shape, w.shape[1]
    if narrow is None:
        narrow = x.dtype == torch.bfloat16 and m <= NARROW_M
    if narrow and x.dtype != torch.bfloat16:
        raise ValueError("weight_stationary_matmul: the narrow tile is the bf16 "
                         "kernel's; f32 has one tile")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load()
    code = lib.repro_matmul(_build.dtype_code(x), _build.DTYPE_CODES[out_dtype],
                            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                            int(narrow), _build.stream_ptr(x))
    launches += 1
    _build.check("weight_stationary_matmul", code)
    return out
