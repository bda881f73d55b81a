"""Fused RMSNorm — hand-written CUDA kernel for Hopper (``csrc/rmsnorm.cu``).

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py`` (``rmsnorm``,
``pallas_call`` at :51).  On the H100 it is bound by bytes — one read of x,
one write of the output — and the kernel makes exactly that traffic: one
block per row reduces the sum of squares in registers and shared memory,
then scales the row (the second read of the row hits L1/L2).  The TPU
kernel's optional ``curry_rounds`` Newton rsqrt has no caller on the serving
path and is left for a later slice.

The plain version is ``kernels/ref.py:rmsnorm``; ``kernels/ops.py`` sends CPU
tensors there.  This wrapper takes CUDA tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches through this wrapper


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x [..., D]; w [D] (x's dtype) -> normalized x."""
    global launches
    _build.require_cuda("rmsnorm", x=x, w=w)
    d = x.shape[-1]
    if w.shape != (d,) or w.dtype != x.dtype:
        raise ValueError(f"rmsnorm: w must be [{d}] {x.dtype}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    out = torch.empty_like(x)
    lib = _build.load()
    code = lib.repro_rmsnorm(_build.dtype_code(x), x.data_ptr(), w.data_ptr(),
                             out.data_ptr(), x.numel() // d, d, float(eps),
                             _build.stream_ptr(x))
    launches += 1
    _build.check("rmsnorm", code)
    return out
