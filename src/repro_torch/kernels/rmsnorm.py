"""Fused RMSNorm and its backward — hand-written CUDA kernels for Hopper
(``csrc/rmsnorm.cu``).

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py`` (``rmsnorm``,
``pallas_call`` at :51).  On the H100 it is bound by bytes — one read of x,
one write of the output — and the kernel makes exactly that traffic: one
block per row reduces the sum of squares in registers and shared memory,
then scales the row (the second read of the row hits L1/L2).  The TPU
kernel's ``curry_rounds`` form (the paper's Curry-ALU rsqrt: Newton steps
from a bf16-rounded seed) is the same kernel with a runtime round count,
forward only; it has no caller on a model path and its launches are counted
apart (``curry_launches``).

The backward (no TPU kernel: the JAX package differentiates its oracle) is
bound by bytes too: x and dy read once, dx written once.  ``dw`` is a column
sum over all rows, taken without atomics in two passes: per-block f32
partials, then one pass over the partials in block order, so the result
does not depend on scheduling.

The plain versions are ``kernels/ref.py:rmsnorm`` and ``rmsnorm_bwd``;
``kernels/ops.py`` sends CPU tensors there.  These wrappers take CUDA
tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0       # forward kernel launches through this module
curry_launches = 0  # launches of the curry_rounds form
bwd_launches = 0   # backward launches (one per rmsnorm_bwd call)
BWD_BLOCKS = 528   # row blocks of the backward (4 per SM of the H100)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            curry_rounds: int = 0) -> torch.Tensor:
    """x [..., D]; w [D] (x's dtype) -> normalized x; ``curry_rounds``
    Newton steps replace the native rsqrt when nonzero."""
    global launches, curry_launches
    _build.require_cuda("rmsnorm", x=x, w=w)
    d = x.shape[-1]
    if w.shape != (d,) or w.dtype != x.dtype:
        raise ValueError(f"rmsnorm: w must be [{d}] {x.dtype}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    out = torch.empty_like(x)
    lib = _build.load()
    code = lib.repro_rmsnorm(_build.dtype_code(x), x.data_ptr(), w.data_ptr(),
                             out.data_ptr(), x.numel() // d, d, float(eps),
                             int(curry_rounds), _build.stream_ptr(x))
    if curry_rounds:
        curry_launches += 1
    else:
        launches += 1
    _build.check("rmsnorm", code)
    return out


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5):
    """Gradients (dx, dw) of :func:`rmsnorm` for the output gradient dy."""
    global bwd_launches
    _build.require_cuda("rmsnorm_bwd", x=x, w=w, dy=dy)
    d = x.shape[-1]
    if w.shape != (d,) or w.dtype != x.dtype or dy.shape != x.shape \
            or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)} {x.dtype}, w "
                         f"{tuple(w.shape)} {w.dtype}, dy {tuple(dy.shape)} "
                         f"{dy.dtype} do not match")
    rows = x.numel() // d
    blocks = max(1, min(rows, BWD_BLOCKS))
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    lib = _build.load()
    code = lib.repro_rmsnorm_bwd(_build.dtype_code(x), x.data_ptr(),
                                 w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                 dw.data_ptr(), part.data_ptr(), rows, d,
                                 float(eps), blocks, _build.stream_ptr(x))
    bwd_launches += 1
    _build.check("rmsnorm_bwd", code)
    return dx, dw
