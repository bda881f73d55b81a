"""Fused SwiGLU gating and its backward — hand-written CUDA kernels for
Hopper (``csrc/swiglu.cu``).

Replaces the TPU kernel ``src/repro/kernels/swiglu.py`` (``silu_mul``,
``pallas_call`` at :59).  On the H100 it is bound by bytes: two reads and one
write per element; fusing keeps ``silu(gate)`` out of device memory.  The
kernel rounds ``silu(gate)`` to the element type before the multiply, as the
plain version does; the TPU kernel keeps it in f32, one bf16 rounding away.
The TPU kernel's ``curry_rounds`` form (the paper's Curry-ALU sigmoid: exp
by a range-reduced Taylor series and four squarings) is the same kernel with
a runtime round count, forward only; it keeps ``g * sigma(g) * u`` in f32
with one rounding, as the TPU kernel does.  It has no caller on a model path
and its launches are counted apart (``curry_launches``).

The backward (no TPU kernel: the JAX package differentiates its oracle) is
one elementwise pass, bound by bytes (three reads, two writes); it rounds
where the forward rounds.

The plain versions are ``kernels/ref.py:silu_mul`` and ``silu_mul_bwd``;
``kernels/ops.py`` sends CPU tensors there.  These wrappers take CUDA
tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0       # forward kernel launches through this module
curry_launches = 0  # launches of the curry_rounds form
bwd_launches = 0   # backward kernel launches


def silu_mul(gate: torch.Tensor, up: torch.Tensor,
             curry_rounds: int = 0) -> torch.Tensor:
    """silu(gate) * up, elementwise; gate and up of one shape and dtype;
    ``curry_rounds`` Taylor terms replace the native exp when nonzero."""
    global launches, curry_launches
    if gate.shape != up.shape or gate.dtype != up.dtype:
        raise ValueError(f"silu_mul: gate {tuple(gate.shape)} {gate.dtype} and "
                         f"up {tuple(up.shape)} {up.dtype} must match")
    _build.require_cuda("silu_mul", gate=gate, up=up)
    out = torch.empty_like(up)
    lib = _build.load()
    code = lib.repro_silu_mul(_build.dtype_code(up), gate.data_ptr(),
                              up.data_ptr(), out.data_ptr(), up.numel(),
                              int(curry_rounds), _build.stream_ptr(up))
    if curry_rounds:
        curry_launches += 1
    else:
        launches += 1
    _build.check("silu_mul", code)
    return out


def silu_mul_bwd(gate: torch.Tensor, up: torch.Tensor, dy: torch.Tensor):
    """Gradients (dgate, dup) of :func:`silu_mul` for the output gradient."""
    global bwd_launches
    if not (gate.shape == up.shape == dy.shape) or \
            not (gate.dtype == up.dtype == dy.dtype):
        raise ValueError(f"silu_mul_bwd: gate {tuple(gate.shape)} {gate.dtype}, "
                         f"up {tuple(up.shape)} {up.dtype}, dy "
                         f"{tuple(dy.shape)} {dy.dtype} must match")
    _build.require_cuda("silu_mul_bwd", gate=gate, up=up, dy=dy)
    dgate = torch.empty_like(gate)
    dup = torch.empty_like(up)
    lib = _build.load()
    code = lib.repro_silu_mul_bwd(_build.dtype_code(up), gate.data_ptr(),
                                  up.data_ptr(), dy.data_ptr(),
                                  dgate.data_ptr(), dup.data_ptr(), up.numel(),
                                  _build.stream_ptr(up))
    bwd_launches += 1
    _build.check("silu_mul_bwd", code)
    return dgate, dup
