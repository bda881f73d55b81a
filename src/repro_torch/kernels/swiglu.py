"""Fused SwiGLU gating — hand-written CUDA kernel for Hopper
(``csrc/swiglu.cu``).

Replaces the TPU kernel ``src/repro/kernels/swiglu.py`` (``silu_mul``,
``pallas_call`` at :59).  On the H100 it is bound by bytes: two reads and one
write per element; fusing keeps ``silu(gate)`` out of device memory.  The
kernel rounds ``silu(gate)`` to the element type before the multiply, as the
plain version does; the TPU kernel keeps it in f32, one bf16 rounding away.
The TPU kernel's optional ``curry_rounds`` Taylor exp has no caller on the
serving path and is left for a later slice.

The plain version is ``kernels/ref.py:silu_mul``; ``kernels/ops.py`` sends CPU
tensors there.  This wrapper takes CUDA tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches through this wrapper


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up, elementwise; gate and up of one shape and dtype."""
    global launches
    if gate.shape != up.shape or gate.dtype != up.dtype:
        raise ValueError(f"silu_mul: gate {tuple(gate.shape)} {gate.dtype} and "
                         f"up {tuple(up.shape)} {up.dtype} must match")
    _build.require_cuda("silu_mul", gate=gate, up=up)
    out = torch.empty_like(up)
    lib = _build.load()
    code = lib.repro_silu_mul(_build.dtype_code(up), gate.data_ptr(),
                              up.data_ptr(), out.data_ptr(), up.numel(),
                              _build.stream_ptr(up))
    launches += 1
    _build.check("silu_mul", code)
    return out
