"""Interleaved RoPE — hand-written CUDA kernel for Hopper (``csrc/rope.cu``).

Replaces the TPU kernel ``src/repro/kernels/rope.py`` (``apply_rope``,
``pallas_call`` at :52).  On the H100 it is bound by bytes: one read of x and
the int32 positions, one write.  One thread rotates one neighbour pair with
cos/sin computed from the position in registers, so the pair swap never
touches memory and no table is read.  The inverse frequency follows the
plain version, ``1 / theta^(j/half)``; the TPU kernel's ``exp(-ln(theta)
j/half)`` differs from it by a few ulp.

The plain version is ``kernels/ref.py:apply_rope``; ``kernels/ops.py`` sends
CPU tensors there.  This wrapper takes CUDA tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches through this wrapper


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x [B, S, H, D]; positions [B, S] or [S] int32 -> rotated x."""
    global launches
    b, s, h, d = x.shape
    if d % 2:
        raise ValueError(f"apply_rope: head dim {d} must be even")
    if positions.dim() == 1:
        positions = positions[None, :].expand(b, s)
    if positions.shape != (b, s) or positions.dtype != torch.int32:
        raise ValueError(f"apply_rope: positions must be [{b}, {s}] int32, "
                         f"got {tuple(positions.shape)} {positions.dtype}")
    positions = positions.contiguous()
    _build.require_cuda("apply_rope", x=x, positions=positions)
    out = torch.empty_like(x)
    lib = _build.load()
    code = lib.repro_rope(_build.dtype_code(x), x.data_ptr(),
                          positions.data_ptr(), out.data_ptr(), b * s, h, d,
                          float(theta), _build.stream_ptr(x))
    launches += 1
    _build.check("apply_rope", code)
    return out
