"""Gradients through the port's CUDA kernels.

One :class:`torch.autograd.Function` per kernel on the training path:
``forward`` launches the forward kernel and ``backward`` the backward
kernel, with ``ctx`` keeping what the backward reads.  RoPE needs no kernel
of its own: the interleaved rotation by ``pos * inv_freq`` is orthogonal, so
its vector-Jacobian product is the same rotation at ``-pos``, which the
forward kernel computes at ``sign=-1`` (no negated position tensor); q and
k go through one launch each way.  Gradients arriving non-contiguous (from
a reshape or a transposed product) are made contiguous before a launch.

These take CUDA tensors only; ``kernels/ops.py`` routes to them.  On the CPU
autograd differentiates the plain versions directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_chunk as _mamba
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import rope as _rope
from repro_torch.kernels import rwkv_chunk as _rwkv
from repro_torch.kernels import swiglu as _sw


class RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rn.rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _rn.rmsnorm_bwd(x, w, dy.contiguous(), ctx.eps)
        return dx, dw, None


class Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, positions, theta: float):
        ctx.save_for_backward(positions)
        ctx.theta = theta
        return _rope.apply_rope(x, positions, theta)

    @staticmethod
    def backward(ctx, dy):
        (positions,) = ctx.saved_tensors
        return (_rope.apply_rope(dy.contiguous(), positions, ctx.theta, sign=-1),
                None, None)


class RopeQK(torch.autograd.Function):
    """q and k rotated at the same positions by one launch, and their
    gradients by one launch at ``sign=-1``."""

    @staticmethod
    def forward(ctx, q, k, positions, theta: float):
        ctx.save_for_backward(positions)
        ctx.theta = theta
        return _rope.apply_rope_qk(q, k, positions, theta)

    @staticmethod
    def backward(ctx, dq, dk):
        (positions,) = ctx.saved_tensors
        dq, dk = _rope.apply_rope_qk(dq.contiguous(), dk.contiguous(), positions,
                                     ctx.theta, sign=-1)
        return dq, dk, None, None


class SiluMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return _sw.silu_mul(gate, up)

    @staticmethod
    def backward(ctx, dy):
        gate, up = ctx.saved_tensors
        return _sw.silu_mul_bwd(gate, up, dy.contiguous())


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o, lse = _fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                             causal=ctx.causal,
                                             window=ctx.window)
        return dq, dk, dv, None, None


class RWKV6(torch.autograd.Function):
    """(o, S_final) of the wkv recurrence from a zero state; S_final is not
    differentiable (training never carries it).  The forward writes the
    chunk-entry states when a gradient is wanted, and the backward reads
    them."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        want = any(ctx.needs_input_grad)        # grad mode is off in here
        o, sf, states = _rwkv.rwkv6_fwd(r, k, v, w, u, save_states=want)
        ctx.mark_non_differentiable(sf)
        if want:
            ctx.save_for_backward(r, k, v, w, u, states)
        return o, sf

    @staticmethod
    def backward(ctx, do, _dsf):
        r, k, v, w, u, states = ctx.saved_tensors
        return _rwkv.rwkv6_bwd(r, k, v, w, u, do.contiguous(), states)


class Mamba2(torch.autograd.Function):
    """(y, h_final) of the Mamba2 SSD scan from a zero state; h_final is not
    differentiable (training never carries it).  The forward writes the
    chunk-entry states when a gradient is wanted, and the backward reads
    them."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        want = any(ctx.needs_input_grad)        # grad mode is off in here
        y, hf, states = _mamba.mamba2_fwd(x, dt, A, B, C, save_states=want)
        ctx.mark_non_differentiable(hf)
        if want:
            ctx.save_for_backward(x, dt, A, B, C, states)
        return y, hf

    @staticmethod
    def backward(ctx, dy, _dhf):
        x, dt, A, B, C, states = ctx.saved_tensors
        return _mamba.mamba2_bwd(x, dt, A, B, C, dy.contiguous(), states)
