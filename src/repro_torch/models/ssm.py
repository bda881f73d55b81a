"""Mamba2 block (SSD with a scalar decay per head), n_groups = 1.

Port of the JAX package's ``models/ssm.py`` (the full-sequence path):
in_proj -> [z | x | B | C | dt]; a causal depthwise conv over (x, B, C);
silu; the SSD scan through ``kernels.ops.mamba2_scan`` (the CUDA kernel on
the card); the ``D`` skip; the gated RMSNorm rmsnorm(silu(z) * y) through
the silu_mul and rmsnorm kernels; out_proj.  The JAX dtypes are kept:
``A_log``, ``D`` and ``dt_bias`` are f32, ``conv_w``, the norm and the
linears in the model dtype; the conv accumulates in f32 and casts back,
the softplus runs in f32, and the ``D`` skip adds in y's dtype.  The conv
and silu are plain PyTorch (the JAX package has no kernel for them).
Serving keeps a (conv tail [B, W - 1, C] in the model dtype, SSM state
[B, H, P, N] f32) pair per layer: :func:`mamba_apply` carries it through a
right-padded chunk (on the card the scan kernel from a carried state), and
:func:`mamba_decode_step` advances it by one token (``ops.mamba2_step``,
plain PyTorch as in JAX; the one-row conv accumulates in f32).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers


def mamba_init(cfg: ModelConfig, normal: Callable, dtype, device):
    """One layer's ``mamba`` parameters, the JAX ``mamba_init``'s shapes and
    distributions; ``normal(shape, scale, dtype)`` draws N(0, 1) * scale
    from the caller's generator."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * di + 2 * n + h                  # z, x, B, C, dt
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=device))
    return {
        "in_proj": {"w": normal((d, proj_out), d ** -0.5, dtype)},
        "conv_w": normal((cfg.conv_width, di + 2 * n), 0.2, dtype),
        "A_log": a_log,
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "norm": {"scale": torch.ones((di,), dtype=dtype, device=device)},
        "out_proj": {"w": normal((di, d), di ** -0.5, dtype)},
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xin = zxbcdt[..., di:2 * di]
    B = zxbcdt[..., 2 * di:2 * di + n]
    C = zxbcdt[..., 2 * di + n:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xin, B, C, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, conv_state=None, length=None):
    """Depthwise causal conv over the sequence: x [B, S, C]; w [W, C] ->
    (y like x, tail), the tail being the last W - 1 inputs (the decode
    state).  With ``length`` (int or [B]) the tail is taken at the last
    *valid* inputs: rows at and beyond ``length`` are right-padding."""
    b, s, c = x.shape
    wlen = w.shape[0]
    if conv_state is None:
        xp = F.pad(x, (0, 0, wlen - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for i in range(wlen):                   # W = 4: a small static unroll
        y = y + xp[:, i:i + s].float() * w[i].float()
    if wlen <= 1:
        tail = None
    elif length is None:
        tail = xp[:, -(wlen - 1):]
    else:
        # xp row ``length + i`` (i < W - 1) is input row length - W + 1 + i
        starts = torch.as_tensor(length, device=x.device).long().expand(b)
        idx = starts[:, None] + torch.arange(wlen - 1, device=x.device)[None]
        tail = xp[torch.arange(b, device=x.device)[:, None], idx]
    return y.to(x.dtype), tail


def mamba_apply(p, x: torch.Tensor, cfg: ModelConfig, *, conv_state=None,
                ssm_state=None, length=None, return_state: bool = False):
    """x [B, S, d] -> y [B, S, d] (and (conv tail, ssm state) with
    ``return_state``).  ``length`` (int or [B]): valid rows per sequence;
    the padding rows get dt = 0, which freezes the recurrence, and the conv
    tail is taken at the last valid inputs, so a padded sequence carries
    exactly the state of an unpadded one."""
    b, s, _ = x.shape
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xin, B, C, dt = _split_proj(cfg, layers.linear(p["in_proj"], x))
    conv_in = torch.cat([xin, B, C], dim=-1)
    conv_out, tail = _causal_conv(conv_in, p["conv_w"], conv_state, length)
    conv_out = ops.silu(conv_out)
    xs = conv_out[..., :di].reshape(b, s, h, hd)
    Bs = conv_out[..., di:di + n]
    Cs = conv_out[..., di + n:]
    dt_sp = F.softplus(dt.float() + p["dt_bias"])
    if length is not None:
        lens = torch.as_tensor(length, device=x.device).long().expand(b)
        valid = torch.arange(s, device=x.device)[None, :] < lens[:, None]
        dt_sp = torch.where(valid[..., None], dt_sp, 0.0)
    A = -torch.exp(p["A_log"])
    y, hfin = ops.mamba2_scan(xs, dt_sp, A, Bs, Cs, h0=ssm_state)
    y = y + xs.float().to(y.dtype) * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(b, s, di)
    y = layers.rmsnorm(p["norm"], ops.silu_mul(z, y), cfg.norm_eps)
    out = layers.linear(p["out_proj"], y)
    if return_state:
        return out, (tail, hfin)
    return out


def _conv_step(x: torch.Tensor, w: torch.Tensor, conv_tail: torch.Tensor):
    """The causal conv over one token: x [B, 1, C]; w [W, C]; the tail [B,
    W - 1, C] -> (y [B, 1, C] in x's dtype, accumulated in f32; the new
    tail, the last W - 1 inputs)."""
    xp = torch.cat([conv_tail.to(x.dtype), x], dim=1)
    y = (xp.float() * w.float()[None]).sum(dim=1, keepdim=True)
    return y.to(x.dtype), xp[:, 1:]


def mamba_decode_step(p, x: torch.Tensor, cfg: ModelConfig, state):
    """One-token step: x [B, 1, d]; state = (conv tail [B, W - 1, C], h [B,
    H, P, N] f32) -> (y [B, 1, d], (conv tail, h))."""
    conv_tail, h = state
    b = x.shape[0]
    di, n, hh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xin, B, C, dt = _split_proj(cfg, layers.linear(p["in_proj"], x))
    y, tail = _conv_step(torch.cat([xin, B, C], dim=-1), p["conv_w"], conv_tail)
    conv_out = ops.silu(y)
    xs = conv_out[..., :di].reshape(b, hh, hd)
    Bs = conv_out[:, 0, di:di + n]
    Cs = conv_out[:, 0, di + n:]
    dt_sp = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    yt, hnew = ops.mamba2_step(xs, dt_sp, A, Bs, Cs, h)
    yt = yt + xs.float().to(yt.dtype) * p["D"][None, :, None].to(yt.dtype)
    yt = yt.reshape(b, 1, di)
    yt = layers.rmsnorm(p["norm"], ops.silu_mul(z, yt), cfg.norm_eps)
    return layers.linear(p["out_proj"], yt), (tail, hnew)


def mamba_state_init(cfg: ModelConfig, batch: int, n_layers: int, dtype,
                     device):
    """Zero (conv tail [L, B, W - 1, d_inner + 2 N] in ``dtype``, SSM state
    [L, B, H, P, N] f32) of ``n_layers`` layers and ``batch`` sequences."""
    conv_c = cfg.d_inner + 2 * cfg.ssm_state
    return (torch.zeros((n_layers, batch, cfg.conv_width - 1, conv_c),
                        dtype=dtype, device=device),
            torch.zeros((n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=device))
