"""RWKV-6 "Finch" block: time mix (wkv6) + channel mix.

Port of the JAX package's ``models/rwkv.py``:
token-shift lerp and the *data-dependent* per-channel decay
w_t = exp(-exp(w0 + tanh(x W_a) W_b)) from a low-rank (LoRA) projection,
with the JAX version's simplifications (static token-shift mix ratios,
per-head RMSNorm instead of GroupNorm) and dtypes: ``w0`` and ``u`` are
f32, ``mix``, ``w_a``, ``w_b`` and the linears in the model dtype; the
decay runs in f32, the channel mix squares in f32 and casts back.  The wkv
recurrence goes through ``kernels.ops.rwkv6_scan`` (the CUDA kernel on the
card, from zero or from a carried state); the one-token steps
(:func:`time_mix_step`, :func:`channel_mix_step`) through
``ops.rwkv6_step``, plain PyTorch as in JAX.  The recurrent state of a
batch (:func:`rwkv_state_init`) is the time mix's and the channel mix's
last input rows in the model dtype and the wkv state in f32.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers


def rwkv_init(cfg: ModelConfig, normal: Callable, dtype, device):
    """One layer's ``tm`` / ``cm`` parameters, the JAX ``rwkv_init``'s
    shapes and distributions; ``normal(shape, scale, dtype)`` draws
    N(0, 1) * scale from the caller's generator."""
    d, hd, h, lora = cfg.d_model, cfg.rwkv_head_dim, cfg.rwkv_heads, cfg.rwkv_lora

    def lin(d_in, d_out):
        return {"w": normal((d_in, d_out), d_in ** -0.5, dtype)}

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "tm": {                                           # time mix
            "mix": full((5, d), 0.5),                     # r, k, v, w, g lerp
            "wr": lin(d, d), "wk": lin(d, d), "wv": lin(d, d),
            "wg": lin(d, d), "wo": lin(d, d),
            "w0": full((d,), -5.0, torch.float32),        # base decay
            "w_a": normal((d, lora), d ** -0.5, dtype),
            "w_b": full((lora, d), 0.0),
            "u": normal((h, hd), 0.1, torch.float32),
            "ln": {"scale": full((d,), 1.0)},
        },
        "cm": {                                           # channel mix
            "mix": full((2, d), 0.5),                     # r, k lerp
            "wk": lin(d, cfg.d_ff), "wv": lin(cfg.d_ff, d), "wr": lin(d, d),
        },
    }


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None, length=None):
    """Token shift: x_{t-1} (zeros / the carried state at t = 0) -> (shifted,
    new_last).  With ``length`` (int or [B] int), ``new_last`` is the last
    *valid* row ``x[length - 1]`` rather than the final (possibly
    right-padded) row."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    shifted = torch.cat([last, x[:, :-1]], dim=1)
    if length is None:
        return shifted, x[:, -1:]
    b = x.shape[0]
    idx = torch.clamp(torch.as_tensor(length, device=x.device).long()
                      .expand(b) - 1, 0, x.shape[1] - 1)
    return shifted, x[torch.arange(b, device=x.device), idx][:, None]


def _valid_mask(length, b: int, s: int, device) -> torch.Tensor:
    """[B, S] bool: row < length (right-padding rows are False)."""
    lens = torch.as_tensor(length, device=device).long().expand(b)
    return torch.arange(s, device=device)[None, :] < lens[:, None]


def _decay(tm, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay w_t in (0, 1), f32: exp(-exp(w0 + tanh(xw Wa)
    Wb)), the logit clipped to [-12, 4]."""
    lora = torch.tanh(xw.float() @ tm["w_a"].float())
    logit = tm["w0"] + lora @ tm["w_b"].float()
    return torch.exp(-torch.exp(torch.clamp(logit, -12.0, 4.0)))


def time_mix(tm, x: torch.Tensor, cfg: ModelConfig, *, shift_state=None,
             wkv_state=None, length=None, return_state: bool = False):
    """x [B, S, d] -> [B, S, d].  ``length`` (int or [B]): valid rows per
    sequence; padding rows are made state-neutral (k -> 0, w -> 1) and the
    shift state is taken at the last valid row.  With ``return_state`` also
    returns (new shift state, wkv state)."""
    b, s, d = x.shape
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    prev, new_shift = _shift(x, shift_state, length)
    mix = tm["mix"].to(x.dtype)
    xr, xk, xv, xw, xg = (x * mix[i] + prev * (1 - mix[i]) for i in range(5))
    r = layers.linear(tm["wr"], xr).reshape(b, s, h, hd)
    k = layers.linear(tm["wk"], xk).reshape(b, s, h, hd)
    v = layers.linear(tm["wv"], xv).reshape(b, s, h, hd)
    g = layers.linear(tm["wg"], xg)
    w = _decay(tm, xw).reshape(b, s, h, hd)
    if length is not None:
        valid = _valid_mask(length, b, s, x.device)[..., None, None]
        k = torch.where(valid, k, 0.0)
        w = torch.where(valid, w, 1.0)
    o, sf = ops.rwkv6_scan(r, k, v, w.float(), tm["u"], s0=wkv_state)
    o = o.reshape(b, s, d)
    o = layers.rmsnorm(tm["ln"], o, cfg.norm_eps) * ops.silu(g)
    out = layers.linear(tm["wo"], o)
    if return_state:
        return out, (new_shift, sf)
    return out


def channel_mix(cm, x: torch.Tensor, *, shift_state=None, length=None,
                return_state: bool = False):
    prev, new_shift = _shift(x, shift_state, length)
    mix = cm["mix"].to(x.dtype)
    xr = x * mix[0] + prev * (1 - mix[0])
    xk = x * mix[1] + prev * (1 - mix[1])
    r = torch.sigmoid(layers.linear(cm["wr"], xr).float())
    k = layers.linear(cm["wk"], xk)
    kk = torch.square(torch.relu(k.float())).to(x.dtype)
    out = (r * layers.linear(cm["wv"], kk).float()).to(x.dtype)
    if return_state:
        return out, new_shift
    return out


def time_mix_step(tm, x: torch.Tensor, cfg: ModelConfig, state):
    """One-token step: x [B, 1, d]; state = (last x [B, 1, d], S [B, H, D, D]
    f32) -> (out [B, 1, d], (x, S_new))."""
    prev, S = state
    b, _, d = x.shape
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    mix = tm["mix"].to(x.dtype)
    xr, xk, xv, xw, xg = (x * mix[i] + prev * (1 - mix[i]) for i in range(5))
    r = layers.linear(tm["wr"], xr).reshape(b, h, hd)
    k = layers.linear(tm["wk"], xk).reshape(b, h, hd)
    v = layers.linear(tm["wv"], xv).reshape(b, h, hd)
    g = layers.linear(tm["wg"], xg)
    w = _decay(tm, xw).reshape(b, h, hd)
    o, S_new = ops.rwkv6_step(r, k, v, w, tm["u"], S)
    o = o.reshape(b, 1, d)
    o = layers.rmsnorm(tm["ln"], o, cfg.norm_eps) * ops.silu(g)
    return layers.linear(tm["wo"], o), (x, S_new)


def channel_mix_step(cm, x: torch.Tensor, state):
    """One-token step: x [B, 1, d]; state = last x [B, 1, d] -> (out, x)."""
    prev = state
    mix = cm["mix"].to(x.dtype)
    xr = x * mix[0] + prev * (1 - mix[0])
    xk = x * mix[1] + prev * (1 - mix[1])
    r = torch.sigmoid(layers.linear(cm["wr"], xr).float())
    k = layers.linear(cm["wk"], xk)
    kk = torch.square(torch.relu(k.float())).to(x.dtype)
    out = (r * layers.linear(cm["wv"], kk).float()).to(x.dtype)
    return out, x


def rwkv_state_init(cfg: ModelConfig, batch: int, n_layers: int,
                    dtype=torch.bfloat16, device="cuda"):
    """Zero recurrent state of ``batch`` sequences, stacked over layers:
    (tm shift [L, B, 1, d] dtype, wkv [L, B, H, D, D] f32, cm shift [L, B,
    1, d] dtype)."""
    d, h, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    return (torch.zeros((n_layers, batch, 1, d), dtype=dtype, device=device),
            torch.zeros((n_layers, batch, h, hd, hd), dtype=torch.float32,
                        device=device),
            torch.zeros((n_layers, batch, 1, d), dtype=dtype, device=device))
