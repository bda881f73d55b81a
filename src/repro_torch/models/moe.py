"""Top-k routed Mixture-of-Experts FFN with optional shared experts.

Port of the JAX package's ``models/moe.py`` single-program dispatch: GShard
capacity with a position per assignment from an exclusive cumsum over the
tokens (never the [T, E, C] one-hot einsum), a scatter of the kept
assignments into an ``[E_pad * cap + 1, d]`` buffer whose last row takes
every dropped one, the routed experts' FFNs as batched products over the
expert axis with ``ops.silu_mul`` between them (the ported SwiGLU kernel on
the card), a gather from the expert outputs with a zero row appended (so
the junk row is never read and a dropped assignment adds 0), and the
combine in f32.  Routed-expert counts of 16 or more pad to a multiple of 16
(qwen2-moe: 60 -> 64); a padded expert's router logit is -1e30, so it never
wins.

Every row of ``x`` is routed, in order: capacity couples the rows of one
dispatch (``cap`` follows the row count; positions follow row order), so
the right-padded rows of a prefill chunk and the idle rows of a batched
decode decide which live assignments drop, exactly as in the JAX package.
Top-k breaks ties towards the lower expert index, as ``jax.lax.top_k``
does (a stable descending sort).  No step reads a value back to the host.

The Switch load-balance loss, the router z-loss and the dropped fraction
(what the JAX function returns on every call) are computed only when the
caller asks: the training forward (``losses``: the two losses and the
dropped fraction), or the serving engine's expert telemetry
(``return_stats``: the per-expert load and the dropped fraction, no loss).
A serving dispatch without the telemetry computes none of them.  Every step
is differentiable where JAX's is: the router's gradient reaches it through
the gates, the load-balance loss and the z-loss; the padded experts'
router columns take exactly zero gradient (their logits are overwritten
in place).  The expert-parallel dispatches (``_moe_apply_ep``,
``_moe_apply_ep_local``, ``expert_param_specs``) come with the
expert-parallel slice (ROADMAP A.2b).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers


def moe_padded_experts(cfg: ModelConfig) -> int:
    """Routed expert count padded to a multiple of 16 (qwen2-moe: 60 ->
    64); fewer than 16 experts (the reduced test configs) keep their
    count."""
    e = cfg.n_experts
    if e < 16:
        return e
    return -(-e // 16) * 16


def moe_init(cfg: ModelConfig, gen: torch.Generator, dtype=torch.bfloat16,
             device="cuda"):
    """One layer's MoE parameters drawn from ``gen`` (on ``device``), the
    JAX ``moe_init``'s shapes and distributions: the router [d, E_pad] in
    f32 whatever ``dtype``, the banks ``w_gate`` / ``w_up`` [E_pad, d, ff]
    and ``w_down`` [E_pad, ff, d] N(0, 1) * d_in^-0.5, and with shared
    experts one ``shared`` FFN of width ``n_shared * moe_d_ff``."""
    d, ff = cfg.d_model, cfg.moe_d_ff
    e_pad = moe_padded_experts(cfg)

    def normal(shape, scale, dt=dtype):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * scale).to(dt)

    p = {"router": normal((d, e_pad), d ** -0.5, torch.float32),
         "w_gate": normal((e_pad, d, ff), d ** -0.5),
         "w_up": normal((e_pad, d, ff), d ** -0.5),
         "w_down": normal((e_pad, ff, d), ff ** -0.5)}
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        p["shared"] = {"gate": {"w": normal((d, sff), d ** -0.5)},
                       "up": {"w": normal((d, sff), d ** -0.5)},
                       "down": {"w": normal((sff, d), sff ** -0.5)}}
    return p


def capacity(t: int, k: int, cf: float, e_pad: int) -> int:
    """Slots an expert takes in one dispatch of ``t`` rows: the average
    load times ``cf``, at least 4 (tiny decode batches), at most ``t`` (a
    cap of t is exactly dropless; ``cf >= E / k`` gives it)."""
    return int(min(t, max(t * k * cf / e_pad, 4)))


class Routing(NamedTuple):
    """One dispatch's routing: ``gates`` [T, K] f32 (renormalised),
    ``slot`` [T * K] int64 (row ``e * cap + pos`` of the expert buffer, or
    ``E_pad * cap`` for a dropped assignment), and what the aux values
    read: ``logits`` / ``probs`` [T, E_pad] f32, ``assign`` [T, E_pad]
    (the one-hot of the chosen experts) and ``keep`` [T, K] bool."""
    gates: torch.Tensor
    slot: torch.Tensor
    logits: torch.Tensor
    probs: torch.Tensor
    assign: torch.Tensor
    keep: torch.Tensor


def route(p, xt: torch.Tensor, cfg: ModelConfig, cap: int) -> Routing:
    """Router, top-k and the GShard positions of ``xt`` [T, d]'s rows."""
    e_pad = p["router"].shape[1]
    k = cfg.top_k
    logits = xt.float() @ p["router"]
    if e_pad > cfg.n_experts:        # padded experts can never win routing
        logits[:, cfg.n_experts:] = -1e30
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k's order: the larger value first, the lower index first
    # among equal values (torch.topk promises no order for ties)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[:, :k], idx[:, :k]
    gates = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # position in its expert: an exclusive cumsum over the tokens of the
    # one-hot assignment (a token's K experts are distinct)
    assign = torch.zeros_like(logits, dtype=torch.int32).scatter_(1, idx, 1)
    pos = (torch.cumsum(assign, dim=0, dtype=torch.int32) - assign).gather(1, idx)
    keep = pos < cap
    slot = torch.where(keep, idx * cap + pos, e_pad * cap).reshape(-1)
    return Routing(gates, slot, logits, probs, assign, keep)


def dispatch(xt: torch.Tensor, slot: torch.Tensor, e_pad: int, cap: int,
             k: int) -> torch.Tensor:
    """Each row's K copies scattered into ``[E_pad * cap + 1, d]`` (every
    dropped copy into the last row, never read) -> the experts' inputs
    [E_pad, cap, d]; slots no assignment reached hold zeros."""
    buf = xt.new_zeros((e_pad * cap + 1, xt.shape[1]))
    buf.index_copy_(0, slot, xt.repeat_interleave(k, dim=0))
    return buf[:-1].view(e_pad, cap, xt.shape[1])


def experts(p, expert_in: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLU FFNs as batched products over the expert
    axis, in the activation dtype: [E_pad, cap, d] -> [E_pad, cap, d]."""
    dt = expert_in.dtype
    g = torch.bmm(expert_in, p["w_gate"].to(dt))
    u = torch.bmm(expert_in, p["w_up"].to(dt))
    return torch.bmm(ops.silu_mul(g, u), p["w_down"].to(dt))


def combine(expert_out: torch.Tensor, r: Routing, dtype) -> torch.Tensor:
    """Gather each assignment's expert output (a zero row for a dropped
    one) and sum them weighted by the gates in f32 -> [T, d] in ``dtype``."""
    t, k = r.gates.shape
    d = expert_out.shape[-1]
    flat = torch.cat([expert_out.reshape(-1, d), expert_out.new_zeros((1, d))])
    gathered = flat.index_select(0, r.slot).view(t, k, d)
    return torch.einsum("tk,tkd->td", r.gates, gathered.float()).to(dtype)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
              losses: bool = False, return_stats: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] -> (y [B, S, d], aux).

    ``aux`` is empty unless asked for.  ``losses`` gives the JAX
    function's aux: ``lb_loss`` (the Switch load-balance loss over the real
    experts), ``z_loss`` (the router's mean squared logsumexp) and
    ``frac_dropped``; ``return_stats`` gives the serving telemetry:
    ``frac_dropped`` and ``expert_load`` [E_pad], each expert's
    routed-token count in this dispatch (f32).  Both together give what
    JAX's ``return_stats`` does."""
    b, s, d = x.shape
    t = b * s
    e_pad = p["router"].shape[1]
    k = cfg.top_k
    cap = capacity(t, k, cfg.capacity_factor, e_pad)
    xt = x.reshape(t, d)
    r = route(p, xt, cfg, cap)
    y = combine(experts(p, dispatch(xt, r.slot, e_pad, cap, k)), r, x.dtype)
    if "shared" in p:
        y = y + layers.ffn(p["shared"], xt)
    aux = {}
    if losses or return_stats:
        aux["frac_dropped"] = 1.0 - r.keep.float().mean()
    if losses:
        ce = r.assign.float().mean(0) * cfg.n_experts / k
        aux["lb_loss"] = (r.probs.mean(0) * ce)[:cfg.n_experts].sum()
        aux["z_loss"] = (torch.logsumexp(r.logits, dim=-1) ** 2).mean()
    if return_stats:
        aux["expert_load"] = r.assign.sum(0).float()
    return y.reshape(b, s, d), aux
