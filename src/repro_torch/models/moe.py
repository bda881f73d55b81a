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
in place).

Expert parallelism (``moe_apply(expert_parallel=ep)``, the serving
engine's ``expert_parallel``) is the counterpart of the JAX package's
``_moe_apply_ep_local`` (:255-331), with one card's ``ep`` shards as views:
shard ``e`` sees ``w_gate`` / ``w_up`` / ``w_down[e * E_loc:(e + 1) *
E_loc]`` (``expert_shards``; no bank is copied), routes the full token set
against the full router, with ``cap`` from the global ``E_pad``, and keeps
only its own assignments (its drop slot is ``E_loc``).  The routing is one
``route`` for every shard: JAX's shards each compute the same replicated
routing, and an expert's positions come from its own column of the
cumsum.  Each shard's f32 combine is cast to the activation dtype, and the
shards' outputs are summed in shard order in that dtype, where JAX sums
them with one ``psum``; so bf16 rounds as JAX's sharded dispatch does, not
as the unsharded one.  The shared experts are added once, after the sum.
The JAX train path's ``_moe_apply_ep`` (FSDP gather, dp mean) has no
counterpart: training runs on one card.  ``expert_param_specs`` names the
expert-sharded leaves of a parameter tree, as JAX's does with its
partition specs.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

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
    (the one-hot of the chosen experts) and ``keep`` [T, K] bool; ``idx``
    and ``pos`` [T, K] (each assignment's expert and its position there)
    for an expert shard's own slots."""
    gates: torch.Tensor
    slot: torch.Tensor
    logits: torch.Tensor
    probs: torch.Tensor
    assign: torch.Tensor
    keep: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor


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
    return Routing(gates, slot, logits, probs, assign, keep, idx, pos)


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


def expert_shards(p, ep: int) -> List[dict]:
    """Shard ``e`` of ``ep``'s routed banks: ``w_gate`` / ``w_up`` /
    ``w_down[e * E_loc:(e + 1) * E_loc]``, views of ``p``'s (the banks a
    device of JAX's ``expert`` mesh axis would hold)."""
    e_loc = p["w_gate"].shape[0] // ep
    return [{w: p[w][e * e_loc:(e + 1) * e_loc]
             for w in ("w_gate", "w_up", "w_down")} for e in range(ep)]


def expert_param_specs(params) -> dict:
    """The expert-sharded leaves of a serving parameter tree: the same tree
    with 0 (the axis an expert shard slices) at every layer's routed banks
    (``moe`` -> ``w_gate`` / ``w_up`` / ``w_down``) and None at every other
    leaf (the router, the shared experts, the rest: replicated), as JAX's
    ``expert_param_specs`` gives ``P(None, axis)`` and ``P()`` (its layers
    are stacked on a leading axis, so its expert axis is 1)."""
    def spec(tree, path=()):
        if isinstance(tree, dict):
            return {k: spec(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [spec(v, path) for v in tree]
        sharded = (len(path) >= 2 and path[-2] == "moe"
                   and path[-1] in ("w_gate", "w_up", "w_down"))
        return 0 if sharded else None
    return spec(params)


def _moe_apply_ep_local(p, xt: torch.Tensor, r: Routing, cap: int, k: int,
                        ep: int, dtype) -> torch.Tensor:
    """The routed experts of ``xt`` [T, d] over ``ep`` expert shards, views
    of ``p``'s banks, under the replicated routing ``r`` -> [T, d] in
    ``dtype``: each shard keeps its own assignments (its drop slot is
    ``E_loc``), casts its f32 combine to ``dtype``, and the shards are
    summed in shard order (JAX's ``psum``)."""
    e_loc = p["w_gate"].shape[0] // ep
    y = None
    for e, bank in enumerate(expert_shards(p, ep)):
        loc = r.idx - e * e_loc
        mine = r.keep & (loc >= 0) & (loc < e_loc)
        slot = torch.where(mine, loc * cap + r.pos, e_loc * cap).reshape(-1)
        ye = combine(experts(bank, dispatch(xt, slot, e_loc, cap, k)),
                     r._replace(slot=slot), dtype)
        y = ye if y is None else y + ye
    return y


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
              losses: bool = False, return_stats: bool = False,
              expert_parallel: Optional[int] = None,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] -> (y [B, S, d], aux).

    ``aux`` is empty unless asked for.  ``losses`` gives the JAX
    function's aux: ``lb_loss`` (the Switch load-balance loss over the real
    experts), ``z_loss`` (the router's mean squared logsumexp) and
    ``frac_dropped``; ``return_stats`` gives the serving telemetry:
    ``frac_dropped`` and ``expert_load`` [E_pad], each expert's
    routed-token count in this dispatch (f32).  Both together give what
    JAX's ``return_stats`` does.  ``expert_parallel``: the routed experts
    over that many expert shards (``_moe_apply_ep_local``), under the same
    routing, so the aux values are the unsharded dispatch's."""
    b, s, d = x.shape
    t = b * s
    e_pad = p["router"].shape[1]
    k = cfg.top_k
    cap = capacity(t, k, cfg.capacity_factor, e_pad)
    xt = x.reshape(t, d)
    r = route(p, xt, cfg, cap)
    if expert_parallel is None:
        y = combine(experts(p, dispatch(xt, r.slot, e_pad, cap, k)), r, x.dtype)
    else:
        y = _moe_apply_ep_local(p, xt, r, cap, k, expert_parallel, x.dtype)
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
