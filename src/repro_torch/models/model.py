"""Decoder LM: full-sequence forward (training) and serving for every
family: the dense and MoE families over a paged KV cache or a dense KV
slab, RWKV6 and Mamba2 over a fixed-size recurrent state per sequence (the
serve state's slot rows, or the dense-slab baseline's batch rows), and the
hybrid over both (its shared attention block's KV in pages or slabs, its
Mamba2 layers' state in slots).

Port of the JAX package's ``models/model.py``: the stacked-layer
``lax.scan`` becomes a Python loop over a list of per-layer parameter
dicts, ``jax.checkpoint`` becomes ``torch.utils.checkpoint``, and the pages
and slabs are updated in place.  An MoE layer is a dense one whose FFN is
``moe`` (``models/moe.py``: top-k routed experts with GShard capacity,
optionally shared experts) in place of ``ffn``; its serving cache is the
dense family's.  The hybrid family runs groups of
``attn_every`` Mamba2 layers, each group followed by one attention + FFN
block whose weights all groups share, then an ungrouped tail; its
parameters are ``groups`` (a list of groups, each a list of layer dicts),
``tail`` (a list of layer dicts) and ``shared``.  RWKV6's recurrent state
is ``tm_shift`` [L, B, 1, d] and ``cm_shift`` [L, B, 1, d] in the model
dtype and ``wkv`` [L, B, H, D, D] f32, the batch (or engine slot) on axis
1 as in JAX; prefill and decode advance it in place.  Mamba2's is
``conv`` [L, B, W - 1, C] in the model dtype and ``ssm`` [L, B, H, P, N]
f32; the hybrid's is ``conv_g`` / ``ssm_g`` [G, K, B, ...] for its groups
and ``conv_t`` / ``ssm_t`` [max(tail, 1), B, ...] for its tail, beside
``attn``, the pages [G, KvH, NB, BS, hd] (or slabs [G, B, Smax, KvH, hd])
of the shared block's G applications; the JAX layouts, so
``models/convert.py:state_from_jax`` is a plain map.  The MoE forward
returns the load-balance and z losses summed over the layers, as JAX's
does; the paged serving functions return the per-layer expert load on
request (``expert_stats``, the serving engine's expert telemetry) and run
each MoE layer over expert shards on request (``expert_parallel``).

Public API:
    init_params(cfg, seed, device, dtype)          -> params
    forward(cfg, params, tokens, ...)              -> (logits [B, S, V], aux [2])
    init_decode_state(cfg, batch, max_seq, dtype, device)   (KV slabs / recurrent state)
    prefill(cfg, params, state, tokens=..., lengths=...) -> (logits [B, 1, V], state)
    decode_step(cfg, params, state, tokens, lengths) -> (logits [B, V], state)
    init_serve_state(cfg, slots, num_blocks, block_size, dtype, device, kv_dtype)
                                                   (pages / slot state)
    prefill_paged(cfg, params, state, ...)         -> (logits [1, V], state)
    decode_step_paged(cfg, params, state, ...)     -> (logits [B, V], state)
                          (expert_stats=True: the expert telemetry third)
    serve_prefill_chunk / serve_decode_step        (the runner's entry points)
    copy_kv_page(state, src, dst)                  (prefix-cache copy-on-write)
    extract_kv_pages / insert_kv_pages             (the device halves of a page swap)
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, moe, rwkv, ssm

RWKV_STATE = ("tm_shift", "wkv", "cm_shift")   # RWKV6's recurrent state keys
MAMBA_STATE = ("conv", "ssm")                  # Mamba2's (family "ssm")
HYBRID_STATE = ("conv_g", "ssm_g", "conv_t", "ssm_t")   # the hybrid's slot state


def require_trainable(cfg: ModelConfig) -> None:
    """The full-sequence forward (training): dense, MoE, RWKV6, Mamba2 and
    hybrid, every family the port serves."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"training family {cfg.family!r} ({cfg.name}) is not ported: "
            f"repro_torch trains family='dense', 'moe', 'ssm' (RWKV6, "
            f"Mamba2) and 'hybrid'")


def require_servable(cfg: ModelConfig) -> None:
    """Serving, and with it parameters (every family that trains also
    serves): the dense and MoE families (paged or over a dense slab), the
    ``ssm`` family (RWKV6 and Mamba2, over their recurrent state) and the
    hybrid (paged or slab attention KV beside its Mamba2 state)."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported: repro_torch "
            f"serves family='dense', 'moe', 'ssm' and 'hybrid'")


# ---------------------------------------------------------------------------
# init (same distributions as the JAX package; the draws differ — the CPU
# tests carry JAX's parameters over through models/convert.py)
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype=torch.bfloat16):
    """Random parameters from ``seed``, made on ``device``: embeddings and
    linear weights N(0, 1) * d_in^-0.5, zero biases, unit norm scales (the
    RWKV6, Mamba2 and MoE layers as ``models/rwkv.py:rwkv_init``,
    ``models/ssm.py:mamba_init`` and ``models/moe.py:moe_init`` make them;
    an MoE router is f32 whatever ``dtype``).  On ``device="meta"`` it
    allocates nothing and draws nothing: the shapes and dtypes a sharding
    plan reads (``core/mapping.py``)."""
    require_servable(cfg)
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))

    def normal(shape, scale, dt=dtype):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * scale).to(dt)

    def lin(d_in, d_out, bias=False):
        p = {"w": normal((d_in, d_out), d_in ** -0.5)}
        if bias:
            p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
        return p

    def norm():
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}

    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    params = {"embed": {"table": normal((cfg.vocab_size, d), d ** -0.5)},
              "final_norm": norm()}
    if not cfg.tie_embeddings:
        params["lm_head"] = lin(d, cfg.vocab_size)

    def attn_block(routed: bool = False):
        p = {
            "ln1": norm(),
            "attn": {"wq": lin(d, h * hd, cfg.qkv_bias),
                     "wk": lin(d, kvh * hd, cfg.qkv_bias),
                     "wv": lin(d, kvh * hd, cfg.qkv_bias),
                     "wo": lin(h * hd, d)},
            "ln2": norm(),
        }
        if routed:
            p["moe"] = moe.moe_init(cfg, gen, dtype, device)
        else:
            p["ffn"] = {"gate": lin(d, cfg.d_ff), "up": lin(d, cfg.d_ff),
                        "down": lin(cfg.d_ff, d)}
        return p

    def layer():
        if cfg.family in ("dense", "moe"):
            return attn_block(routed=cfg.family == "moe")
        if cfg.rwkv:
            return {"ln1": norm(), "ln2": norm(),
                    **rwkv.rwkv_init(cfg, normal, dtype, device)}
        return {"ln1": norm(),
                "mamba": ssm.mamba_init(cfg, normal, dtype, device)}

    if cfg.family == "hybrid":
        g, k, tail = hybrid_layout(cfg)
        params["groups"] = [[layer() for _ in range(k)] for _ in range(g)]
        params["tail"] = [layer() for _ in range(tail)]
        params["shared"] = attn_block()
    else:
        params["layers"] = [layer() for _ in range(cfg.n_layers)]
    return params


def hybrid_layout(cfg: ModelConfig):
    """(n_groups, group_size, n_tail) for the hybrid family."""
    k = cfg.attn_every
    g = cfg.n_layers // k
    return g, k, cfg.n_layers - g * k


def _rwkv_state(cfg: ModelConfig, batch: int, dtype, device):
    return dict(zip(RWKV_STATE, rwkv.rwkv_state_init(cfg, batch, cfg.n_layers,
                                                     dtype, device)))


def _mamba_state(cfg: ModelConfig, batch: int, dtype, device):
    """Mamba2's zero slot state of ``batch`` sequences in the JAX layouts:
    ``conv`` / ``ssm`` [L, B, ...] (family "ssm"), or the hybrid's
    ``conv_g`` / ``ssm_g`` [G, K, B, ...] and ``conv_t`` / ``ssm_t``
    [max(tail, 1), B, ...]."""
    if cfg.family == "ssm":
        return dict(zip(MAMBA_STATE, ssm.mamba_state_init(
            cfg, batch, cfg.n_layers, dtype, device)))
    g, k, tail = hybrid_layout(cfg)
    conv_g, ssm_g = ssm.mamba_state_init(cfg, batch, g * k, dtype, device)
    conv_t, ssm_t = ssm.mamba_state_init(cfg, batch, max(tail, 1), dtype,
                                         device)
    return {"conv_g": conv_g.reshape(g, k, *conv_g.shape[1:]),
            "ssm_g": ssm_g.reshape(g, k, *ssm_g.shape[1:]),
            "conv_t": conv_t, "ssm_t": ssm_t}


def _paged_family(cfg: ModelConfig) -> bool:
    """A family whose every layer attends (dense, MoE): its serving cache is
    KV pages or slabs alone, no slot state."""
    return cfg.family in ("dense", "moe")


def _attn_apps(cfg: ModelConfig) -> int:
    """Attention applications per token: L layers, or the hybrid's G."""
    return hybrid_layout(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cuda"):
    """The dense-slab serving baseline's state: KV slabs ``[L, B, Smax, KvH,
    hd]`` (dense), the zero recurrent state of B sequences (RWKV6, Mamba2;
    ``max_seq`` unused), or the hybrid's Mamba2 state beside slabs ``[G, B,
    Smax, KvH, hd]``."""
    require_servable(cfg)
    if cfg.rwkv:
        return _rwkv_state(cfg, batch, dtype, device)
    state = {} if _paged_family(cfg) else _mamba_state(cfg, batch, dtype,
                                                        device)
    if cfg.family != "ssm":
        state["attn"] = layers.attn_cache_init(cfg, batch, max_seq, dtype,
                                               n_slots=_attn_apps(cfg),
                                               device=device)
    return state


def init_serve_state(cfg: ModelConfig, slots: int, num_blocks: int,
                     block_size: int, dtype=torch.bfloat16, device="cuda",
                     kv_dtype: str = "fp16"):
    """The runner path's serving state.  Dense: paged KV pages ``[L, KvH,
    NB, BS, hd]`` shared by all slots; ``kv_dtype="int8"`` stores int8 pages
    plus per-(layer, kv head, page) ``k_scales`` / ``v_scales`` [L, KvH, NB]
    f32.  RWKV6 and Mamba2: the recurrent slot state of ``slots`` sequences
    only (``num_blocks``, ``block_size`` and ``kv_dtype`` unused).  Hybrid:
    the Mamba2 slot state beside pages ``[G, KvH, NB, BS, hd]`` for the
    shared block's G applications (one block table per sequence serves
    them all, as one serves the L layers of the dense family)."""
    require_servable(cfg)
    if cfg.rwkv:
        return _rwkv_state(cfg, slots, dtype, device)
    state = {} if _paged_family(cfg) else _mamba_state(cfg, slots, dtype,
                                                        device)
    if cfg.family != "ssm":
        state["attn"] = layers.paged_kv_cache_init(
            cfg, num_blocks, block_size, dtype, n_slots=_attn_apps(cfg),
            device=device, kv_dtype=kv_dtype)
    return state


def _layer_scales(state, li: int):
    """Layer ``li``'s (k_scales, v_scales) views of an int8 pool, or (None,
    None) for a float pool."""
    att = state["attn"]
    if "k_scales" not in att:
        return None, None
    return att["k_scales"][li], att["v_scales"][li]


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].to(x.dtype).t()
    return layers.linear(params["lm_head"], x)


def _block(cfg, lp, x, attn, **moe_kw):
    """Pre-norm residual block -> (x, aux); ``attn`` maps the normed input
    to the attention output.  The FFN is the layer's ``moe`` (every row of
    ``x`` routed in one dispatch; ``aux`` is ``moe_apply``'s, holding what
    ``moe_kw`` asks for: ``losses``, ``return_stats``) or its ``ffn``
    (``aux`` empty)."""
    x = x + attn(layers.rmsnorm(lp["ln1"], x, cfg.norm_eps))
    h = layers.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if "moe" in lp:
        y, aux = moe.moe_apply(lp["moe"], h, cfg, **moe_kw)
        return x + y, aux
    return x + layers.ffn(lp["ffn"], h), {}


def _expert_stats(auxs):
    """The paged serving functions' telemetry from each MoE layer's aux:
    ``expert_load`` [L, E_pad] and ``frac_dropped``, the layers' mean (the
    JAX package's ``expert_stats`` value)."""
    return {"expert_load": torch.stack([a["expert_load"] for a in auxs]),
            "frac_dropped": torch.stack([a["frac_dropped"] for a in auxs]).mean()}


def _rwkv_block(cfg, lp, x):
    """Pre-norm residual RWKV6 block: time mix, then channel mix."""
    x = x + rwkv.time_mix(lp["tm"], layers.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                          cfg)
    return x + rwkv.channel_mix(lp["cm"], layers.rmsnorm(lp["ln2"], x,
                                                          cfg.norm_eps))


def _rwkv_block_state(cfg, lp, x, views, length, carry: bool):
    """Pre-norm residual RWKV6 block over a right-padded chunk with
    ``length`` valid rows (a [B] tensor), advancing the recurrent state
    ``views`` (this layer's tm shift, wkv and cm shift rows) in place: from
    the state they hold (``carry``, a serving chunk) or from zero (the
    slab prefill, which starts every sequence afresh, as in JAX)."""
    tms, wkv, cms = views if carry else (None, None, None)
    y, (tms1, wkv1) = rwkv.time_mix(
        lp["tm"], layers.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
        shift_state=tms, wkv_state=wkv, length=length, return_state=True)
    x = x + y
    y2, cms1 = rwkv.channel_mix(lp["cm"], layers.rmsnorm(lp["ln2"], x,
                                                          cfg.norm_eps),
                                shift_state=cms, length=length,
                                return_state=True)
    for dst, src in zip(views, (tms1, wkv1, cms1)):
        dst.copy_(src)
    return x + y2


def _put_rows(dst: torch.Tensor, src: torch.Tensor, rows) -> None:
    """Write ``src`` into ``dst`` in place: every batch row (``rows`` None),
    or only the batch rows ``rows`` (an int64 tensor on dst's device)."""
    if rows is None:
        dst.copy_(src)
    else:
        dst.index_copy_(0, rows, src.index_select(0, rows))


def _mamba_block(cfg, lp, x):
    """Pre-norm residual Mamba2 block."""
    return x + ssm.mamba_apply(lp["mamba"],
                               layers.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg)


def _mamba_block_state(cfg, lp, x, conv, h, length, carry: bool):
    """Pre-norm residual Mamba2 block over a right-padded chunk with
    ``length`` valid rows, advancing one layer's state views ``conv`` and
    ``h`` in place: from the state they hold (``carry``, a serving chunk:
    the scan kernel from a carried state) or from zero (the slab prefill:
    the zero-state kernel)."""
    y, (tail, hf) = ssm.mamba_apply(
        lp["mamba"], layers.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
        conv_state=conv if carry else None, ssm_state=h if carry else None,
        length=length, return_state=True)
    conv.copy_(tail)
    h.copy_(hf)
    return x + y


def _mamba_block_step(cfg, lp, x, conv, h, rows):
    """Pre-norm residual Mamba2 block over one token, its state views
    written back in place at the batch rows ``rows`` (all when None)."""
    y, (conv1, h1) = ssm.mamba_decode_step(
        lp["mamba"], layers.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg, (conv, h))
    _put_rows(conv, conv1, rows)
    _put_rows(h, h1, rows)
    return x + y


def _mamba_stack(cfg, params, state, x, sl, layer, attend=None):
    """``x`` through every Mamba2 layer in order, ``layer(lp, x, conv, h)``
    given the layer's state views at the batch rows ``sl`` (a slice), and,
    for the hybrid, through the shared attention + FFN block after each
    group: ``attend(gi)`` maps the normed input to application ``gi``'s
    attention output (its pages or its slab)."""
    if cfg.family == "ssm":
        for li, lp in enumerate(params["layers"]):
            x = layer(lp, x, state["conv"][li, sl], state["ssm"][li, sl])
        return x
    sp = params["shared"]
    for gi, gp in enumerate(params["groups"]):
        for ki, lp in enumerate(gp):
            x = layer(lp, x, state["conv_g"][gi, ki, sl],
                      state["ssm_g"][gi, ki, sl])
        x = _block(cfg, sp, x, attend(gi))[0]
    for ti, lp in enumerate(params["tail"]):
        x = layer(lp, x, state["conv_t"][ti, sl], state["ssm_t"][ti, sl])
    return x


def forward(cfg: ModelConfig, params, tokens: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            lengths: Optional[torch.Tensor] = None, train: bool = False,
            attn_window: Optional[int] = None, remat: bool = True):
    """Full-sequence forward -> (logits [B, S, V], aux [2]).

    tokens [B, S] (or ``embeds`` [B, S, d]); positions [B, S] int32
    (default 0..S-1).  With ``train`` and ``remat`` each layer runs under
    ``torch.utils.checkpoint``: only its input is kept, and the backward
    recomputes its forward (kernels included; an MoE layer's routing too,
    which deterministic kernels repeat exactly).  The hybrid family nests
    the remat as the JAX package does: a checkpoint per layer inside a
    checkpoint per group (the group's backward recomputes its layers'
    forwards, and each layer's backward recomputes its own forward once
    more), and one per layer in the tail.  ``aux`` holds the MoE
    (load-balance, z) losses summed over the layers (each layer's
    ``moe_apply`` over its B x S rows, as JAX's ``forward``), zeros for the
    other families."""
    require_trainable(cfg)
    x = embeds if embeds is not None else layers.embed(params["embed"], tokens)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    remat = train and remat

    def attend(p):
        return lambda h: layers.attention(p["attn"], h, positions, cfg,
                                          lengths=lengths, window=attn_window)

    def body(xc, lp):
        """One layer -> (x, its aux [2], or None for a layer without)."""
        if cfg.family in ("dense", "moe"):
            xc, a = _block(cfg, lp, xc, attend(lp), losses=True)
            return xc, (torch.stack([a["lb_loss"], a["z_loss"]]) if a else None)
        if cfg.rwkv:
            return _rwkv_block(cfg, lp, xc), None
        return _mamba_block(cfg, lp, xc), None

    def run(fn, xc, p):
        if remat:
            return checkpoint(fn, xc, p, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(xc, p)

    auxs = []

    def scan(xc, layer_params):
        for lp in layer_params:
            xc, a = run(body, xc, lp)
            if a is not None:
                auxs.append(a)
        return xc

    if cfg.family == "hybrid":
        sp = params["shared"]

        def group_body(xc, gp):
            return _block(cfg, sp, scan(xc, gp), attend(sp))[0]

        for gp in params["groups"]:
            x = run(group_body, x, gp)
        x = scan(x, params["tail"])
    else:
        x = scan(x, params["layers"])
    aux = (torch.stack(auxs).sum(0) if auxs else
           torch.zeros((2,), dtype=torch.float32, device=x.device))
    return _logits(cfg, params, x), aux


def prefill(cfg: ModelConfig, params, state, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            lengths: Optional[torch.Tensor] = None,
            attn_window: Optional[int] = None):
    """Prefill of B right-padded sequences from position 0 into the slabs.

    tokens [B, S] (or ``embeds`` [B, S, d]); lengths [B] int32 valid rows
    (default S).  Every layer writes its K/V into slab rows ``[0, S)`` of
    ``state`` in place and attends with the per-sequence key bound.
    Returns (logits at each sequence's last valid row [B, 1, V], state).
    RWKV6 and Mamba2 run each sequence from a zero state (the state passed
    in is only written: its rows end holding the state after each
    sequence's ``lengths`` valid rows), the scans on the zero-state
    kernels; the hybrid's shared block writes application ``gi``'s slab
    and attends with the key bound, as the dense family's layers do."""
    require_servable(cfg)
    x = embeds if embeds is not None else layers.embed(params["embed"], tokens)
    b, s, _ = x.shape
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    if cfg.rwkv:
        for li, lp in enumerate(params["layers"]):
            x = _rwkv_block_state(cfg, lp, x,
                                  tuple(state[k][li] for k in RWKV_STATE),
                                  lengths, carry=False)
        return _logits(cfg, params, _last_token(x, lengths)), state
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    if cfg.family != "ssm":
        ck_all, cv_all = state["attn"]["k"], state["attn"]["v"]

    def attend(p, i):
        return lambda h: layers.attention_prefill(
            p, h, positions, cfg, {"k": ck_all[i], "v": cv_all[i]},
            lengths=lengths, window=attn_window)[0]

    if _paged_family(cfg):
        for li, lp in enumerate(params["layers"]):
            x = _block(cfg, lp, x, attend(lp["attn"], li))[0]
    else:
        x = _mamba_stack(
            cfg, params, state, x, slice(None),
            lambda lp, xc, conv, h: _mamba_block_state(cfg, lp, xc, conv, h,
                                                       lengths, carry=False),
            lambda gi: attend(params["shared"]["attn"], gi))
    return _logits(cfg, params, _last_token(x, lengths)), state


def _last_token(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Row ``lengths - 1`` of each sequence (clamped into range): [B, 1, d]."""
    b, s = x.shape[:2]
    idx = torch.clamp(lengths.long() - 1, 0, s - 1)
    return x[torch.arange(b, device=x.device), idx][:, None, :]


def decode_step(cfg: ModelConfig, params, state, tokens: torch.Tensor,
                lengths: torch.Tensor, *, embeds: Optional[torch.Tensor] = None,
                attn_window: Optional[int] = None, rows=None):
    """Batched one-token decode over the slabs (or RWKV6's state).

    tokens [B] (or ``embeds`` [B, d]); lengths [B] int32 = cache fill level.
    Each layer writes the new K/V row at position ``lengths`` into its slab
    in place (the stacked cache carried through the layer loop, so no slab
    is copied) and attends over ``[0, lengths]``.  RWKV6 and Mamba2 step
    every row's recurrent state (``ops.rwkv6_step``, ``ops.mamba2_step``)
    and write it back in place: every row, or with ``rows`` (an int64
    tensor of batch rows) those rows only, the others kept bit for bit (the
    runner's slot mask); the hybrid's shared block attends over application
    ``gi``'s slab.  Returns (logits [B, V], state)."""
    require_servable(cfg)
    if embeds is not None:
        x = embeds[:, None, :]
    else:
        x = layers.embed(params["embed"], tokens[:, None])
    if cfg.rwkv:
        for li, lp in enumerate(params["layers"]):
            views = tuple(state[k][li] for k in RWKV_STATE)
            y, (tms1, wkv1) = rwkv.time_mix_step(
                lp["tm"], layers.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                views[:2])
            x = x + y
            y2, cms1 = rwkv.channel_mix_step(
                lp["cm"], layers.rmsnorm(lp["ln2"], x, cfg.norm_eps), views[2])
            x = x + y2
            for dst, src in zip(views, (tms1, wkv1, cms1)):
                _put_rows(dst, src, rows)
        return _logits(cfg, params, x)[:, 0], state
    if cfg.family != "ssm":
        ck_all, cv_all = state["attn"]["k"], state["attn"]["v"]

    def attend(p, i):
        return lambda h: layers.attention_decode_stacked(
            p, h, cfg, ck_all, cv_all, i, lengths, window=attn_window)[0]

    if _paged_family(cfg):
        for li, lp in enumerate(params["layers"]):
            x = _block(cfg, lp, x, attend(lp["attn"], li))[0]
    else:
        x = _mamba_stack(
            cfg, params, state, x, slice(None),
            lambda lp, xc, conv, h: _mamba_block_step(cfg, lp, xc, conv, h,
                                                      rows),
            lambda gi: attend(params["shared"]["attn"], gi))
    return _logits(cfg, params, x)[:, 0], state


def _require_stats(cfg: ModelConfig, expert_stats: bool,
                   expert_parallel: Optional[int] = None) -> None:
    if (expert_stats or expert_parallel is not None) and cfg.family != "moe":
        raise ValueError(f"expert_stats / expert_parallel need a moe family, "
                         f"got {cfg.family!r}")


def _paged_layers(cfg, params, x, attend, expert_stats: bool,
                  expert_parallel: Optional[int] = None):
    """``x`` through the dense or MoE layers over the pool -> (x, the
    expert telemetry or None); ``expert_parallel``: each MoE layer over
    that many expert shards (``moe._moe_apply_ep_local``)."""
    auxs = []
    for li, lp in enumerate(params["layers"]):
        x, a = _block(cfg, lp, x, attend(lp["attn"], li),
                      return_stats=expert_stats,
                      expert_parallel=expert_parallel)
        auxs.append(a)
    return x, (_expert_stats(auxs) if expert_stats else None)


def prefill_paged(cfg: ModelConfig, params, state, *, tokens: torch.Tensor,
                  length: int, q_offset: int, block_table: torch.Tensor,
                  attn_window: Optional[int] = None,
                  local_tables: Optional[torch.Tensor] = None,
                  expert_stats: bool = False,
                  expert_parallel: Optional[int] = None):
    """One chunk of a single-sequence prefill into the paged KV cache.

    tokens [1, C] (right-padded chunk); ``length`` valid rows; ``q_offset``
    tokens already cached; block_table [MB] int32, possibly a prefix slice
    of the slot's table as long as it covers ``q_offset + length``.  Chunks
    attend to the already-paged prefix plus themselves, so repeated calls
    with growing ``q_offset`` reproduce a monolithic prefill.  Returns
    (logits at the chunk's last valid row [1, V], state); the pages in
    ``state`` (and an int8 pool's scales) are updated in place.
    ``local_tables`` [S, MB] int32, the shard-local forms of
    ``block_table``, marks a sequence-sharded pool (the scatter stays on
    global page ids; attention runs per shard, ``layers.pool_shards``).
    ``expert_stats`` (MoE): return a third value, ``{"expert_load" [L,
    E_pad], "frac_dropped"}``, the per-layer routed-token counts of this
    chunk (the serving telemetry), as the JAX package does.
    ``expert_parallel`` (MoE): every MoE layer over that many expert
    shards; with ``local_tables`` too, attention runs per sequence shard
    and the MoE layer per expert shard (every expert shard of JAX's
    ``(seq, expert)`` mesh holds its sequence shard's whole KV).
    ``attn_window``: each query sees only the keys ``kpos > qpos -
    attn_window`` (raises with ``local_tables``, as in the JAX package)."""
    require_servable(cfg)
    _require_stats(cfg, expert_stats, expert_parallel)
    x = layers.embed(params["embed"], tokens)
    attend = _paged_prefill_attend(cfg, state, x.shape[1], length, q_offset,
                                   block_table, local_tables, attn_window)
    x, est = _paged_layers(cfg, params, x, attend, expert_stats,
                           expert_parallel)
    logits = _logits(cfg, params, x[:, length - 1:length])
    if expert_stats:
        return logits[:, 0], state, est
    return logits[:, 0], state


def _paged_prefill_attend(cfg, state, c: int, length: int, q_offset: int,
                          block_table, local_tables, window=None):
    """``attend(p, i)``: the chunk's attention through application ``i``'s
    pages (and an int8 pool's scales, or the shards' views), its K/V
    scattered there first."""
    kp_all, vp_all = state["attn"]["k_pages"], state["attn"]["v_pages"]
    positions = (q_offset + torch.arange(c, dtype=torch.int32,
                                         device=kp_all.device))[None]
    idx = (None if "k_scales" in state["attn"] else      # int8: a window
           layers.prefill_scatter_index(block_table, q_offset, length, c,
                                        kp_all.shape[3]))

    def attend(p, i):
        ks, vs = _layer_scales(state, i)
        return lambda h: layers.attention_prefill_paged(
            p, h, positions, cfg, kp_all[i], vp_all[i], block_table,
            q_offset, length, idx, ks, vs, local_tables, window)
    return attend


def decode_step_paged(cfg: ModelConfig, params, state, tokens: torch.Tensor,
                      lengths: torch.Tensor, block_tables: torch.Tensor,
                      local_tables: Optional[torch.Tensor] = None,
                      expert_stats: bool = False,
                      expert_parallel: Optional[int] = None,
                      attn_window: Optional[int] = None):
    """Batched one-token decode over the paged KV cache.

    tokens [B]; lengths [B] int32 = cache fill level; block_tables [B, MB]
    int32.  The K/V row for position ``lengths`` is scattered into its page
    and the paged decode kernel reads through the block table.  Returns
    (logits [B, V], state); pages (and an int8 pool's scales) are updated
    in place.  ``local_tables`` [S, B, MB] int32 marks a sequence-sharded
    pool, and ``expert_stats`` asks for the expert telemetry of the step's
    B rows and ``expert_parallel`` for the expert shards, as in
    :func:`prefill_paged`.  ``attn_window`` is accepted and unused, as in
    the JAX package, whose paged decode never reads it."""
    require_servable(cfg)
    _require_stats(cfg, expert_stats, expert_parallel)
    x = layers.embed(params["embed"], tokens[:, None])
    attend = _paged_decode_attend(cfg, state, lengths, block_tables,
                                  local_tables, attn_window)
    x, est = _paged_layers(cfg, params, x, attend, expert_stats,
                           expert_parallel)
    if expert_stats:
        return _logits(cfg, params, x)[:, 0], state, est
    return _logits(cfg, params, x)[:, 0], state


def _paged_decode_attend(cfg, state, lengths, block_tables, local_tables,
                         window=None):
    """``attend(p, i)``: one decode row per sequence through application
    ``i``'s pages, the new K/V row scattered there first."""
    kp_all, vp_all = state["attn"]["k_pages"], state["attn"]["v_pages"]
    idx = layers.decode_scatter_index(lengths, block_tables, kp_all.shape[3])

    def attend(p, i):
        ks, vs = _layer_scales(state, i)
        return lambda h: layers.attention_decode_paged(
            p, h, cfg, kp_all[i], vp_all[i], lengths, block_tables, idx, ks,
            vs, local_tables, window)
    return attend


def copy_kv_page(state, src: int, dst: int):
    """Physical-page copy across all layers and heads, in place
    (copy-on-write for a prefix-cache match that ends mid-page); an int8
    pool's per-page scales copy along with the pages.  The ids are global,
    so on a sequence-sharded pool a copy across shards is one copy in the
    one pool."""
    for t in state["attn"].values():      # pages [L, KvH, NB, ...], scales
        t[:, :, dst] = t[:, :, src]
    return state


def extract_kv_pages(state, pages: torch.Tensor):
    """Gather physical KV pages by global id: the device half of a page
    swap-out (the JAX package's ``extract_kv_pages``).  ``pages`` [P] int;
    returns ``(k, v, k_scales, v_scales)``, pages ``[A, KvH, P, BS, hd]``
    and scales ``[A, KvH, P]`` (None for a float pool), new tensors on the
    pool's device.  The engine pads ``pages`` to a power of two with the
    null page and makes one call per shard of a sequence-sharded pool."""
    att = state["attn"]
    idx = pages.to(att["k_pages"].device).long()
    ks = vs = None
    if "k_scales" in att:
        ks = att["k_scales"].index_select(2, idx)
        vs = att["v_scales"].index_select(2, idx)
    return (att["k_pages"].index_select(2, idx),
            att["v_pages"].index_select(2, idx), ks, vs)


def insert_kv_pages(state, pages: torch.Tensor, k, v, k_scales=None,
                    v_scales=None):
    """Scatter swapped-out pages back into the pool in place: the device half
    of a swap-in (the JAX package's ``insert_kv_pages``).  ``pages`` [P]
    global destination ids; ``k`` / ``v`` ``[A, KvH, P, BS, hd]`` as
    :func:`extract_kv_pages` gives them, ``k_scales`` / ``v_scales`` ``[A,
    KvH, P]`` an int8 pool's scales.  The engine pads ``pages`` with the
    null page 0 and the data with zero pages and scales, as the JAX
    engine does: every duplicate target then receives the same bytes, so
    the order of the writes never matters.  Slot state passes through."""
    att = state["attn"]
    idx = pages.to(att["k_pages"].device).long()
    att["k_pages"].index_copy_(2, idx, k.to(att["k_pages"].dtype))
    att["v_pages"].index_copy_(2, idx, v.to(att["v_pages"].dtype))
    if "k_scales" in att:
        att["k_scales"].index_copy_(2, idx, k_scales.to(att["k_scales"].dtype))
        att["v_scales"].index_copy_(2, idx, v_scales.to(att["v_scales"].dtype))
    return state


# ---------------------------------------------------------------------------
# serving entry points (what models/runner.py's ModelRunner calls)
# ---------------------------------------------------------------------------

def serve_prefill_chunk(cfg: ModelConfig, params, state, *, tokens, length,
                        q_offset, block_table, slot: int = 0,
                        local_tables=None, expert_stats: bool = False,
                        expert_parallel: Optional[int] = None,
                        attn_window: Optional[int] = None):
    """One chunk of a single-sequence prefill against the serve state.

    tokens [1, C] (right-padded); ``length`` valid rows.  Dense and MoE:
    K/V land in the pages of ``block_table`` (``local_tables``: a
    sequence-sharded pool's).  RWKV6 and Mamba2: the chunk runs from engine
    slot ``slot``'s recurrent state and advances its rows in place (padding
    rows are state-neutral, so repeated chunks reproduce one unpadded
    prefill; ``q_offset`` and the tables are unused); the scans are the
    kernels with a carried state.  Hybrid: both, the shared block's application ``gi``
    through its pages at ``q_offset``.  Returns (logits at the chunk's last
    valid row [1, V], state), and with ``expert_stats`` (MoE only) the
    chunk's expert telemetry third; ``expert_parallel`` (MoE only): the
    expert shards of :func:`prefill_paged`; ``attn_window``: the window of
    every paged attention (the dense and MoE layers', the hybrid's shared
    block's)."""
    if _paged_family(cfg):
        return prefill_paged(cfg, params, state, tokens=tokens, length=length,
                             q_offset=q_offset, block_table=block_table,
                             attn_window=attn_window,
                             local_tables=local_tables,
                             expert_stats=expert_stats,
                             expert_parallel=expert_parallel)
    _require_stats(cfg, expert_stats, expert_parallel)
    x = layers.embed(params["embed"], tokens)
    lens = torch.full((1,), length, dtype=torch.int32, device=x.device)
    sl = slice(slot, slot + 1)
    if cfg.rwkv:
        for li, lp in enumerate(params["layers"]):
            x = _rwkv_block_state(
                cfg, lp, x, tuple(state[k][li][sl] for k in RWKV_STATE),
                lens, carry=True)
    else:
        attend = None
        if cfg.family == "hybrid":
            paged = _paged_prefill_attend(cfg, state, x.shape[1], length,
                                          q_offset, block_table, local_tables,
                                          attn_window)
            attend = lambda gi: paged(params["shared"]["attn"], gi)  # noqa: E731
        x = _mamba_stack(
            cfg, params, state, x, sl,
            lambda lp, xc, conv, h: _mamba_block_state(cfg, lp, xc, conv, h,
                                                       lens, carry=True),
            attend)
    logits = _logits(cfg, params, x[:, length - 1:length])
    return logits[:, 0], state


def serve_decode_step(cfg: ModelConfig, params, state, tokens, lengths,
                      block_tables=None, local_tables=None, rows=None,
                      expert_stats: bool = False,
                      expert_parallel: Optional[int] = None,
                      attn_window: Optional[int] = None):
    """Batched one-token decode against the serve state: the paged pool
    (``local_tables``: a sequence-sharded pool's; ``expert_stats``, MoE
    only: the step's expert telemetry returned third; ``expert_parallel``,
    MoE only: its expert shards), or the slot state
    (RWKV6, Mamba2), of which only the batch rows ``rows`` are written when
    given, or both (the hybrid: its shared block through the pool at
    application ``gi``, its Mamba2 state gated by ``rows``).
    ``attn_window`` is accepted and unused by every decode, as in the JAX
    package."""
    if _paged_family(cfg):
        return decode_step_paged(cfg, params, state, tokens, lengths,
                                 block_tables, local_tables,
                                 expert_stats=expert_stats,
                                 expert_parallel=expert_parallel,
                                 attn_window=attn_window)
    _require_stats(cfg, expert_stats, expert_parallel)
    if cfg.family == "ssm":
        return decode_step(cfg, params, state, tokens, lengths, rows=rows,
                           attn_window=attn_window)
    x = layers.embed(params["embed"], tokens[:, None])
    attend = _paged_decode_attend(cfg, state, lengths, block_tables,
                                  local_tables, attn_window)
    x = _mamba_stack(
        cfg, params, state, x, slice(None),
        lambda lp, xc, conv, h: _mamba_block_step(cfg, lp, xc, conv, h, rows),
        lambda gi: attend(params["shared"]["attn"], gi))
    return _logits(cfg, params, x)[:, 0], state
