"""Building blocks of the dense family: linear, RMSNorm, RoPE attention
(full-sequence for training; for serving over a paged KV cache or a dense
KV slab), SwiGLU FFN.

Port of the JAX package's ``models/layers.py`` (dense subset).  Parameters
are plain nested dicts of tensors with the JAX layouts (``linear`` weights
``[d_in, d_out]``, applied as ``x @ w``); kernel dispatch goes through
``repro_torch.kernels.ops``.  Cache writes are in place: a layer's new K/V
rows (and, on an int8 pool, its page scales) are written straight into the
pool or slab tensor, where the JAX version (``.at[].set``,
``dynamic_update_slice``) returns an updated copy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import noc
from repro_torch.kernels import ops, ref


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm(x, p["scale"], eps=eps)


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    """Row lookup; its gradient (a sorted segment sum on the card) is
    deterministic, unlike an atomic scatter-add."""
    return torch.nn.functional.embedding(tokens.long(), p["table"])


# ---------------------------------------------------------------------------
# paged KV cache: pages [L, KvH, NB, BS, hd] shared by all slots through
# per-slot block tables.  Physical page 0 is the null sink: padding rows and
# retired slots write there, so a block-table entry of 0 is always safe.
#
# int8 pool (``kv_dtype="int8"``): pages hold int8 values and one f32 scale
# per (layer, kv head, page), ``k_scales`` / ``v_scales`` [L, KvH, NB]; a
# row's float value is ``int8 * scale``.  The scatters below keep a page's
# scale consistent with all its live rows, and the paged kernels dequantize
# page by page.
# ---------------------------------------------------------------------------

# Floor for per-page scales: an all-zero page quantizes against this
# instead of dividing by zero.
KV_SCALE_EPS = 1e-8
# amax / 127 as the reference computes it: XLA turns the division by the
# constant into a product with its f32 reciprocal, and a one-ulp difference
# in a scale can flip an int8 rounding at a tie
_INV127 = float(np.float32(1.0 / 127.0))


def paged_kv_cache_init(cfg: ModelConfig, num_blocks: int, block_size: int,
                        dtype=torch.bfloat16, n_slots: int = 1,
                        device="cuda", kv_dtype: str = "fp16"):
    """Zero pages ``[n_slots, KvH, NB, BS, hd]`` in ``dtype`` (``kv_dtype``
    "fp16": the engine dtype), or int8 pages and unit scales ``[n_slots,
    KvH, NB]`` f32 (``kv_dtype`` "int8")."""
    shape = (n_slots, cfg.n_kv_heads, num_blocks, block_size, cfg.hd)
    if kv_dtype == "int8":
        sshape = shape[:3]
        return {"k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scales": torch.ones(sshape, dtype=torch.float32, device=device),
                "v_scales": torch.ones(sshape, dtype=torch.float32, device=device)}
    if kv_dtype != "fp16":
        raise ValueError(f"kv_dtype must be 'fp16' or 'int8', got {kv_dtype!r}")
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


# (page [N], offset [N], writer [N] or None): row i's target, and the row
# whose values land there (None: every row writes its own)
ScatterIndex = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


# ---------------------------------------------------------------------------
# sequence-sharded pool: shard s owns global pages [s*nbl, (s+1)*nbl) of the
# one pool on the card, nbl = NB / S, and its local page 0 (global s*nbl) is
# its null page.  Its view of a layer's pages is the slice of the NB axis that
# the JAX package's device s holds (P(None, None, "seq") on [L, KvH, NB, ..]).
# Attention runs per shard over its view with its shard-local table (foreign
# pages -> local 0, skipped), and the (acc, m, l) partials merge through
# core.noc.tree_softmax_combine.  The K/V scatters stay one per layer by
# global page id: the owned pages (and an int8 pool's scales) come out as
# the owning shard writes them in JAX; only the null pages of shards 1..S-1
# differ (JAX writes foreign rows there), and no read ever sees them.
# ---------------------------------------------------------------------------

def pool_shards(t: Optional[torch.Tensor], n_shards: int) -> list:
    """The ``n_shards`` views ``t[:, s*nbl:(s+1)*nbl]`` of one layer's pages
    [KvH, NB, BS, hd] or scales [KvH, NB] (no copy); None (a float pool's
    scales) gives None for every shard."""
    if t is None:
        return [None] * n_shards
    nbl = t.shape[1] // n_shards
    return [t[:, s * nbl:(s + 1) * nbl] for s in range(n_shards)]


def _sharded_attention(partial, q, kp, vp, ks, vs, local_tables, *,
                       unseen_zero: bool = False, **kw):
    """``partial``'s skip_null partials over each shard's view of one
    layer's pool with its local table (``local_tables`` [S, ...]), merged by
    the NoC tree combine -> the normalized output, f32.

    ``unseen_zero``: a row that sees no key in any shard reads 0.  That is
    the decode's idle row (token 0, length 0, a table of zeros: every entry
    foreign to every shard).  Each shard's partial then has m = -1e30; the
    card's kernel gives the zero-weight partial (0, -1e30, 0) of
    ``docs/kernels.md`` (the Pallas kernel's too, so o = 0), while the plain
    version gives every gathered null-page row weight 1 (the JAX oracle's
    form, o = their mean).  The row's output is set to the former on both
    devices, so it never reads the null pages' bytes."""
    n = local_tables.shape[0]
    parts = [partial(q, kps, vps, lt, skip_null=True, k_scales=kss,
                     v_scales=vss, **kw)
             for kps, vps, kss, vss, lt in zip(
                 pool_shards(kp, n), pool_shards(vp, n), pool_shards(ks, n),
                 pool_shards(vs, n), local_tables)]
    o = noc.tree_softmax_combine(parts)
    if unseen_zero:
        seen = torch.stack([m for _, m, _ in parts]).amax(dim=0) > 0.5 * ref.NEG_INF
        o = torch.where(seen[..., None], o, 0.0)
    return o


# The K/V scatters resolve duplicate targets (every one in the null page) to
# the last writer in index order, the order of the CPU's index_put and of
# XLA's scatter, so the card's unordered writes leave the CPU's null page,
# the same from run to run.  A decode step's duplicates are idle, stalled or
# mid-prefill slots aimed at row 0 of the null page: the index moves every
# one but the last to a row of the null page that nothing reads (rows 1, 2,
# ... in order), so the targets are distinct and no layer pays for it.  A
# prefill chunk's duplicates are its padding rows past one page of padding:
# there each target takes its last writer's row.

def _last_writer(keys: torch.Tensor) -> torch.Tensor:
    """For each entry of ``keys`` [N], the index of the last entry with the
    same key (an N x N comparison: N is a decode batch)."""
    rows = torch.arange(keys.shape[0], device=keys.device)
    same = keys[:, None] == keys[None, :]
    return torch.where(same, rows[None, :], -1).amax(dim=1)


def decode_scatter_index(lengths: torch.Tensor, block_tables: torch.Tensor,
                         block_size: int) -> ScatterIndex:
    """Page and row of position ``lengths`` per sequence (retired slots
    carry an all-zero table row, so they land in the null page), every
    target but its last writer's moved to a free row of the null page
    (computed once per dispatch)."""
    lens = lengths.long()
    rows = torch.arange(lens.shape[0], device=lens.device)
    phys = block_tables.long()[rows, lens // block_size]
    off = lens % block_size
    if block_size == 1:                    # no free row: each takes its writer
        return phys, off, _last_writer(phys)
    later = _last_writer(phys * block_size + off) != rows
    rank = torch.cumsum(later.long(), 0) - 1
    return (torch.where(later, 0, phys),
            torch.where(later, 1 + rank % (block_size - 1), off), None)


def prefill_scatter_index(block_table: torch.Tensor, q_offset: int, length: int,
                          c: int, block_size: int) -> ScatterIndex:
    """Page and row of each chunk position; invalid (padding) rows -> page 0,
    at row ``(q_offset + t) % BS``.  Past one page of padding a target is
    shared: it takes its last writer's row, the last padding row ``t + k BS``
    below ``c`` (valid rows own their targets)."""
    t = torch.arange(c, device=block_table.device)
    pos = q_offset + t
    lb = torch.clamp(pos // block_size, 0, block_table.shape[0] - 1)
    pad = t >= length
    phys = torch.where(pad, 0, block_table.long()[lb])
    if c - length <= block_size:
        return phys, pos % block_size, None
    last = t + (c - 1 - t) // block_size * block_size
    return phys, pos % block_size, torch.where(pad, last, t)


def _scatter(pages: torch.Tensor, idx: ScatterIndex, rows: torch.Tensor) -> None:
    """pages [KvH, NB, BS, hd] (one layer's view of the pool, written in
    place); rows [N, KvH, hd], each target taking its writer's row."""
    phys, off, win = idx
    if win is not None:
        rows = rows.index_select(0, win)
    pages[:, phys, off] = rows.transpose(0, 1).to(pages.dtype)


def _decode_scatter_quant(pages: torch.Tensor, scales: torch.Tensor,
                          idx: ScatterIndex, row: torch.Tensor) -> None:
    """Scatter one decode row per sequence into one layer's int8 pages, in
    place: pages [KvH, NB, BS, hd] int8, scales [KvH, NB] f32; ``idx`` the
    target (page [B], row offset [B], and any more entries of a
    :data:`ScatterIndex`); row [B, KvH, hd] float.

    The page scale is monotone within a page's life: a page starting a new
    occupancy (offset 0) drops the previous occupant's scale, then each
    appended row can only grow it (``max(old, amax(row) / 127)``, floored at
    ``KV_SCALE_EPS``).  On growth the page's earlier rows are requantized at
    the new scale (ratio <= 1, so no clipping); rows past the offset are
    stale and zeroed.  The write is of whole pages, so rows that share a
    page (retired slots -> the null page 0) take the page and scale of its
    last writer.  The JAX package's ``layers._decode_scatter_quant``,
    rounding points included."""
    phys, off = idx[0], idx[1]
    win = _last_writer(phys)
    bs = pages.shape[2]
    rowT = row.float().transpose(0, 1)                       # [KvH, B, hd]
    # the divisions by arrays below stay true divisions, as in the reference
    old_q = pages[:, phys].float()                           # [KvH, B, BS, hd]
    old_s = scales[:, phys]                                  # [KvH, B]
    base_s = torch.where(off[None, :] == 0, 0.0, old_s)
    new_s = torch.maximum(base_s, rowT.abs().amax(dim=-1) * _INV127)
    new_s = new_s.clamp_min(KV_SCALE_EPS)
    ridx = torch.arange(bs, device=pages.device)
    keep = ridx[None, None, :] < off[None, :, None]          # [1, B, BS]
    req = torch.round(old_q * (base_s / new_s)[..., None, None])
    req = torch.where(keep[..., None], req, 0.0)
    newq = torch.round(rowT / new_s[..., None])
    sel = ridx[None, None, :] == off[None, :, None]
    page = torch.where(sel[..., None], newq[:, :, None, :], req)
    page = torch.clamp(page, -127.0, 127.0).to(torch.int8)
    pages[:, phys] = page.index_select(1, win)
    scales[:, phys] = new_s.index_select(1, win)


def _prefill_scatter_quant(pages: torch.Tensor, scales: torch.Tensor,
                           block_table: torch.Tensor, q_offset: int,
                           length: int, chunk_rows: torch.Tensor) -> None:
    """Scatter a prefill chunk's rows into one layer's int8 pages, in place.

    chunk_rows [C, KvH, hd] float at global positions [q_offset, q_offset +
    C), the first ``length`` valid.  Works on the window of ``ceil(C / BS) +
    1`` logical blocks the chunk can touch, read from the table zero-padded
    past its end (so a window at the end reads null entries instead of
    shifting): gather and dequantize the window, write the chunk's valid
    rows into it, zero the stale rows past the live end so that they cannot
    inflate a page's amax, and requantize each window page at its own fresh
    scale.  The JAX package's ``layers._prefill_scatter_quant``, rounding
    points included.  Window pages repeated in ``tbl`` are null entries past
    the chunk's rows: all zero, at one floor scale, so duplicates carry
    equal bytes."""
    kvh, _, bs, hd = pages.shape
    c = chunk_rows.shape[0]
    npg = -(-c // bs) + 1
    first_lb = q_offset // bs
    mb = block_table.shape[0]
    btp = torch.cat([block_table.long(),
                     torch.zeros((npg,), dtype=torch.long,
                                 device=block_table.device)])
    start = min(first_lb, mb)              # lax.dynamic_slice clamps its start
    tbl = btp[start:start + npg]
    win = pages[:, tbl].float() * scales[:, tbl][..., None, None]
    win = win.reshape(kvh, npg * bs, hd)                     # [KvH, npg*BS, hd]
    lo = q_offset - first_lb * bs
    win[:, lo:lo + length] = chunk_rows[:length].float().transpose(0, 1)
    win[:, lo + length:] = 0.0                               # past the live end
    win = win.reshape(kvh, npg, bs, hd)
    new_s = (win.abs().amax(dim=(2, 3)) * _INV127).clamp_min(KV_SCALE_EPS)
    q8 = torch.round(win / new_s[..., None, None])     # a true division
    pages[:, tbl] = torch.clamp(q8, -127.0, 127.0).to(torch.int8)
    scales[:, tbl] = new_s


def _qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(p["wq"], x).reshape(b, s, h, hd)
    k = linear(p["wk"], x).reshape(b, s, kvh, hd)
    v = linear(p["wv"], x).reshape(b, s, kvh, hd)
    q, k = ops.apply_rope_qk(q, k, positions, theta=cfg.rope_theta)
    return q, k, v


def attention(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
              *, lengths=None, window=None) -> torch.Tensor:
    """Full-sequence causal attention (training).  x [B,S,d] -> [B,S,d];
    positions [B,S] int32."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    o = ops.flash_attention(q, k, v, causal=True, lengths=lengths,
                            window=window)
    return linear(p["wo"], o.reshape(b, s, cfg.n_heads * cfg.hd))


# ---------------------------------------------------------------------------
# dense KV slab: [B, Smax, KvH, hd] per attention application, row s of
# sequence b holding position s (the dense-slab serving baseline)
# ---------------------------------------------------------------------------

def attn_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                    dtype=torch.bfloat16, n_slots: Optional[int] = None,
                    device="cuda"):
    """KV slab ``[B, Smax, KvH, hd]``, with a leading ``[n_slots]`` (one per
    layer) when ``n_slots`` is given."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    if n_slots is not None:
        shape = (n_slots,) + shape
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(p, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig, cache, *, lengths=None, window=None):
    """Prefill: full causal attention over the sequence, and its K/V written
    into slab rows ``[0, S)`` in place (padding rows too, as the JAX
    version's ``dynamic_update_slice`` writes them).  x [B,S,d]; cache
    {"k", "v"} [B, Smax, KvH, hd]; lengths [B] int32 bounds the keys.
    Returns (y [B,S,d], cache)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    o = ops.flash_attention(q, k, v, causal=True, lengths=lengths,
                            window=window)
    return linear(p["wo"], o.reshape(b, s, cfg.n_heads * cfg.hd)), cache


def attention_decode(p, x: torch.Tensor, cfg: ModelConfig, cache,
                     lengths: torch.Tensor, *, window=None):
    """One-token decode against a slab.  x [B,1,d]; cache {"k", "v"}
    [B, Smax, KvH, hd]; lengths [B] int32 = tokens already cached (each
    below Smax).  The new K/V row is written at position ``lengths`` in
    place, then attention spans ``[0, lengths]``; ``window`` is accepted and
    unused, as in the JAX version.  Returns (y [B,1,d], cache)."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg, lengths[:, None])
    rows = torch.arange(b, device=x.device)
    pos = lengths.long()
    cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)
    o = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                             lengths=lengths + 1)
    return linear(p["wo"], o.reshape(b, 1, cfg.n_heads * cfg.hd)), cache


def attention_decode_stacked(p, x: torch.Tensor, cfg: ModelConfig,
                             ck_all: torch.Tensor, cv_all: torch.Tensor,
                             layer_idx: int, lengths: torch.Tensor, *,
                             window=None):
    """:func:`attention_decode` against layer ``layer_idx`` of the stacked
    slabs ck_all / cv_all [L, B, Smax, KvH, hd]: only the new K/V row is
    written (into the layer's view, so into the stack).  Returns
    (y [B,1,d], ck_all, cv_all)."""
    y, _ = attention_decode(p, x, cfg, {"k": ck_all[layer_idx],
                                        "v": cv_all[layer_idx]}, lengths,
                            window=window)
    return y, ck_all, cv_all


def attention_decode_paged(p, x: torch.Tensor, cfg: ModelConfig,
                           kp: torch.Tensor, vp: torch.Tensor,
                           lengths: torch.Tensor, block_tables: torch.Tensor,
                           scatter_idx: ScatterIndex,
                           ks: Optional[torch.Tensor] = None,
                           vs: Optional[torch.Tensor] = None,
                           local_tables: Optional[torch.Tensor] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """One-token decode against one layer's pages.

    x [B,1,d]; kp/vp [KvH, NB, BS, hd] (this layer's pool view); lengths [B]
    int32 = tokens already cached; block_tables [B, MB] int32;
    ``scatter_idx`` from :func:`decode_scatter_index`.  The new K/V row is
    written into its page first, then attention spans ``[0, lengths]``.
    ``ks`` / ``vs`` [KvH, NB] f32 (the layer's scale views) mark an int8
    pool: the row goes in through :func:`_decode_scatter_quant` and the
    kernel dequantizes page by page.  ``local_tables`` [S, B, MB] int32
    marks a sequence-sharded pool: each shard's skip_null partials over its
    view of the pool (:func:`pool_shards`) and its local table, merged by
    the NoC tree combine, as the JAX package's ``seq_axis`` path does; a
    row that sees no key in any shard (an idle row) reads 0.  ``window`` is
    accepted and unused: the JAX package's paged decode never reads it
    (``src/repro/models/layers.py:324-378``), so a windowed model decodes
    over its whole prefix there, and here."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg, lengths[:, None])
    if ks is None:
        _scatter(kp, scatter_idx, k[:, 0])
        _scatter(vp, scatter_idx, v[:, 0])
    else:
        _decode_scatter_quant(kp, ks, scatter_idx, k[:, 0])
        _decode_scatter_quant(vp, vs, scatter_idx, v[:, 0])
    if local_tables is None:
        o = ops.paged_decode_attention(q[:, 0], kp, vp, block_tables,
                                       lengths=lengths + 1, k_scales=ks,
                                       v_scales=vs)
    else:
        o = _sharded_attention(ops.paged_decode_attention_partial, q[:, 0], kp,
                               vp, ks, vs, local_tables, unseen_zero=True,
                               lengths=lengths + 1).to(x.dtype)
    return linear(p["wo"], o.reshape(b, 1, cfg.n_heads * cfg.hd))


def attention_prefill_paged(p, x: torch.Tensor, positions: torch.Tensor,
                            cfg: ModelConfig, kp: torch.Tensor, vp: torch.Tensor,
                            block_table: torch.Tensor, q_offset: int, length: int,
                            scatter_idx: Optional[ScatterIndex],
                            ks: Optional[torch.Tensor] = None,
                            vs: Optional[torch.Tensor] = None,
                            local_tables: Optional[torch.Tensor] = None,
                            window: Optional[int] = None) -> torch.Tensor:
    """Chunked prefill of one sequence against one layer's pages.

    x [1,C,d] is the chunk at global positions [q_offset, q_offset+C);
    ``length`` counts its valid rows.  The chunk's K/V are scattered into
    their pages *before* attention (padding rows to the null page 0), then
    attention runs over the pages of ``block_table`` (a prefix slice of the
    slot's table that covers ``q_offset + length``).  ``ks`` / ``vs`` [KvH,
    NB] f32 mark an int8 pool: the chunk goes in through
    :func:`_prefill_scatter_quant` (``scatter_idx`` None) and the kernel
    dequantizes page by page.  ``local_tables`` [S, MB] int32 (the
    shard-local slices of ``block_table``) marks a sequence-sharded pool:
    skip_null partials per shard, causal on global positions, merged by the
    NoC tree combine.  ``window`` keeps only the keys ``kpos > qpos -
    window`` (the paged prefill kernel's window on the card); over a
    sequence-sharded pool it raises, as in the JAX package."""
    if window is not None and local_tables is not None:
        raise NotImplementedError(
            "windowed attention over a sequence-sharded page pool")
    _, c, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    if ks is None:
        _scatter(kp, scatter_idx, k[0])
        _scatter(vp, scatter_idx, v[0])
    else:
        _prefill_scatter_quant(kp, ks, block_table, q_offset, length, k[0])
        _prefill_scatter_quant(vp, vs, block_table, q_offset, length, v[0])
    if local_tables is None:
        o = ops.paged_prefill_attention(q, kp, vp, block_table,
                                        q_offset=q_offset, length=length,
                                        window=window, k_scales=ks,
                                        v_scales=vs)
    else:
        o = _sharded_attention(ops.paged_prefill_attention_partial, q, kp, vp,
                               ks, vs, local_tables, q_offset=q_offset,
                               length=length).to(x.dtype)
    return linear(p["wo"], o.reshape(1, c, cfg.n_heads * cfg.hd))


def ffn(p, x: torch.Tensor) -> torch.Tensor:
    g = linear(p["gate"], x)
    u = linear(p["up"], x)
    return linear(p["down"], ops.silu_mul(g, u))
