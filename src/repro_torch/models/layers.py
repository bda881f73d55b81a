"""Building blocks of the dense family: linear, RMSNorm, RoPE attention
(full-sequence for training; for serving over a paged KV cache or a dense
KV slab), SwiGLU FFN.

Port of the JAX package's ``models/layers.py`` (dense subset).  Parameters
are plain nested dicts of tensors with the JAX layouts (``linear`` weights
``[d_in, d_out]``, applied as ``x @ w``); kernel dispatch goes through
``repro_torch.kernels.ops``.  Cache writes are in place: a layer's new K/V
rows are written straight into the pool or slab tensor, where the JAX
version (``.at[].set``, ``dynamic_update_slice``) returns an updated copy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


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
# ---------------------------------------------------------------------------

def paged_kv_cache_init(cfg: ModelConfig, num_blocks: int, block_size: int,
                        dtype=torch.bfloat16, n_slots: int = 1,
                        device="cuda"):
    shape = (n_slots, cfg.n_kv_heads, num_blocks, block_size, cfg.hd)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


ScatterIndex = Tuple[torch.Tensor, torch.Tensor]   # (page [N], offset [N])


def decode_scatter_index(lengths: torch.Tensor, block_tables: torch.Tensor,
                         block_size: int) -> ScatterIndex:
    """Page and row of position ``lengths`` per sequence (retired slots
    carry an all-zero table row, so they land in the null page)."""
    lens = lengths.long()
    rows = torch.arange(lens.shape[0], device=lens.device)
    return block_tables.long()[rows, lens // block_size], lens % block_size


def prefill_scatter_index(block_table: torch.Tensor, q_offset: int, length: int,
                          c: int, block_size: int) -> ScatterIndex:
    """Page and row of each chunk position; invalid (padding) rows -> page 0."""
    t = torch.arange(c, device=block_table.device)
    pos = q_offset + t
    lb = torch.clamp(pos // block_size, 0, block_table.shape[0] - 1)
    phys = torch.where(t < length, block_table.long()[lb], 0)
    return phys, pos % block_size


def _scatter(pages: torch.Tensor, idx: ScatterIndex, rows: torch.Tensor) -> None:
    """pages [KvH, NB, BS, hd] (one layer's view of the pool, written in
    place); rows [N, KvH, hd].  Duplicate targets only ever hit page 0."""
    phys, off = idx
    pages[:, phys, off] = rows.transpose(0, 1).to(pages.dtype)


def _qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(p["wq"], x).reshape(b, s, h, hd)
    k = linear(p["wk"], x).reshape(b, s, kvh, hd)
    v = linear(p["wv"], x).reshape(b, s, kvh, hd)
    q = ops.apply_rope(q, positions, theta=cfg.rope_theta)
    k = ops.apply_rope(k, positions, theta=cfg.rope_theta)
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
                           scatter_idx: ScatterIndex) -> torch.Tensor:
    """One-token decode against one layer's pages.

    x [B,1,d]; kp/vp [KvH, NB, BS, hd] (this layer's pool view); lengths [B]
    int32 = tokens already cached; block_tables [B, MB] int32;
    ``scatter_idx`` from :func:`decode_scatter_index`.  The new K/V row is
    written into its page first, then attention spans ``[0, lengths]``."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg, lengths[:, None])
    _scatter(kp, scatter_idx, k[:, 0])
    _scatter(vp, scatter_idx, v[:, 0])
    o = ops.paged_decode_attention(q[:, 0], kp, vp, block_tables,
                                   lengths=lengths + 1)
    return linear(p["wo"], o.reshape(b, 1, cfg.n_heads * cfg.hd))


def attention_prefill_paged(p, x: torch.Tensor, positions: torch.Tensor,
                            cfg: ModelConfig, kp: torch.Tensor, vp: torch.Tensor,
                            block_table: torch.Tensor, q_offset: int, length: int,
                            scatter_idx: ScatterIndex) -> torch.Tensor:
    """Chunked prefill of one sequence against one layer's pages.

    x [1,C,d] is the chunk at global positions [q_offset, q_offset+C);
    ``length`` counts its valid rows.  The chunk's K/V are scattered into
    their pages *before* attention (padding rows to the null page 0), then
    attention runs over the pages of ``block_table`` (a prefix slice of the
    slot's table that covers ``q_offset + length``)."""
    _, c, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    _scatter(kp, scatter_idx, k[0])
    _scatter(vp, scatter_idx, v[0])
    o = ops.paged_prefill_attention(q, kp, vp, block_table, q_offset=q_offset,
                                    length=length)
    return linear(p["wo"], o.reshape(1, c, cfg.n_heads * cfg.hd))


def ffn(p, x: torch.Tensor) -> torch.Tensor:
    g = linear(p["gate"], x)
    u = linear(p["up"], x)
    return linear(p["down"], ops.silu_mul(g, u))
