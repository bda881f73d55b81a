"""Plain PyTorch versions of the kernels on the dense serving and training
paths, forward and backward, and of the kernel API's fidelity entries (the
weight-stationary matmul and the Curry-ALU forms of rmsnorm and silu_mul).

A line-for-line port of the oracles in the JAX package's ``kernels/ref.py``
(rounding points included): they are the CPU execution path (see
``kernels/ops.py``) and the yardstick each hand-written CUDA kernel is held
against on the card.  Layouts follow the JAX package:

attention:  q [B, Sq, H, D];  k, v [B, Sk, KvH, D];  GQA via H % KvH == 0.
paged KV:   pages [KvH, NB, BS, D];  block tables [B, MB] (or [MB]) int32.
RoPE uses the *interleaved* (neighbour-pair) convention.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import curry

NEG_INF = -1e30

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# normalization / elementwise
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            curry_rounds: int = 0) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * w in f32, one rounding to x's dtype.
    With ``curry_rounds > 0`` the rsqrt is the Curry ALU's: Newton steps
    from a bf16-rounded seed (``core.curry.curry_rsqrt``), as the TPU
    kernel's ``_kernel`` computes it."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = (curry.curry_rsqrt(var + eps, curry_rounds) if curry_rounds
           else torch.rsqrt(var + eps))
    return (xf * inv * w.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def silu_mul(gate: torch.Tensor, up: torch.Tensor,
             curry_rounds: int = 0) -> torch.Tensor:
    """silu(gate) * up.  With ``curry_rounds = 0``, silu is computed in f32
    and rounded to ``up``'s dtype before the multiply: the JAX oracle's
    rounding point, which the training and serving kernels follow.  With
    ``curry_rounds > 0`` the sigmoid's exp is the Curry ALU's Taylor
    iteration (``core.curry.curry_exp``) and ``g * sigma(g) * u`` stays in
    f32 with one rounding to ``up``'s dtype: the TPU kernel's rounding point
    (``kernels/swiglu.py:31-40``), since no JAX oracle has a curry form."""
    if curry_rounds:
        g = gate.float()
        e = curry.curry_exp(-torch.abs(g), curry_rounds)
        sig = torch.where(g >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
        return (g * sig * up.float()).to(up.dtype)
    return silu(gate.float()).to(up.dtype) * up


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients (dx, dw) of :func:`rmsnorm`, in f32 from the forward's
    f32 statistics: with x^ = x rstd and g = w dy,
    dx = rstd (g - x^ mean(g x^)) and dw = sum over rows of dy x^."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    g = dy.float() * w.float()
    c = torch.mean(g * xhat, dim=-1, keepdim=True)
    dx = rstd * (g - xhat * c)
    dw = (dy.float() * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


def silu_mul_bwd(gate: torch.Tensor, up: torch.Tensor,
                 dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients (dgate, dup) of :func:`silu_mul`, at its rounding point:
    dup = dy * round(silu(gate)) and dgate = round(dy * up) *
    sigma(g) (1 + g (1 - sigma(g))) in f32, rounded to ``gate``'s dtype."""
    gf = gate.float()
    sig = torch.sigmoid(gf)
    act = (gf * sig).to(up.dtype)
    dup = dy * act
    dact = (dy * up).float()
    dgate = dact * (sig * (1.0 + gf * (1.0 - sig)))
    return dgate.to(gate.dtype), dup


# ---------------------------------------------------------------------------
# RoPE (interleaved / neighbour-pair convention)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> cos/sin [..., head_dim//2] in fp32."""
    half = head_dim // 2
    j = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (j / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x [B, S, H, D], positions [B, S] (or [S]) -> rotated x; the pairs
    (x0, x1), (x2, x3), ... each turn by the same angle."""
    b, s, h, d = x.shape
    if positions.dim() == 1:
        positions = positions[None, :].expand(b, s)
    cos, sin = rope_cos_sin(positions, d, theta)           # [B, S, D/2]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    xf = x.float().reshape(b, s, h, d // 2, 2)
    x_even, x_odd = xf[..., 0], xf[..., 1]
    r_even = x_even * cos - x_odd * sin
    r_odd = x_even * sin + x_odd * cos
    out = torch.stack([r_even, r_odd], dim=-1).reshape(b, s, h, d)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, KvH, D] -> [B, S, H, D] by repeating each KV head."""
    group = n_heads // k.shape[2]
    return torch.repeat_interleave(k, group, dim=2) if group > 1 else k


def _flash_stats(q, k, v, *, causal: bool, q_offset: int,
                 lengths: Optional[torch.Tensor], window: Optional[int],
                 block_k: int):
    """Online-softmax attention over KV blocks of ``block_k`` rows, keeping
    the running (m, l, acc) statistics of the JAX oracle.  Returns the f32
    (acc, m, l) as [B, Sq, KvH, G, D] / [B, Sq, KvH, G]."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    block_k = min(block_k, sk)
    nblk = -(-sk // block_k)
    pad = nblk * block_k - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    qf = q.float().reshape(b, sq, kvh, group, d)
    scale = 1.0 / math.sqrt(d)
    qpos = (torch.arange(sq, device=dev) + q_offset)[:, None]

    m = torch.full((b, sq, kvh, group), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, kvh, group), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, kvh, group, d), dtype=torch.float32, device=dev)
    for iblk in range(nblk):
        kf = k[:, iblk * block_k:(iblk + 1) * block_k].float()
        vf = v[:, iblk * block_k:(iblk + 1) * block_k].float()
        s = torch.einsum("bqgnd,bkgd->bqgnk", qf, kf) * scale
        kpos = iblk * block_k + torch.arange(block_k, device=dev)
        mask = _attn_mask(qpos, kpos, causal, window, sk if pad else None)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        if lengths is not None:
            lm = kpos[None, :] < lengths[:, None]          # [B, block_k]
            s = torch.where(lm[:, None, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqgnk,bkgd->bqgnd", p, vf)
        m = m_new
    return acc, m, l


def _attn_mask(qpos, kpos, causal: bool, window: Optional[int],
               sk: Optional[int]) -> torch.Tensor:
    """[Sq, Sk_blk] bool: causal ``kpos <= qpos``, sliding window ``kpos >
    qpos - window`` (the JAX oracle's mask), and ``kpos < sk`` for padding."""
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=kpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos
    if window is not None:
        mask &= kpos[None, :] > qpos - window
    if sk is not None:
        mask &= (kpos < sk)[None, :]
    return mask


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    lengths: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    block_k: int = 512) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Sk, KvH, D] -> [B, Sq, H, D]; optional
    causal mask, sliding ``window``, per-sequence KV ``lengths``."""
    b, sq, h, d = q.shape
    acc, _, l = _flash_stats(q, k, v, causal=causal, q_offset=q_offset,
                             lengths=lengths, window=window, block_k=block_k)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, block_k: int = 512):
    """:func:`flash_attention` plus the per-row log-sum-exp ``lse = m +
    log(l)`` [B, H, Sq] in f32 (``l`` floored at 1e-30), which the backward
    reads to recompute the probabilities."""
    b, sq, h, d = q.shape
    acc, m, l = _flash_stats(q, k, v, causal=causal, q_offset=0, lengths=None,
                             window=window, block_k=block_k)
    lf = torch.clamp(l, min=1e-30)
    out = (acc / lf[..., None]).reshape(b, sq, h, d).to(q.dtype)
    lse = (m + torch.log(lf)).reshape(b, sq, h).permute(0, 2, 1).contiguous()
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None, block_k: int = 512):
    """Gradients (dq, dk, dv) of :func:`flash_attention` by the explicit
    flash-attention backward, block by block over the keys:

        D  = rowsum(do * o)               p  = exp(s - lse)  (0 where masked)
        dv = sum_q p do                   dp = do . v
        ds = p (dp - D)                   dq = scale sum_k ds k
                                          dk = scale sum_q ds q

    with s = scale (q . k), everything in f32, and the outputs rounded to
    the inputs' dtype.  GQA sums dk and dv over the query heads of a KV
    head.  ``lse`` [B, H, Sq] is what :func:`flash_attention_lse` returns."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    block_k = min(block_k, sk)
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, kvh, group, d)
    dof = do.float().reshape(b, sq, kvh, group, d)
    delta = (dof * o.float().reshape(b, sq, kvh, group, d)).sum(-1)
    lse_r = lse.permute(0, 2, 1).reshape(b, sq, kvh, group)
    qpos = torch.arange(sq, device=dev)[:, None]
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, sk, kvh, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, sk, kvh, d), dtype=torch.float32, device=dev)
    for k0 in range(0, sk, block_k):
        kf = k[:, k0:k0 + block_k].float()
        vf = v[:, k0:k0 + block_k].float()
        kpos = k0 + torch.arange(kf.shape[1], device=dev)
        s = torch.einsum("bqgnd,bkgd->bqgnk", qf, kf) * scale
        mask = _attn_mask(qpos, kpos, causal, window, None)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        p = torch.exp(s - lse_r[..., None])
        dv[:, k0:k0 + block_k] = torch.einsum("bqgnk,bqgnd->bkgd", p, dof)
        dp = torch.einsum("bqgnd,bkgd->bqgnk", dof, vf)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bqgnk,bkgd->bqgnd", ds, kf)
        dk[:, k0:k0 + block_k] = torch.einsum("bqgnk,bqgnd->bkgd", ds, qf)
    return ((dq * scale).reshape(b, sq, h, d).to(q.dtype),
            (dk * scale).to(k.dtype), dv.to(v.dtype))


def decode_attention_partial(q, k, v, *, lengths: Optional[torch.Tensor] = None,
                             kv_offset: int = 0,
                             kv_valid: Optional[torch.Tensor] = None) -> Partials:
    """Single-token attention partials: q [B, H, D]; k, v [B, Sk, KvH, D]
    -> (acc [B, H, D] f32, m [B, H], l [B, H]).  q is cast to the cache's
    dtype and p is rounded to it before the PV product, with f32 sums — the
    JAX oracle's ``preferred_element_type=f32`` path.  ``kv_valid`` [B, Sk]
    bool masks keys besides ``lengths``.  A row with no valid key comes out
    ``(sum of v, -1e30, Sk)``, as the JAX oracle's does (masked keys count
    at p = 1 there); beside any row that sees a key it weighs nothing."""
    b, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    qc = q.to(k.dtype).reshape(b, kvh, group, d)
    s = torch.einsum("bgnd,bkgd->bgnk", qc.float(), k.float()) / math.sqrt(d)
    kpos = kv_offset + torch.arange(sk, device=q.device)
    if lengths is not None:
        valid = kpos[None, :] < lengths[:, None]
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bgnk,bkgd->bgnd", p.to(k.dtype).float(), v.float())
    return acc.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h)


def decode_attention(q, k, v, *, lengths: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Single-token attention over a dense KV slab, normalized: q [B, H, D];
    k, v [B, Sk, KvH, D] -> [B, H, D] in q's dtype (``l`` floored at
    1e-30)."""
    acc, m, l = decode_attention_partial(q, k, v, lengths=lengths)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def combine_partials(parts: Partials, other: Partials) -> Partials:
    """Merge two (acc, m, l) attention partials."""
    acc_a, m_a, l_a = parts
    acc_b, m_b, l_b = other
    m = torch.maximum(m_a, m_b)
    ca = torch.exp(m_a - m)
    cb = torch.exp(m_b - m)
    return (acc_a * ca[..., None] + acc_b * cb[..., None], m, l_a * ca + l_b * cb)


# ---------------------------------------------------------------------------
# paged attention (block/paged KV cache)
# ---------------------------------------------------------------------------

def gather_pages(pages: torch.Tensor, block_table: torch.Tensor,
                 scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pages [KvH, NB, BS, D]; block_table [B, MB] (or [MB]) physical page
    ids -> linear KV [B, MB*BS, KvH, D] (or [MB*BS, KvH, D]).  ``scales``
    [KvH, NB] f32 marks an int8 pool: the gathered pages come out
    dequantized, ``int8 * scale`` in f32."""
    squeeze = block_table.dim() == 1
    if squeeze:
        block_table = block_table[None]
    kvh, _, bs, d = pages.shape
    mb = block_table.shape[-1]
    idx = block_table.long()
    lin = pages[:, idx]                                # [KvH, B, MB, BS, D]
    if scales is not None:
        lin = lin.float() * scales[:, idx][..., None, None]
    lin = torch.movedim(lin, 0, 3)                     # [B, MB, BS, KvH, D]
    lin = lin.reshape(block_table.shape[0], mb * bs, kvh, d)
    return lin[0] if squeeze else lin


def paged_decode_attention_partial(q, k_pages, v_pages, block_tables, *,
                                   lengths: Optional[torch.Tensor] = None,
                                   kv_offset: int = 0, skip_null: bool = False,
                                   k_scales: Optional[torch.Tensor] = None,
                                   v_scales: Optional[torch.Tensor] = None
                                   ) -> Partials:
    """Flash-decoding partials over a paged KV cache: q [B, H, D];
    block_tables [B, MB] -> (acc f32 [B, H, D], m [B, H], l [B, H]).  Key
    ``j`` of the gathered pages sits at global position ``kv_offset + j``.
    With ``skip_null`` a table entry of 0 contributes nothing even inside
    the live range: the contract of shard-local tables, where a page that
    another shard of a sequence-sharded pool owns maps to the local null
    page.  ``k_scales`` / ``v_scales`` [KvH, NB] f32 dequantize an int8 pool
    page by page (the gathered K/V, and so q and p, are then f32)."""
    k_lin = gather_pages(k_pages, block_tables, k_scales)
    v_lin = gather_pages(v_pages, block_tables, v_scales)
    kv_valid = None
    if skip_null:
        bt = block_tables if block_tables.dim() == 2 else block_tables[None]
        kv_valid = torch.repeat_interleave(bt != 0, k_pages.shape[2], dim=-1)
    return decode_attention_partial(q, k_lin, v_lin, lengths=lengths,
                                    kv_offset=kv_offset, kv_valid=kv_valid)


def paged_decode_attention(q, k_pages, v_pages, block_tables, *,
                           lengths: Optional[torch.Tensor] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None):
    acc, m, l = paged_decode_attention_partial(
        q, k_pages, v_pages, block_tables, lengths=lengths,
        k_scales=k_scales, v_scales=v_scales)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def paged_prefill_attention_partial(q, k_pages, v_pages, block_table, *,
                                    q_offset: int, length: int,
                                    skip_null: bool = False,
                                    k_scales: Optional[torch.Tensor] = None,
                                    v_scales: Optional[torch.Tensor] = None,
                                    window: Optional[int] = None
                                    ) -> Partials:
    """Prefill-chunk attention partials over a paged KV cache.

    q [1, C, H, D] is the chunk at global positions [q_offset, q_offset+C);
    block_table [MB] (the chunk's own K/V already scattered into the pages).
    Causal mask on global positions, KV validity on ``kpos < q_offset +
    length``, and with ``window`` only the keys ``kpos > qpos - window``;
    ``skip_null`` also masks the keys of zero table entries (a shard-local
    table's foreign pages).  ``k_scales`` / ``v_scales`` [KvH, NB] f32
    dequantize an int8 pool.  Returns (acc f32 [1,C,H,D], m [1,C,H], l
    [1,C,H])."""
    _, c, h, d = q.shape
    bs = k_pages.shape[2]
    k_lin = gather_pages(k_pages, block_table, k_scales)   # [MB*BS, KvH, D]
    v_lin = gather_pages(v_pages, block_table, v_scales)
    sk = k_lin.shape[0]
    kh = _expand_kv(k_lin[None], h)[0]                 # [Sk, H, D]
    vh = _expand_kv(v_lin[None], h)[0]
    s = torch.einsum("chd,khd->chk", q[0].float(), kh.float()) / math.sqrt(d)
    qpos = q_offset + torch.arange(c, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    valid = (kpos <= qpos) & (kpos < q_offset + length)
    if window is not None:
        valid = valid & (kpos > qpos - window)
    if skip_null:
        valid = valid & torch.repeat_interleave(block_table != 0, bs)[None, :]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("chk,khd->chd", p, vh.float())
    return acc[None], m[None], l[None]


def paged_prefill_attention(q, k_pages, v_pages, block_table, *,
                            q_offset: int, length: int,
                            k_scales: Optional[torch.Tensor] = None,
                            v_scales: Optional[torch.Tensor] = None,
                            window: Optional[int] = None) -> torch.Tensor:
    acc, m, l = paged_prefill_attention_partial(
        q, k_pages, v_pages, block_table, q_offset=q_offset, length=length,
        k_scales=k_scales, v_scales=v_scales, window=window)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _bf16_pair(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x as hi = bf16(x) and lo = bf16(x - hi), both back in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def paged_prefill_staged_partial(q, k_pages, v_pages, block_table, *,
                                 q_offset: int, length: int,
                                 skip_null: bool = False,
                                 k_scales: Optional[torch.Tensor] = None,
                                 v_scales: Optional[torch.Tensor] = None,
                                 rows: int = 64, stage: int = 64) -> Partials:
    """The arithmetic of the bf16 paged-prefill kernel
    (``csrc/paged_attention.cu``, its tensor-core form) in plain PyTorch, for
    the CPU tests: the same partials as :func:`paged_prefill_attention_partial`
    by another walk.  Query rows of each kv head, row-major (position,
    group), in tiles of ``rows``; a tile walks the keys below its causal end
    ``min(total, q_offset + its last position + 1)`` over its table prefix's
    pages in table order (under ``skip_null`` only the nonzero entries, the
    pages a shard owns), ``stage`` keys at a time, each key keeping its
    logical position for the mask.  s = (q . k) * K scale * 1/sqrt(D) in f32
    (the int8 pool's K scale on each score column), an online softmax in f32
    whose l sums the unscaled p, and P V with p times V's scale carried as a
    bf16 hi + lo pair against the (int8 or float) V rows.  A row that sees
    no key is ``(0, -1e30, 0)``.  Returns (acc f32 [1,C,H,D], m [1,C,H], l
    [1,C,H])."""
    _, c, h, d = q.shape
    kvh, _, bs, _ = k_pages.shape
    g = h // kvh
    n_rows = c * g
    total = min(q_offset + length, block_table.shape[0] * bs)
    scale = 1.0 / math.sqrt(d)
    # [KvH, C * G, D], rows row-major (position, group)
    qr = q[0].float().reshape(c, kvh, g, d).transpose(0, 1).reshape(kvh, n_rows, d)
    acc = torch.zeros(kvh, n_rows, d, dtype=torch.float32, device=q.device)
    m = torch.full((kvh, n_rows), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(kvh, n_rows, dtype=torch.float32, device=q.device)
    tbl = block_table.long()
    for r0 in range(0, n_rows, rows):
        r1 = min(r0 + rows, n_rows)
        qpos = q_offset + torch.arange(r0, r1, device=q.device) // g
        end = min(total, q_offset + (r1 - 1) // g + 1)
        n_prefix = -(-end // bs) if end > 0 else 0
        idx = torch.arange(n_prefix, device=q.device)
        if skip_null:
            idx = idx[tbl[:n_prefix] != 0]
        pos = (idx[:, None] * bs + torch.arange(bs, device=q.device)).flatten()
        page = tbl[idx].repeat_interleave(bs)
        row = torch.arange(bs, device=q.device).repeat(len(idx))
        keep = pos < end
        pos, page, row = pos[keep], page[keep], row[keep]
        for h_kv in range(kvh):
            qt = qr[h_kv, r0:r1]
            mt = torch.full((r1 - r0,), NEG_INF, dtype=torch.float32, device=q.device)
            lt = torch.zeros(r1 - r0, dtype=torch.float32, device=q.device)
            at = torch.zeros(r1 - r0, d, dtype=torch.float32, device=q.device)
            for s0 in range(0, len(pos), stage):
                sl = slice(s0, s0 + stage)
                kk = k_pages[h_kv, page[sl], row[sl]].float()
                vv = v_pages[h_kv, page[sl], row[sl]].float()
                s = qt @ kk.T
                if k_scales is not None:
                    s = s * k_scales[h_kv, page[sl]][None]
                s = torch.where(pos[sl][None] <= qpos[:, None], s * scale,
                                torch.tensor(NEG_INF, device=q.device))
                m_new = torch.maximum(mt, s.amax(dim=1))
                p = torch.exp(s - m_new[:, None])
                corr = torch.exp(mt - m_new)
                lt = lt * corr + p.sum(dim=1)
                if v_scales is not None:
                    p = p * v_scales[h_kv, page[sl]][None]
                hi, lo = _bf16_pair(p)
                at = at * corr[:, None] + hi @ vv + lo @ vv
                mt = m_new
            none = mt == NEG_INF
            acc[h_kv, r0:r1] = torch.where(none[:, None], 0.0, at)
            m[h_kv, r0:r1] = mt
            l[h_kv, r0:r1] = torch.where(none, 0.0, lt)
    acc = acc.reshape(kvh, c, g, d).transpose(0, 1).reshape(1, c, h, d)
    m = m.reshape(kvh, c, g).transpose(0, 1).reshape(1, c, h)
    l = l.reshape(kvh, c, g).transpose(0, 1).reshape(1, c, h)
    return acc, m, l


# ---------------------------------------------------------------------------
# RWKV6 wkv recurrence (linear attention with data-dependent decay)
# ---------------------------------------------------------------------------

W_FLOOR = 1e-20          # the decay is clamped here before its log


def rwkv6_scan(r, k, v, w, u, *, s0: Optional[torch.Tensor] = None):
    """RWKV-6 wkv recurrence, the exact recurrent form (the oracle).

    r, k, v [B, S, H, D]; w [B, S, H, D] per-step decay in (0, 1); u [H, D]
    bonus for the current token:
        S_t = diag(w_t) S_{t-1} + k_t v_t^T
        o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    -> (o [B, S, H, D] in r's dtype, S_final [B, H, D, D] f32; first D the
    key dim, second the value dim)."""
    b, s, h, d = r.shape
    uf = u.float()
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    S = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    outs = []
    for t in range(s):
        kv = torch.einsum("bhd,bhe->bhde", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhd,bhde->bhe", rf[:, t],
                                 S + uf[None, :, :, None] * kv))
        S = S * wf[:, t][..., None] + kv
    return torch.stack(outs, 1).to(r.dtype), S


def _rwkv6_chunks(r, k, v, w, chunk: int, extra=()):
    """Pad S to a multiple of ``chunk`` (r, k, v and ``extra`` with 0, w
    with 1: a padded row leaves the recurrence untouched) and split it ->
    f32 tensors [B, NC, T, H, D], plus the per-chunk log-decay sums
    ``cum`` (inclusive) and ``cin = cum - log w`` (exclusive)."""
    b, s, h, d = r.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    z = (0, 0, 0, 0, 0, pad)
    parts = [torch.nn.functional.pad(t.float(), z) for t in (r, k, v, *extra)]
    wf = torch.nn.functional.pad(w.float(), z, value=1.0)
    split = lambda t: t.reshape(b, nc, chunk, h, d)
    logw = torch.log(torch.clamp(split(wf), min=W_FLOOR))
    cum = torch.cumsum(logw, dim=2)
    return [split(t) for t in parts], cum, cum - logw


def _pair_decay(cin_c, cum_c, tri):
    """exp(cin[t] - cum[u]) for u < t, 0 elsewhere: [B, T, U, H, D].  The
    exponent is masked with a finite -1e30 *before* exp (u >= t would give
    up to ~46 T, inf in f32; -inf would breed NaN in autograd)."""
    logdiff = cin_c[:, :, None] - cum_c[:, None]
    return torch.exp(torch.where(tri[None, :, :, None, None], logdiff, NEG_INF))


def rwkv6_scan_chunked(r, k, v, w, u, *, s0: Optional[torch.Tensor] = None,
                       chunk: int = 32):
    """Chunked (parallel within a chunk) wkv, the algorithm of the kernels.
    All pairwise decay exponents are cum_in[t] - cum[u] with u < t, hence
    <= 0.  Memory is O(chunk^2 D) per (batch, head)."""
    b, s, h, d = r.shape
    chunk = min(chunk, s)
    (rs, ks, vs), cum, cin = _rwkv6_chunks(r, k, v, w, chunk)
    uf = u.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    S = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    outs = []
    for c in range(rs.shape[1]):
        rc, kc, vc, cc, ci = rs[:, c], ks[:, c], vs[:, c], cum[:, c], cin[:, c]
        o_state = torch.einsum("bthd,bhde->bthe", rc * torch.exp(ci), S)
        att = torch.einsum("bthd,btuhd,buhd->bhtu", rc,
                           _pair_decay(ci, cc, tri), kc)
        o_intra = torch.einsum("bhtu,buhe->bthe", att, vc)
        bonus = torch.einsum("bthd,hd,bthd->bth", rc, uf, kc)
        outs.append(o_state + o_intra + bonus[..., None] * vc)
        dec_out = torch.exp(cc[:, -1:] - cc)             # prod_{j>u} w_j <= 1
        S = S * torch.exp(cc[:, -1])[..., None] \
            + torch.einsum("buhd,buhe->bhde", kc * dec_out, vc)
    o = torch.stack(outs, 1).reshape(b, -1, h, d)[:, :s]
    return o.to(r.dtype), S


def rwkv6_step(rt, kt, vt, wt, u, S):
    """One-token wkv update (decode): rt, kt, vt, wt [B, H, D]; u [H, D]; S
    [B, H, D, D] f32 -> (o [B, H, D] in rt's dtype, S_new [B, H, D, D] f32),
    one step of :func:`rwkv6_scan`."""
    rf, kf, vf, wf = (t.float() for t in (rt, kt, vt, wt))
    kv = torch.einsum("bhd,bhe->bhde", kf, vf)
    o = torch.einsum("bhd,bhde->bhe", rf, S + u.float()[None, :, :, None] * kv)
    return o.to(rt.dtype), S * wf[..., None] + kv


def _entry_states(ks, vs, cum):
    """The state at each chunk's entry from a zero state: [B, H, NC, D, D]."""
    b, nc, _, h, d = ks.shape
    S = torch.zeros((b, h, d, d), dtype=torch.float32, device=ks.device)
    states = []
    for c in range(nc):
        states.append(S)
        cc = cum[:, c]
        S = S * torch.exp(cc[:, -1])[..., None] + torch.einsum(
            "buhd,buhe->bhde", ks[:, c] * torch.exp(cc[:, -1:] - cc), vs[:, c])
    return torch.stack(states, 2)


def rwkv6_chunk_states(k, v, w, *, chunk: int = 32):
    """The wkv state at the entry of each ``chunk``-row chunk, from a zero
    state: [B, H, ceil(S / chunk), D, D] f32 (what the training forward
    kernel writes for its backward)."""
    (_, ks, vs), cum, _ = _rwkv6_chunks(k, k, v, w, chunk)
    return _entry_states(ks, vs, cum)


def rwkv6_chunk_dstates(r, w, do, *, chunk: int = 32):
    """The gradient of each ``chunk``-row chunk's exit state for the output
    gradient ``do`` (and none on S_final): [B, H, ceil(S / chunk), D, D]
    f32, what the backward kernel's reverse scan writes.  The last chunk's
    is 0; then dS_{c-1} = e^{cT_c} dS_c + sum_t (r_t e^{cin_t})^T do_t over
    chunk c (cum, cin as in :func:`_rwkv6_chunks`, cT the chunk's total)."""
    (rs, _, dos), cum, cin = _rwkv6_chunks(r, r, do, w, chunk)
    b, nc, _, h, d = rs.shape
    dS = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    out = [dS] * nc
    for c in reversed(range(nc)):
        out[c] = dS
        dS = dS * torch.exp(cum[:, c, -1])[..., None] + torch.einsum(
            "bthd,bthe->bhde", rs[:, c] * torch.exp(cin[:, c]), dos[:, c])
    return torch.stack(out, 2)


def rwkv6_bwd(r, k, v, w, u, do, *, chunk: int = 32):
    """Gradients (dr, dk, dv, dw, du) of :func:`rwkv6_scan_chunked` with
    ``s0 = 0`` and a zero cotangent on S_final (the training case), by
    explicit formulas in the order of the backward kernels: the chunk-entry
    states S0 (:func:`rwkv6_chunk_states`), the exit-state gradients dS of
    every chunk (:func:`rwkv6_chunk_dstates`), then every chunk's gradients
    from its own S0 and dS alone (:func:`rwkv6_bwd_local`).  dr, dk, dv
    come back in r's dtype, dw and du in f32."""
    chunk = min(chunk, r.shape[1])
    return rwkv6_bwd_local(r, k, v, w, u, do,
                           rwkv6_chunk_states(k, v, w, chunk=chunk),
                           rwkv6_chunk_dstates(r, w, do, chunk=chunk),
                           chunk=chunk)


def rwkv6_bwd_local(r, k, v, w, u, do, states, dstates, *, chunk: int = 32):
    """:func:`rwkv6_bwd`'s gradients, each chunk's from its own entry state
    S0 (``states``, [B, H, NC, D, D]) and exit-state gradient dS
    (``dstates``, the same shape) alone: the backward kernel's
    chunk-parallel pass.  Within a chunk, with E[t, u] = exp(cin_t - cum_u)
    (u < t), dov[t, u] = do_t . v_u, att and bonus as in the forward:

        dv_u  = sum_{t>u} att[t,u] do_t + bonus_u do_u + (k_u e^{cT-cum_u}) dS
        dr'_t = e^{cin_t} (S0 do_t) + p'_t,  p'_t = sum_{u<t} dov[t,u] E[t,u] k_u
        dk'_u = z'_u + q'_u,  z'_u = e^{cT-cum_u} (dS v_u),
                q'_u = sum_{t>u} dov[t,u] E[t,u] r_t
        dr_t  = dr'_t + u k_t dov[t,t];   dk_u = dk'_u + u r_u dov[u,u]
        du    = sum_t r_t k_t dov[t,t]

    The decay: the weight of a pair (u < t) decays through row j when
    u < j < t, so the gradient of l_j = log max(w_j, 1e-20) gathers, per
    channel, four groups of pairs, all inside the chunk:

        dl_j = sum_{t>j} r_t p'_t - sum_{u>=j} k_u q'_u     (within the chunk)
             + sum_{t>j} r_t e^{cin_t} (S0 do_t)            (entry state to t)
             + sum_{u<j} k_u z'_u                           (u to the exit)
             + e^{cT} <S0, dS>  (per key channel)           (entry to exit)

    with no running sum across chunks, whose nearly cancelling terms lose
    f32 digits where the decays are strong.  dw = dl / w where w > 1e-20
    and 0 where the clamp holds."""
    b, s, h, d = r.shape
    (rs, ks, vs, dos), cum, cin = _rwkv6_chunks(r, k, v, w, chunk, (do,))
    nc = rs.shape[1]
    uf = u.float()
    dev = r.device
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev),
                     diagonal=-1)
    eye = torch.eye(chunk, dtype=torch.bool, device=dev)
    du = torch.zeros((h, d), dtype=torch.float32, device=dev)
    dr, dk, dv, dl = (torch.zeros_like(rs) for _ in range(4))
    for c in range(nc):
        rc, kc, vc, doc = rs[:, c], ks[:, c], vs[:, c], dos[:, c]
        cc, ci = cum[:, c], cin[:, c]
        S0, dS = states[:, :, c], dstates[:, :, c]
        cT = cc[:, -1]                                    # [B, H, D]
        E = _pair_decay(ci, cc, tri)                      # [B, T, U, H, D]
        dov = torch.einsum("bthe,buhe->bhtu", doc, vc)
        diag = dov.diagonal(dim1=2, dim2=3).permute(0, 2, 1)   # [B, T, H]
        datt = torch.where(tri, dov, 0.0)
        att = torch.einsum("bthd,btuhd,buhd->bhtu", rc, E, kc)
        bonus = torch.einsum("bthd,hd,bthd->bth", rc, uf, kc)
        att = att + torch.where(eye, bonus.permute(0, 2, 1)[..., None], 0.0)
        kdec = torch.exp(cT[:, None] - cc)                # e^{cT - cum_u}
        dv[:, c] = (torch.einsum("bhtu,bthe->buhe", att, doc)
                    + torch.einsum("buhd,bhde->buhe", kc * kdec, dS))
        entry = torch.exp(ci) * torch.einsum("bhde,bthe->bthd", S0, doc)
        p = torch.einsum("bhtu,btuhd,buhd->bthd", datt, E, kc)
        z = kdec * torch.einsum("bhde,buhe->buhd", dS, vc)
        q = torch.einsum("bhtu,btuhd,bthd->buhd", datt, E, rc)
        dr[:, c] = entry + p + uf * kc * diag[..., None]
        dk[:, c] = z + q + uf * rc * diag[..., None]
        du = du + torch.einsum("bthd,bth->hd", rc * kc, diag)
        x, y, zk = rc * (entry + p), kc * q, kc * z       # [B, T, H, D]
        after = torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1]) - x
        from_j = torch.flip(torch.cumsum(torch.flip(y, [1]), 1), [1])
        before = torch.cumsum(zk, 1) - zk
        ends = torch.exp(cT) * torch.einsum("bhde,bhde->bhd", S0, dS)
        dl[:, c] = after - from_j + before + ends[:, None]
    unchunk = lambda t: t.reshape(b, nc * chunk, h, d)[:, :s]  # noqa: E731
    wf = w.float()
    dw = torch.where(wf > W_FLOOR, unchunk(dl) / wf, 0.0)
    return (unchunk(dr).to(r.dtype), unchunk(dk).to(k.dtype),
            unchunk(dv).to(v.dtype), dw, du)


# ---------------------------------------------------------------------------
# matmul (the "SRAM-PIM lane": weight-stationary tiled GEMM)
# ---------------------------------------------------------------------------

def matmul(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x [..., K] @ w [K, N] with f32 accumulation over all of K and one
    rounding to ``out_dtype`` (default x's dtype)."""
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 SSD scan (scalar-per-head decay, n_groups = 1)
# ---------------------------------------------------------------------------

def _mamba2_chunks(x, dt, B, C, chunk: int, extra=()):
    """Pad S to a multiple of ``chunk`` with zeros (dt = 0 makes a padded row
    a no-op: its decay is exp(0) = 1 and its input term 0) and split it ->
    f32 tensors x [B, NC, T, H, P], dt [B, NC, T, H], B and C [B, NC, T, N],
    and each of ``extra`` (shaped like x) as x."""
    b, s, h, p = x.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    F = torch.nn.functional
    xs = [F.pad(t.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nc, chunk, h, p)
          for t in (x, *extra)]
    dts = F.pad(dt.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, h)
    bs, cs = (F.pad(t.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, -1)
              for t in (B, C))
    return xs, dts, bs, cs


def _seg_decay(cum, tri):
    """exp(cum[t] - cum[u]) for u <= t, 0 elsewhere: [B, T, U, H].  The
    exponent is masked with a finite -1e30 *before* exp (u > t gives a
    positive exponent that overflows f32; -inf would breed NaN in
    autograd)."""
    diff = cum[:, :, None, :] - cum[:, None, :, :]
    return torch.exp(torch.where(tri[None, :, :, None], diff, NEG_INF))


def mamba2_scan(x, dt, A, B, C, *, h0: Optional[torch.Tensor] = None,
                chunk: int = 128):
    """Chunked selective-state-space scan (Mamba2 SSD), the JAX oracle's
    algorithm.

    x [Bt, S, H, P]; dt [Bt, S, H] (softplus step sizes, >= 0); A [H]
    (negative); B, C [Bt, S, N] (shared by the heads); h0 [Bt, H, P, N] an
    optional initial state.  Recurrence, per head:
        h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
    -> (y [Bt, S, H, P] in x's dtype, h_final [Bt, H, P, N] f32).  Within a
    chunk every decay exponent is cum[t] - cum[u] with u <= t, hence <= 0."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, s)
    (xs,), dts, bs, cs = _mamba2_chunks(x, dt, B, C, chunk)
    af = A.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    hs = (torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device)
          if h0 is None else h0.float())
    ys = []
    for c in range(xs.shape[1]):
        xc, dtc, bc, cc = xs[:, c], dts[:, c], bs[:, c], cs[:, c]
        cum = torch.cumsum(dtc * af, dim=1)                        # [Bt,T,H]
        cb = torch.einsum("btn,bun->btu", cc, bc)
        wts = _seg_decay(cum, tri) * cb[..., None] * dtc[:, None]  # [Bt,T,U,H]
        y_intra = torch.einsum("btuh,buhp->bthp", wts, xc)
        y_inter = torch.einsum("btn,bhpn,bth->bthp", cc, hs, torch.exp(cum))
        dec_rest = torch.exp(cum[:, -1:] - cum)                    # [Bt,U,H]
        contrib = torch.einsum("buh,buhp,bun->bhpn", dec_rest * dtc, xc, bc)
        hs = hs * torch.exp(cum[:, -1])[..., None, None] + contrib
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(bt, -1, h, p)[:, :s]
    return y.to(x.dtype), hs


def mamba2_step(xt, dtt, A, Bt, Ct, h):
    """One-token Mamba2 update (decode): xt [B, H, P]; dtt [B, H]; A [H];
    Bt, Ct [B, N]; h [B, H, P, N] f32 -> (y [B, H, P] in xt's dtype, h_new
    [B, H, P, N] f32), one step of :func:`mamba2_scan`."""
    dtf = dtt.float()
    dA = torch.exp(dtf * A.float()[None, :])
    hn = h * dA[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtf, xt.float(), Bt.float())
    y = torch.einsum("bhpn,bn->bhp", hn, Ct.float())
    return y.to(xt.dtype), hn


def mamba2_chunk_states(x, dt, A, B, *, chunk: int = 64):
    """The SSM state at the entry of each ``chunk``-row chunk, from a zero
    state: [Bt, H, ceil(S / chunk), P, N] f32 (what the training forward
    kernel writes for its backward)."""
    bt, s, h, p = x.shape
    (xs,), dts, bs, _ = _mamba2_chunks(x, dt, B, B, chunk)
    hs = torch.zeros((bt, h, p, B.shape[-1]), dtype=torch.float32,
                     device=x.device)
    states = []
    for c in range(xs.shape[1]):
        states.append(hs)
        cum = torch.cumsum(dts[:, c] * A.float(), dim=1)
        hs = hs * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "buh,buhp,bun->bhpn", torch.exp(cum[:, -1:] - cum) * dts[:, c],
            xs[:, c], bs[:, c])
    return torch.stack(states, 2)


def mamba2_chunk_dstates(dt, A, C, dy, *, chunk: int = 64):
    """The gradient of each ``chunk``-row chunk's exit state for the output
    gradient ``dy`` (and none on h_final): [Bt, H, ceil(S / chunk), P, N]
    f32, what the backward kernel's reverse walk writes.  The last chunk's
    is 0; then dS_{c-1} = e^{cT_c} dS_c + sum_t e^{cum_t} dy_t C_t^T over
    chunk c (cum the inclusive sums of A dt within it, cT their total)."""
    (dys,), dts, _, cs = _mamba2_chunks(dy, dt, C, C, chunk)
    bt, nc, _, h, p = dys.shape
    dS = torch.zeros((bt, h, p, C.shape[-1]), dtype=torch.float32,
                     device=dy.device)
    out = [dS] * nc
    for c in reversed(range(nc)):
        out[c] = dS
        cum = torch.cumsum(dts[:, c] * A.float(), dim=1)
        dS = dS * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bth,bthp,btn->bhpn", torch.exp(cum), dys[:, c], cs[:, c])
    return torch.stack(out, 2)


def mamba2_bwd(x, dt, A, B, C, dy, *, chunk: int = 64):
    """Gradients (dx, ddt, dA, dB, dC) of :func:`mamba2_scan`'s y with
    ``h0 = 0`` and a zero cotangent on h_final (the training case), by
    explicit formulas in the order of the backward kernel: the chunk-entry
    states h0 (the forward's), the exit-state gradients dS of every chunk
    (:func:`mamba2_chunk_dstates`), then every chunk's gradients at once,
    each from its own h0 and dS alone.

    With l_t = A dt_t, a_t = exp(l_t), h_t = a_t h_{t-1} + dt_t x_t B_t^T
    and y_t = h_t C_t, the state gradient g_t = dy_t C_t^T + a_{t+1} g_{t+1}
    is, inside a chunk with inclusive log-decay sums cum and exit value cT,
    g_t = sum_{s>=t} e^{cum_s - cum_t} dy_s C_s^T + e^{cT - cum_t} dS.  With
    M[s,u] = e^{cum_s - cum_u} C_s.B_u and Q[s,u] = e^{cum_s - cum_u}
    dy_s.x_u (both for u <= s):

        dx_t  = dt_t g_t B_t = dt_t (sum_s M[s,t] dy_s + e^{cT-cum_t} dS B_t)
        e_t   = x_t . g_t B_t
        dB_t  = sum_heads dt_t (sum_s Q[s,t] C_s + e^{cT-cum_t} x_t^T dS)
        dC_t  = sum_heads (e^{cum_t} h0^T dy_t + sum_u Q[t,u] dt_u B_u)

    The log-decay gradient dl_j = <g_j, a_j h_{j-1}> is taken pair by pair
    over the (s >= j, u < j) terms that decay through step j, inside the
    chunk (the boundary terms carry h0 and dS):

        dl_j = sum_{s>=j} sum_{u<j} M[s,u] dt_u dy_s.x_u
             + sum_{s>=j} e^{cum_s} dy_s^T h0 C_s
             + sum_{u<j} e^{cT-cum_u} dt_u x_u^T dS B_u + e^{cT} <dS, h0>

    (the same value as sum_{t>=j} (<y_t, dy_t> - dt_t e_t), but without its
    running sum over the whole sequence of nearly cancelling terms, which
    loses f32 digits where the decays are strong).  Then ddt_t = e_t + A dl_t
    and dA = sum_{batch, t} dt_t dl_t.  dx, dB and dC come back in the
    dtypes of x, B and C; ddt and dA in f32."""
    chunk = min(chunk, x.shape[1])
    return mamba2_bwd_local(x, dt, A, B, C, dy,
                            mamba2_chunk_states(x, dt, A, B, chunk=chunk),
                            mamba2_chunk_dstates(dt, A, C, dy, chunk=chunk),
                            chunk=chunk)


def mamba2_bwd_local(x, dt, A, B, C, dy, states, dstates, *, chunk: int = 64):
    """:func:`mamba2_bwd`'s gradients, every chunk's at once from its own
    entry state (``states``, [Bt, H, NC, P, N]) and exit-state gradient
    (``dstates``, the same shape) alone: the backward kernel's chunk-parallel
    pass and its last sums."""
    bt, s, h, p = x.shape
    (xs, dys), dts, bs, cs = _mamba2_chunks(x, dt, B, C, chunk, (dy,))
    nc = xs.shape[1]
    dev = x.device
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    h0, dS = states, dstates
    af = A.float()
    cum = torch.cumsum(dts * af, dim=2)                          # [Bt,NC,T,H]
    cT = cum[:, :, -1]                                           # [Bt,NC,H]
    L = _seg_decay(cum.flatten(0, 1), tri).reshape(bt, nc, chunk, chunk, h)
    cb = torch.einsum("bctn,bcun->bctu", cs, bs)
    M = L * cb[..., None]
    dyx = torch.einsum("bcthp,bcuhp->bctuh", dys, xs)            # dy_t . x_u
    Q = L * dyx
    tail = torch.exp(cT[:, :, None] - cum)                       # e^{cT - cum_t}
    head = torch.exp(cum)                                        # e^{cum_t}
    # dx, e
    gB = (torch.einsum("bcsth,bcshp->bcthp", M, dys)
          + tail[..., None] * torch.einsum("bhcpn,bctn->bcthp", dS, bs))
    dx = dts[..., None] * gB
    e = (xs * gB).sum(-1)                                        # [Bt,NC,T,H]
    # dB, and x_t^T dS B_t
    xdS = torch.einsum("bcthp,bhcpn->bcthn", xs, dS)
    dB = torch.einsum("bcth,bcsth,bcsn->bctn", dts, Q, cs) + torch.einsum(
        "bcth,bcthn->bctn", dts * tail, xdS)
    xdsb = torch.einsum("bcthn,bctn->bcth", xdS, bs)
    # dC, and C_t . h0^T dy_t
    hdy = torch.einsum("bhcpn,bcthp->bcthn", h0, dys)            # h0^T dy_t
    dC = (torch.einsum("bcth,bcthn->bctn", head, hdy)
          + torch.einsum("bctuh,bcuh,bcun->bctn", Q, dts, bs))
    hc = torch.einsum("bctn,bcthn->bcth", cs, hdy)
    # dl, ddt, dA
    K = M * dts[:, :, None] * dyx                                # [Bt,NC,S,U,H]
    before = torch.cumsum(K, dim=3) - K                          # sum_{u<j} K[s,u]
    intra = torch.einsum("bcsjh,sj->bcjh", before, tri.float())  # sum_{s>=j}
    h_side = torch.flip(torch.cumsum(torch.flip(head * hc, [2]), 2), [2])
    s_side = tail * dts * xdsb
    s_side = torch.cumsum(s_side, 2) - s_side                    # sum_{u<j}
    const = torch.exp(cT) * torch.einsum("bhcpn,bhcpn->bch", dS, h0)
    dl = intra + h_side + s_side + const[:, :, None]
    ddt = e + af * dl
    dA = (dts * dl).sum((0, 1, 2))
    unchunk = lambda t: t.reshape(bt, nc * chunk, *t.shape[3:])[:, :s]  # noqa: E731
    return (unchunk(dx).to(x.dtype), unchunk(ddt), dA,
            unchunk(dB).to(B.dtype), unchunk(dC).to(C.dtype))
