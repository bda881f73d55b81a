"""Flash-decoding — one hand-written CUDA kernel for Hopper
(``csrc/decode_attention.cu``) over two key sources: the paged KV pool and a
dense KV slab.

Replaces two TPU kernels of ``src/repro/kernels/decode_attention.py``:
``_paged_decode`` (``pallas_call`` at :300, behind ``paged_decode_attention``
:313 and ``paged_decode_attention_partial`` :327) and ``_decode``
(``pallas_call`` at :114, behind ``decode_attention`` :143 and
``decode_attention_partial`` :151).

Each (sequence, kv head)'s keys are cut into up to eight fixed ranges, one
block of a thread-block cluster each: ``_paged.decode_plan`` picks the split
from shapes alone (the lengths never reach the host; as many splits as keep
the grid to one wave of blocks) and ``_paged.split_key_ranges`` mirrors the
ranges.  A block holds all G query rows of its kv head, walks only its
range's live keys in 32-key stages (each of its four warps streams its
stages' K and V through 16-byte ``cp.async`` into a ring in shared memory)
and keeps the online softmax in f32; each block pushes its ``(acc, m, l)``
into the shared memory of the cluster's rank 0, which merges them in a
fixed order and writes the normalized output or the partials, so a call is
one launch and two calls give the same bits.
Two forms, by ``_paged.decode_form`` (query dtype, head dim, G): bf16
queries at head dims 112 and 128, and at 64 with grouped KV, take the
tensor-core form (``mma.sync`` on 16-key stages, P as a bf16 hi + lo pair,
its own plan ``_paged.tc_decode_plan`` and instantiations, chosen by the
entry points' ``tc`` argument); f32 queries and G = 1 up to head dim 64
keep the CUDA-core form.  ``tc_launches`` counts the
tensor-core launches beside each mode's counter.
Bound on the H100: bytes (each live K/V byte is read once).  The TPU
kernel's 64-row K-subtiling for ``BS > 64`` has no counterpart to port: the
stages are 32 keys whatever the page size.

The pool: q [B, H, D] against pages [KvH, NB, BS, D] through the block
table.  Ported here: the fp pool and the int8 pool (pages int8 with
``k_scales`` / ``v_scales`` [KvH, NB] f32, one per (kv head, page), each value
dequantized as ``int8 * scale`` in f32: the TPU kernel's quantized branch,
:166-230), normalized output and ``(acc, m, l)`` partials (an empty row is
``(0, -1e30, 0)``), and the sequence-sharded pool's modes of
``paged_decode_attention_partial`` (:327; ``skip_null`` and ``kv_offset``,
:219, :235-237): a shard's view of the pool is read through its kv-head
stride, a page whose shard-local table entry is zero is skipped whole (no
copy, no arithmetic), and key ``j`` of the table sits at global position
``kv_offset + j``.  A row all of whose live pages another shard owns returns
the combine identity.  Retired slots (all-zero table row, length 0) launch
validly; their rows are discarded by the engine.

The slab: q [B, H, D] against one layer's slab k, v [B, Sk, KvH, D], read
in place through strides (no permute, pad or copy on the host); the live
keys are ``[kv_offset, min(lengths[b], kv_offset + Sk))`` in global
positions.  A row with no live key returns ``(0, -1e30, 0)``; the JAX oracle
and the TPU kernel count masked keys at p = 1 there, which combines to the
same zero weight beside any non-empty partial.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _paged

launches = 0           # launches over a float pool
q8_launches = 0        # launches over an int8 pool
shard_launches = 0     # skip_null launches over a shard of a float pool
shard_q8_launches = 0  # skip_null launches over a shard of an int8 pool
dense_launches = 0     # launches over a dense slab
tc_launches = 0        # of those, the launches that took the tensor-core form

DENSE_HEAD_DIMS = (16, 64, 112, 128)   # csrc/decode_attention.cu's instantiations


def _plan(q: torch.Tensor, kvh: int, keys: int, grain: int) -> _paged.DecodePlan:
    b, h, _ = q.shape
    return _paged.decode_plan(b, kvh, h // kvh, keys, grain, _build.n_sms(q.device))


def _tc_plan(q: torch.Tensor, kvh: int, keys: int, grain: int) -> _paged.DecodePlan:
    b, h, d = q.shape
    return _paged.tc_decode_plan(b, kvh, h // kvh, d, keys, grain)


def _outputs(q: torch.Tensor, partials: bool):
    """The outputs of one launch and their pointers (out, acc, m, l)."""
    if partials:
        acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
        l = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
        return (acc, m, l), (None, acc.data_ptr(), m.data_ptr(), l.data_ptr())
    out = torch.empty_like(q)
    return out, (out.data_ptr(), None, None, None)


def _aligned(name: str, **tensors) -> None:
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned (the "
                             f"kernel copies 16-byte chunks)")


def _q_aligned(name: str, q: torch.Tensor) -> None:
    if q.data_ptr() % 4:
        raise ValueError(f"{name}: q must be 4-byte aligned (the tensor-core "
                         f"form loads its fragments as bf16 pairs)")


def _decode(q, k_pages, v_pages, block_tables, lengths, partials: bool,
            k_scales, v_scales, kv_offset: int = 0, skip_null: bool = False):
    global launches, q8_launches, shard_launches, shard_q8_launches, tc_launches
    if q.dim() != 3:
        raise ValueError(f"paged decode: q must be [B, H, D], got {tuple(q.shape)}")
    g = _paged.geometry(q[:, None].shape, k_pages.shape, block_tables.shape)
    if k_pages.shape != v_pages.shape:
        raise ValueError("paged decode: k_pages and v_pages differ in shape")
    int8 = _paged.check_scales(q.dtype, k_pages, v_pages, k_scales, v_scales)
    if block_tables.dtype != torch.int32:
        raise ValueError(f"paged decode: tables must be int32, got "
                         f"{block_tables.dtype}")
    if lengths.shape != (g.b,) or lengths.dtype != torch.int32:
        raise ValueError(f"paged decode: lengths must be [{g.b}] int32")
    if kv_offset < 0:
        raise ValueError(f"paged decode: kv_offset {kv_offset} < 0")
    page_stride, scale_stride = _paged.pool_strides(k_pages, v_pages, k_scales,
                                                    v_scales)
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages, tables=block_tables,
                   lens=lengths)
    if int8:
        tensors.update(k_scales=k_scales, v_scales=v_scales)
    _build.require_cuda("paged_decode",
                        views=("k_pages", "v_pages", "k_scales", "v_scales"),
                        **tensors)
    _aligned("paged decode", k_pages=k_pages, v_pages=v_pages)
    tc = _paged.decode_form(q.dtype, g.d, g.group) == "tc"
    res, ptrs = _outputs(q, partials)
    lib = _build.load()
    if tc:
        _q_aligned("paged decode", q)
    plan = (_tc_plan if tc else _plan)(q, g.kvh, g.mb * g.bs, g.bs)
    code = lib.repro_paged_decode(
        _build.dtype_code(q), int(tc), q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), k_scales.data_ptr() if int8 else None,
        v_scales.data_ptr() if int8 else None, block_tables.data_ptr(),
        lengths.data_ptr(), int(kv_offset), int(bool(skip_null)), *ptrs, g.b,
        g.h, g.kvh, page_stride, scale_stride, g.bs, g.d, g.mb, plan.n_split,
        plan.split_keys, _build.n_sms(q.device), _build.stream_ptr(q))
    tc_launches += tc
    if skip_null and not int8:
        shard_launches += 1
    elif skip_null:
        shard_q8_launches += 1
    elif not int8:
        launches += 1
    else:
        q8_launches += 1
    _build.check("paged_decode", code)
    return res


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q [B,H,D]; k_pages, v_pages [KvH,NB,BS,D] in q's dtype, or int8 with
    ``k_scales`` / ``v_scales`` [KvH,NB] f32; block_tables [B,MB] int32;
    lengths [B] int32 (keys ``[0, len)`` attended) -> [B,H,D]."""
    return _decode(q, k_pages, v_pages, block_tables, lengths, False,
                   k_scales, v_scales)


def paged_decode_attention_partial(q, k_pages, v_pages, block_tables, lengths,
                                   k_scales=None, v_scales=None,
                                   kv_offset: int = 0, skip_null: bool = False):
    """(acc f32 [B,H,D], m [B,H], l [B,H]) for the softmax combine.  The
    pages (and scales) may be a shard's view of a pool, dense past the
    kv-head dim; ``skip_null`` masks the keys of zero table entries, and
    ``kv_offset`` puts key ``j`` of the table at global position
    ``kv_offset + j`` (live below ``min(len, kv_offset + MB*BS)``)."""
    return _decode(q, k_pages, v_pages, block_tables, lengths, True,
                   k_scales, v_scales, kv_offset, skip_null)


def _dense(q, k, v, lengths: Optional[torch.Tensor], kv_offset: int,
           partials: bool):
    global dense_launches, tc_launches
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[2]:
        raise ValueError(f"decode attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"[B,H,D], [B,Sk,KvH,D] x2")
    b, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"decode attention: {h} query heads over {kvh} kv heads")
    if d not in DENSE_HEAD_DIMS:
        raise ValueError(f"decode attention: head dim {d} not in {DENSE_HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"decode attention: q, k, v dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if kv_offset < 0:
        raise ValueError(f"decode attention: kv_offset {kv_offset} < 0")
    tensors = dict(q=q, k=k, v=v)
    if lengths is not None:
        if lengths.shape != (b,) or lengths.dtype != torch.int32:
            raise ValueError(f"decode attention: lengths must be [{b}] int32, "
                             f"got {tuple(lengths.shape)} {lengths.dtype}")
        tensors["lengths"] = lengths
    _build.require_cuda("decode_attention", **tensors)
    _aligned("decode attention", k=k, v=v)
    res, ptrs = _outputs(q, partials)
    lib = _build.load()
    tc = _paged.decode_form(q.dtype, d, h // kvh) == "tc"
    if tc:
        _q_aligned("decode attention", q)
        plan = _tc_plan(q, kvh, sk, _paged.TC_STAGE_KEYS)
    else:
        plan = _plan(q, kvh, sk, _paged.STAGE_KEYS)
    code = lib.repro_decode_attention(
        _build.dtype_code(q), int(tc), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lengths is None else lengths.data_ptr(), int(kv_offset), *ptrs,
        b, sk, h, kvh, d, plan.n_split, plan.split_keys, _build.n_sms(q.device),
        _build.stream_ptr(q))
    tc_launches += tc
    dense_launches += 1
    _build.check("decode_attention", code)
    return res


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,H,D]; k, v [B,Sk,KvH,D] (one layer's slab); lengths [B] int32
    (keys ``[0, len)`` attended; None: all Sk) -> [B,H,D]."""
    return _dense(q, k, v, lengths, 0, partials=False)


def decode_attention_partial(q, k, v, lengths: Optional[torch.Tensor] = None,
                             kv_offset: int = 0):
    """(acc f32 [B,H,D], m [B,H], l [B,H]) over a slab whose row 0 sits at
    global position ``kv_offset`` (a sequence shard), for the softmax
    combine."""
    return _dense(q, k, v, lengths, kv_offset, partials=True)
