"""Flash-decoding — hand-written CUDA kernels for Hopper: over the paged KV
pool (``csrc/paged_attention.cu``, host side in ``_paged.py``) and over a
dense KV slab (``csrc/decode_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py``
(``_paged_decode``, ``pallas_call`` at :300, behind
``paged_decode_attention`` :313 and ``paged_decode_attention_partial``
:327).  A decode step is run as a one-row chunk per sequence: block
(tile, kv head, sequence) reads its own block-table row, walks only the
sequence's live keys ``[0, min(len, MB*BS))`` 32 at a time through shared
memory, and keeps the online softmax in f32 registers.  Bound on the H100:
bytes (each live K/V byte is read once).  The TPU kernel's 64-row
K-subtiling for ``BS > 64`` has no counterpart to port: this kernel's step
is 32 keys whatever the page size.  Retired slots (all-zero table row,
length 0 -> attention over the null page's first row) launch validly and
their rows are discarded by the engine.

Ported here: the fp pool and the int8 pool (pages int8 with ``k_scales`` /
``v_scales`` [KvH, NB] f32, one per (kv head, page), dequantized as the
kernel stages each value: the TPU kernel's quantized branch, :166-230),
normalized output and ``(acc, m, l)`` partials (an empty row is ``(0,
-1e30, 0)``), and the sequence-sharded pool's modes of
``paged_decode_attention_partial`` (:327; ``skip_null`` and ``kv_offset``,
:219, :235-237): a shard's view of the pool is read through its kv-head
stride, a zero entry of its shard-local table is masked and its bytes
never loaded, and key ``j`` of the table sits at global position
``kv_offset + j``.  A row all of whose live pages another shard owns
returns the combine identity.

The dense slab replaces the TPU kernel's ``_decode`` (``pallas_call`` at
:114, behind ``decode_attention`` :143 and ``decode_attention_partial``
:151): q [B, H, D] against one layer's slab k, v [B, Sk, KvH, D], read in
place through strides (no permute, pad or copy on the host).  Block (row
tile, kv head, sequence) walks only the live keys, ``[kv_offset,
min(lengths[b], kv_offset + Sk))`` in global positions, split over its four
warps in steps of 32 keys, and merges the warps' ``(acc, m, l)`` at the
end.  Bound on the H100: bytes.  A row with no live key returns ``(0,
-1e30, 0)``; the JAX oracle and the TPU kernel count masked keys at p = 1
there, which combines to the same zero weight beside any non-empty
partial.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _paged

launches = 0         # paged kernel launches over a float pool
q8_launches = 0      # paged kernel launches over an int8 pool (its variant)
shard_launches = 0     # skip_null launches over a shard of a float pool
shard_q8_launches = 0  # skip_null launches over a shard of an int8 pool
dense_launches = 0   # dense-slab kernel launches

DENSE_HEAD_DIMS = (16, 64, 128)   # csrc/decode_attention.cu's instantiations


def _decode(q, k_pages, v_pages, block_tables, lengths, partials: bool,
            k_scales, v_scales, kv_offset: int = 0, skip_null: bool = False):
    global launches, q8_launches, shard_launches, shard_q8_launches
    if q.dim() != 3:
        raise ValueError(f"paged decode: q must be [B, H, D], got {tuple(q.shape)}")
    res = _paged.launch(q[:, None], k_pages, v_pages, block_tables, lengths,
                        0, 0, partials=partials, k_scales=k_scales,
                        v_scales=v_scales, kv_offset=kv_offset,
                        skip_null=skip_null)
    if skip_null and k_scales is None:
        shard_launches += 1
    elif skip_null:
        shard_q8_launches += 1
    elif k_scales is None:
        launches += 1
    else:
        q8_launches += 1
    if partials:
        acc, m, l = res
        return acc[:, 0], m[:, 0], l[:, 0]
    return res[:, 0]


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
    global dense_launches
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
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode attention: k and v must be 16-byte aligned "
                         "(the kernel reads 16-byte chunks)")
    if partials:
        acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty((b, h), dtype=torch.float32, device=q.device)
        l = torch.empty((b, h), dtype=torch.float32, device=q.device)
        ptrs = (None, acc.data_ptr(), m.data_ptr(), l.data_ptr())
    else:
        out = torch.empty_like(q)
        ptrs = (out.data_ptr(), None, None, None)
    lib = _build.load()
    code = lib.repro_decode_attention(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lengths is None else lengths.data_ptr(), int(kv_offset), *ptrs,
        b, sk, h, kvh, d, _build.stream_ptr(q))
    dense_launches += 1
    _build.check("decode_attention", code)
    return (acc, m, l) if partials else out


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
