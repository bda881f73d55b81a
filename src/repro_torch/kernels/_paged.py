"""Host side of the paged-attention CUDA kernel (``csrc/paged_attention.cu``)
shared by ``decode_attention.py`` and ``prefill_attention.py``.

The kernel reads queries in their natural ``[B, C, H, D]`` layout (decode:
C = 1) and writes outputs in the same layout, so the host does no padding
and no transposes: a tile of ``ROWS`` query rows of one (sequence, kv head)
is cut out by index arithmetic inside the kernel.  :func:`geometry` and
:func:`check_scales` are the host-side parts that the CPU tests reach:
argument checks, tile count and the per-tile key bound the kernel computes
for itself.

An int8 pool passes ``k_scales`` / ``v_scales`` [KvH, NB] f32, one scale
per (kv head, page); the kernel's int8-page variant dequantizes each value
as it stages it (q and the output keep their f32 or bf16 type).

A sequence-sharded pool passes each shard's view of the pool,
``pages[:, s*nbl:(s+1)*nbl]`` (and the same slice of the scales), with the
shard-local table and ``skip_null``: the kernel reads the view through its
kv-head stride, no copy, and masks the keys of zero table entries.  Decode
may shift key positions by ``kv_offset``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.kernels import _build

ROWS = 16                      # query rows per block (csrc: kRows)
HEAD_DIMS = (16, 64, 128)      # head dims the kernel is instantiated for
#                                (the reduced configs, and every full-width
#                                dense config of the registry)


@dataclass(frozen=True)
class Geometry:
    b: int
    c: int
    h: int
    kvh: int
    bs: int
    d: int
    mb: int
    n_tiles: int     # row tiles per (sequence, kv head): ceil(C*G / ROWS)

    @property
    def group(self) -> int:
        return self.h // self.kvh


def geometry(q_shape, pages_shape, table_shape) -> Geometry:
    """Validate shapes; q [B, C, H, D], pages [KvH, NB, BS, D], table [B, MB]."""
    b, c, h, d = q_shape
    kvh, _, bs, pd = pages_shape
    tb, mb = table_shape
    if pd != d or tb != b:
        raise ValueError(f"paged attention: q {tuple(q_shape)}, pages "
                         f"{tuple(pages_shape)} and table {tuple(table_shape)} "
                         f"disagree")
    if kvh <= 0 or h % kvh:
        raise ValueError(f"paged attention: {h} query heads not a multiple "
                         f"of {kvh} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged attention: head dim {d} not in {HEAD_DIMS}")
    return Geometry(b, c, h, kvh, bs, d, mb,
                    n_tiles=-(-(c * (h // kvh)) // ROWS))


def check_scales(q_dtype, k_pages, v_pages, k_scales, v_scales) -> bool:
    """Validate the page types against the scales; True for an int8 pool.
    A float pool takes no scales and shares q's dtype; an int8 pool takes
    both scales, [KvH, NB] f32 on the pages' device."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("paged attention: pass both k_scales and v_scales "
                         "or neither")
    if k_scales is None:
        if not (q_dtype == k_pages.dtype == v_pages.dtype):
            raise ValueError(f"paged attention: q {q_dtype} and pages "
                             f"{k_pages.dtype}/{v_pages.dtype} must share a "
                             f"dtype (an int8 pool needs its scales)")
        return False
    if not (k_pages.dtype == v_pages.dtype == torch.int8):
        raise ValueError(f"paged attention: scales mark an int8 pool, got "
                         f"pages {k_pages.dtype}/{v_pages.dtype}")
    want = (k_pages.shape[0], k_pages.shape[1])
    for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tuple(s.shape) != want or s.dtype != torch.float32:
            raise ValueError(f"paged attention: {name} must be {list(want)} "
                             f"float32 ([KvH, NB]), got {tuple(s.shape)} "
                             f"{s.dtype}")
        if s.device != k_pages.device:
            raise ValueError(f"paged attention: {name} on {s.device}, the "
                             f"pages on {k_pages.device}")
    return True


def tile_key_ends(g: Geometry, q_offset: int, total: int) -> List[int]:
    """Keys ``[0, end)`` each row tile walks — the kernel's tile_end:
    ``min(total, q_offset + last position of the tile + 1)``.  ``total`` is
    the live KV rows, already clamped to ``MB * BS``; the tile reads
    ``ceil(end / BS)`` pages (the TPU kernel's per-q-tile live-page clamp)."""
    n_rows = g.c * g.group
    return [min(total, q_offset + (min((t + 1) * ROWS, n_rows) - 1) // g.group + 1)
            for t in range(g.n_tiles)]


def pool_strides(k_pages, v_pages, k_scales=None, v_scales=None):
    """The kv-head strides (elements) the kernel reads a pool, or a shard's
    view of one, through: (pages', scales' or 0).  K and V must share
    them."""
    if k_pages.stride() != v_pages.stride():
        raise ValueError(f"paged attention: k_pages and v_pages strides "
                         f"{k_pages.stride()} / {v_pages.stride()} differ")
    if k_scales is None:
        return k_pages.stride(0), 0
    if k_scales.stride() != v_scales.stride():
        raise ValueError(f"paged attention: k_scales and v_scales strides "
                         f"{k_scales.stride()} / {v_scales.stride()} differ")
    return k_pages.stride(0), k_scales.stride(0)


def launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           tables: torch.Tensor, lens: Optional[torch.Tensor], q_offset: int,
           total: int, *, partials: bool,
           k_scales: Optional[torch.Tensor] = None,
           v_scales: Optional[torch.Tensor] = None,
           kv_offset: int = 0, skip_null: bool = False):
    """One kernel launch.  q [B, C, H, D]; tables [B, MB] int32; decode
    passes ``lens`` [B] int32 (and may pass ``kv_offset``), prefill
    ``q_offset`` and ``total``; an int8 pool passes its scales; the pages
    (and scales) may be a shard's view of a pool, dense past the kv-head
    dim, with ``skip_null`` for its shard-local table.  Returns the
    normalized output, or the f32 partials (acc, m, l)."""
    g = geometry(q.shape, k_pages.shape, tables.shape)
    if k_pages.shape != v_pages.shape:
        raise ValueError("paged attention: k_pages and v_pages differ in shape")
    int8 = check_scales(q.dtype, k_pages, v_pages, k_scales, v_scales)
    if tables.dtype != torch.int32:
        raise ValueError(f"paged attention: tables must be int32, got {tables.dtype}")
    if kv_offset < 0 or (kv_offset and lens is None):
        raise ValueError(f"paged attention: kv_offset {kv_offset} (decode "
                         f"only, >= 0)")
    page_stride, scale_stride = pool_strides(k_pages, v_pages, k_scales,
                                             v_scales)
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages, tables=tables)
    if int8:
        tensors.update(k_scales=k_scales, v_scales=v_scales)
    if lens is not None:
        if lens.shape != (g.b,) or lens.dtype != torch.int32:
            raise ValueError(f"paged attention: lengths must be [{g.b}] int32")
        tensors["lens"] = lens
    _build.require_cuda("paged_attention",
                        views=("k_pages", "v_pages", "k_scales", "v_scales"),
                        **tensors)
    if partials:
        acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        l = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = None
        ptrs = (None, acc.data_ptr(), m.data_ptr(), l.data_ptr())
    else:
        out = torch.empty_like(q)
        ptrs = (out.data_ptr(), None, None, None)
    lib = _build.load()
    code = lib.repro_paged_attention(
        _build.dtype_code(q), q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), k_scales.data_ptr() if int8 else None,
        v_scales.data_ptr() if int8 else None, tables.data_ptr(),
        None if lens is None else lens.data_ptr(), int(q_offset), int(total),
        int(kv_offset), int(bool(skip_null)), *ptrs, g.b, g.c, g.h, g.kvh,
        page_stride, scale_stride, g.bs, g.d, g.mb, g.n_tiles,
        _build.stream_ptr(q))
    _build.check("paged_attention", code)
    return (acc, m, l) if partials else out
