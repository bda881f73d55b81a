"""Host side of the paged-attention CUDA kernels, shared by
``decode_attention.py`` and ``prefill_attention.py``: the paged prefill
(``csrc/paged_attention.cu``, :func:`launch`) and the split plan of the
flash-decoding kernel (``csrc/decode_attention.cu``, :func:`decode_plan`).

The prefill kernel reads queries in their natural ``[B, C, H, D]`` layout
and writes outputs in the same layout, so the host does no padding and no
transposes: a tile of query rows of one (sequence, kv head) is cut out by
index arithmetic inside the kernel, ``TC_ROWS`` rows for bf16 queries (the
tensor-core form) and ``ROWS`` for f32 (the CUDA-core form), as
:func:`prefill_rows` says.  :func:`geometry`, :func:`check_scales`,
:func:`tile_key_ends`, :func:`owned_pages`, :func:`stage_positions`,
:func:`decode_plan` and :func:`split_key_ranges` are the host-side parts
that the CPU tests reach: argument checks, tile counts, the split plan, and
the key ranges, page lists and stages the kernels compute for themselves.

An int8 pool passes ``k_scales`` / ``v_scales`` [KvH, NB] f32, one scale
per (kv head, page) (q and the output keep their f32 or bf16 type): the
bf16 prefill widens the int8 pages to bf16 and applies the scales to its
score and P columns, the f32 prefill and decode dequantize each value as
they stage it.

A sequence-sharded pool passes each shard's view of the pool,
``pages[:, s*nbl:(s+1)*nbl]`` (and the same slice of the scales), with the
shard-local table and ``skip_null``: the kernel reads the view through its
kv-head stride, no copy, and skips the keys of zero table entries (the bf16
prefill walks only the pages the shard owns).  Decode may shift key
positions by ``kv_offset``.

Decode splits each (sequence, kv head)'s keys over the blocks of a thread
block cluster: :func:`decode_plan` picks the split from shapes alone (never
from the lengths, which would cost a host sync every step), and
:func:`split_key_ranges` mirrors the range each block walks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build

ROWS = 16                      # f32 prefill: query rows per block (csrc: kRows)
TC_ROWS = 64                   # bf16 prefill: query rows per block (kTcRows)
PREFILL_STAGE = 64             # bf16 prefill: keys of a stage (kStage)
HEAD_DIMS = (16, 64, 112, 128)  # head dims the kernels are instantiated for
#                                 (the reduced configs, every full-width
#                                 dense config of the registry, zamba2-7b's
#                                 112: 7 k-steps and 14 n-tiles of the bf16
#                                 prefill's mma.sync, 4 dims a lane of the
#                                 decode's first 28 lanes)

# the flash-decoding kernel (csrc/decode_attention.cu)
DECODE_ROWS = 8        # query rows of one kv head a block holds (kMaxRows)
DECODE_WARPS = 4       # warps of a block, each walking 32-key stages (kWarps)
STAGE_KEYS = 32        # keys of a stage, and the slab's split grain (kKeys)
MAX_SPLIT = 8          # blocks of a cluster: the portable cluster size
BLOCKS_PER_SM = 4      # the grid a plan aims at: one wave of resident blocks
MAX_GRID_YZ = 65535    # CUDA's limit on gridDim.y and gridDim.z

# the decode kernel's tensor-core form (flash_decode_tc_kernel): bf16
# queries at these head dims (decode_form says which shapes take it)
TC_DECODE_DIMS = (64, 112, 128)
TC_STAGE_KEYS = 16     # keys of a stage: one k16 step of P V (kTcKeys)
TC_SPLIT_KEYS = 256    # keys a split aims at


@dataclass(frozen=True)
class Geometry:
    b: int
    c: int
    h: int
    kvh: int
    bs: int
    d: int
    mb: int
    n_tiles: int     # row tiles per (sequence, kv head): ceil(C*G / rows)
    rows: int = ROWS   # query rows of a tile (prefill_rows of q's dtype)

    @property
    def group(self) -> int:
        return self.h // self.kvh


def prefill_rows(dtype) -> int:
    """Query rows of a prefill tile: ``TC_ROWS`` for bf16 queries (the
    tensor-core form), ``ROWS`` for f32 (the CUDA-core form)."""
    return TC_ROWS if dtype == torch.bfloat16 else ROWS


def geometry(q_shape, pages_shape, table_shape, rows: int = ROWS) -> Geometry:
    """Validate shapes; q [B, C, H, D], pages [KvH, NB, BS, D], table [B,
    MB]; the prefill's tiles of ``rows`` query rows."""
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
                    n_tiles=-(-(c * (h // kvh)) // rows), rows=rows)


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
    """Keys ``[0, end)`` each prefill row tile walks — the kernel's tile_end:
    ``min(total, q_offset + last position of the tile + 1)``.  ``total`` is
    the live KV rows, already clamped to ``MB * BS``; the tile reads
    ``ceil(end / BS)`` pages (the TPU kernel's per-q-tile live-page clamp)."""
    n_rows = g.c * g.group
    return [min(total, q_offset + (min((t + 1) * g.rows, n_rows) - 1) // g.group + 1)
            for t in range(g.n_tiles)]


def owned_pages(table, end: int, bs: int,
                skip_null: bool) -> List[Tuple[int, int]]:
    """The bf16 prefill's page list for a tile that walks the keys ``[0,
    end)``: ``(page id, table index)`` of the table prefix ``[0, ceil(end /
    BS))`` in table order, under ``skip_null`` only the nonzero entries (the
    pages this shard owns) -- the kernel's ballot-and-popc compaction."""
    n_prefix = -(-end // bs) if end > 0 else 0
    return [(int(table[i]), i) for i in range(n_prefix)
            if not skip_null or int(table[i]) != 0]


def stage_positions(pages: List[Tuple[int, int]], end: int,
                    bs: int) -> List[List[int]]:
    """The logical key positions the bf16 prefill stages, in walk order:
    the listed pages' keys page after page, cut at ``end`` (only the last
    page can reach past it), in stages of ``PREFILL_STAGE`` keys (the last
    one short)."""
    walk = [i * bs + r for _, i in pages for r in range(bs) if i * bs + r < end]
    return [walk[s:s + PREFILL_STAGE] for s in range(0, len(walk), PREFILL_STAGE)]


@dataclass(frozen=True)
class DecodePlan:
    keys: int                  # table keys (MB * BS) or slab rows (Sk)
    n_split: int               # blocks of a cluster, one key range each
    split_keys: int            # keys of a range: a multiple of the grain
    row_tiles: int             # row tiles of a kv head's G query rows
    grid: Tuple[int, int, int]       # (n_split, KvH * row_tiles, B)
    cluster: Tuple[int, int, int]    # (n_split, 1, 1)


def decode_form(dtype, d: int, g: int) -> str:
    """Which form of the decode kernel a call takes, from the query dtype,
    head dim and group G = H / KvH: ``"tc"`` (tensor cores) for bf16
    queries at head dim 112 or 128, and at 64 with grouped KV (G > 1);
    ``"cuda"`` (the CUDA-core form) for f32 queries and for G = 1 at head
    dims up to 64, where it stays."""
    if dtype == torch.bfloat16 and (d in (112, 128) or (d == 64 and g > 1)):
        return "tc"
    return "cuda"


def decode_plan(b: int, kvh: int, g: int, keys: int, grain: int,
                n_sm: int) -> DecodePlan:
    """The flash-decoding kernel's split, from shapes alone: B sequences,
    KvH kv heads of G query heads, ``keys`` keys a sequence (MB * BS on the
    pool, Sk on the slab), cut into ``n_split <= MAX_SPLIT`` ranges of
    ``split_keys``, a multiple of ``grain`` (BS on the pool, so a page lies
    in one range; STAGE_KEYS on the slab).  It takes as many splits as keep
    the grid within BLOCKS_PER_SM blocks an SM of ``n_sm`` (one wave: each
    wave of blocks costs a chain of memory latencies), and none shorter than
    one stage a warp."""
    if min(b, kvh, g, keys, grain, n_sm) <= 0:
        raise ValueError(f"decode plan: b {b}, kvh {kvh}, g {g}, keys {keys}, "
                         f"grain {grain}, n_sm {n_sm} must be positive")
    row_tiles = -(-g // DECODE_ROWS)
    if kvh * row_tiles > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"decode plan: grid ({kvh * row_tiles}, {b}) past "
                         f"CUDA's {MAX_GRID_YZ}")
    base = b * kvh * row_tiles
    want = min(MAX_SPLIT, -(-keys // (DECODE_WARPS * STAGE_KEYS)),
               BLOCKS_PER_SM * n_sm // base)
    split = -(-keys // max(want, 1))
    split = -(-split // grain) * grain
    n_split = -(-keys // split)
    return DecodePlan(keys, n_split, split, row_tiles,
                      (n_split, kvh * row_tiles, b), (n_split, 1, 1))


def tc_decode_plan(b: int, kvh: int, g: int, d: int, keys: int,
                   grain: int) -> DecodePlan:
    """The tensor-core form's split, from shapes alone: as many ranges (a
    multiple of ``grain`` keys each) as TC_SPLIT_KEYS-key ranges cover the
    cache, at most MAX_SPLIT; row tiles of 8 rows whatever G.  A sweep of
    1-8 splits at the rows 1g, 1o, 1h, 7o, 7h and granite-3-2b's G 4 slab
    (tools/decode_readings.py --sweep, H100 at 700 W) put this rule within
    3% of the best at each, and within 6% at one sequence of 1 k or 32 k
    keys and at 8 of up to 32 k (rows 1g, 1o, 1h; where the card's SM count
    would add splits, at one short sequence, it gained at most those 6%); a
    rule that took the most splits one wave of blocks allows, as
    :func:`decode_plan` does, read up to 16% slower (row 1g)."""
    if min(b, kvh, g, keys, grain) <= 0:
        raise ValueError(f"decode plan: b {b}, kvh {kvh}, g {g}, keys {keys}, "
                         f"grain {grain} must be positive")
    if d not in TC_DECODE_DIMS:
        raise ValueError(f"decode plan: head dim {d} not in {TC_DECODE_DIMS}")
    row_tiles = -(-g // DECODE_ROWS)
    if kvh * row_tiles > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"decode plan: grid ({kvh * row_tiles}, {b}) past "
                         f"CUDA's {MAX_GRID_YZ}")
    want = min(MAX_SPLIT, -(-keys // TC_SPLIT_KEYS))
    split = -(-(-(-keys // want)) // grain) * grain
    n_split = -(-keys // split)
    return DecodePlan(keys, n_split, split, row_tiles,
                      (n_split, kvh * row_tiles, b), (n_split, 1, 1))


def split_key_ranges(plan: DecodePlan, length: Optional[int],
                     kv_offset: int = 0) -> List[Tuple[int, int]]:
    """The table keys (slab rows) ``[start, stop)`` each block of a cluster
    walks for one sequence of ``length`` (None: every key) whose key 0 sits
    at global position ``kv_offset`` — the kernel's range arithmetic:
    ``end = min(length - kv_offset, keys)``, block ``i`` walks ``[i *
    split_keys, min((i + 1) * split_keys, end))``; an empty range is
    ``(start, start)``."""
    end = plan.keys if length is None else min(plan.keys, length - kv_offset)
    out = []
    for i in range(plan.n_split):
        start = i * plan.split_keys
        out.append((start, max(start, min(start + plan.split_keys, end))))
    return out


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
           tables: torch.Tensor, q_offset: int, total: int, *, partials: bool,
           k_scales: Optional[torch.Tensor] = None,
           v_scales: Optional[torch.Tensor] = None, skip_null: bool = False,
           window: int = 0):
    """One launch of the paged prefill kernel.  q [B, C, H, D]; tables [B,
    MB] int32; ``q_offset`` and ``total`` (the live KV rows, clamped to MB *
    BS); ``window`` > 0 keeps only the keys ``kpos > qpos - window`` (0:
    none); an int8 pool passes its scales; the pages (and scales) may be a
    shard's view of a pool, dense past the kv-head dim, with ``skip_null``
    for its shard-local table.  bf16 queries run the tensor-core form, whose
    q and pages must start 16-byte aligned.  Returns the normalized output,
    or the f32 partials (acc, m, l)."""
    g = geometry(q.shape, k_pages.shape, tables.shape, prefill_rows(q.dtype))
    if k_pages.shape != v_pages.shape:
        raise ValueError("paged attention: k_pages and v_pages differ in shape")
    int8 = check_scales(q.dtype, k_pages, v_pages, k_scales, v_scales)
    if tables.dtype != torch.int32:
        raise ValueError(f"paged attention: tables must be int32, got {tables.dtype}")
    page_stride, scale_stride = pool_strides(k_pages, v_pages, k_scales,
                                             v_scales)
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages, tables=tables)
    if int8:
        tensors.update(k_scales=k_scales, v_scales=v_scales)
    _build.require_cuda("paged_attention",
                        views=("k_pages", "v_pages", "k_scales", "v_scales"),
                        **tensors)
    if q.dtype == torch.bfloat16:
        for arg, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
            if t.data_ptr() % 16:
                raise ValueError(f"paged attention: {arg} must be 16-byte "
                                 f"aligned (the bf16 kernel reads it by "
                                 f"cp.async)")
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
        int(q_offset), int(total), int(bool(skip_null)), int(window), *ptrs,
        g.b, g.c,
        g.h, g.kvh, page_stride, scale_stride, g.bs, g.d, g.mb, g.n_tiles,
        _build.stream_ptr(q))
    _build.check("paged_attention", code)
    return (acc, m, l) if partials else out
