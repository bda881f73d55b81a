"""Interleaved RoPE — hand-written CUDA kernel for Hopper (``csrc/rope.cu``).

Replaces the TPU kernel ``src/repro/kernels/rope.py`` (``apply_rope``,
``pallas_call`` at :52).  On the H100 it is bound by bytes: one read of x and
the int32 positions, one write.  The angle depends on (token, pair) only,
so a block forms cos/sin once for each (token, pair) of a tile of tokens,
into shared memory, and rotates every head of those tokens from there in
16-byte accesses (4 bf16 or 2 f32 pairs).  :func:`apply_rope_qk` rotates q
and k, which share positions and theta, in one launch: the model calls it
once a layer where it made two calls.  ``sign=-1`` rotates by ``-pos``: the
rotation is orthogonal, so that is its vector-Jacobian product, and the
backward makes no negated position tensor.  :func:`plan` sizes the grid from
the card.  A head dim that is not a multiple of the vector, or a tensor off
a 16-byte boundary, takes the kernel's scalar route (counted in
``launches_by_route``).  The inverse frequency follows the plain version,
``1 / theta^(j/half)``; the TPU kernel's ``exp(-ln(theta) j/half)`` differs
from it by a few ulp.

The plain version is ``kernels/ref.py:apply_rope``; ``kernels/ops.py`` sends
CPU tensors there.  These wrappers take CUDA tensors only.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

launches = 0       # kernel launches through this module
qk_launches = 0    # the launches that rotated q and k together
launches_by_route = {"vector": 0, "scalar": 0}

VEC_BYTES = 16
THREADS = 256           # the largest block (csrc kMaxThreads)
ACCESSES = 2            # accesses a thread makes in a tile, the target
MIN_BLOCK_ACCESSES = 32  # a head split stops before a block has fewer than a warp's
MAX_TILE_PAIRS = 2048   # (token, pair) angles a block keeps (16 KiB of cos/sin)
BLOCKS_PER_SM = 8       # the grid's cap: resident blocks of THREADS threads an SM


class Plan(NamedTuple):
    route: str             # "vector" (16-byte accesses) or "scalar"
    pairs: int             # pairs an access rotates
    tile: int              # tokens a block takes at a time
    heads_per_block: int   # of the q-then-k head list
    threads: int
    grid: Tuple[int, int]  # (blocks walking the tiles, the head split)


@functools.lru_cache(maxsize=1024)
def plan(tokens: int, heads: int, d: int, elem_bytes: int, n_sms: int,
         aligned: bool = True) -> Plan:
    """The launch shape for ``tokens`` tokens of ``heads`` heads (q's and
    k's together) of head dim ``d``.  A tile holds about ``ACCESSES``
    accesses a thread, but no more tokens than leave one tile an SM; while
    the tiles alone leave SMs idle (decode), a token's heads are halved over
    more blocks (grid y), down to a warp's worth of accesses a block.  The
    grid's x is at most ``BLOCKS_PER_SM`` blocks an SM, shared by the split;
    blocks walk the rest of the tiles."""
    vec = VEC_BYTES // elem_bytes
    vector = aligned and d % vec == 0
    pairs = vec // 2 if vector else 1
    half = d // 2
    per_head = half // pairs                 # accesses a head row
    per_token = max(1, heads * per_head)
    tile = max(1, min(THREADS * ACCESSES // per_token, -(-tokens // n_sms),
                      MAX_TILE_PAIRS // max(1, half)))
    tiles = max(1, -(-tokens // tile))
    hpb = max(1, heads)
    while hpb > 1 and tiles * -(-heads // hpb) < n_sms:
        nxt = -(-hpb // 2)
        if tile * nxt * per_head < MIN_BLOCK_ACCESSES:
            break
        hpb = nxt
    split = max(1, -(-heads // hpb))
    threads = min(THREADS, max(32, -(-tile * hpb * per_head // 32) * 32))
    grid_x = min(tiles, max(1, n_sms * BLOCKS_PER_SM // split))
    return Plan("vector" if vector else "scalar", pairs, tile, hpb, threads,
                (grid_x, split))


def _positions(positions: torch.Tensor, b: int, s: int, name: str) -> torch.Tensor:
    if positions.dim() == 1:
        positions = positions[None, :].expand(b, s)
    if positions.shape != (b, s) or positions.dtype != torch.int32:
        raise ValueError(f"{name}: positions must be [{b}, {s}] int32, "
                         f"got {tuple(positions.shape)} {positions.dtype}")
    return positions.contiguous()


def _rope(name: str, q: torch.Tensor, k: Optional[torch.Tensor],
          positions: torch.Tensor, theta: float, sign: int):
    global launches, qk_launches
    b, s, hq, d = q.shape
    if d % 2:
        raise ValueError(f"{name}: head dim {d} must be even")
    if sign not in (1, -1):
        raise ValueError(f"{name}: sign must be 1 or -1, got {sign}")
    if k is not None and (k.dim() != 4 or k.shape[:2] != (b, s)
                          or k.shape[3] != d or k.dtype != q.dtype):
        raise ValueError(f"{name}: q {tuple(q.shape)} {q.dtype} and k "
                         f"{tuple(k.shape)} {k.dtype} do not share tokens, "
                         f"head dim and dtype")
    positions = _positions(positions, b, s, name)
    tensors = dict(q=q, positions=positions, **({} if k is None else dict(k=k)))
    _build.require_cuda(name, **tensors)
    hk = 0 if k is None else k.shape[2]
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (q, k) if t is not None)
    p = plan(b * s, hq + hk, d, q.element_size(), _build.n_sms(q.device), aligned)
    oq = torch.empty_like(q)
    ok = None if k is None else torch.empty_like(k)
    lib = _build.load()
    code = lib.repro_rope(_build.dtype_code(q), q.data_ptr(),
                          None if k is None else k.data_ptr(),
                          positions.data_ptr(), oq.data_ptr(),
                          None if ok is None else ok.data_ptr(), b * s, hq, hk,
                          d, float(theta), sign, p.pairs, p.tile,
                          p.heads_per_block, p.threads, *p.grid,
                          _build.stream_ptr(q))
    launches += 1
    if k is not None:
        qk_launches += 1
    launches_by_route[p.route] += 1
    _build.check(name, code)
    return oq, ok


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0, sign: int = 1) -> torch.Tensor:
    """x [B, S, H, D]; positions [B, S] or [S] int32 -> x rotated by
    ``sign * positions``."""
    return _rope("apply_rope", x, None, positions, theta, sign)[0]


def apply_rope_qk(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                  theta: float = 10_000.0, sign: int = 1):
    """q [B, S, H, D] and k [B, S, KvH, D] rotated by ``sign * positions``
    ([B, S] or [S] int32) in one launch -> (q', k')."""
    return _rope("apply_rope_qk", q, k, positions, theta, sign)
