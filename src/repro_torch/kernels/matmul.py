"""Weight-stationary GEMM — hand-written CUDA kernels for Hopper
(``csrc/matmul.cu``).

Replaces the TPU kernel ``src/repro/kernels/matmul.py``
(``weight_stationary_matmul``, ``pallas_call`` at :50), the paper's SRAM-PIM
lane: x [M, K] @ w [K, N] with f32 accumulation over all of K and one
rounding to ``out_dtype``.  The TPU kernel holds a [K, bn] weight panel in
VMEM across the m tiles; on the H100 a panel does not fit shared memory, so
the kernels keep the reference's grid order (m tiles inner, n panels outer)
and the panel stays in L2 across the m tiles.  No split of K and no atomics,
so two launches give the same bits.

Three routes, chosen by :func:`plan` from the shapes, the dtype and the
alignment before the launch (never a fallback on failure):

- ``"wgmma"``: bf16 whose rows TMA can load (K and N multiples of 8, both
  bases 16-byte aligned): Hopper's warpgroup MMA fed by TMA through an
  mbarrier ring, out-of-range rows and columns zero-filled by TMA;
- ``"mma_sync"``: any other bf16 call: ``mma.sync`` from registers, ragged
  tiles masked in the kernel;
- ``"ffma"``: f32, on the CUDA cores (no TF32).

The plain version is ``kernels/ref.py:matmul``; ``kernels/ops.py:matmul``
routes by the reference's rule.  This wrapper takes CUDA tensors only.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

# kernel launches through this module: all of them, and each route's
launches = 0
wgmma_launches = 0
mma_sync_launches = 0
ffma_launches = 0

# route codes of csrc/matmul.cu (Route) and the block tiles (BM, BN) each
# route's kernel is instantiated for
ROUTES = {"ffma": 0, "mma_sync": 1, "wgmma": 2}
TILES = {
    "ffma": ((64, 64),),
    "mma_sync": ((16, 32), (64, 64)),
    "wgmma": ((64, 16), (64, 32), (64, 64),
              (128, 64), (128, 128), (128, 192), (128, 256)),
}
NARROW_M = 16     # mma_sync calls with at most this many rows take its 16 x 32 tile
DECODE_M = 64     # wgmma calls with at most this many rows take one 64-row warpgroup
SMS = 132         # streaming multiprocessors of an H100 SXM
MAX_GRID_Y = 65535


class Plan(NamedTuple):
    route: str                 # a key of ROUTES
    tile: Tuple[int, int]      # the block tile (BM, BN)
    grid: Tuple[int, int]      # (m tiles, n tiles): blockIdx.x walks m, inner


def tma_loadable(k: int, n: int, aligned: bool) -> bool:
    """Whether TMA can load x [M, K] and w [K, N] in bf16: rows of a
    multiple of 16 bytes and both bases 16-byte aligned (``aligned``)."""
    return aligned and k > 0 and k % 8 == 0 and n % 8 == 0


def _wgmma_tile(m: int, n: int) -> Tuple[int, int]:
    """The wgmma tile for an [m, n] output.  Up to ``DECODE_M`` rows the work
    is streaming the weight: the widest of 64 / 32 / 16 columns that still
    gives a block an SM (16 at N 2048: 128 blocks).  Above, two 64-row
    warpgroups, and the width that covers the output in the fewest
    (waves x width): a tile's time grows with its width, plus a fixed cost
    (~32 columns' worth) for its prologue and epilogue."""
    if m <= DECODE_M:
        for bn in (64, 32, 16):
            if math.ceil(n / bn) >= SMS:
                return 64, bn
        return 64, 16
    m_tiles = math.ceil(m / 128)

    def cost(bn):
        return math.ceil(m_tiles * math.ceil(n / bn) / SMS) * (bn + 32)

    return 128, min((256, 192, 128, 64), key=cost)


def plan(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool,
         route: Optional[str] = None,
         tile: Optional[Tuple[int, int]] = None) -> Plan:
    """Route, block tile and grid of x [m, k] @ w [k, n] in ``dtype``;
    ``aligned``: both bases are 16-byte aligned.  ``route`` and ``tile``
    force a choice (tests and ``chip_smoke.py`` drive every route and tile
    at one shape); a forced choice the kernels cannot take raises."""
    if dtype == torch.float32:
        auto = "ffma"
    elif dtype == torch.bfloat16:
        auto = "wgmma" if tma_loadable(k, n, aligned) else "mma_sync"
    else:
        raise TypeError(f"weight_stationary_matmul: dtype {dtype}; the kernels "
                        f"take float32 and bfloat16")
    route = route or auto
    if route not in ROUTES:
        raise ValueError(f"weight_stationary_matmul: route {route!r}; one of "
                         f"{list(ROUTES)}")
    if (route == "ffma") != (dtype == torch.float32):
        raise ValueError(f"weight_stationary_matmul: the {route} route does "
                         f"not take {dtype}")
    if route == "wgmma" and not tma_loadable(k, n, aligned):
        raise ValueError(f"weight_stationary_matmul: the wgmma route needs K "
                         f"and N multiples of 8 and 16-byte aligned bases "
                         f"(K {k}, N {n}, aligned {aligned})")
    if tile is None:
        if route == "wgmma":
            tile = _wgmma_tile(m, n)
        elif route == "mma_sync":
            tile = (16, 32) if m <= NARROW_M else (64, 64)
        else:
            tile = (64, 64)
    tile = tuple(tile)
    if tile not in TILES[route]:
        raise ValueError(f"weight_stationary_matmul: tile {tile}; the {route} "
                         f"route has {list(TILES[route])}")
    grid = (math.ceil(m / tile[0]), math.ceil(n / tile[1]))
    if grid[1] > MAX_GRID_Y:
        raise ValueError(f"weight_stationary_matmul: N {n} needs {grid[1]} "
                         f"n tiles of {tile[1]}, over CUDA's {MAX_GRID_Y}")
    return Plan(route, tile, grid)


def weight_stationary_matmul(x: torch.Tensor, w: torch.Tensor,
                             out_dtype=None, route: Optional[str] = None,
                             tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x [M, K] @ w [K, N] -> [M, N] of ``out_dtype`` (default x's dtype);
    x and w of one dtype, bf16 or f32; the output bf16 or f32.  The route
    and tile are :func:`plan`'s, or forced through ``route`` / ``tile``."""
    global launches, wgmma_launches, mma_sync_launches, ffma_launches
    _build.require_cuda("weight_stationary_matmul", x=x, w=w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"weight_stationary_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [M, K] and [K, N]")
    if x.dtype != w.dtype:
        raise TypeError(f"weight_stationary_matmul: x {x.dtype} and w "
                        f"{w.dtype} must share a dtype")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"weight_stationary_matmul: out_dtype {out_dtype}; the "
                        f"kernel writes {list(_build.DTYPE_CODES)}")
    (m, k), n = x.shape, w.shape[1]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    p = plan(m, n, k, x.dtype, aligned, route, tile)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load()
    code = lib.repro_matmul(_build.dtype_code(x), _build.DTYPE_CODES[out_dtype],
                            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                            ROUTES[p.route], *p.tile, _build.stream_ptr(x))
    launches += 1
    if p.route == "wgmma":
        wgmma_launches += 1
    elif p.route == "mma_sync":
        mma_sync_launches += 1
    else:
        ffma_launches += 1
    _build.check("weight_stationary_matmul", code)
    return out
