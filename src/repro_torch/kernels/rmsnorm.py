"""Fused RMSNorm and its backward — hand-written CUDA kernels for Hopper
(``csrc/rmsnorm.cu``).

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py`` (``rmsnorm``,
``pallas_call`` at :51).  On the H100 it is bound by bytes — one read of x,
one write of the output — and the kernel makes exactly that traffic: each
row lives in registers, read once in 16-byte vectors (8 bf16 or 4 f32 a
thread a step) beside the same columns of ``w`` (loaded once a thread and
kept across the rows it walks), its sum of squares reduced by warp shuffles
(plus one shared-memory step where a row spans warps), then scaled from the
registers and stored as 16-byte vectors.  :func:`plan` chooses the shape of
the work from the width and the card: as many threads a row as leave each
one or two vectors (a whole block a row at the models' widths, several
rows a block for narrow ones), the grid within a wave of the card's
resident blocks.
A width that is not a multiple of the vector, or a base off a 16-byte
boundary, takes the kernel's scalar route (chosen by the plan, counted in
``launches_by_route``).  The TPU kernel's ``curry_rounds`` form (the
paper's Curry-ALU rsqrt: Newton steps from a bf16-rounded seed) is the same
kernel with a runtime round count, forward only; it has no caller on a model
path and its launches are counted apart (``curry_launches``).

The backward (no TPU kernel: the JAX package differentiates its oracle) is
bound by bytes too: x and dy read once, dx written once.  Its rows pass
holds the row in registers as the forward does (x and dy loaded once as
16-byte vectors and kept across the two sums and the dx store; ``w`` and the
thread's f32 ``dw`` column partials kept across every row it walks), and
:func:`bwd_plan` shapes it as :func:`plan` shapes the forward, with blocks
that own contiguous runs of rows and a grid of at most one wave of
``BWD_SM_THREADS`` an SM.  ``dw`` is a column sum over all rows, taken
without atomics: each block writes its f32 partials, then a column pass
gives each block 32 columns whose warps sum fixed slices of the partials,
added in order, so the result does not depend on scheduling.  Odd widths
and bases off 16 bytes take the scalar route here too
(``bwd_launches_by_route``).

The plain versions are ``kernels/ref.py:rmsnorm`` and ``rmsnorm_bwd``;
``kernels/ops.py`` sends CPU tensors there.  These wrappers take CUDA
tensors only.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0       # forward kernel launches through this module
curry_launches = 0  # launches of the curry_rounds form
bwd_launches = 0   # backward launches (one per rmsnorm_bwd call)
launches_by_route = {"vector": 0, "scalar": 0}   # every forward launch
bwd_launches_by_route = {"vector": 0, "scalar": 0}   # every backward launch

VEC_BYTES = 16        # one access a thread: 8 bf16 or 4 f32
PER_THREAD = (1, 2, 4)  # vectors a thread holds (the kernel's instantiations)
BLOCK = 256           # threads of a block that holds several rows
MAX_THREADS = 512     # threads of a block that holds one row (csrc kMaxThreads)
BLOCKS_PER_SM = 8     # resident blocks of BLOCK threads an SM takes (2048 threads)
BWD_THREADS = 512     # threads of a backward block that holds several rows
BWD_SM_THREADS = 1024  # backward threads an SM takes in the plan's wave


class Plan(NamedTuple):
    route: str         # "vector" (16-byte accesses, the row in registers) or "scalar"
    per: int           # vectors a thread holds; 0 on the scalar route
    row_threads: int   # threads that share a row (a power of two)
    threads: int       # threads of a block: threads // row_threads rows at a time
    grid: int          # blocks; block b takes row groups b, b + grid, ...


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


@functools.lru_cache(maxsize=1024)
def plan(rows: int, d: int, elem_bytes: int, aligned: bool, n_sms: int) -> Plan:
    """The launch shape of :func:`rmsnorm` for ``rows`` rows of ``d``
    elements of ``elem_bytes`` bytes; ``aligned``: x and w start on a
    16-byte boundary.  A row takes the largest power of two of threads, up
    to ``MAX_THREADS``, that leaves none without a vector (one or two
    vectors a thread; four for f32 rows past 4096 elements): a whole block
    a row at every model width, several rows a block only for narrow rows.
    Fewer registers a thread keep more blocks resident, which timed faster
    than a warp or two a row holding four vectors a thread
    (``tools/norm_rope_readings.py``'s sweep).  The grid is at most
    ``BLOCKS_PER_SM`` blocks an SM; blocks walk the rest."""
    vec = VEC_BYTES // elem_bytes
    vector = aligned and d % vec == 0 and d // vec <= PER_THREAD[-1] * MAX_THREADS
    # vectors a row; the scalar route spreads as many threads over its elements
    units = d // vec if vector else -(-d // vec)
    t = min(MAX_THREADS, _pow2_floor(units))
    per = next(p for p in PER_THREAD if p * t >= units) if vector else 0
    threads = t if t >= BLOCK else min(BLOCK, max(32, -(-rows * t // 32) * 32))
    groups = threads // t
    grid = max(1, min(-(-rows // groups), n_sms * BLOCKS_PER_SM))
    return Plan("vector" if vector else "scalar", per, t, threads, grid)


class BwdPlan(NamedTuple):
    route: str           # "vector" (16-byte accesses, the row in registers) or "scalar"
    per: int             # vectors a thread holds; 0 on the scalar route
    row_threads: int     # threads that share a row (a power of two)
    threads: int         # threads of a block: threads // row_threads rows at a time
    grid: int            # blocks, and rows of dw partials
    rows_per_block: int  # block b owns rows [b rows_per_block, (b + 1) rows_per_block)


@functools.lru_cache(maxsize=1024)
def bwd_plan(rows: int, d: int, elem_bytes: int, aligned: bool, n_sms: int) -> BwdPlan:
    """The launch shape of :func:`rmsnorm_bwd`'s rows pass for ``rows``
    rows of ``d`` elements of ``elem_bytes`` bytes; ``aligned``: x, w, dy
    and dx start on a 16-byte boundary.  A row takes threads as the
    forward's :func:`plan` gives them (each one or two vectors of x and of
    dy); a block ``BWD_THREADS`` (several rows at a time for narrow rows;
    fewer threads when the rows do not fill it); the grid at most one wave
    of ``BWD_SM_THREADS`` an SM, each block owning an equal contiguous run
    of rows, so the dw partials number the grid (~264 rows on an H100, not
    one a row)."""
    vec = VEC_BYTES // elem_bytes
    vector = aligned and d % vec == 0 and d // vec <= PER_THREAD[-1] * MAX_THREADS
    units = d // vec if vector else -(-d // vec)
    t = min(MAX_THREADS, _pow2_floor(units))
    per = next(p for p in PER_THREAD if p * t >= units) if vector else 0
    threads = t if t >= BWD_THREADS else min(BWD_THREADS, max(32, -(-rows * t // 32) * 32))
    groups = threads // t
    cap = max(1, n_sms * BWD_SM_THREADS // threads)
    rows_per_block = -(-rows // max(1, min(-(-rows // groups), cap)))
    return BwdPlan("vector" if vector else "scalar", per, t, threads,
                   -(-rows // rows_per_block), rows_per_block)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            curry_rounds: int = 0) -> torch.Tensor:
    """x [..., D]; w [D] (x's dtype) -> normalized x; ``curry_rounds``
    Newton steps replace the native rsqrt when nonzero."""
    global launches, curry_launches
    _build.require_cuda("rmsnorm", x=x, w=w)
    d = x.shape[-1]
    if w.shape != (d,) or w.dtype != x.dtype:
        raise ValueError(f"rmsnorm: w must be [{d}] {x.dtype}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    aligned = x.data_ptr() % VEC_BYTES == 0 and w.data_ptr() % VEC_BYTES == 0
    p = plan(rows, d, x.element_size(), aligned, _build.n_sms(x.device))
    lib = _build.load()
    code = lib.repro_rmsnorm(_build.dtype_code(x), x.data_ptr(), w.data_ptr(),
                             out.data_ptr(), rows, d, float(eps),
                             int(curry_rounds), p.per, p.row_threads,
                             p.threads, p.grid, _build.stream_ptr(x))
    if curry_rounds:
        curry_launches += 1
    else:
        launches += 1
    launches_by_route[p.route] += 1
    _build.check("rmsnorm", code)
    return out


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5):
    """Gradients (dx, dw) of :func:`rmsnorm` for the output gradient dy."""
    global bwd_launches
    _build.require_cuda("rmsnorm_bwd", x=x, w=w, dy=dy)
    d = x.shape[-1]
    if w.shape != (d,) or w.dtype != x.dtype or dy.shape != x.shape \
            or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)} {x.dtype}, w "
                         f"{tuple(w.shape)} {w.dtype}, dy {tuple(dy.shape)} "
                         f"{dy.dtype} do not match")
    rows = x.numel() // d
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (x, w, dy, dx))
    p = bwd_plan(rows, d, x.element_size(), aligned, _build.n_sms(x.device))
    part = torch.empty((p.grid, d), dtype=torch.float32, device=x.device)
    lib = _build.load()
    code = lib.repro_rmsnorm_bwd(_build.dtype_code(x), x.data_ptr(),
                                 w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                 dw.data_ptr(), part.data_ptr(), rows, d,
                                 float(eps), p.per, p.row_threads, p.threads,
                                 p.grid, p.rows_per_block, _build.stream_ptr(x))
    bwd_launches += 1
    bwd_launches_by_route[p.route] += 1
    _build.check("rmsnorm_bwd", code)
    return dx, dw
