"""Port, silu_mul and rmsnorm-backward launch plans on the CPU.

``kernels/swiglu.py:plan`` and ``kernels/rmsnorm.py:bwd_plan`` choose the
shape of the CUDA kernels' work from the shapes and the card's SM count.
The card is not here, so these tests mirror each kernel's walk
(``csrc/swiglu.cu``, ``csrc/rmsnorm.cu``) over the plan and check that every
element, row and column is visited exactly once, at every width the port's
configs reach, that each backward block owns a contiguous run of rows, and
that the grid stays within the waves the plan promises.  A numpy mirror of
the backward's dw order (row groups, block partials, the column pass's
fixed slices) is held to ``jax.vjp`` of the JAX oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as krn  # noqa: E402
from repro_torch.kernels import swiglu as ksw  # noqa: E402

BWD_TOL = dict(rtol=1e-4, atol=1e-4)
H100_SMS = 132
SMS = (132, 114, 78, 16)
ROWS = (1, 8, 512, 8192)
# silu_mul's widths: the reduced configs' d_ff, the hidden widths of the
# full configs, the gated norm's silu(z) * y at zamba2-7b's d_inner
HIDDEN = (96, 5632, 7168, 8192, 8960, 9216, 14336)
# the rmsnorm backward's widths: the reduced configs, d_model, d_inner
NORM_WIDTHS = (64, 2048, 2560, 3072, 3584, 4096, 5120, 6144, 7168, 8192)
NORM_ROWS = (1, 8, 600, 8192)
ELEM_BYTES = (2, 4)              # bf16, f32
COL_WARPS = 32                   # warps of a column-pass block (csrc/rmsnorm.cu kColWarps)


# ---------------------------------------------------------------------------
# silu_mul
# ---------------------------------------------------------------------------

def _strided_visits(total, threads, lo, hi):
    """Visits of units [lo, hi) by a walk of ``threads`` threads: at step j
    thread t takes unit t + j threads while it is below ``total``
    (csrc/swiglu.cu's loops over vectors and over elements).  Only the
    steps that can reach [lo, hi) are walked."""
    counts = np.zeros(hi - lo, np.int64)
    t = np.arange(threads)
    for j in range(lo // threads, (hi - 1) // threads + 1):
        v = t + j * threads
        sel = (v < total) & (v >= lo) & (v < hi)
        counts += np.bincount(v[sel] - lo, minlength=hi - lo)
    return counts


def _silu_windows(p, n, elem_bytes):
    """(start, visits) of the element windows the check covers: all of a
    short walk, else its first and last two steps; plus the elements past
    the last whole vector, one a thread (vector route; the element and
    scalar routes walk single elements)."""
    threads = p.grid * p.threads
    vec = ksw.VEC_BYTES // elem_bytes if p.route == "vector" else 1
    units = n // vec
    span = 2 * threads
    windows = [(0, units)] if units <= 2 * span else \
        [(0, span), (units - span, units)]
    out = []
    for lo, hi in windows:
        v = _strided_visits(units, threads, lo, hi)
        out.append((lo * vec, np.repeat(v, vec)))
    if vec > 1:
        tail = units * vec + np.arange(threads)
        tail = tail[tail < n]
        out.append((units * vec, np.bincount(tail - units * vec,
                                             minlength=n - units * vec)))
    return out


def _check_silu_plan(p, n, elem_bytes, n_sms):
    assert p.threads in ksw.BLOCKS and p.threads % 32 == 0
    assert 1 <= p.grid <= ksw.WAVES * n_sms * ksw.THREADS_PER_SM // p.threads
    assert p.route in ksw.launches_by_route
    if p.route == "vector":
        # the tail's threads exist
        assert p.grid * p.threads >= n % (ksw.VEC_BYTES // elem_bytes)
    for _, visits in _silu_windows(p, n, elem_bytes):
        assert (visits == 1).all()


def _route(n):
    """The route an aligned call of n elements takes on an H100."""
    return "vector" if n > H100_SMS * ksw.THREADS_PER_SM else "element"


@pytest.mark.parametrize("elem_bytes", ELEM_BYTES)
@pytest.mark.parametrize("width", HIDDEN)
@pytest.mark.parametrize("rows", ROWS)
def test_silu_plan_covers_each_element_once(rows, width, elem_bytes):
    n = rows * width
    p = ksw.plan(n, elem_bytes, True, H100_SMS)
    assert p.route == _route(n)
    _check_silu_plan(p, n, elem_bytes, H100_SMS)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 4, 5, 5 * 5631, 3 * 7168 + 3,
                               H100_SMS * 2048 + 1, 61 * 5631, 300003])
@pytest.mark.parametrize("elem_bytes", ELEM_BYTES)
def test_silu_plan_odd_counts_and_the_tail(n, elem_bytes):
    """Counts below, at and past one vector and off the vector, within
    one wave of the card's threads (the element route) and past it (the
    whole vectors on the vector route, the rest one a thread): each
    element once."""
    p = ksw.plan(n, elem_bytes, True, H100_SMS)
    assert p.route == _route(n)
    _check_silu_plan(p, n, elem_bytes, H100_SMS)
    covered = np.zeros(n, np.int64)
    for lo, visits in _silu_windows(p, n, elem_bytes):
        covered[lo:lo + len(visits)] += visits
    assert (covered == 1).all()


@pytest.mark.parametrize("n_sms", SMS)
def test_silu_plan_grid_within_the_waves(n_sms):
    for rows in ROWS + (3, 100):
        for width in HIDDEN + (5631,):
            for eb in ELEM_BYTES:
                for aligned in (True, False):
                    n = rows * width
                    p = ksw.plan(n, eb, aligned, n_sms)
                    assert p.route == ("scalar" if not aligned else "vector"
                                       if n > n_sms * ksw.THREADS_PER_SM else "element")
                    _check_silu_plan(p, n, eb, n_sms)


def test_silu_plan_spreads_small_work_over_the_sms():
    """Decode's [8, 5632] in bf16: one element a thread over 176 blocks
    of 256, not 22 blocks of vectors; a prefill chunk and a training batch
    take vectors in blocks of 256, the batch a grid of WAVES waves whose
    threads walk on; a handful of elements one block of 64."""
    p = ksw.plan(8 * 5632, 2, True, H100_SMS)
    assert (p.route, p.threads, p.grid) == ("element", 256, 176)
    assert ksw.plan(7, 2, True, H100_SMS) == ksw.Plan("element", 64, 1)
    chunk = ksw.plan(512 * 5632, 2, True, H100_SMS)
    assert (chunk.route, chunk.threads) == ("vector", 256)
    big = ksw.plan(8192 * 8192, 2, True, H100_SMS)
    assert (big.route, big.threads) == ("vector", 256)
    assert big.grid == ksw.WAVES * H100_SMS * ksw.THREADS_PER_SM // 256
    assert ksw.plan(8192 * 8192, 2, True, 16).grid == \
        ksw.WAVES * 16 * ksw.THREADS_PER_SM // 256


def test_silu_plan_scalar_route():
    """A base off a 16-byte boundary: the scalar route, one element a
    thread a step, every element once."""
    for n, eb in ((512 * 5632, 2), (8 * 5632, 4), (7, 2)):
        p = ksw.plan(n, eb, False, H100_SMS)
        assert p.route == "scalar"
        _check_silu_plan(p, n, eb, H100_SMS)


@pytest.mark.parametrize("n_sms", SMS)
def test_stride_grid_from_the_card(n_sms):
    """The grid-stride loops (silu_mul backward, the Mamba2 backward's last
    pass): as many blocks as the items need, at most STRIDE_BLOCKS_PER_SM
    an SM; on 132 SMs the grid the kernels took before it came from the
    card (4224 blocks at most)."""
    for n in (1, 255, 256, 257, 8192 * 8192, 2 * 4096 * 64):
        g = _build.stride_grid(n, 256, n_sms)
        assert g == max(1, min(-(-n // 256), n_sms * _build.STRIDE_BLOCKS_PER_SM))
        if n_sms == 132:
            assert g == min(-(-n // 256), 132 * 32)


# ---------------------------------------------------------------------------
# the rmsnorm backward
# ---------------------------------------------------------------------------

def _bwd_rows(p, rows):
    """Rows visited by the rows pass: block b owns [b rpb, (b + 1) rpb) and
    its row group g takes rows r0 + g, r0 + g + groups, ...; also whether
    every block's rows are one contiguous run."""
    groups = p.threads // p.row_threads
    visits = np.zeros(rows, np.int64)
    contiguous = True
    for b in range(p.grid):
        r0, r1 = b * p.rows_per_block, min((b + 1) * p.rows_per_block, rows)
        steps = max(0, -(-(r1 - r0) // groups))
        mine = (r0 + np.arange(steps)[:, None] * groups + np.arange(groups)[None, :]).ravel()
        mine = np.sort(mine[mine < r1])
        contiguous &= bool(len(mine) == 0 or (np.diff(mine) == 1).all())
        visits += np.bincount(mine, minlength=rows)
    return visits, contiguous


def _bwd_columns(p, d, elem_bytes):
    """Elements of a row visited by its row_threads threads: on the vector
    route thread l holds vectors l + k row_threads (k < per), each 16 bytes;
    on the scalar route it strides over the elements."""
    lanes = np.arange(p.row_threads)[:, None]
    if p.route == "scalar":
        visits = lanes + p.row_threads * np.arange(-(-d // p.row_threads))[None, :]
    else:
        vec = krn.VEC_BYTES // elem_bytes
        i = (lanes + p.row_threads * np.arange(p.per)[None, :]).ravel()
        i = i[i < d // vec]
        visits = i[:, None] * vec + np.arange(vec)[None, :]
    visits = visits.ravel()
    return np.bincount(visits[visits < d], minlength=d)


def _check_bwd_plan(p, rows, d, elem_bytes, n_sms):
    assert p.row_threads & (p.row_threads - 1) == 0
    assert p.threads % 32 == 0 and p.threads % p.row_threads == 0
    assert p.threads <= krn.MAX_THREADS
    groups = p.threads // p.row_threads
    assert 1 <= p.grid <= max(1, n_sms * krn.BWD_SM_THREADS // p.threads)
    assert p.grid * p.rows_per_block >= rows > (p.grid - 1) * p.rows_per_block
    if p.route == "vector":
        assert p.per in krn.PER_THREAD
        assert p.per * p.row_threads * (krn.VEC_BYTES // elem_bytes) >= d
        smem = groups * d * 4 if groups > 1 else 0
    else:
        assert p.per == 0
        smem = groups * d * 4
    assert smem <= 227 * 1024
    visits, contiguous = _bwd_rows(p, rows)
    assert (visits == 1).all() and contiguous


@pytest.mark.parametrize("elem_bytes", ELEM_BYTES)
@pytest.mark.parametrize("d", NORM_WIDTHS)
@pytest.mark.parametrize("rows", NORM_ROWS)
def test_bwd_plan_covers_each_row_and_column_once(rows, d, elem_bytes):
    p = krn.bwd_plan(rows, d, elem_bytes, True, H100_SMS)
    assert p.route == "vector"
    _check_bwd_plan(p, rows, d, elem_bytes, H100_SMS)
    assert (_bwd_columns(p, d, elem_bytes) == 1).all()


@pytest.mark.parametrize("n_sms", SMS)
def test_bwd_plan_grid_within_the_waves(n_sms):
    for rows in NORM_ROWS + (3, 100, 20000):
        for d in NORM_WIDTHS + (2049, 16384, 40000):
            for eb in ELEM_BYTES:
                for aligned in (True, False):
                    p = krn.bwd_plan(rows, d, eb, aligned, n_sms)
                    _check_bwd_plan(p, rows, d, eb, n_sms)
                    if d <= 8192:
                        assert (_bwd_columns(p, d, eb) == 1).all()


def test_bwd_plan_routes_and_partials():
    """Odd widths, a base off 16 bytes and a row past the registers take
    the scalar route; at granite-3-2b's training rows the partials number
    at most BWD_SM_THREADS / threads an SM (256 on an H100), not one a
    row."""
    for d, eb in ((2049, 2), (2050, 2), (6, 4), (2050, 4)):
        p = krn.bwd_plan(600, d, eb, True, H100_SMS)
        assert p.route == "scalar" and (_bwd_columns(p, d, eb) == 1).all()
    assert krn.bwd_plan(8192, 2048, 2, False, H100_SMS).route == "scalar"
    assert krn.bwd_plan(8, 32768, 2, True, H100_SMS).route == "scalar"
    p = krn.bwd_plan(8192, 2048, 2, True, H100_SMS)
    assert (p.row_threads, p.threads, p.per) == (256, 512, 1)
    assert p.grid <= H100_SMS * krn.BWD_SM_THREADS // p.threads


def _mirror_bwd(x, w, dy, eps, p):
    """(dx, dw) in f32 in the order of the kernels: dw over each row
    group's rows in order, a block's groups added in group order, then the
    column pass's COL_WARPS fixed slices of the blocks' partials, each in
    block order, added in slice order."""
    f = np.float32
    rows, d = x.shape
    rstd = (1 / np.sqrt((x * x).sum(-1, dtype=f) / f(d) + f(eps))).astype(f)
    xh = x * rstd[:, None]
    c = rstd * (w * dy * x).sum(-1, dtype=f) / f(d)
    dx = rstd[:, None] * (w * dy - xh * c[:, None])
    groups = p.threads // p.row_threads
    parts = np.zeros((p.grid, d), f)
    for b in range(p.grid):
        r0, r1 = b * p.rows_per_block, min((b + 1) * p.rows_per_block, rows)
        acc = np.zeros((groups, d), f)
        for g in range(groups):
            for r in range(r0 + g, r1, groups):
                acc[g] += dy[r] * xh[r]
        for g in range(groups):
            parts[b] += acc[g]
    chunk = -(-p.grid // COL_WARPS)
    dw = np.zeros(d, f)
    for k in range(COL_WARPS):
        part = np.zeros(d, f)
        for b in range(k * chunk, min((k + 1) * chunk, p.grid)):
            part += parts[b]
        dw += part
    return dx, dw


@pytest.mark.parametrize("d,n_sms", [(64, 132), (96, 132), (64, 16), (2048, 16)])
def test_bwd_plan_dw_order_matches_jax_vjp(rng, d, n_sms):
    """600 rows at a few layers' width: the kernels' order of dw, on the
    card's plan, against jax.vjp of the JAX oracle and the plain version."""
    x = rng.normal(size=(600, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    dy = rng.normal(size=(600, d)).astype(np.float32)
    p = krn.bwd_plan(600, d, 4, True, n_sms)
    assert p.grid > 1
    dx, dw = _mirror_bwd(x, w, dy, 1e-5, p)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b, 1e-5), jnp.asarray(x),
                     jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(dx, np.asarray(jdx), **BWD_TOL)
    np.testing.assert_allclose(dw, np.asarray(jdw), **BWD_TOL)
    tdx, tdw = tref.rmsnorm_bwd(*(torch.from_numpy(a) for a in (x, w, dy)), 1e-5)
    np.testing.assert_allclose(dx, tdx.numpy(), **BWD_TOL)
    np.testing.assert_allclose(dw, tdw.numpy(), **BWD_TOL)
