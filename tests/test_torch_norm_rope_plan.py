"""Port, rmsnorm and rope launch plans and the q + k rope on the CPU.

``kernels/rmsnorm.py:plan`` and ``kernels/rope.py:plan`` choose the shape of
the CUDA kernels' work from the shapes and the card's SM count.  The card
is not here, so these tests mirror each kernel's walk (``csrc/rmsnorm.cu``,
``csrc/rope.cu``) over the plan and check that every row and element, and
every (token, head, pair), is visited exactly once, at every width and head
dim the port's configs reach, and that the grid stays within the waves the
plan promises.  ``ops.apply_rope_qk`` on the CPU is held bitwise to two
plain calls and, on q and k with H != KvH, to the JAX oracle, the Pallas
kernel (``interpret=True``) and ``jax.vjp``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import rope as jrope  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as krn  # noqa: E402
from repro_torch.kernels import rope as krope  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132
ROWS = (1, 8, 512, 8192)
# rmsnorm widths of the port's configs: the reduced ones, d_model, the
# Mamba2 gated norm's d_inner (7168 at zamba2-7b)
WIDTHS = (64, 2048, 2560, 3072, 3584, 4096, 5120, 6144, 7168, 8192)
HEAD_DIMS = (16, 64, 112, 128)
# (H, KvH) of the q + k launch; KvH 0 is one tensor
HEADS = ((32, 0), (32, 8), (24, 8))
ELEM_BYTES = (2, 4)              # bf16, f32


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **{**TOL, **kw})


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

def _rmsnorm_rows(p, rows):
    """Rows visited by the kernel's walk: block b takes row groups b,
    b + grid, ..., a group being threads // row_threads consecutive rows."""
    groups = p.threads // p.row_threads
    bases = np.concatenate([np.arange(b * groups, rows, p.grid * groups)
                            for b in range(p.grid)])
    visits = (bases[:, None] + np.arange(groups)[None, :]).ravel()
    return np.bincount(visits[visits < rows], minlength=rows)


def _rmsnorm_columns(p, d, elem_bytes):
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


def _check_rmsnorm_plan(p, rows, d, elem_bytes, n_sms):
    assert p.row_threads & (p.row_threads - 1) == 0
    assert p.threads % 32 == 0 and p.threads % p.row_threads == 0
    assert p.threads <= krn.MAX_THREADS
    assert 1 <= p.grid <= n_sms * krn.BLOCKS_PER_SM
    if p.route == "vector":
        assert p.per in krn.PER_THREAD
        assert p.per * p.row_threads * (krn.VEC_BYTES // elem_bytes) >= d
    else:
        assert p.per == 0


@pytest.mark.parametrize("elem_bytes", ELEM_BYTES)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_rmsnorm_plan_covers_each_element_once(rows, d, elem_bytes):
    p = krn.plan(rows, d, elem_bytes, True, H100_SMS)
    assert p.route == "vector"
    _check_rmsnorm_plan(p, rows, d, elem_bytes, H100_SMS)
    assert (_rmsnorm_rows(p, rows) == 1).all()
    assert (_rmsnorm_columns(p, d, elem_bytes) == 1).all()


@pytest.mark.parametrize("n_sms", [132, 114, 78, 16])
def test_rmsnorm_plan_grid_within_the_waves(n_sms):
    for rows in ROWS + (3, 100, 20000):
        for d in WIDTHS + (2049, 16384, 40000):
            for eb in ELEM_BYTES:
                for aligned in (True, False):
                    p = krn.plan(rows, d, eb, aligned, n_sms)
                    _check_rmsnorm_plan(p, rows, d, eb, n_sms)
                    assert (_rmsnorm_rows(p, rows) == 1).all()
                    if d <= 8192:
                        assert (_rmsnorm_columns(p, d, eb) == 1).all()


def test_rmsnorm_plan_routes_and_shapes():
    # odd widths, a base off 16 bytes, a row past the registers: scalar
    for d, eb in ((2049, 2), (2050, 2), (6, 4), (2050, 4)):
        p = krn.plan(512, d, eb, True, H100_SMS)
        assert p.route == "scalar" and (_rmsnorm_columns(p, d, eb) == 1).all()
    assert krn.plan(512, 2048, 2, False, H100_SMS).route == "scalar"
    assert krn.plan(8, 32768, 2, True, H100_SMS).route == "scalar"
    assert krn.plan(8, 16384, 2, True, H100_SMS).route == "vector"
    # stablelm's width: a whole block a row, one vector a thread, for
    # decode's 8 rows, a prefill chunk and a training batch, the grid within
    # a wave of the card's resident blocks
    for rows, grid in ((8, 8), (512, 512), (8192, H100_SMS * krn.BLOCKS_PER_SM)):
        p = krn.plan(rows, 2048, 2, True, H100_SMS)
        assert (p.row_threads, p.threads, p.per, p.grid) == (256, 256, 1, grid)
    # a row past 512 vectors: two a thread (four in f32 past 4096 elements)
    assert krn.plan(512, 7168, 2, True, H100_SMS)[:3] == ("vector", 2, 512)
    assert krn.plan(512, 8192, 4, True, H100_SMS)[:3] == ("vector", 4, 512)
    # the reduced configs' 64: several rows a block
    p = krn.plan(512, 64, 2, True, H100_SMS)
    assert (p.row_threads, p.threads) == (8, 256)


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

def _rope_visits(p, tokens, heads, d):
    """(token, head, pair) visit counts of the kernel's walk, factored as it
    is: block (x, y) takes tiles x, x + grid_x, ... of ``tile`` tokens,
    heads [y hpb, y hpb + hpb) of the q-then-k list, and every access v of
    a head row rotates pairs v pairs.. v pairs + pairs."""
    gx, gy = p.grid
    starts = np.concatenate([np.arange(x * p.tile, tokens, gx * p.tile)
                             for x in range(gx)])
    visits = (starts[:, None] + np.arange(p.tile)[None, :]).ravel()
    tok = np.bincount(visits[visits < tokens], minlength=tokens)
    head = np.zeros(heads, np.int64)
    for y in range(gy):
        head[y * p.heads_per_block:min((y + 1) * p.heads_per_block, heads)] += 1
    half = d // 2
    pair = np.zeros(half, np.int64)
    for v in range(half // p.pairs):
        pair[v * p.pairs:(v + 1) * p.pairs] += 1
    return tok, head, pair


def _check_rope_plan(p, tokens, heads, d, elem_bytes, n_sms):
    tok, head, pair = _rope_visits(p, tokens, heads, d)
    assert (tok == 1).all() and (head == 1).all() and (pair == 1).all()
    gx, gy = p.grid
    assert 32 <= p.threads <= krope.THREADS and p.threads % 32 == 0
    assert gx <= max(1, n_sms * krope.BLOCKS_PER_SM // gy)
    assert (gy - 1) * p.heads_per_block < heads <= gy * p.heads_per_block
    assert p.tile * (d // 2) <= krope.MAX_TILE_PAIRS
    if p.route == "vector":
        assert 2 * p.pairs * elem_bytes == krope.VEC_BYTES
    else:
        assert p.pairs == 1


@pytest.mark.parametrize("elem_bytes", ELEM_BYTES)
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("tokens", ROWS)
def test_rope_plan_covers_each_pair_once(tokens, d, heads, elem_bytes):
    h = sum(heads)
    p = krope.plan(tokens, h, d, elem_bytes, H100_SMS)
    assert p.route == "vector"
    _check_rope_plan(p, tokens, h, d, elem_bytes, H100_SMS)


@pytest.mark.parametrize("n_sms", [132, 114, 78, 16])
def test_rope_plan_grid_within_the_waves(n_sms):
    for tokens in ROWS + (3, 100, 20000):
        for d in HEAD_DIMS + (6, 12, 256):
            for h in (1, 8, 40, 64):
                for eb in ELEM_BYTES:
                    for aligned in (True, False):
                        p = krope.plan(tokens, h, d, eb, n_sms, aligned)
                        _check_rope_plan(p, tokens, h, d, eb, n_sms)


def test_rope_plan_routes_and_decode_split():
    for d, eb in ((6, 4), (12, 2), (6, 2)):
        assert krope.plan(512, 40, d, eb, H100_SMS).pairs == 1
    assert krope.plan(512, 40, 64, 2, H100_SMS, aligned=False).route == "scalar"
    assert krope.plan(512, 40, 64, 2, H100_SMS).pairs == 4
    assert krope.plan(512, 40, 64, 4, H100_SMS).pairs == 2
    # decode, q and k of stablelm-1.6b: 8 tokens of 64 heads, the heads
    # split over grid y until the grid is about a block an SM
    p = krope.plan(8, 64, 64, 2, H100_SMS)
    gx, gy = p.grid
    assert gx == 8 and gy > 1 and gx * gy >= H100_SMS // 2
    # a prefill chunk: tiles of tokens, no split
    p = krope.plan(512, 64, 64, 2, H100_SMS)
    assert p.grid[1] == 1 and p.grid[0] >= H100_SMS


# ---------------------------------------------------------------------------
# the q + k rope on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h, kvh", [(4, 2), (6, 2), (4, 4)])
def test_apply_rope_qk_is_two_plain_calls(rng, h, kvh):
    q = _t(rng.normal(size=(2, 9, h, 16)).astype(np.float32))
    k = _t(rng.normal(size=(2, 9, kvh, 16)).astype(np.float32))
    pos = _t(rng.integers(0, 4096, size=(2, 9)).astype(np.int32))
    for p in (pos, pos[0]):
        gq, gk = ops.apply_rope_qk(q, k, p, theta=10_000.0)
        assert torch.equal(gq, tref.apply_rope(q, p, 10_000.0))
        assert torch.equal(gk, tref.apply_rope(k, p, 10_000.0))
    bq, bk = q.bfloat16(), k.bfloat16()
    gq, gk = ops.apply_rope_qk(bq, bk, pos, theta=5e5)
    assert torch.equal(gq, tref.apply_rope(bq, pos, 5e5))
    assert torch.equal(gk, tref.apply_rope(bk, pos, 5e5))


@pytest.mark.parametrize("max_pos", [64, 4096])
def test_apply_rope_qk_matches_jax(rng, max_pos):
    """q and k with H != KvH against the JAX oracle at any position, and
    against the Pallas kernel where its exp(-ln(theta) j/half) inverse
    frequency is within 1e-5 (positions below 64, as test_torch_kernels)."""
    q = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    pos = rng.integers(0, max_pos, size=(2, 7)).astype(np.int32)
    gq, gk = ops.apply_rope_qk(_t(q), _t(k), _t(pos))
    for got, x in ((gq, q), (gk, k)):
        _close(got, jref.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
        if max_pos <= 64:
            _close(got, jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         block_s=4, interpret=True))


@pytest.mark.parametrize("max_pos", [64, 4096])
def test_apply_rope_qk_grads_match_jax_vjp(rng, max_pos):
    q = rng.normal(size=(2, 9, 6, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    dq = rng.normal(size=q.shape).astype(np.float32)
    dk = rng.normal(size=k.shape).astype(np.float32)
    pos = rng.integers(0, max_pos, size=(2, 9)).astype(np.int32)
    _, vjp = jax.vjp(lambda a, b: (jref.apply_rope(a, jnp.asarray(pos)),
                                   jref.apply_rope(b, jnp.asarray(pos))),
                     jnp.asarray(q), jnp.asarray(k))
    wq, wk = vjp((jnp.asarray(dq), jnp.asarray(dk)))
    xs = [_t(q).requires_grad_(), _t(k).requires_grad_()]
    oq, ok = ops.apply_rope_qk(*xs, _t(pos))
    gq, gk = torch.autograd.grad((oq, ok), xs, (_t(dq), _t(dk)))
    _close(gq, wq)
    _close(gk, wk)
    # the card's backward: the rotation at -pos, as the plain version gives it
    _close(gq, tref.apply_rope(_t(dq), -_t(pos)))
    _close(gk, tref.apply_rope(_t(dk), -_t(pos)))


def test_rope_wrappers_check_before_any_launch():
    q, k = torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 1, 16)
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        krope.apply_rope_qk(q, k, pos)
    with pytest.raises(ValueError, match="sign"):
        krope.apply_rope_qk(q, k, pos, sign=2)
    with pytest.raises(ValueError, match="do not share"):
        krope.apply_rope_qk(q, torch.zeros(1, 5, 1, 16), pos)
    with pytest.raises(ValueError, match="int32"):
        krope.apply_rope(q, pos.long())
    with pytest.raises(ValueError, match="even"):
        krope.apply_rope(torch.zeros(1, 4, 2, 15), pos)
