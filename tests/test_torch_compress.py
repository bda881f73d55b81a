"""Port parity, the data-parallel collectives of training: the int8
gradient all-reduce with error feedback (``train/compress.py``) and the
NoC cross-entropy (``train/step.py:cross_entropy_noc``).

The JAX package runs both inside ``shard_map`` over fake devices
(``tests/test_noc_distributed.py``, ``tests/test_noc_xent.py``: one
subprocess each).  Here its functions run in process under
``jax.vmap(..., axis_name=...)``: a named vmap gives ``pmax``,
``ppermute``, ``psum`` and ``axis_index`` their meaning over the stacked
shards, op by op.  The port takes the same shards as a list.  The
compressed sync is held bit for bit (quantize / dequantize, the butterfly at
1, 2, 4 and 8 shards in f32 and bf16, the synced and error trees over three
steps that carry the error); the cross-entropy to JAX's ``cross_entropy``
within the reference's own bounds (loss 1e-5, gradient 1e-6).  Inputs come
from numpy seeds."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import noc as JNOC  # noqa: E402
from repro.train import compress as JC  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.core import noc as TNOC  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.train import compress as TC  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the reference's own bounds (tests/test_noc_xent.py)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-6
# the reference's quadratic (tests/test_noc_distributed.py): 8 shards, 60
# steps of lr 0.3, converged when max |w - target| < 0.05
QUAD_SHARDS, QUAD_STEPS, QUAD_LR, QUAD_TOL = 8, 60, 0.3, 0.05


def _bits(x) -> np.ndarray:
    """The bit pattern of a JAX array or torch tensor (bf16 widened to f32,
    which is exact)."""
    if isinstance(x, torch.Tensor):
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.atleast_1d(np.asarray(x))
    x = x.astype(np.float32) if x.dtype.name == "bfloat16" else x
    return x.view(np.uint8)


def _to_torch(x) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _stacked(rng, s, shape, dtype, scale=1.0):
    return jnp.asarray(rng.normal(size=(s,) + shape) * scale, dtype)


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["normal", "zeros", "ties", "bf16"])
def test_quantize_int8_bitwise(case):
    rng = np.random.default_rng(1)
    if case == "zeros":                         # the scale's 1e-12 floor
        x = jnp.zeros((7, 3), jnp.float32)
    elif case == "ties":                        # values at half steps: x = 127.0 max
        x = jnp.asarray(np.arange(-127, 128, 0.5), jnp.float32)
    else:
        x = _stacked(rng, 3, (41,), DTYPES.get(case, DTYPES["f32"])[0], 3.0)
    q, s = JC.quantize_int8(x)
    tq, ts = TC.quantize_int8(_to_torch(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(q), tq.numpy())
    np.testing.assert_array_equal(_bits(s), _bits(ts))
    np.testing.assert_array_equal(_bits(JC.dequantize(q, s)),
                                  _bits(TC.dequantize(tq, ts)))
    if case == "zeros":
        assert float(ts) == np.float32(1e-12) and not tq.any()


# ---------------------------------------------------------------------------
# the int8 butterfly
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_butterfly(s: int, dt: str):
    """(shards [S, 4099] as JAX made them, JAX's result on every shard)."""
    rng = np.random.default_rng(10 + s)
    x = _stacked(rng, s, (4099,), DTYPES[dt][0], 2.0)
    fn = jax.vmap(lambda a: JC.butterfly_allreduce_int8(a, "x"), axis_name="x")
    return x, fn(x)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_butterfly_allreduce_int8_bitwise(s, dt):
    x, want = _jax_butterfly(s, dt)
    got = TC.butterfly_allreduce_int8([_to_torch(x[i]) for i in range(s)])
    assert len(got) == s and all(g.dtype == DTYPES[dt][1] for g in got)
    for i in range(s):
        np.testing.assert_array_equal(_bits(got[i]), _bits(want[i]))
    # the mean it approximates, within the reference's bound
    mean = np.asarray(x, np.float32).mean(0)
    err = np.abs(got[0].float().numpy() - mean).max() / np.abs(mean).max()
    assert err < 0.05, err


def test_butterfly_refuses_three_shards():
    with pytest.raises(ValueError, match="power-of-two"):
        TC.butterfly_allreduce_int8([torch.ones(4)] * 3)
    with pytest.raises(AssertionError, match="power-of-two"):   # the reference's
        jax.vmap(lambda a: JC.butterfly_allreduce_int8(a, "x"),
                 axis_name="x")(jnp.ones((3, 4)))


def test_butterfly_per_shard_scale_control():
    """A hop that quantizes each shard by its own scale (not the max over
    every shard) differs from JAX's bits: the bitwise hold catches it."""
    x, want = _jax_butterfly(4, "f32")
    xs = [_to_torch(x[i]) for i in range(4)]

    def own_scale(values):
        n, xs, k = len(values), [v.float() for v in values], 1
        while k < n:
            qs = [TC.quantize_int8(v) for v in xs]
            xs = [qs[i][0].int() * qs[i][1] + qs[i ^ k][0].int() * qs[i ^ k][1]
                  for i in range(n)]
            k *= 2
        return [v / n for v in xs]

    bad = own_scale(xs)
    assert not np.array_equal(_bits(bad[0]), _bits(want[0]))


# ---------------------------------------------------------------------------
# error-feedback sync over trees
# ---------------------------------------------------------------------------

def _grad_trees(rng, s):
    """S shards' two-leaf gradient trees stacked [S, ...] (JAX) -> and the
    port's list of S trees."""
    g = {"a": _stacked(rng, s, (37, 5), jnp.float32, 0.5),
         "b": {"c": _stacked(rng, s, (130,), jnp.bfloat16, 4.0)}}
    tg = [jax.tree.map(lambda a, i=i: _to_torch(a[i]), g) for i in range(s)]
    return g, tg


@functools.lru_cache(maxsize=None)
def _jax_sync_steps(s: int, steps: int = 3):
    rng = np.random.default_rng(20 + s)
    first = jax.vmap(lambda g: JC.compressed_grad_sync(g, "x"), axis_name="x")
    later = jax.vmap(lambda g, e: JC.compressed_grad_sync(g, "x", e), axis_name="x")
    out, err = [], None
    for _ in range(steps):
        g, tg = _grad_trees(rng, s)
        synced, err = first(g) if err is None else later(g, err)
        out.append((tg, synced, err))
    return out


@pytest.mark.parametrize("s", [2, 4, 8])
def test_compressed_grad_sync_three_steps_bitwise(s):
    err = None
    for step, (tg, want_synced, want_err) in enumerate(_jax_sync_steps(s)):
        synced, err = TC.compressed_grad_sync(tg, err)
        assert len(synced) == len(err) == s
        for i in range(s):
            for name, got, want in (("synced", synced[i], want_synced),
                                    ("error", err[i], want_err)):
                gl, wl = T.leaves(got), jax.tree.leaves(want)
                assert len(gl) == len(wl) == 2
                for a, b in zip(gl, wl):
                    assert a.dtype == torch.float32
                    np.testing.assert_array_equal(
                        _bits(a), _bits(np.asarray(b)[i]),
                        err_msg=f"{name}, step {step}, shard {i}")


def _quadratic(sync):
    """The reference's error-feedback quadratic over QUAD_SHARDS shards."""
    target = np.random.default_rng(0).normal(size=(64,)).astype(np.float32)
    xs = np.random.default_rng(1).normal(size=(QUAD_SHARDS, 64)).astype(np.float32)
    return sync(target, xs)


def test_quadratic_converges_and_matches_jax():
    def torch_run(target, xs):
        target, xs = torch.from_numpy(target), torch.from_numpy(xs)
        w, err = torch.zeros(64), None
        for _ in range(QUAD_STEPS):
            grads = [{"w": (w - target) * (1.0 + 0.1 * x)} for x in xs]
            synced, err = TC.compressed_grad_sync(grads, err)
            w = w - QUAD_LR * synced[0]["w"]
        return w.numpy(), float((w - target).abs().max())

    def jax_run(target, xs):
        def body(w, e, x):
            g = {"w": (w - target) * (1.0 + 0.1 * x)}
            synced, e2 = JC.compressed_grad_sync(g, "x", {"w": e})
            return synced["w"], e2["w"]

        step = jax.vmap(body, in_axes=(None, 0, 0), axis_name="x")   # op by op
        w, err = jnp.zeros((64,)), jnp.zeros((QUAD_SHARDS, 64))
        for _ in range(QUAD_STEPS):
            g, err = step(w, err, jnp.asarray(xs))
            w = w - QUAD_LR * g[0]
        return np.asarray(w)

    w, dist = _quadratic(torch_run)
    assert dist < QUAD_TOL, dist
    np.testing.assert_array_equal(_bits(w), _bits(_quadratic(jax_run)))


# ---------------------------------------------------------------------------
# the NoC cross-entropy
# ---------------------------------------------------------------------------

B, S, V = 4, 6, 32
MESHES = {                                     # name -> (shape, axis names)
    "tp1": ((1,), ("model",)), "tp2": ((2,), ("model",)),
    "tp4": ((4,), ("model",)), "tp8": ((8,), ("model",)),
    "dp2_tp1": ((2, 1), ("data", "model")), "dp2_tp2": ((2, 2), ("data", "model")),
    "dp2_tp4": ((2, 4), ("data", "model")), "dp2_tp8": ((2, 8), ("data", "model")),
    "pod2_dp2_tp2": ((2, 2, 2), ("pod", "data", "model")),
}


@functools.lru_cache(maxsize=None)
def _xent_inputs():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(B, S, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = rng.integers(0, 2, (B, S)).astype(np.float32)
    want = {}
    for m in (None, mask):
        kw = {} if m is None else {"mask": jnp.asarray(m)}
        loss, grad = jax.value_and_grad(
            lambda lg: JS.cross_entropy(lg, jnp.asarray(labels), **kw))(
                jnp.asarray(logits))
        want[m is not None] = (float(loss), np.asarray(grad))
    return logits, labels, mask, want


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cross_entropy_noc_matches_jax(mesh_name, masked):
    logits, labels, mask, want = _xent_inputs()
    mesh = Mesh(*MESHES[mesh_name], device="cpu")
    lg = torch.from_numpy(logits).requires_grad_()
    kw = {"mask": torch.from_numpy(mask)} if masked else {}
    loss = TS.cross_entropy_noc(lg, torch.from_numpy(labels), mesh,
                                ("pod", "data"), "model", **kw)
    (grad,) = torch.autograd.grad(loss, lg)
    loss = loss.detach()
    want_loss, want_grad = want[masked]
    assert abs(float(loss) - want_loss) < LOSS_TOL, (float(loss), want_loss)
    assert float(np.abs(grad.numpy() - want_grad).max()) < GRAD_TOL
    # and the port's own cross_entropy
    plain = TS.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), **kw)
    assert abs(float(loss) - float(plain)) < LOSS_TOL


def test_cross_entropy_noc_controls():
    """A shard that drops its vocabulary offset (v0) picks the wrong gold
    logits, and the loss leaves the bound; an indivisible split raises."""
    logits, labels, _, want = _xent_inputs()
    lf = torch.from_numpy(logits)
    lb = torch.from_numpy(labels)[..., None]
    shards = list(torch.split(lf, V // 4, dim=-1))
    lse = TNOC.distributed_logsumexp(shards)[0]
    iota = torch.arange(V // 4, dtype=torch.int32)
    gold = sum(torch.where(iota == lb, x, 0.0).sum(-1) for x in shards)
    assert abs(float((lse - gold).mean()) - want[False][0]) > 100 * LOSS_TOL
    with pytest.raises(ValueError, match="do not split"):
        TS.cross_entropy_noc(lf, lb[..., 0], Mesh((3,), ("model",), "cpu"),
                             ("data",), "model")


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_distributed_logsumexp_matches_jax(tp):
    logits, *_ = _xent_inputs()
    split = np.stack(np.split(logits, tp, axis=-1))        # [tp, B, S, V/tp]
    want = jax.vmap(lambda x: JNOC.distributed_logsumexp(x, "model"),
                    axis_name="model")(jnp.asarray(split))
    got = TNOC.distributed_logsumexp([torch.from_numpy(x) for x in split])
    for i in range(tp):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-6, atol=0)
        assert torch.equal(got[i], got[0])
