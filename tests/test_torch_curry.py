"""Port parity, the Curry ALU: ``repro_torch.core.curry`` against the JAX
package's ``repro.core.curry``, and the plain versions of the Curry-ALU
kernel forms (``repro_torch.kernels.ref`` ``rmsnorm`` / ``silu_mul`` with
``curry_rounds``) against the Pallas kernels run with ``interpret=True``.

The Pallas kernels are called directly: the JAX package's ``ops.rmsnorm`` /
``ops.silu_mul`` drop ``curry_rounds`` off the TPU.  Inputs are numpy from a
seed.  f32 is held to 1e-6 relative (plus 1e-6 of the largest entry, for
entries that cancel towards zero): both sides take the same f32 steps, true
divisions included.  bf16 outputs are held to one bf16 ulp of the expected
value: both round one f32 result once, and the f32 values may differ in the
last bits (a sum of squares in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import curry as jcurry  # noqa: E402
from repro.kernels import rmsnorm as jrn  # noqa: E402
from repro.kernels import swiglu as jsw  # noqa: E402
from repro_torch.core import curry as tcurry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import swiglu as tsw  # noqa: E402

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close_f32(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value (bf16 keeps 16 fewer mantissa bits than
    f32, so its spacing is f32's times 2^16)."""
    return np.spacing(np.abs(v).astype(np.float32)) * 2.0 ** 16


def _close_bf16(got, want):
    got, want = _np(got), _np(want)
    err = np.abs(got - want)
    assert (err <= _bf16_ulp(want)).all(), \
        f"max |err| {err.max()} beyond one bf16 ulp"


def _close(got, want, name):
    (_close_f32 if name == "f32" else _close_bf16)(got, want)


def _both(a: np.ndarray, name: str = "f32"):
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


# ---------------------------------------------------------------------------
# core.curry, function by function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounds", [1, 4, 6, 8])
def test_curry_exp(rng, rounds):
    x = (-np.abs(rng.normal(size=(9, 40))) * 4).astype(np.float32)
    t, j = _both(x)
    _close_f32(tcurry.curry_exp(t, rounds), jcurry.curry_exp(j, rounds))


@pytest.mark.parametrize("fn", ["curry_rsqrt", "curry_sqrt"])
@pytest.mark.parametrize("rounds", [0, 1, 3])
def test_curry_rsqrt_and_sqrt(rng, fn, rounds):
    x = (np.abs(rng.normal(size=(7, 33))) * 5 + 1e-3).astype(np.float32)
    t, j = _both(x)
    _close_f32(getattr(tcurry, fn)(t, rounds), getattr(jcurry, fn)(j, rounds))


@pytest.mark.parametrize("axis", [-1, 0])
def test_curry_softmax(rng, axis):
    x = (rng.normal(size=(6, 17)) * 3).astype(np.float32)
    t, j = _both(x)
    got = tcurry.curry_softmax(t, axis=axis, rounds=8)
    _close_f32(got, jcurry.curry_softmax(j, axis=axis, rounds=8))


def test_curry_softmax_gradient_stops_at_the_max(rng):
    """The max is detached (JAX's stop_gradient): the gradient matches
    JAX's through the same function."""
    import jax

    x = (rng.normal(size=(4, 9)) * 2).astype(np.float32)
    g = rng.normal(size=(4, 9)).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_(True)
    (tcurry.curry_softmax(t, rounds=6) * torch.from_numpy(g)).sum().backward()
    want = jax.grad(lambda a: (jcurry.curry_softmax(a, rounds=6) * g).sum())(
        jnp.asarray(x))
    _close_f32(t.grad, want)


@pytest.mark.parametrize("rounds", [4, 8])
def test_curry_silu(rng, rounds):
    x = (rng.normal(size=(5, 48)) * 3).astype(np.float32)
    t, j = _both(x)
    _close_f32(tcurry.curry_silu(t, rounds), jcurry.curry_silu(j, rounds))


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_curry_rmsnorm(rng, name):
    x = rng.normal(size=(6, 64)).astype(np.float32)
    w = (rng.normal(size=(64,)) + 1).astype(np.float32)
    (tx, jx), (tw, jw) = _both(x, name), _both(w, name)
    _close(tcurry.curry_rmsnorm(tx, tw, 1e-5, 3),
           jcurry.curry_rmsnorm(jx, jw, 1e-5, 3), name)


def _chain(mod, scale, bias):
    S = mod.ChainStep
    return mod.Chain([S("+=", 0.5), S("*=", "scale"), S("-=", 1.25),
                      S("/=", 3.0), S("max=", -0.2), S("-=", "bias"),
                      S("/=", "scale"), S("max=", "bias")])


def test_chain_apply_every_op(rng):
    x = rng.normal(size=(4, 32)).astype(np.float32)
    scale = (np.abs(rng.normal(size=(32,))) + 0.5).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    (tx, jx), (ts, js), (tb, jb) = _both(x), _both(scale), _both(bias)
    tchain, jchain = _chain(tcurry, ts, tb), _chain(jcurry, js, jb)
    assert len(tchain) == len(jchain) == 8
    assert set(tcurry.OPS) == set(jcurry.OPS)
    assert {s.op for s in tchain.steps} == set(tcurry.OPS)
    _close_f32(tchain.apply(tx, {"scale": ts, "bias": tb}),
               jchain.apply(jx, {"scale": js, "bias": jb}))


# ---------------------------------------------------------------------------
# the plain versions of the kernel forms against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("rounds", [1, 3])
def test_rmsnorm_curry_matches_pallas(rng, name, rounds):
    x = rng.normal(size=(37, 96)).astype(np.float32)
    w = (rng.normal(size=(96,)) + 1).astype(np.float32)
    (tx, jx), (tw, jw) = _both(x, name), _both(w, name)
    got = tref.rmsnorm(tx, tw, 1e-5, curry_rounds=rounds)
    assert got.dtype == tx.dtype
    want = jrn.rmsnorm(jx, jw, eps=1e-5, block_rows=16, curry_rounds=rounds,
                       interpret=True)
    _close(got, want, name)
    assert torch.equal(ops.rmsnorm(tx, tw, eps=1e-5, curry_rounds=rounds), got)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("rounds", [4, 6, 8])
def test_silu_mul_curry_matches_pallas(rng, name, rounds):
    g = (rng.normal(size=(23, 80)) * 3).astype(np.float32)
    u = rng.normal(size=(23, 80)).astype(np.float32)
    (tg, jg), (tu, ju) = _both(g, name), _both(u, name)
    got = tref.silu_mul(tg, tu, curry_rounds=rounds)
    assert got.dtype == tu.dtype
    want = jsw.silu_mul(jg, ju, block_rows=8, curry_rounds=rounds,
                        interpret=True)
    _close(got, want, name)
    assert torch.equal(ops.silu_mul(tg, tu, curry_rounds=rounds), got)


@pytest.mark.parametrize("op", ["rmsnorm", "silu_mul"])
def test_f32_tolerance_tells_the_native_form_from_the_curry_form(rng, op):
    """Control: the native form (``curry_rounds=0``) held against the Pallas
    curry form with the fewest rounds the tests above use (one Newton step
    from the bf16 seed, up to ~6e-6 relative off; four Taylor terms) fails
    the f32 tolerance, so the parity above shows the Curry arithmetic
    itself."""
    x = rng.normal(size=(37, 96)).astype(np.float32)
    if op == "rmsnorm":
        w = (rng.normal(size=(96,)) + 1).astype(np.float32)
        native = tref.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
        curry = jrn.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-5,
                            block_rows=16, curry_rounds=1, interpret=True)
    else:
        u = rng.normal(size=(37, 96)).astype(np.float32)
        native = tref.silu_mul(torch.from_numpy(3 * x), torch.from_numpy(u))
        curry = jsw.silu_mul(jnp.asarray(3 * x), jnp.asarray(u), block_rows=8,
                             curry_rounds=4, interpret=True)
    with pytest.raises(AssertionError):
        _close_f32(native, curry)


def test_curry_rounds_zero_keeps_the_native_forms(rng):
    """``curry_rounds=0`` is the plain version the model paths run, bit for
    bit (silu rounded before the product)."""
    x = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32)).bfloat16()
    w = torch.ones(64, dtype=torch.bfloat16)
    assert torch.equal(tref.rmsnorm(x, w, 1e-5, curry_rounds=0),
                       tref.rmsnorm(x, w, 1e-5))
    assert torch.equal(tref.silu_mul(x, x.flip(0), curry_rounds=0),
                       tref.silu(x.float()).bfloat16() * x.flip(0))


def test_curry_wrappers_refuse_cpu_tensors():
    """The curry forms launch the CUDA kernels or raise; a CPU tensor never
    reaches a launch (ops sends it to the plain version)."""
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        trn.rmsnorm(x, torch.ones(64), 1e-5, curry_rounds=3)
    with pytest.raises(ValueError, match="CUDA"):
        tsw.silu_mul(x, x, curry_rounds=6)
    assert trn.curry_launches == 0 and tsw.curry_launches == 0


def test_curry_forms_are_forward_only_on_the_card(monkeypatch):
    """On the card an input that requires grad raises before any launch
    (the kernels have no backward, as the TPU kernels have no VJP).  Meta
    tensors stand in for the card's, with ``ops`` told they are not on
    the CPU."""
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    x = torch.empty(4, 64, device="meta", requires_grad=True)
    w = torch.empty(64, device="meta")
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.rmsnorm(x, w, curry_rounds=3)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.silu_mul(x, x.detach(), curry_rounds=6)
