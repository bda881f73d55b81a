"""Port parity, the weight-stationary matmul: the plain version
(``repro_torch.kernels.ref.matmul``) against the Pallas kernel run with
``interpret=True`` at the JAX sweep's shapes, and the port's routing rule
(``ops.weight_panel_fits`` and ``ops.matmul`` as it routes on the card)
against the JAX package's ``ops.matmul``.

f32 is held to 1e-5 (the same products summed in another order); bf16
inputs with a bf16 output to one bf16 ulp of the expected value (both round
one f32 sum once, and the sums may differ in the last bits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import matmul as jmm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the JAX sweep (tests/test_kernels_elementwise.py:69-72): (m, k, n, bm, bn)
SWEEP = [(16, 8, 16, 8, 8), (100, 40, 50, 32, 16), (128, 128, 128, 64, 64),
         (33, 17, 9, 16, 8)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _inputs(rng, m, k, n, name):
    tdt, jdt = DTYPES[name]
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    return (torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
            jnp.asarray(x, jdt), jnp.asarray(w, jdt))


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n,bm,bn", SWEEP)
def test_matmul_matches_pallas(rng, name, m, k, n, bm, bn):
    tx, tw, jx, jw = _inputs(rng, m, k, n, name)
    got = tref.matmul(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    want = _np(jmm.weight_stationary_matmul(jx, jw, bm=bm, bn=bn,
                                            interpret=True))
    if name == "f32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    else:
        ulp = np.spacing(np.abs(want)) * 2.0 ** 16     # one bf16 ulp
        assert (np.abs(_np(got) - want) <= ulp).all()
    assert torch.equal(ops.matmul(tx, tw), got)


@pytest.mark.parametrize("m,k,n,bm,bn", SWEEP)
def test_matmul_f32_out_from_bf16_in(rng, m, k, n, bm, bn):
    """out_dtype=f32 from bf16 inputs: the f32 sum with no rounding."""
    tx, tw, jx, jw = _inputs(rng, m, k, n, "bf16")
    got = tref.matmul(tx, tw, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = jmm.weight_stationary_matmul(jx, jw, bm=bm, bn=bn,
                                        out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_matmul_batched_input_matches_jax_ref(rng):
    """A 3-D input is the library dot's (routed there by the rule): the
    plain version matches the JAX oracle on it too."""
    from repro.kernels import ref as jref

    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    w = rng.normal(size=(24, 7)).astype(np.float32)
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(_np(got), _np(jref.matmul(jnp.asarray(x),
                                                         jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)


# (x shape, w [K, N], dtype): the stablelm-1.6b projections at decode (M 8)
# and a 512-row prefill chunk, a 3-D input, panels just under, at and over
# the budget, N below the reference's bn of 256
ROUTES = [
    ((8, 2048), (2048, 2048), "bf16"),
    ((8, 2048), (2048, 5632), "bf16"),
    ((8, 5632), (5632, 2048), "bf16"),
    ((8, 2048), (2048, 100352), "bf16"),
    ((512, 5632), (5632, 2048), "bf16"),
    ((512, 2048), (2048, 100352), "bf16"),
    ((512, 5632), (5632, 2048), "f32"),      # 5.5 MiB panel
    ((2, 8, 2048), (2048, 2048), "bf16"),    # not 2-D
    ((4, 8192), (8192, 512), "bf16"),        # exactly 4 MiB
    ((4, 8200), (8200, 512), "bf16"),        # just over
    ((4, 4096), (4096, 300), "f32"),         # exactly 4 MiB
    ((4, 16384), (16384, 128), "bf16"),      # N < bn: 4 MiB
    ((4, 16384), (16384, 129), "bf16"),      # N < bn: over
    ((33, 17), (17, 9), "f32"),
]


def _jax_routes(xs, ws, name, monkeypatch):
    """Whether the JAX package's ``ops.matmul`` at its defaults (its Pallas
    path, as on the TPU) takes the kernel for these shapes: the callees are
    replaced by recorders and the inputs by shape stand-ins, so nothing
    computes."""
    calls = []
    monkeypatch.setattr(jops._mm, "weight_stationary_matmul",
                        lambda *a, **k: calls.append("kernel"))
    monkeypatch.setattr(jops.ref, "matmul",
                        lambda *a, **k: calls.append("dot"))
    jdt = DTYPES[name][1]
    with jops.use_mode("interpret"):
        jops.matmul(jax.ShapeDtypeStruct(xs, jdt), jax.ShapeDtypeStruct(ws, jdt))
    assert len(calls) == 1
    return calls[0] == "kernel"


def _card_routes(x, w, monkeypatch):
    """``ops.matmul`` as it routes on the card: meta tensors stand in for
    the card's, with ops told they are not on the CPU; returns the
    callee and the dtypes it was given."""
    calls = []
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops._mm, "weight_stationary_matmul",
                        lambda a, b, o: calls.append(("kernel", a.dtype, b.dtype, o)))
    monkeypatch.setattr(ops.ref, "matmul",
                        lambda a, b, o: calls.append(("dot", a.dtype, b.dtype, o)))
    ops.matmul(x, w)
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("xs,ws,name", ROUTES)
def test_routing_rule_matches_jax(xs, ws, name, monkeypatch):
    want = _jax_routes(xs, ws, name, monkeypatch)
    tdt = DTYPES[name][0]
    itemsize = torch.empty((), dtype=tdt).element_size()
    assert ops.weight_panel_fits(len(xs), *ws, itemsize) == want
    callee = _card_routes(torch.empty(xs, dtype=tdt, device="meta"),
                          torch.empty(ws, dtype=tdt, device="meta"), monkeypatch)
    assert callee[0] == ("kernel" if want else "dot")


def test_budget_edge_routes_to_the_kernel():
    """A panel of exactly the budget takes the kernel, one K row more the
    library dot (the reference's ``<=``)."""
    assert ops.weight_panel_fits(2, 8192, 4096, 2)          # 8192 * 256 * 2
    assert not ops.weight_panel_fits(2, 8193, 4096, 2)
    assert ops.VMEM_BUDGET == 4 * 1024 * 1024 and ops.PANEL_BN == 256


@pytest.mark.parametrize("xdt,wdt", [(torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_mixed_dtypes_route_alike_on_both_devices(rng, xdt, wdt, monkeypatch):
    """x and w of different dtypes: on the CPU the plain version, on the
    card the kernel on both cast to their common dtype (f32, exact from
    bf16), so both devices give the f32-accumulated product in x's dtype."""
    x = torch.from_numpy(rng.normal(size=(8, 24)).astype(np.float32)).to(xdt)
    w = torch.from_numpy(rng.normal(size=(24, 40)).astype(np.float32)).to(wdt)
    got = ops.matmul(x, w)
    assert got.dtype == xdt
    assert torch.equal(got, tref.matmul(x.float(), w.float(), xdt))
    callee = _card_routes(x.to("meta"), w.to("meta"), monkeypatch)
    assert callee == ("kernel", torch.float32, torch.float32, xdt)


def test_kernel_matmul_is_forward_only_on_the_card(monkeypatch):
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    x = torch.empty(8, 64, device="meta", requires_grad=True)
    w = torch.empty(64, 32, device="meta")
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.matmul(x, w)


def test_matmul_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor raises before any
    build or launch."""
    with pytest.raises(ValueError, match="CUDA"):
        tmm.weight_stationary_matmul(torch.zeros(4, 8), torch.zeros(8, 3))
    assert tmm.launches == 0
