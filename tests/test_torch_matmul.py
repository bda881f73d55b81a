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


# ---------------------------------------------------------------------------
# the host-side plan of the card kernels (route, tile, grid), on the CPU
# ---------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32
# (m, k, n, the tile the plan picks): phase 16's seven full-width
# stablelm-1.6b rows (PERF.md rows 10-10g)
FULL_WIDTH = [(8, 2048, 2048, (64, 16)), (8, 2048, 5632, (64, 32)),
              (8, 5632, 2048, (64, 16)), (8, 2048, 100352, (64, 64)),
              (512, 2048, 5632, (128, 192)), (512, 5632, 2048, (128, 64)),
              (512, 2048, 100352, (128, 256))]


@pytest.mark.parametrize("m,k,n,tile", FULL_WIDTH)
def test_plan_full_width_rows_take_wgmma(m, k, n, tile):
    p = tmm.plan(m, n, k, BF16, True)
    assert p.route == "wgmma" and p.tile == tile
    assert p.grid == (-(-m // tile[0]), -(-n // tile[1]))
    assert p.tile in tmm.TILES["wgmma"]


@pytest.mark.parametrize("m,k,n,aligned", [
    (8, 2044, 2048, True), (8, 2048, 2044, True), (512, 17, 2048, True),
    (8, 2048, 2048, False), (33, 17, 9, True), (100, 40, 50, True),
    (8, 0, 2048, True)])
def test_plan_unloadable_rows_take_mma_sync(m, k, n, aligned):
    """K or N not a multiple of 8, an unaligned base, or K 0 (no TMA map):
    the mma.sync kernel, its 16 x 32 tile up to NARROW_M rows."""
    p = tmm.plan(m, n, k, BF16, aligned)
    assert p.route == "mma_sync"
    assert p.tile == ((16, 32) if m <= tmm.NARROW_M else (64, 64))
    with pytest.raises(ValueError, match="wgmma route"):
        tmm.plan(m, n, k, BF16, aligned, route="wgmma")


@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (512, 5632, 2048),
                                   (33, 17, 9)])
def test_plan_f32_takes_ffma(m, k, n):
    assert tmm.plan(m, n, k, F32, True) == ("ffma", (64, 64),
                                            (-(-m // 64), -(-n // 64)))
    for route in ("wgmma", "mma_sync"):
        with pytest.raises(ValueError, match="does not take"):
            tmm.plan(m, n, k, F32, True, route=route)
    with pytest.raises(ValueError, match="does not take"):
        tmm.plan(m, n, k, BF16, True, route="ffma")


@pytest.mark.parametrize("m", [1, 8, 16, 64])
@pytest.mark.parametrize("k,n", [(2048, 2048), (5632, 2048), (2048, 5632)])
def test_plan_decode_puts_a_block_on_every_sm(m, k, n):
    """At decode the weight streams through the card: N 2048 gives 128
    blocks (its narrowest tile), wider N at least one block an SM."""
    p = tmm.plan(m, n, k, BF16, True)
    assert p.route == "wgmma" and p.tile[0] == 64
    blocks = p.grid[0] * p.grid[1]
    assert blocks >= (128 if n == 2048 else tmm.SMS)


@pytest.mark.parametrize("m", [1, 8, 512, 4096])
def test_plan_lm_head_grid_fits_cuda(m):
    """stablelm-1.6b's lm_head [2048, 100352]: the n tiles ride
    blockIdx.y, which CUDA caps at 65535; every tile fits."""
    for tile in tmm.TILES["wgmma"]:
        p = tmm.plan(m, 100352, 2048, BF16, True, tile=tile)
        assert p.grid[1] <= tmm.MAX_GRID_Y and p.grid[0] < 2 ** 31
    with pytest.raises(ValueError, match="n tiles"):
        tmm.plan(m, 16 * (tmm.MAX_GRID_Y + 1), 2048, BF16, True, tile=(64, 16))


def test_plan_prefill_covers_the_card_in_fewest_waves():
    """M 512 x N 5632: 128 x 192 tiles make 120 blocks, one wave on the 132
    SMs, where 128 x 256 leaves a third of the card idle and 128 x 128
    needs two waves."""
    p = tmm.plan(512, 5632, 2048, BF16, True)
    assert p.tile == (128, 192) and p.grid[0] * p.grid[1] == 120 <= tmm.SMS


@pytest.mark.parametrize("route,tile", [("wgmma", (64, 48)), ("wgmma", (16, 32)),
                                        ("mma_sync", (64, 16)), ("ffma", (16, 32))])
def test_plan_refuses_tiles_a_route_lacks(route, tile):
    dtype = F32 if route == "ffma" else BF16
    with pytest.raises(ValueError, match="tile"):
        tmm.plan(64, 2048, 2048, dtype, True, route=route, tile=tile)


def test_plan_forced_route_and_tile():
    """tests and chip_smoke.py force each route and tile at one shape."""
    assert tmm.plan(8, 2048, 2048, BF16, True, route="mma_sync") == (
        "mma_sync", (16, 32), (1, 64))
    assert tmm.plan(8, 2048, 2048, BF16, True, route="mma_sync",
                    tile=(64, 64)) == ("mma_sync", (64, 64), (1, 32))
    assert tmm.plan(8, 2048, 2048, BF16, True, tile=(128, 256)) == (
        "wgmma", (128, 256), (1, 8))
    with pytest.raises(ValueError, match="route"):
        tmm.plan(8, 2048, 2048, BF16, True, route="tf32")
    with pytest.raises(TypeError, match="dtype"):
        tmm.plan(8, 2048, 2048, torch.float16, True)
