"""Port parity, Mamba2 and hybrid (Zamba2) training: the plain Mamba2 scan in
repro_torch.kernels.ref against the JAX oracle (repro.kernels.ref) and the
Pallas ``mamba2_chunked`` kernel run with ``interpret=True``; the explicit
backward ``mamba2_bwd`` against ``jax.vjp`` of the JAX oracle and a float64
recurrence; the conv and the Mamba2 block; the reduced zamba2-7b model
(hybrid) and its Mamba2-only variant (``family="ssm"``): logits, loss,
every gradient leaf and a train step against the JAX model, with the JAX
package's parameters carried over through ``repro_torch.models.convert``.
All in f32 on numpy inputs from a seed; each test names its tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba_chunk import mamba2_chunked  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels import mamba_chunk as tmamba  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

FWD_TOL = dict(rtol=2e-4, atol=2e-4)       # tests/test_kernels_scan.py's own
BWD_REL = 1e-5                             # max|diff| / max|jax.vjp| per gradient
# With strong decays (|A dt| up to 64 a step) dA is a small sum of pair terms
# much larger than itself: jax.vjp's dA is 0.9e-4 to 2e-4 off a float64
# recurrence there (absolute, whatever dA's size: 3e-3 to 0.7 over four
# seeds), the explicit backward's within 2.4e-5 of dA.  So that case holds
# dA to jax.vjp within 5e-4 absolute, and every gradient to the float64
# recurrence within 1e-4 of its largest entry.
STRONG_DA_ATOL = 5e-4
F64_REL = 1e-4
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 1e-4                            # per leaf, relative to its largest entry

# (B, S, H, P, N, chunk, strong): tests/test_kernels_scan.py:45-47, a ragged
# S, a chunk-64 case at S > 64, and strong decays where the TPU kernel's
# unmasked exp overflows
SCAN_CASES = [
    (1, 16, 1, 8, 4, 8, False), (2, 50, 3, 16, 8, 16, False),
    (1, 64, 2, 8, 16, 32, False), (2, 37, 3, 8, 4, 16, False),
    (1, 130, 2, 16, 8, 64, False), (1, 100, 2, 8, 4, 64, True),
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The shapes here are tiny: two intra-op threads keep this file from
    crowding the CPUs that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scan_inputs(rng, b, s, h, p, n, strong=False):
    """x, dt, A, B, C, dy as tests/test_kernels_scan.py draws them; with
    ``strong``, dt in [0.5, 4] and A in [-16, -4]."""
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(0.3, 2.0, size=(h,)).astype(np.float32)
    if strong:
        dt = rng.uniform(0.5, 4.0, size=(b, s, h)).astype(np.float32)
        A = -rng.uniform(4.0, 16.0, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    return x, dt, A, B, C, dy


def _unmasked_overflows(dt, A, chunk):
    """Whether exp(cum_t - cum_u) over the whole [T, T] block, as the TPU
    kernel takes it before masking, overflows f32 somewhere."""
    b, s, h = dt.shape
    nc = -(-s // chunk)
    dA = np.zeros((b, nc * chunk, h), np.float32)
    dA[:, :s] = dt * A
    cum = np.cumsum(dA.reshape(b, nc, chunk, h), axis=2)
    return float((cum[:, :, :, None] - cum[:, :, None]).max()) > 88.8


@pytest.mark.parametrize("b,s,h,p,n,chunk,strong", SCAN_CASES)
def test_plain_scan_matches_jax_and_pallas(b, s, h, p, n, chunk, strong):
    """mamba2_scan against the JAX oracle and the Pallas kernel
    (interpret=True), y and h_final within 2e-4."""
    x, dt, A, B, C, _ = _scan_inputs(np.random.default_rng(0), b, s, h, p, n,
                                     strong)
    assert _unmasked_overflows(dt, A, chunk) == strong
    jin = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    got = tref.mamba2_scan(*[_t(a) for a in (x, dt, A, B, C)], chunk=chunk)
    for want in (jref.mamba2_scan(*jin, chunk=chunk),
                 mamba2_chunked(*jin, chunk=chunk, interpret=True)):
        for g, w_ in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), **FWD_TOL)


def test_chunk_states_and_carried_state():
    """The chunk-entry states are the scan's state after each chunk's
    prefix, and a carried h0 continues a split sequence (2e-4)."""
    x, dt, A, B, C, _ = [_t(a) for a in _scan_inputs(np.random.default_rng(1),
                                                     2, 150, 2, 16, 8)]
    states = tref.mamba2_chunk_states(x, dt, A, B, chunk=64)
    assert states.shape == (2, 2, 3, 16, 8)
    assert not bool(states[:, :, 0].any())
    for c in (1, 2):
        _, hf = tref.mamba2_scan(x[:, :64 * c], dt[:, :64 * c], A, B[:, :64 * c],
                                 C[:, :64 * c], chunk=64)
        np.testing.assert_allclose(states[:, :, c].numpy(), hf.numpy(), **FWD_TOL)
    y1, h1 = tref.mamba2_scan(x[:, :70], dt[:, :70], A, B[:, :70], C[:, :70],
                              chunk=64)
    y2, h2 = tref.mamba2_scan(x[:, 70:], dt[:, 70:], A, B[:, 70:], C[:, 70:],
                              h0=h1, chunk=64)
    y, hf = tref.mamba2_scan(x, dt, A, B, C, chunk=64)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), **FWD_TOL)
    np.testing.assert_allclose(h2.numpy(), hf.numpy(), **FWD_TOL)


def _vjp(x, dt, A, B, C, dy, chunk):
    f = lambda *a: jref.mamba2_scan(*a, chunk=chunk)[0]
    _, pull = jax.vjp(f, *[jnp.asarray(a) for a in (x, dt, A, B, C)])
    return [np.asarray(g) for g in pull(jnp.asarray(dy))]


def _f64_grads(x, dt, A, B, C, dy):
    """(dx, ddt, dA, dB, dC) by autograd of the token-by-token recurrence in
    float64."""
    live = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
            for a in (x, dt, A, B, C)]
    xs, dts, As, Bs, Cs = live
    b, s, h, p = x.shape
    hs = torch.zeros((b, h, p, B.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(s):
        hs = (hs * torch.exp(dts[:, t] * As)[..., None, None]
              + torch.einsum("bh,bhp,bn->bhpn", dts[:, t], xs[:, t], Bs[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", hs, Cs[:, t]))
    grads = torch.autograd.grad(torch.stack(ys, 1), live,
                                torch.tensor(dy, dtype=torch.float64))
    return [g.numpy() for g in grads]


def _close_rel(got, want, rel, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max|diff| {err} vs {rel} x {scale}"


@pytest.mark.parametrize("b,s,h,p,n,chunk,strong", SCAN_CASES)
def test_chunk_dstates_match_jax_vjp(b, s, h, p, n, chunk, strong):
    """The exit-state gradient of every chunk (the backward kernel's reverse
    walk) against jax.vjp, with respect to h0, of the JAX oracle over the
    sequence after that chunk with its share of dy: within 1e-5 of the
    largest entry; the last chunk's is 0."""
    x, dt, A, B, C, dy = _scan_inputs(np.random.default_rng(5), b, s, h, p, n,
                                      strong)
    got = tref.mamba2_chunk_dstates(_t(dt), _t(A), _t(C), _t(dy), chunk=chunk)
    nc = -(-s // chunk)
    assert got.shape == (b, h, nc, p, n) and got.dtype == torch.float32
    assert not bool(got[:, :, -1].any())
    for c in range(nc - 1):
        r = (c + 1) * chunk
        f = lambda h0: jref.mamba2_scan(  # noqa: E731
            *[jnp.asarray(a[:, r:]) for a in (x, dt)], jnp.asarray(A),
            *[jnp.asarray(a[:, r:]) for a in (B, C)], h0=h0, chunk=chunk)[0]
        _, pull = jax.vjp(f, jnp.zeros((b, h, p, n), jnp.float32))
        want = np.asarray(pull(jnp.asarray(dy[:, r:]))[0])
        _close_rel(got[:, :, c].numpy(), want, BWD_REL, f"dS of chunk {c}")


@pytest.mark.parametrize("b,s,h,p,n,chunk,strong", SCAN_CASES)
def test_mamba2_bwd_matches_jax_vjp(b, s, h, p, n, chunk, strong):
    """(dx, ddt, dA, dB, dC) against jax.vjp of the JAX oracle (h0 = 0, no
    cotangent on h_final), each within 1e-5 of its largest entry (with
    strong decays dA within STRONG_DA_ATOL), and against a float64
    recurrence within 1e-4; finite everywhere."""
    x, dt, A, B, C, dy = _scan_inputs(np.random.default_rng(2), b, s, h, p, n,
                                      strong)
    want = _vjp(x, dt, A, B, C, dy, chunk)
    exact = _f64_grads(x, dt, A, B, C, dy)
    got = tref.mamba2_bwd(*[_t(a) for a in (x, dt, A, B, C, dy)], chunk=chunk)
    for i, (name, g, wt, ex) in enumerate(zip(("dx", "ddt", "dA", "dB", "dC"),
                                              got, want, exact)):
        assert g.dtype == torch.float32 and g.shape == wt.shape
        assert np.isfinite(g.numpy()).all()
        if strong and i == 2:
            assert float(np.abs(g.numpy() - wt).max()) <= STRONG_DA_ATOL
        else:
            _close_rel(g.numpy(), wt, BWD_REL, name)
        _close_rel(g.numpy(), ex, F64_REL, name + " (float64)")


def _sweep_bwd(x, dt, A, B, C, dy, chunk):
    """(dx, ddt, dA, dB, dC) by one reverse sweep over the chunks that
    carries dS, the exit-state gradient, from chunk to chunk: the plain
    backward's earlier form, kept here as an oracle for the chunk-local
    one (the same formulas as ``ref.mamba2_bwd``'s docstring, with dS
    updated in the sweep instead of read from ``mamba2_chunk_dstates``)."""
    bt, s, h, p = x.shape
    (xs, dys), dts, bs, cs = tref._mamba2_chunks(x, dt, B, C, chunk, (dy,))
    nc = xs.shape[1]
    af = A.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    states = tref.mamba2_chunk_states(x, dt, A, B, chunk=chunk)
    dS = torch.zeros_like(states[:, :, 0])
    dA = torch.zeros((h,), dtype=torch.float32)
    dx, ddt, dB, dC = (torch.zeros_like(t) for t in (xs, dts, bs, cs))
    rev = lambda t: torch.flip(torch.cumsum(torch.flip(t, [1]), 1), [1])  # noqa: E731
    for c in reversed(range(nc)):
        xc, dyc, dtc, bc, cc = xs[:, c], dys[:, c], dts[:, c], bs[:, c], cs[:, c]
        h0 = states[:, :, c]
        cum = torch.cumsum(dtc * af, dim=1)                        # [Bt,T,H]
        cT = cum[:, -1]
        L = tref._seg_decay(cum, tri)                              # [Bt,T,U,H]
        M = L * torch.einsum("btn,bun->btu", cc, bc)[..., None]
        dyx = torch.einsum("bthp,buhp->btuh", dyc, xc)             # dy_t . x_u
        Q = L * dyx
        tail, head = torch.exp(cT[:, None] - cum), torch.exp(cum)
        gB = (torch.einsum("bsth,bshp->bthp", M, dyc)
              + tail[..., None] * torch.einsum("bhpn,btn->bthp", dS, bc))
        dx[:, c] = dtc[..., None] * gB
        e = (xc * gB).sum(-1)
        xdsb = torch.einsum("bthp,bhpn,btn->bth", xc, dS, bc)
        dB[:, c] = (torch.einsum("bth,bsth,bsn->btn", dtc, Q, cc)
                    + torch.einsum("bth,bthp,bhpn->btn", dtc * tail, xc, dS))
        hdy = torch.einsum("bhpn,bthp->bthn", h0, dyc)
        dC[:, c] = (torch.einsum("bth,bthn->btn", head, hdy)
                    + torch.einsum("btuh,buh,bun->btn", Q, dtc, bc))
        K = M * dtc[:, None] * dyx
        before = torch.cumsum(K, dim=2) - K
        intra = torch.einsum("bsjh,sj->bjh", before, tri.float())
        h_side = rev(head * torch.einsum("btn,bthn->bth", cc, hdy))
        s_side = tail * dtc * xdsb
        s_side = torch.cumsum(s_side, 1) - s_side
        const = torch.exp(cT) * torch.einsum("bhpn,bhpn->bh", dS, h0)
        dl = intra + h_side + s_side + const[:, None]
        ddt[:, c] = e + af * dl
        dA = dA + (dtc * dl).sum((0, 1))
        dS = dS * torch.exp(cT)[..., None, None] + torch.einsum(
            "bth,bthp,btn->bhpn", head, dyc, cc)
    unchunk = lambda t: t.reshape(bt, nc * chunk, *t.shape[3:])[:, :s]  # noqa: E731
    return unchunk(dx), unchunk(ddt), dA, unchunk(dB), unchunk(dC)


@pytest.mark.parametrize("b,s,h,p,n,strong", [
    (2, 300, 3, 16, 8, True), (1, 256, 2, 64, 64, True),
    (2, 200, 3, 16, 8, False)])
def test_chunk_local_bwd_matches_the_sequential_sweep(b, s, h, p, n, strong):
    """``mamba2_bwd_local``, every chunk at once from (states, dstates),
    against the reverse sweep that carries dS from chunk to chunk, at
    several 64-row chunks (a ragged S included) and strong decays: every
    gradient within 1e-5 of its largest entry (with strong decays dA
    within STRONG_DA_ATOL), and both against a float64 recurrence within
    1e-4."""
    x, dt, A, B, C, dy = [_t(a) for a in _scan_inputs(
        np.random.default_rng(8), b, s, h, p, n, strong)]
    got = tref.mamba2_bwd_local(
        x, dt, A, B, C, dy, tref.mamba2_chunk_states(x, dt, A, B, chunk=64),
        tref.mamba2_chunk_dstates(dt, A, C, dy, chunk=64), chunk=64)
    want = _sweep_bwd(x, dt, A, B, C, dy, 64)
    exact = _f64_grads(*[a.numpy() for a in (x, dt, A, B, C, dy)])
    for i, (name, g, wt, ex) in enumerate(zip(("dx", "ddt", "dA", "dB", "dC"),
                                              got, want, exact)):
        assert g.shape == wt.shape and np.isfinite(g.numpy()).all()
        if strong and i == 2:
            assert float((g - wt).abs().max()) <= STRONG_DA_ATOL
        else:
            _close_rel(g.numpy(), wt.numpy(), BWD_REL, name)
        _close_rel(g.numpy(), ex, F64_REL, name + " (float64)")
        _close_rel(wt.numpy(), ex, F64_REL, name + " (sweep, float64)")


def test_autograd_finite_where_unmasked_exp_overflows():
    """Strong decays: autograd of the plain chunked scan stays finite (the
    exponent is masked before exp) and agrees with the explicit backward
    within 1e-4 of each gradient's largest entry (dA, as jax.vjp's, within
    STRONG_DA_ATOL)."""
    x, dt, A, B, C, dy = [_t(a) for a in _scan_inputs(
        np.random.default_rng(3), 2, 100, 2, 8, 4, strong=True)]
    assert _unmasked_overflows(dt.numpy(), A.numpy(), 64)
    live = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, _ = tref.mamba2_scan(*live, chunk=64)
    grads = torch.autograd.grad(y, live, dy)
    explicit = tref.mamba2_bwd(x, dt, A, B, C, dy, chunk=64)
    for i, (g, e) in enumerate(zip(grads, explicit)):
        assert torch.isfinite(g).all() and torch.isfinite(e).all()
        if i == 2:
            assert float((g - e).abs().max()) <= STRONG_DA_ATOL
        else:
            _close_rel(g.numpy(), e.numpy(), 1e-4, "autograd vs explicit")


def test_ops_cpu_dispatch_and_wrapper_checks():
    """On the CPU ``ops.mamba2_scan`` is the plain chunked version with
    chunks of 64, as the JAX package runs off the TPU; the kernel wrappers
    refuse CPU tensors and (head dim, state) pairs they are not built for."""
    rng = np.random.default_rng(4)
    xs = [_t(a) for a in _scan_inputs(rng, 2, 90, 2, 16, 8)[:5]]
    for g, w_ in zip(ops.mamba2_scan(*xs),
                     tref.mamba2_scan(*xs, chunk=64)):
        assert torch.equal(g, w_)
    jo = jops.mamba2_scan(*[jnp.asarray(t.numpy()) for t in xs])
    for g, w_ in zip(ops.mamba2_scan(*xs), jo):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **FWD_TOL)
    with pytest.raises(ValueError, match="CUDA"):
        tmamba.mamba2_fwd(*xs)
    bad = [_t(a) for a in _scan_inputs(rng, 1, 8, 2, 32, 8)[:5]]
    with pytest.raises(ValueError, match="not in"):
        tmamba.mamba2_fwd(*bad)
    assert tmamba.n_chunks(4096) == 64 and tmamba.n_chunks(70) == 2


# ---------------------------------------------------------------------------
# the Mamba2 block and the model
# ---------------------------------------------------------------------------

def _cfg(family="hybrid"):
    cfg = reduced(get_config("zamba2-7b"))
    return cfg if family == "hybrid" else cfg.replace(family="ssm")


def _pair(family="hybrid", seed=0):
    cfg = _cfg(family)
    jstate = JS.init_state(cfg, jax.random.key(seed), dtype=jnp.float32)
    return cfg, jstate, state_from_jax(jax.tree.map(np.asarray, jstate))


@pytest.mark.parametrize("with_length", [False, True])
def test_causal_conv_matches_jax(with_length):
    """_causal_conv with and without ``length`` and a carried conv state:
    output and tail within 1e-6."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    state = rng.normal(size=(2, 3, 6)).astype(np.float32)
    lens = np.array([11, 5], np.int32) if with_length else None
    for st in (None, state):
        jy, jt = JSSM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if st is None else jnp.asarray(st),
                                   None if lens is None else jnp.asarray(lens))
        ty, tt = TSSM._causal_conv(_t(x), _t(w), None if st is None else _t(st),
                                   None if lens is None else _t(lens))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-6)


def test_mamba_apply_with_state_matches_jax():
    """mamba_apply with a right-padded ``length``, carried conv and SSM
    states and ``return_state``, against the JAX block (1e-4)."""
    cfg, jstate, tstate = _pair()
    jl0 = jax.tree.map(lambda a: a[0, 0], jstate.params["groups"])["mamba"]
    tl0 = tstate.params["groups"][0][0]["mamba"]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(2, cfg.conv_width - 1,
                            cfg.d_inner + 2 * cfg.ssm_state)).astype(np.float32)
    hs = rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state)).astype(np.float32)
    lens = np.array([37, 21], np.int32)
    japply = jax.jit(lambda p, x, **kw: JSSM.mamba_apply(p, x, cfg,
                                                         return_state=True, **kw))
    for kw in ({}, dict(conv_state=conv, ssm_state=hs, length=lens)):
        jo, (jt, jh) = japply(jl0, jnp.asarray(x),
                              **{k: jnp.asarray(v) for k, v in kw.items()})
        to, (tt, th) = TSSM.mamba_apply(tl0, _t(x), cfg, return_state=True,
                                        **{k: _t(v) for k, v in kw.items()})
        for g, w_ in ((to, jo), (tt, jt), (th, jh)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), **MODEL_TOL)


def test_convert_carries_the_hybrid_tree():
    """params_from_jax / state_from_jax split groups [G, K, ...] into G
    lists of K layers and tail [T, ...] into T layers, keep ``shared``,
    the f32 A_log / D / dt_bias among bf16 leaves, and every value bit for
    bit; the port's own init has the same tree, shapes and dtypes."""
    cfg = _cfg()
    g, k, t = TM.hybrid_layout(cfg)
    assert (g, k, t) == (2, 2, 1)
    jp = JM.init_params(cfg, jax.random.key(0))                  # bf16 init
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    assert len(tp["groups"]) == g and all(len(gp) == k for gp in tp["groups"])
    assert len(tp["tail"]) == t and sorted(tp["shared"]) == sorted(jp["shared"])
    for path, leaf in T.leaves_with_paths(tp):
        keys = path.split("::")
        # the stacked axes of groups ([G, K]) and tail ([T]) are list indices
        n_idx = {"groups": 2, "tail": 1}.get(keys[0], 0)
        want = jp[keys[0]]
        for key in keys[1 + n_idx:]:
            want = want[key]
        want = np.asarray(want)[tuple(int(i) for i in keys[1:1 + n_idx])]
        f32 = keys[-1] in ("A_log", "D", "dt_bias")
        assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), path
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(want).astype(np.float32),
                                      err_msg=path)
    own = TM.init_params(cfg, seed=0, device="cpu")
    for (p1, a), (p2, b_) in zip(T.leaves_with_paths(own), T.leaves_with_paths(tp)):
        assert p1 == p2 and a.shape == b_.shape and a.dtype == b_.dtype, p1
    # the full config at the one-card depth: 5 groups of 6 and a 3-layer tail
    assert TM.hybrid_layout(t_get_config("zamba2-7b").replace(n_layers=33)) == (5, 6, 3)
    _, _, tstate = _pair()
    assert tstate.opt.m["tail"][0]["mamba"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
@pytest.mark.parametrize("s", [40, 70])
def test_logits_match_jax(family, s):
    """Reduced zamba2-7b (hybrid) and its Mamba2-only variant: logits within
    1e-4; S = 40 is one ragged chunk, S = 70 a full chunk of 64 and a
    ragged one."""
    cfg, jstate, tstate = _pair(family)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(2, s))
    jl, jaux = jax.jit(lambda p, t: JM.forward(cfg, p, tokens=t))(
        jstate.params, jnp.asarray(toks))
    tl, taux = TM.forward(cfg, tstate.params, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_jax(family, remat):
    """Loss and every gradient leaf against jax.value_and_grad at S = 70,
    each leaf within 1e-4 of its largest entry; no leaf is zero."""
    cfg, jstate, tstate = _pair(family)
    batch = JSyntheticLM(cfg.vocab_size, 70, 2, seed=1).batch(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        JS.make_loss_fn(cfg, remat=remat), has_aux=True))(
            jstate.params, {k: jnp.asarray(v) for k, v in batch.items()})
    (tloss, _), tgrads = TS.value_and_grad(TS.make_loss_fn(cfg, remat=remat))(
        tstate.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), **MODEL_TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    pairs = list(zip(T.leaves_with_paths(tgrads), T.leaves_with_paths(want)))
    assert len(pairs) == len(T.leaves(tstate.params))
    for (path, g), (wpath, w_) in pairs:
        assert path == wpath
        scale = float(w_.abs().max())
        assert scale > 0, path
        assert float((g - w_).abs().max()) <= GRAD_REL * scale, path


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
def test_train_step_matches_jax(family):
    """One whole train step: loss and grad norm within 1e-4, parameters
    within 2 lr (1 + wd) of JAX's (Adam's g / (|g| + eps) can flip sign
    where a gradient is near zero)."""
    lr, wd = 1e-3, 0.1
    cfg, jstate, tstate = _pair(family)
    kw = dict(base_lr=lr, warmup=1, weight_decay=wd)
    batch = JSyntheticLM(cfg.vocab_size, 40, 4, seed=4).batch(0)
    jstate, jm = jax.jit(JS.make_train_step(cfg, **kw))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = TS.make_train_step(cfg, **kw)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **MODEL_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               **MODEL_TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    worst = max(float((a - b_).abs().max())
                for a, b_ in zip(T.leaves(tstate.params), T.leaves(want)))
    assert worst <= 2 * lr * (1 + wd)
    assert int(tstate.opt.step) == 1


def test_nested_remat_reruns_the_scan_three_times(monkeypatch):
    """With remat the hybrid's grouped layers run their forward three times
    a step (forward, the group's recompute, the layer's own recompute), the
    tail's and the shared block's twice: the launch counts the card's train
    phase holds its kernels to (3gk + 2t scans, 2g attentions)."""
    cfg = t_reduced(t_get_config("zamba2-7b"))
    g, k, t = TM.hybrid_layout(cfg)
    calls = {"scan": 0, "attn": 0}

    def counted(name, fn):
        def wrap(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrap

    monkeypatch.setattr(ops, "mamba2_scan", counted("scan", ops.mamba2_scan))
    monkeypatch.setattr(ops, "flash_attention", counted("attn", ops.flash_attention))
    params = TM.init_params(cfg, device="cpu", dtype=torch.float32)
    batch = JSyntheticLM(cfg.vocab_size, 40, 2, seed=1).batch(0)
    TS.value_and_grad(TS.make_loss_fn(cfg))(
        params, {kk: torch.from_numpy(v) for kk, v in batch.items()})
    assert calls == {"scan": 3 * g * k + 2 * t, "attn": 2 * g}


def test_launch_train_zamba_cpu(tmp_path, capsys):
    tlaunch.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                  "--steps", "3", "--ckpt-dir", str(tmp_path), "--seq-len", "40",
                  "--global-batch", "2"])
    out = capsys.readouterr().out
    assert "[train] done at step 2" in out
    assert np.isfinite(float(out.split("loss=")[-1].split()[0]))


def test_mamba2_serving_refused():
    """The Mamba2 and hybrid families now serve as well as train (their
    serving state is made, JAX's keys), and so does MoE (its pool and slabs,
    the dense family's); a family the port does not know is refused."""
    for family in ("hybrid", "ssm"):
        cfg = t_reduced(t_get_config("zamba2-7b"))
        cfg = cfg if family == "hybrid" else cfg.replace(family="ssm")
        TM.init_params(cfg, device="cpu")
        state = TM.init_serve_state(cfg, 2, 9, 8, dtype=torch.float32,
                                    device="cpu")
        assert sorted(state) == (["attn", "conv_g", "conv_t", "ssm_g", "ssm_t"]
                                 if family == "hybrid" else ["conv", "ssm"])
    moe = t_reduced(t_get_config("olmoe-1b-7b"))
    assert sorted(TM.init_serve_state(moe, 2, 9, 8, device="cpu")["attn"]) == \
        ["k_pages", "v_pages"]
    assert sorted(TM.init_decode_state(moe, 2, 8, device="cpu")["attn"]) == ["k", "v"]
    unknown = moe.replace(family="encoder")
    for call in (lambda: TM.init_serve_state(unknown, 2, 9, 8, device="cpu"),
                 lambda: TM.init_decode_state(unknown, 2, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="not ported"):
            call()
