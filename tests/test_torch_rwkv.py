"""Port parity, RWKV6 training: the plain wkv6 versions in
repro_torch.kernels.ref against the JAX oracles (repro.kernels.ref) and the
Pallas ``rwkv6_chunked`` kernel run with ``interpret=True``; the explicit
backward ``rwkv6_bwd`` against ``jax.vjp`` of the JAX chunked form; the
reduced rwkv6-3b model's logits, loss, every gradient leaf and a train step
against the JAX model, with the JAX package's parameters carried over
through ``repro_torch.models.convert`` and a random nonzero ``w_b`` (zero
at init) so the decay depends on the data.  All in f32 on numpy inputs from
a seed; each test names its tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv_chunk import rwkv6_chunked  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rwkv_chunk as twkv  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rwkv as TR  # noqa: E402
from repro_torch.models.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.models.runner import ModelRunner as TRunner  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

FWD_TOL = dict(rtol=2e-4, atol=2e-4)       # tests/test_kernels_scan.py's own
BWD_REL = 1e-5                             # max|diff| / max|jax.vjp| per gradient,
                                           # plus the rounding of the log sums below
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 1e-4                            # per leaf, relative to its largest entry
W_CLAMPED = 1e-25                          # below the 1e-20 clamp

# (B, S, H, D, chunk): tests/test_kernels_scan.py:14-16, a ragged S, and
# the same with some decays below the 1e-20 clamp
SCAN_CASES = [
    (1, 17, 1, 8, 8, False), (2, 64, 3, 16, 16, False), (1, 50, 2, 32, 32, False),
    (2, 37, 3, 16, 16, False), (2, 37, 3, 8, 8, True), (1, 70, 2, 16, 32, True),
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _wkv(rng, b, s, h, d, clamped=False, w_lo=0.05):
    r, k, v, do = (rng.normal(size=(b, s, h, d)).astype(np.float32)
                   for _ in range(4))
    w = rng.uniform(w_lo, 0.999, size=(b, s, h, d)).astype(np.float32)
    if clamped:
        w[rng.random(w.shape) < 0.1] = W_CLAMPED
    u = rng.normal(size=(h, d)).astype(np.float32)
    return r, k, v, w, u, do


@pytest.mark.parametrize("b,s,h,d,chunk,clamped", SCAN_CASES)
def test_plain_scans_match_jax_and_pallas(b, s, h, d, chunk, clamped):
    """rwkv6_scan (recurrent) and rwkv6_scan_chunked against their JAX
    oracles and the Pallas kernel (interpret=True), within 2e-4."""
    r, k, v, w, u, _ = _wkv(np.random.default_rng(0), b, s, h, d, clamped)
    jin = [jnp.asarray(a) for a in (r, k, v, w, u)]
    tin = [_t(a) for a in (r, k, v, w, u)]
    j_rec = jref.rwkv6_scan(*jin)
    j_chk = jref.rwkv6_scan_chunked(*jin, chunk=chunk)
    j_pal = rwkv6_chunked(*jin, chunk=chunk, interpret=True)
    t_rec = tref.rwkv6_scan(*tin)
    t_chk = tref.rwkv6_scan_chunked(*tin, chunk=chunk)
    for got, want in ((t_rec, j_rec), (t_chk, j_chk), (t_chk, j_pal),
                      (t_rec, j_pal)):
        for g, w_ in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), **FWD_TOL)


def test_chunk_states_and_carried_state():
    """The chunk-entry states are the recurrence's state after each chunk's
    prefix, and a carried s0 continues a split sequence (2e-4)."""
    r, k, v, w, u, _ = [_t(a) for a in _wkv(np.random.default_rng(1), 2, 70, 2, 8)]
    states = tref.rwkv6_chunk_states(k, v, w, chunk=32)
    assert states.shape == (2, 2, 3, 8, 8)
    assert not bool(states[:, :, 0].any())
    for c in (1, 2):
        _, sf = tref.rwkv6_scan(r[:, :32 * c], k[:, :32 * c], v[:, :32 * c],
                                w[:, :32 * c], u)
        np.testing.assert_allclose(states[:, :, c].numpy(), sf.numpy(), **FWD_TOL)
    o1, s1 = tref.rwkv6_scan_chunked(r[:, :40], k[:, :40], v[:, :40], w[:, :40], u,
                                     chunk=16)
    o2, s2 = tref.rwkv6_scan_chunked(r[:, 40:], k[:, 40:], v[:, 40:], w[:, 40:], u,
                                     s0=s1, chunk=16)
    o, sf = tref.rwkv6_scan(r, k, v, w, u)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), o.numpy(), **FWD_TOL)
    np.testing.assert_allclose(s2.numpy(), sf.numpy(), **FWD_TOL)


def _vjp(r, k, v, w, u, do, chunk):
    f = lambda *a: jref.rwkv6_scan_chunked(*a, chunk=chunk)[0]
    _, pull = jax.vjp(f, *[jnp.asarray(a) for a in (r, k, v, w, u)])
    return [np.asarray(g) for g in pull(jnp.asarray(do))]


def _cum_rounding(w, chunk):
    """The pair weights are exp of differences of f32 running sums of
    log max(w, 1e-20) over a chunk; each sum carries ~|cum| 2^-24 of
    rounding, so the two frameworks' weights may differ by ~max|cum| 2^-23
    relative (clamped rows add -46 each)."""
    b, s, h, d = w.shape
    nc = -(-s // chunk)
    lw = np.zeros((b, nc * chunk, h, d), np.float32)
    lw[:, :s] = np.log(np.maximum(w, 1e-20))
    return float(np.abs(np.cumsum(lw.reshape(b, nc, chunk, h, d), 2)).max()) * 2.0 ** -23


def _close_rel(got, want, rel, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max|diff| {err} vs {rel} x {scale}"


@pytest.mark.parametrize("b,s,h,d,chunk,clamped", SCAN_CASES)
def test_rwkv6_bwd_matches_jax_vjp(b, s, h, d, chunk, clamped):
    """(dr, dk, dv, dw, du) against jax.vjp of the JAX chunked form (with
    s0 = 0 and no cotangent on S_final), each within 1e-5 of the largest
    entry plus the rounding of the log-decay sums (``_cum_rounding``: at
    most 5e-6 here without clamped rows, 2e-5 to 5e-5 with them); dw is
    exactly 0 where the clamp holds."""
    r, k, v, w, u, do = _wkv(np.random.default_rng(2), b, s, h, d, clamped)
    want = _vjp(r, k, v, w, u, do, chunk)
    got = tref.rwkv6_bwd(*[_t(a) for a in (r, k, v, w, u, do)], chunk=chunk)
    rel = BWD_REL + _cum_rounding(w, chunk)
    for name, g, wt in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert g.dtype == torch.float32 and np.isfinite(g.numpy()).all()
        _close_rel(g.numpy(), wt, rel, name)
    assert not got[3].numpy()[w <= 1e-20].any()


def test_rwkv6_bwd_finite_where_unmasked_exp_overflows():
    """Decays of 1e-15 over whole chunks: the pair exponent cin_t - cum_u
    reaches +500 for u >= t, where the TPU kernel's exp of the whole block
    (masked afterwards) is inf.  The plain forward and backward mask before
    exp and stay finite, and match jax.vjp: dl = dw w within 1e-5 of its
    largest entry plus the log sums' rounding (dw itself is dl / w, and
    where w is tiny both frameworks' dw is the rounding of a difference of
    running sums times 1 / w)."""
    rng = np.random.default_rng(3)
    b, s, h, d, chunk = 1, 48, 2, 8, 16
    r, k, v, w, u, do = _wkv(rng, b, s, h, d)
    w[:, 16:32] = 1e-15
    lw = np.log(np.maximum(w, 1e-20)).reshape(b, 3, chunk, h, d)
    cum = np.cumsum(lw, axis=2)
    unmasked = (cum - lw)[:, :, :, None] - cum[:, :, None]     # [b,c,t,u,h,d]
    assert unmasked.max() > 88.8          # exp overflows f32 above ~88.7
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(unmasked.astype(np.float32))).any()
    tin = [_t(a) for a in (r, k, v, w, u, do)]
    o, sf = tref.rwkv6_scan_chunked(*tin[:5], chunk=chunk)
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    got = tref.rwkv6_bwd(*tin, chunk=chunk)
    want = _vjp(r, k, v, w, u, do, chunk)
    for g in got:
        assert torch.isfinite(g).all()
    rel = BWD_REL + _cum_rounding(w, chunk)
    for i, name in ((0, "dr"), (1, "dk"), (2, "dv"), (4, "du")):
        _close_rel(got[i].numpy(), want[i], rel, name)
    _close_rel(got[3].numpy() * w, want[3] * w, rel, "dl = dw w")
    # autograd of the plain chunked form is finite there too
    live = [x.clone().requires_grad_() for x in tin[:5]]
    grads = torch.autograd.grad(tref.rwkv6_scan_chunked(*live, chunk=chunk)[0],
                                live, tin[5])
    assert all(torch.isfinite(g).all() for g in grads)


def _sweep_bwd(r, k, v, w, u, do, chunk):
    """The backward as one reverse sweep over the whole sequence, carrying
    dS and the running decay sum ``acc`` across chunk boundaries (the plain
    backward before the chunk-local form; kept here as its oracle): dL_t =
    r_{t+1} dr'_{t+1} - k_t dk'_t and dl_j = sum_{t>=j} dL_t."""
    b, s, h, d = r.shape
    (rs, ks, vs, dos), cum, cin = tref._rwkv6_chunks(r, k, v, w, chunk, (do,))
    nc = rs.shape[1]
    uf = u.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool), diagonal=-1)
    eye = torch.eye(chunk, dtype=torch.bool)
    states = tref.rwkv6_chunk_states(k, v, w, chunk=chunk)
    dS = torch.zeros_like(states[:, :, 0])
    acc = torch.zeros((b, h, d))
    du = torch.zeros((h, d))
    dr, dk, dv, dl = (torch.zeros_like(rs) for _ in range(4))
    for c in reversed(range(nc)):
        rc, kc, vc, doc = rs[:, c], ks[:, c], vs[:, c], dos[:, c]
        cc, ci, S0 = cum[:, c], cin[:, c], states[:, :, c]
        cT = cc[:, -1]
        E = tref._pair_decay(ci, cc, tri)
        dov = torch.einsum("bthe,buhe->bhtu", doc, vc)
        diag = dov.diagonal(dim1=2, dim2=3).permute(0, 2, 1)
        datt = torch.where(tri, dov, 0.0)
        att = torch.einsum("bthd,btuhd,buhd->bhtu", rc, E, kc)
        bonus = torch.einsum("bthd,hd,bthd->bth", rc, uf, kc)
        att = att + torch.where(eye, bonus.permute(0, 2, 1)[..., None], 0.0)
        kdec = torch.exp(cT[:, None] - cc)
        dv[:, c] = (torch.einsum("bhtu,bthe->buhe", att, doc)
                    + torch.einsum("buhd,bhde->buhe", kc * kdec, dS))
        drp = (torch.exp(ci) * torch.einsum("bhde,bthe->bthd", S0, doc)
               + torch.einsum("bhtu,btuhd,buhd->bthd", datt, E, kc))
        dkp = (kdec * torch.einsum("bhde,buhe->buhd", dS, vc)
               + torch.einsum("bhtu,btuhd,bthd->buhd", datt, E, rc))
        dr[:, c] = drp + uf * kc * diag[..., None]
        dk[:, c] = dkp + uf * rc * diag[..., None]
        du = du + torch.einsum("bthd,bth->hd", rc * kc, diag)
        x, y = rc * drp, kc * dkp
        rev_x = torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1]) - x
        rev_y = torch.flip(torch.cumsum(torch.flip(y, [1]), 1), [1])
        dl[:, c] = acc[:, None] + rev_x - rev_y
        acc = acc + x.sum(1) - y.sum(1)
        dS = dS * torch.exp(cT)[..., None] + torch.einsum(
            "bthd,bthe->bhde", rc * torch.exp(ci), doc)
    unchunk = lambda t: t.reshape(b, nc * chunk, h, d)[:, :s]  # noqa: E731
    return (unchunk(dr), unchunk(dk), unchunk(dv), unchunk(dl), du)


# (B, S, H, D, chunk, lowest w): 4-5 chunks, a ragged last one, decays down
# to 1e-3 a step (the chunk's log sums reach ~-300) with some below the clamp
LOCAL_CASES = [(2, 70, 3, 8, 16, 0.05), (1, 80, 2, 16, 16, 1e-3),
               (2, 150, 2, 8, 32, 1e-3)]


@pytest.mark.parametrize("b,s,h,d,chunk,w_lo", LOCAL_CASES)
def test_rwkv6_bwd_local_matches_the_sweep(b, s, h, d, chunk, w_lo):
    """The chunk-local backward (every chunk from its own S0 and dS, dl by
    the four groups of pairs inside the chunk) against the sequence-long
    sweep with its running decay sum, both from the same f32 log sums (so
    no allowance for their rounding): dr, dk, dv, du and dl = dw w each
    within 1e-5 of its largest entry; dw is exactly 0 where the clamp
    holds."""
    r, k, v, w, u, do = _wkv(np.random.default_rng(12), b, s, h, d, True, w_lo)
    tin = [_t(a) for a in (r, k, v, w, u, do)]
    got = tref.rwkv6_bwd(*tin, chunk=chunk)
    want = _sweep_bwd(*tin, chunk)
    assert -(-s // chunk) in (4, 5)
    for i, name in ((0, "dr"), (1, "dk"), (2, "dv"), (4, "du")):
        _close_rel(got[i].numpy(), want[i].numpy(), BWD_REL, name)
    live = w > 1e-20
    assert not got[3].numpy()[~live].any()
    dl = np.where(live, want[3].numpy(), 0.0)
    _close_rel(got[3].numpy() * w, dl, BWD_REL, "dl = dw w")


@pytest.mark.parametrize("b,s,h,d,chunk,w_lo", LOCAL_CASES)
def test_rwkv6_chunk_dstates_match_jax_vjp(b, s, h, d, chunk, w_lo):
    """dS of chunk c, the gradient of its exit state, against jax.vjp with
    respect to s0 of the JAX chunked form run over the rows after chunk c
    from that state, with do on those rows as o's cotangent; the last
    chunk's is 0.  Within 1e-5 of the largest entry plus the log sums'
    rounding."""
    r, k, v, w, u, do = _wkv(np.random.default_rng(13), b, s, h, d, True, w_lo)
    got = tref.rwkv6_chunk_dstates(_t(r), _t(w), _t(do), chunk=chunk).numpy()
    nc = -(-s // chunk)
    assert got.shape == (b, h, nc, d, d)
    assert not got[:, :, -1].any()
    rel = BWD_REL + _cum_rounding(w, chunk)
    for c in range(nc - 1):
        e = (c + 1) * chunk
        f = lambda s0: jref.rwkv6_scan_chunked(  # noqa: E731
            *[jnp.asarray(a[:, e:]) for a in (r, k, v, w)], jnp.asarray(u),
            s0=s0, chunk=chunk)[0]
        _, pull = jax.vjp(f, jnp.zeros((b, h, d, d), jnp.float32))
        (want,) = pull(jnp.asarray(do[:, e:]))
        _close_rel(got[:, :, c], np.asarray(want), rel, f"dS of chunk {c}")


def test_ops_cpu_dispatch_and_wrapper_checks():
    """On the CPU ``ops.rwkv6_scan`` takes the plain versions as the JAX
    package does off the TPU (chunks of 16 once S >= 32, else the
    recurrence); the kernel wrappers refuse CPU tensors and head dims they
    are not built for."""
    rng = np.random.default_rng(4)
    for s, want_fn in ((40, lambda *a: tref.rwkv6_scan_chunked(*a, chunk=16)),
                       (20, tref.rwkv6_scan)):
        xs = [_t(a) for a in _wkv(rng, 2, s, 2, 8)[:5]]
        for g, w_ in zip(ops.rwkv6_scan(*xs), want_fn(*xs)):
            assert torch.equal(g, w_)
        jo = jax.tree.map(np.asarray, __import__(
            "repro.kernels.ops", fromlist=["x"]).rwkv6_scan(
                *[jnp.asarray(x.numpy()) for x in xs]))
        np.testing.assert_allclose(ops.rwkv6_scan(*xs)[0].numpy(), jo[0], **FWD_TOL)
    xs = [_t(a) for a in _wkv(rng, 1, 8, 2, 16)[:5]]
    with pytest.raises(ValueError, match="CUDA"):
        twkv.rwkv6_fwd(*xs)
    bad = [_t(a) for a in _wkv(rng, 1, 8, 2, 48)[:5]]
    with pytest.raises(ValueError, match="head dim"):
        twkv.rwkv6_fwd(*bad)
    assert twkv.n_chunks(4096) == 128 and twkv.n_chunks(40) == 2
    # the bf16 tensor-core route takes chunks of 64, the f32 kernels 32
    assert twkv.chunk_of(torch.bfloat16) == 64 and twkv.chunk_of(torch.float32) == 32
    assert twkv.n_chunks(4096, twkv.chunk_of(torch.bfloat16)) == 64


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _jparams(cfg, seed=0, dtype=jnp.float32):
    """JAX init with a random nonzero w_b in every layer (numpy seed)."""
    p = JM.init_params(cfg, jax.random.key(seed), dtype=dtype)
    wb = np.asarray(p["layers"]["tm"]["w_b"])
    new = np.random.default_rng(seed + 10).normal(size=wb.shape).astype(np.float32)
    p["layers"]["tm"]["w_b"] = jnp.asarray(new, dtype)
    return p


def _pair(seed=0):
    cfg = reduced(get_config("rwkv6-3b"))
    jstate = JS.init_state(cfg, jax.random.key(seed), dtype=jnp.float32)
    jstate = jstate._replace(params=_jparams(cfg, seed))
    return cfg, jstate, state_from_jax(jax.tree.map(np.asarray, jstate))


def test_convert_carries_the_rwkv_tree():
    """params_from_jax / state_from_jax keep the nested tm / cm tree, the
    f32 u and w0 among bf16 leaves, and every value bit for bit."""
    cfg = reduced(get_config("rwkv6-3b"))
    jp = JM.init_params(cfg, jax.random.key(0))                 # bf16 init
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    assert len(tp["layers"]) == cfg.n_layers
    assert sorted(tp["layers"][0]) == ["cm", "ln1", "ln2", "tm"]
    assert sorted(tp["layers"][0]["tm"]) == sorted(jp["layers"]["tm"])
    assert sorted(tp["layers"][0]["cm"]) == sorted(jp["layers"]["cm"])
    for li, lp in enumerate(tp["layers"]):
        for path, leaf in T.leaves_with_paths(lp):
            keys = path.split("::")
            want = jp["layers"]
            for kk in keys:
                want = want[kk]
            want = np.asarray(want[li]).astype(np.float32)
            f32 = keys[-1] in ("u", "w0")
            assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), path
            np.testing.assert_array_equal(leaf.float().numpy(), want, err_msg=path)
    # the port's own init: same tree, shapes and dtypes as JAX's
    own = TM.init_params(cfg, seed=0, device="cpu")
    for (p1, a), (p2, b_) in zip(T.leaves_with_paths(own), T.leaves_with_paths(tp)):
        assert p1 == p2 and a.shape == b_.shape and a.dtype == b_.dtype, p1
    _, jstate, tstate = _pair()
    assert tstate.opt.m["layers"][0]["tm"]["u"].dtype == torch.float32
    assert int(tstate.opt.step) == 0


@pytest.mark.parametrize("s", [40, 48])
def test_logits_match_jax(s):
    """Reduced rwkv6-3b logits within 1e-4: S = 40 and 48 take the chunked
    plain version (chunks of 16), S = 40 with a ragged, padded last chunk."""
    cfg, jstate, tstate = _pair()
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, s))
    jl, jaux = JM.forward(cfg, jstate.params, tokens=jnp.asarray(toks))
    tl, taux = TM.forward(cfg, tstate.params, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))


def test_decay_and_mixes_with_state_match_jax():
    """_decay, and time_mix / channel_mix with a right-padded ``length``, a
    carried shift state and ``return_state``, against the JAX functions
    (1e-4)."""
    cfg, jstate, tstate = _pair()
    jl0 = jax.tree.map(lambda a: a[0], jstate.params["layers"])
    tl0 = tstate.params["layers"][0]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    last = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(TR._decay(tl0["tm"], _t(x)).numpy(),
                               np.asarray(JR._decay(jl0["tm"], jnp.asarray(x))),
                               **MODEL_TOL)
    lens = np.array([37, 21], np.int32)
    jo, (jsh, jS) = JR.time_mix(jl0["tm"], jnp.asarray(x), cfg,
                                shift_state=jnp.asarray(last),
                                length=jnp.asarray(lens), return_state=True)
    to, (tsh, tS) = TR.time_mix(tl0["tm"], _t(x), cfg, shift_state=_t(last),
                                length=_t(lens), return_state=True)
    for g, w_ in ((to, jo), (tsh, jsh), (tS, jS)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **MODEL_TOL)
    jc, jcs = JR.channel_mix(jl0["cm"], jnp.asarray(x), length=jnp.asarray(lens),
                             return_state=True)
    tc, tcs = TR.channel_mix(tl0["cm"], _t(x), length=_t(lens), return_state=True)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **MODEL_TOL)
    np.testing.assert_array_equal(tcs.numpy(), np.asarray(jcs))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_jax(remat):
    """Loss and every gradient leaf against jax.value_and_grad, each leaf
    within 1e-4 of its largest entry; with w_b nonzero no leaf is zero."""
    cfg, jstate, tstate = _pair()
    batch = JSyntheticLM(cfg.vocab_size, 40, 4, seed=1).batch(0)
    (jloss, _), jgrads = jax.value_and_grad(
        JS.make_loss_fn(cfg, remat=remat), has_aux=True)(
            jstate.params, {k: jnp.asarray(v) for k, v in batch.items()})
    (tloss, _), tgrads = TS.value_and_grad(TS.make_loss_fn(cfg, remat=remat))(
        tstate.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), **MODEL_TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for (path, g), (_, w_) in zip(T.leaves_with_paths(tgrads),
                                  T.leaves_with_paths(want)):
        scale = float(w_.abs().max())
        assert scale > 0, path
        assert float((g - w_).abs().max()) <= GRAD_REL * scale, path


def test_train_step_matches_jax():
    """One whole train step: loss and grad norm within 1e-4, parameters
    within 2 lr (1 + wd) of JAX's (Adam's g / (|g| + eps) can flip sign
    where a gradient is near zero)."""
    lr, wd = 1e-3, 0.1
    cfg, jstate, tstate = _pair()
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


def test_launch_train_rwkv_cpu(tmp_path, capsys):
    tlaunch.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                  "--steps", "3", "--ckpt-dir", str(tmp_path), "--seq-len", "40",
                  "--global-batch", "2"])
    out = capsys.readouterr().out
    assert "[train] done at step 2" in out
    loss = float(out.split("loss=")[-1].split()[0])
    assert np.isfinite(loss)


def test_rwkv_serving_still_refused():
    """rwkv6-3b serves (its slot state is made), as do the Mamba2 ``ssm``
    variant, the hybrid zamba2-7b and MoE (its pool, runner and engine
    stand up, expert parallelism included); rwkv6-3b refuses expert
    parallelism with JAX's error, having no experts."""
    cfg = t_reduced(t_get_config("rwkv6-3b"))
    state = TM.init_serve_state(cfg, 2, 9, 8, dtype=torch.float32, device="cpu")
    assert sorted(state) == ["cm_shift", "tm_shift", "wkv"]
    moe = t_reduced(t_get_config("olmoe-1b-7b"))
    params = {"embed": {"table": torch.zeros(4, 4)}}
    assert sorted(TM.init_serve_state(moe, 2, 9, 8, device="cpu")) == ["attn"]
    assert TRunner(moe, 2, 64).padded_experts() == moe.n_experts
    assert TEngine(moe, params, max_seq=32, slots=1).paged
    assert TEngine(moe, params, max_seq=32, slots=1,
                   expert_parallel=2).expert_parallel == 2
    with pytest.raises(ValueError, match="requires a MoE family"):
        TEngine(cfg, params, max_seq=32, slots=1, expert_parallel=2)
