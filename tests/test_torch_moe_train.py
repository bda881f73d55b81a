"""Port parity, MoE training: with the JAX package's parameters carried over
through ``repro_torch.models.convert``, the port's ``forward`` (logits and
the [lb, z] aux), its loss and every gradient leaf match JAX's ``forward``
and ``jax.value_and_grad(make_loss_fn(...))`` within 1e-4 at fp32 (the
tolerance of tests/test_torch_train.py) on reduced olmoe-1b-7b (8 experts,
top 2), reduced qwen2-moe-a2.7b (a shared expert) and reduced qwen2-moe
with 20 experts (padded to 32): with remat on and off, at the default
capacity factor 1.25 with assignments dropped and at the dropless cf =
E / k; the padded experts' router columns take exactly zero gradient on
both sides.  One train step and a microbatch-2 step match JAX's
``make_train_step`` (the bound of tests/test_torch_train.py); the loss
falls; a crash and resume of the driver over an MoE state (its f32
routers among bf16 leaves) ends bit-exact; the launcher trains.  Inputs
come from numpy seeds; the JAX references are computed once per module."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.runtime import SimulatedFailure, TrainDriver  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, BATCH = 16, 4                       # 64 rows a dispatch
# name -> (arch, experts or None for the reduced config's 8)
CONFIGS = {"olmoe": ("olmoe-1b-7b", None), "qwen2-moe": ("qwen2-moe-a2.7b", None),
           "padded": ("qwen2-moe-a2.7b", 20)}
# (config, remat, capacity factor: "default" 1.25 or "dropless" E / k):
# each config with remat on and off at the default; the routed-only and
# the padded configs also at E / k (one with remat, one without)
GRAD_CASES = [(n, r, "default") for n in CONFIGS for r in (True, False)] + [
    ("olmoe", True, "dropless"), ("padded", False, "dropless")]
# the JAX references are tiny programs whose compile takes most of their
# time: XLA's cheapest compile keeps this file's run short
JIT = dict(compiler_options={"xla_backend_optimization_level": 0,
                             "xla_llvm_disable_expensive_passes": True})


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The shapes here are tiny: two intra-op threads keep this file from
    crowding the CPUs that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _cfgs(name, cf="default"):
    """(JAX cfg, port cfg) of a case, the capacity factor set on both."""
    arch, experts = CONFIGS[name]
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    if experts:
        cfg, tcfg = (c.replace(n_experts=experts) for c in (cfg, tcfg))
    if cf == "dropless":
        f = TMOE.moe_padded_experts(tcfg) / tcfg.top_k
        cfg, tcfg = (c.replace(capacity_factor=f) for c in (cfg, tcfg))
    return cfg, tcfg


@pytest.fixture(scope="module")
def states():
    """Per config: the JAX train state at fp32 (each from key 0, all in
    one compiled program) and the port's copy."""
    cfgs = {name: _cfgs(name)[0] for name in CONFIGS}
    jss = jax.jit(lambda key: {n: JS.init_state(c, key, dtype=jnp.float32)
                               for n, c in cfgs.items()}, **JIT)(jax.random.key(0))
    return {n: (js, state_from_jax(_np(js))) for n, js in jss.items()}


def _batch(cfg, seed=1):
    return JSyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=seed).batch(0)


@pytest.fixture(scope="module")
def jax_grads(states):
    """``jax.value_and_grad(make_loss_fn)`` at (config, capacity factor),
    computed once: JAX's remat changes only what it stores, so one
    reference holds the port with remat on and with it off."""
    cache = {}

    def get(name, cf):
        if (name, cf) not in cache:
            cfg, _ = _cfgs(name, cf)
            cache[name, cf] = jax.jit(jax.value_and_grad(
                JS.make_loss_fn(cfg, remat=False), has_aux=True), **JIT)(
                    states[name][0].params, _jbatch(_batch(cfg)))
        return cache[name, cf]
    return get


def _routings(monkeypatch):
    """Record each routing the port's MoE layers make, in call order: the
    forward's, then (under remat) the backward's recomputes, the last
    layer first.  ``route`` returns before anything the recompute needs
    last, so each recompute records it whole."""
    seen, route = [], TMOE.route

    def recording(*args):
        r = route(*args)
        seen.append((r.slot.clone(), 1.0 - float(r.keep.float().mean())))
        return r
    monkeypatch.setattr(TMOE, "route", recording)
    return seen


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_and_aux_match_jax(name, states):
    """``forward``'s logits and its aux [lb, z] (summed over the layers)
    against JAX's at the default capacity factor."""
    cfg, tcfg = _cfgs(name)
    js, ts = states[name]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 19))
    jl, jaux = jax.jit(functools.partial(JM.forward, cfg), **JIT)(
        js.params, tokens=jnp.asarray(toks))
    tl, taux = TM.forward(tcfg, ts.params, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), **TOL)
    assert taux.shape == (2,) and float(taux[0]) > 0 and float(taux[1]) > 0


@pytest.mark.parametrize("name,remat,cf", GRAD_CASES,
                         ids=[f"{n}-remat{int(r)}-{c}" for n, r, c in GRAD_CASES])
def test_loss_and_gradients_match_jax(name, remat, cf, states, jax_grads,
                                      monkeypatch):
    """The loss (nll + 0.01 lb + 1e-3 z), its metrics and every gradient
    leaf; at the default capacity assignments drop, at E / k none do; the
    padded router columns' gradients are exactly zero on both sides."""
    cfg, tcfg = _cfgs(name, cf)
    ts = states[name][1]
    batch = _batch(cfg)
    (jloss, jmet), jgrads = jax_grads(name, cf)
    routed = _routings(monkeypatch)
    (tloss, tmet), tgrads = TS.value_and_grad(
        TS.make_loss_fn(tcfg, remat=remat))(ts.params, _tbatch(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    for k in ("nll", "lb", "z"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), err_msg=k,
                                   **TOL)
    want = params_from_jax(_np(jgrads))
    for (path, g), (_, w) in zip(T.leaves_with_paths(tgrads),
                                 T.leaves_with_paths(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=path, **TOL)
    # every layer drops at the default capacity, none at E / k; remat's
    # recomputes route exactly as the forward did
    L = tcfg.n_layers
    assert len(routed) == (2 * L if remat else L)
    fracs = [f for _, f in routed]
    if cf == "dropless":
        assert all(f == 0.0 for f in fracs), fracs
    else:
        assert all(f > 0.0 for f in fracs), fracs
    for (s0, f0), (s1, f1) in zip(routed[:L], routed[L:][::-1]):
        assert torch.equal(s0, s1) and f0 == f1
    e = tcfg.n_experts
    for tl, jr in zip(tgrads["layers"], np.asarray(jgrads["layers"]["moe"]["router"])):
        r = tl["moe"]["router"]
        assert r.shape[1] == TMOE.moe_padded_experts(tcfg)
        if r.shape[1] > e:
            assert torch.count_nonzero(r[:, e:]) == 0
            assert not np.any(jr[:, e:])
        assert torch.count_nonzero(r[:, :e]) > 0


TRAIN_KW = dict(base_lr=1e-3, warmup=1, weight_decay=0.1)


@pytest.fixture(scope="module")
def jax_steps(states):
    """JAX's train step of reduced olmoe from its state, whole and over two
    microbatches, both in one compiled program -> {microbatch: (state,
    metrics)}."""
    cfg, _ = _cfgs("olmoe")
    steps = {mb: JS.make_train_step(cfg, **TRAIN_KW, microbatch=mb)
             for mb in (None, 2)}
    out = jax.jit(lambda s, b: [steps[mb](s, b) for mb in (None, 2)], **JIT)(
        states["olmoe"][0], _jbatch(_batch(cfg, seed=4)))
    return dict(zip((None, 2), out))


@pytest.mark.parametrize("microbatch", [None, 2])
def test_train_step_matches_jax(microbatch, states, jax_steps):
    """One whole train step of reduced olmoe, and one over two
    microbatches (each routed as its own dispatch, its capacity from its
    own rows, as JAX's scan over microbatches): the loss, the grad norm,
    and every parameter within 2 lr (1 + wd) of JAX's."""
    cfg, tcfg = _cfgs("olmoe")
    ts = T.map(torch.clone, states["olmoe"][1])
    js, jm = jax_steps[microbatch]
    ts, tm = TS.make_train_step(tcfg, **TRAIN_KW, microbatch=microbatch)(
        ts, _tbatch(_batch(cfg, seed=4)))
    for k in ("loss", "grad_norm", "lb", "z"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **TOL)
    want = params_from_jax(_np(js.params))
    worst = max(float((t - w).abs().max())
                for t, w in zip(T.leaves(ts.params), T.leaves(want)))
    lr, wd = TRAIN_KW["base_lr"], TRAIN_KW["weight_decay"]
    assert worst <= 2 * lr * (1 + wd), worst
    assert int(ts.opt.step) == int(js.opt.step) == 1


def test_loss_decreases_moe():
    """Reduced olmoe in bf16 (its routers f32) on the plain versions: the
    loss falls over a few steps, the aux losses stay finite."""
    cfg = t_reduced(t_get_config("olmoe-1b-7b"))
    state = TS.init_state(cfg, seed=0, device="cpu")
    assert state.params["layers"][0]["moe"]["router"].dtype == torch.float32
    step = TS.make_train_step(cfg, base_lr=5e-3, warmup=3, total_steps=100)
    ds = SyntheticLM(cfg.vocab_size, 32, 8, seed=0)
    losses = []
    for i in range(24):
        state, m = step(state, _tbatch(ds.batch(i)))
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["lb"])) and np.isfinite(float(m["z"]))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.3, losses[::4]


def test_driver_failure_and_resume_bit_exact_moe(tmp_path):
    """A crash, a restart from the checkpoint, and the same run uncrashed
    end bit-identical over an MoE train state (f32 routers among bf16
    leaves, AdamW moments in f32)."""
    import shutil
    cfg = t_reduced(t_get_config("olmoe-1b-7b"))
    ds = SyntheticLM(cfg.vocab_size, 16, 4, seed=3)
    step = TS.make_train_step(cfg, base_lr=1e-3)

    def mk(inject=None):
        return TrainDriver(
            train_step=step,
            init_state=lambda: TS.init_state(cfg, seed=0, device="cpu"),
            dataset=ds, ckpt_dir=str(tmp_path), ckpt_every=2,
            put_batch=_tbatch, inject_failure_at=inject)

    with pytest.raises(SimulatedFailure):
        mk(inject=3).run(total_steps=6, log_fn=lambda *a: None)
    assert latest_step(str(tmp_path)) == 3
    out = mk().run(total_steps=6, log_fn=lambda *a: None)
    assert out["last_step"] == 5
    shutil.rmtree(tmp_path)
    out2 = mk().run(total_steps=6, log_fn=lambda *a: None)
    dtypes = {a.dtype for a in T.leaves(out["state"].params)}
    assert dtypes == {torch.bfloat16, torch.float32}
    for a, b in zip(T.leaves(out["state"]), T.leaves(out2["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launch_train_moe_cpu(tmp_path, capsys):
    """``launch/train.py --arch olmoe-1b-7b --reduced --device cpu`` trains
    two steps."""
    tlaunch.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                  "--steps", "2", "--ckpt-dir", str(tmp_path), "--seq-len", "16",
                  "--global-batch", "2"])
    out = capsys.readouterr().out
    assert "[train] done at step 1" in out
    assert np.isfinite(float(out.split("loss=")[-1].split()[0]))
