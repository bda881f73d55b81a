"""Port parity, training: with the JAX package's parameters (and optimizer
state) carried over through ``repro_torch.models.convert``, the port's
forward logits, loss and every gradient match JAX's ``jax.value_and_grad
(make_loss_fn(...))`` within 1e-4 at fp32 on reduced granite-3-2b (GQA,
tied embeddings) and reduced stablelm-1.6b (MHA); AdamW, clipping and the
schedule match ``repro.train.optim`` within 1e-6; a whole train step stays
within 2 lr (1 + wd) of JAX's; the data pipeline is bit-identical; the
checkpoint round-trips bf16; the driver resumes bit-exactly."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data import for_cell as j_for_cell  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optim as JO  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, latest_step, restore, save  # noqa: E402
from repro_torch.configs import SHAPES_BY_NAME  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.data import Prefetcher, SyntheticLM, for_cell  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.runtime import SimulatedFailure, StragglerDetector, TrainDriver  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["granite-3-2b", "stablelm-1.6b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _leaves_close(got_tree, jax_tree, **kw):
    """Port tree vs a JAX tree of the params' structure, leaf by leaf."""
    want = params_from_jax(_np(jax_tree))
    for (path, g), (_, w) in zip(T.leaves_with_paths(got_tree),
                                 T.leaves_with_paths(want)):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(),
                                   err_msg=path, **{**TOL, **kw})


def _pair(arch, seed=0):
    cfg = reduced(get_config(arch))
    jstate = JS.init_state(cfg, jax.random.key(seed), dtype=jnp.float32)
    return cfg, jstate, state_from_jax(_np(jstate))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [None, 5])
def test_forward_logits_match_jax(arch, window):
    cfg, jstate, tstate = _pair(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 19))
    jl, jaux = JM.forward(cfg, jstate.params, tokens=jnp.asarray(toks),
                          attn_window=window)
    tl, taux = TM.forward(cfg, tstate.params, torch.from_numpy(toks),
                          attn_window=window)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_jax(arch, remat):
    """Every gradient leaf of the loss, with and without remat, and with a
    loss mask."""
    cfg, jstate, tstate = _pair(arch)
    batch = JSyntheticLM(cfg.vocab_size, 16, 4, seed=1).batch(0)
    batch["loss_mask"] = (np.random.default_rng(2).random((4, 16)) > 0.3
                          ).astype(np.float32)
    (jloss, jmet), jgrads = jax.value_and_grad(
        JS.make_loss_fn(cfg, remat=remat), has_aux=True)(jstate.params,
                                                          _jbatch(batch))
    (tloss, tmet), tgrads = TS.value_and_grad(
        TS.make_loss_fn(cfg, remat=remat))(tstate.params, _tbatch(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    np.testing.assert_allclose(float(tmet["nll"]), float(jmet["nll"]), **TOL)
    _leaves_close(tgrads, jgrads)
    assert all(not p.requires_grad for p in T.leaves(tstate.params))


def test_cross_entropy_matches_jax(rng):
    logits = (rng.normal(size=(2, 5, 11)) * 2).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.5).astype(np.float32)
    for m in (None, mask):
        want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                mask=None if m is None else jnp.asarray(m))
        got = TS.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                               mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_optimizer_matches_jax(rng):
    """adamw_update (several steps from a shared state), clip_by_global_norm
    and cosine_schedule on identical inputs, within 1e-6."""
    shapes = {"a": (4, 8), "b": {"c": (5,), "d": (3, 2)}}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    jp = jax.tree.map(jnp.asarray, params)
    tp = T.map(torch.from_numpy, {"a": params["a"], "b": dict(params["b"])})
    jopt, topt = JO.adamw_init(jp), TO.adamw_init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: (3 * rng.normal(size=a.shape)).astype(np.float32),
                         params)
        tg = T.map(torch.from_numpy, {"a": g["a"], "b": dict(g["b"])})
        jg = jax.tree.map(jnp.asarray, g)
        jc, jn = JO.clip_by_global_norm(jg, 1.0)
        tc, tn = TO.clip_by_global_norm(tg, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _tree_close(tc, jc, 1e-6)
        lr_j = JO.cosine_schedule(jopt.step + 1, base_lr=1e-2, warmup=2, total=10)
        lr_t = TO.cosine_schedule(topt.step + 1, base_lr=1e-2, warmup=2, total=10)
        np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=1e-6)
        jp, jopt, jn = JO.adamw_update(jp, jg, jopt, lr=lr_j)
        tp, topt, tn = TO.adamw_update(tp, tg, topt, lr=lr_t)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for got, want in ((tp, jp), (topt.m, jopt.m), (topt.v, jopt.v)):
            _tree_close(got, want, 1e-6)
        assert int(topt.step) == int(jopt.step) == i + 1
    for s in (0, 1, 2, 5, 9, 10, 20):
        np.testing.assert_allclose(
            float(TO.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                     base_lr=3e-4, warmup=3, total=12)),
            float(JO.cosine_schedule(jnp.asarray(s, jnp.int32), base_lr=3e-4,
                                     warmup=3, total=12)), rtol=1e-6, atol=1e-12)


def _tree_close(tt, jt, tol):
    for a, b in zip(T.leaves(tt), jax.tree.leaves(jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("microbatch", [None, 4])
def test_train_step_matches_jax(arch, microbatch):
    """Three whole train steps from one state.  A parameter may differ from
    JAX's by up to 2 lr (1 + wd) per step: where a gradient is near zero,
    Adam's g / (|g| + eps) can flip sign between two summation orders."""
    lr, wd, steps = 1e-3, 0.1, 3
    cfg, jstate, tstate = _pair(arch)
    kw = dict(base_lr=lr, warmup=1, weight_decay=wd, microbatch=microbatch)
    jstep = jax.jit(JS.make_train_step(cfg, **kw))
    tstep = TS.make_train_step(cfg, **kw)
    ds = JSyntheticLM(cfg.vocab_size, 16, 8, seed=4)
    for i in range(steps):
        jstate, jm = jstep(jstate, _jbatch(ds.batch(i)))
        tstate, tm = tstep(tstate, _tbatch(ds.batch(i)))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   **TOL)
    want = params_from_jax(_np(jstate.params))
    diffs = [(t - w).abs() for t, w in zip(T.leaves(tstate.params), T.leaves(want))]
    bound = steps * 2 * lr * (1 + wd)
    worst = max(float(d.max()) for d in diffs)
    over = sum(int((d > 1e-5).sum()) for d in diffs)
    n = sum(d.numel() for d in diffs)
    print(f"{arch} microbatch={microbatch}: max |dp| {worst:.3g} (bound "
          f"{bound:.3g}), {over} of {n} elements above 1e-5")
    assert worst <= bound
    assert int(tstate.opt.step) == int(jstate.opt.step) == steps


def test_state_from_jax_carries_moments():
    cfg, jstate, _ = _pair("granite-3-2b")
    jstate, _ = jax.jit(JS.make_train_step(cfg, warmup=1))(
        jstate, _jbatch(JSyntheticLM(cfg.vocab_size, 8, 2).batch(0)))
    t = state_from_jax(_np(jstate))
    assert "lm_head" not in t.params                     # tied embeddings
    for got, want in ((t.params, jstate.params), (t.opt.m, jstate.opt.m),
                      (t.opt.v, jstate.opt.v)):
        _leaves_close(got, want, rtol=0, atol=0)
    assert t.opt.step.dtype == torch.int32 and int(t.opt.step) == 1


def test_loss_decreases_dense():
    """The port's counterpart of tests/test_train.py::test_loss_decreases_dense
    (bf16 parameters, plain versions on the CPU)."""
    cfg = t_reduced(t_get_config("granite-3-2b"))
    state = TS.init_state(cfg, seed=0, device="cpu")
    step = TS.make_train_step(cfg, base_lr=5e-3, warmup=5, total_steps=100)
    ds = SyntheticLM(cfg.vocab_size, 32, 8, seed=0)
    losses = []
    for i in range(60):
        state, m = step(state, _tbatch(ds.batch(i)))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:5]) - 0.3, losses[::10]


def test_synthetic_data_bit_equal_to_jax():
    cfg = t_get_config("granite-3-2b")
    for shape in ("train_4k",):
        tds = for_cell(cfg, SHAPES_BY_NAME[shape], seed=3)
        jds = j_for_cell(get_config("granite-3-2b"),
                         __import__("repro.configs", fromlist=["x"]).SHAPES_BY_NAME[shape],
                         seed=3)
        assert (tds.seq_len, tds.global_batch) == (jds.seq_len, jds.global_batch)
    ds, jds = SyntheticLM(101, 8, 4, seed=9), JSyntheticLM(101, 8, 4, seed=9)
    for s in (0, 5, 17):
        a, b = ds.batch(s), jds.batch(s)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    pf = Prefetcher(ds, start_step=3, depth=2)
    step, batch = next(pf)
    assert step == 3
    np.testing.assert_array_equal(batch["tokens"], jds.batch(3)["tokens"])
    pf.close()


def _state_tree(rng):
    return {"a": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
            "bf": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)
                                   ).bfloat16(),
            "nested": [torch.arange(6, dtype=torch.int32),
                       torch.tensor(7, dtype=torch.int32)]}


def test_checkpoint_roundtrip_bf16(tmp_path, rng):
    t = _state_tree(rng)
    save(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    back = restore(str(tmp_path), 7, t)
    for (p, a), (_, b) in zip(T.leaves_with_paths(t), T.leaves_with_paths(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert torch.equal(a, b), p
    with np.load(tmp_path / "step_0000000007" / "arrays.npz") as z:
        assert z["bf"].dtype == np.uint16              # the bf16 bit pattern
    bad = dict(t, a=torch.zeros(3, 3))
    with pytest.raises(ValueError):
        restore(str(tmp_path), 7, bad)


def test_async_save_copies_before_returning(tmp_path, rng):
    """The optimizer updates tensors in place: what is saved is the tree as
    it was when save() returned, whatever happens to it afterwards."""
    t = _state_tree(rng)
    want = T.map(lambda x: x.clone(), t)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(1, t)
    for leaf in T.leaves(t):
        leaf.add_(1)
    mgr.wait()
    back = restore(str(tmp_path), 1, t)
    for a, b in zip(T.leaves(back), T.leaves(want)):
        assert torch.equal(a, b)
    for s in (2, 3, 4):
        mgr.save(s, t)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003", "step_0000000004"]


def test_driver_failure_and_resume_bit_exact(tmp_path):
    """Inject a crash, restart the driver, verify bit-exact continuation."""
    import shutil
    cfg = t_reduced(t_get_config("stablelm-1.6b"))
    ds = SyntheticLM(cfg.vocab_size, 16, 4, seed=3)
    step = TS.make_train_step(cfg, base_lr=1e-3)

    def mk(inject=None):
        return TrainDriver(
            train_step=step,
            init_state=lambda: TS.init_state(cfg, seed=0, device="cpu"),
            dataset=ds, ckpt_dir=str(tmp_path), ckpt_every=3,
            put_batch=_tbatch, inject_failure_at=inject)

    with pytest.raises(SimulatedFailure):
        mk(inject=5).run(total_steps=10, log_fn=lambda *a: None)
    assert latest_step(str(tmp_path)) == 5
    out = mk().run(total_steps=10, log_fn=lambda *a: None)
    assert out["last_step"] == 9 and out["mean_step_s"] > 0
    shutil.rmtree(tmp_path)
    out2 = mk().run(total_steps=10, log_fn=lambda *a: None)
    for a, b in zip(T.leaves(out["state"]), T.leaves(out2["state"])):
        assert torch.equal(a, b)


def test_straggler_detector_copy():
    det = StragglerDetector(n_hosts=4, threshold=1.5, patience=2)
    flagged = set()
    for s in range(6):
        flagged = det.observe({0: 1.0, 1: 1.05, 2: 0.95, 3: 1.0 if s < 2 else 3.0})
    assert flagged == {3}


def test_launch_train_cpu(tmp_path, capsys):
    tlaunch.main(["--reduced", "--device", "cpu", "--steps", "3",
                  "--ckpt-dir", str(tmp_path), "--seq-len", "16",
                  "--global-batch", "2"])
    assert "[train] done at step 2" in capsys.readouterr().out
    assert latest_step(str(tmp_path)) == 2
    with pytest.raises(RuntimeError, match=r"chips\(mesh\) = 256"):
        tlaunch.main(["--reduced", "--device", "cpu", "--mesh", "single"])
    with pytest.raises(NotImplementedError, match="one process"):
        tlaunch.main(["--reduced", "--device", "cpu", "--distributed"])


def test_forward_refuses_other_families():
    """No family is left to refuse: MoE trains too (its forward returns
    logits and nonzero [lb, z] aux; tests/test_torch_moe_train.py holds it
    to JAX), and an unknown family still raises."""
    cfg = t_reduced(t_get_config("olmoe-1b-7b"))
    logits, aux = TM.forward(cfg, TM.init_params(cfg, device="cpu"),
                             torch.zeros(1, 4, dtype=torch.int32))
    assert logits.shape == (1, 4, cfg.vocab_size) and aux.shape == (2,)
    assert bool(torch.all(aux > 0))
    with pytest.raises(NotImplementedError, match="not ported"):
        TM.forward(cfg.replace(family="vision"), {},
                   torch.zeros(1, 4, dtype=torch.int32))
