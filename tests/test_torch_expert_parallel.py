"""Port parity, expert parallelism: the expert shards as views of one
device's banks.

One layer's expert-parallel dispatch (``moe_apply(expert_parallel=ep)``)
at ep 1, 2 and 4 against the JAX package's ``_moe_apply_ep_local`` run per
shard in process under ``jax.vmap(..., axis_name="expert")`` over the
stacked shard banks (its ``lax.axis_index`` and ``psum`` work under a named
vmap, so no fake-device subprocess is needed), on reduced olmoe-1b-7b (8
experts, dropping at the default capacity factor) and reduced
qwen2-moe-a2.7b at 20 experts (padded to 32) with its shared expert: in
f32 within ``F32_TOL``, in bf16 within ``BF16_TOL`` with a control (the
shards' f32 partials summed before the one cast, the unsharded dispatch's
rounding) that must fail it; ``frac_dropped`` and ``expert_load`` exactly
equal.  A skewed router at the default capacity factor drops as many
assignments sharded as unsharded.  The engine at ep 4, ep 4 with the expert
cache and ep 2 x 2 sequence shards is token-identical to JAX's unsharded
engine and to the port's on the mix of tests/test_moe_serve.py's EP
snippet, with its load invariant and cache accounting; the validation
errors are JAX's; ``expert_param_specs`` names JAX's sharded leaves; the
launcher's ``--expert-parallel``.  Inputs come from numpy seeds."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402

BANKS = ("w_gate", "w_up", "w_down")
# f32: the port's products and JAX's sum in other orders (read: at most
# 4.8e-7 at outputs up to 2.6, the same at ep 1 as at ep 4)
F32_TOL = dict(rtol=0.0, atol=1e-6)
# bf16, against the reference compiled without excess precision (each op
# rounds its result): the readings were 0 (the port's shards round and sum
# as JAX's); the control, the unsharded rounding, reads 0.0078-0.0156 (one
# bf16 ulp of outputs in [1, 4)), so the tolerance sits below one ulp at
# |y| >= 0.5
BF16_TOL = dict(rtol=0.0, atol=2e-3)
# the engine mix of tests/test_moe_serve.py's EP snippet (reduced olmoe,
# fp32, the default capacity factor)
ENGINE = dict(max_seq=64, slots=2, block_size=8, prefill_buckets=(8, 16, 64),
              max_tokens_per_tick=12)
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7], list(range(1, 20))]
EP_OPTIONS = {"ep4": dict(expert_parallel=4),
              "ep4_cache": dict(expert_parallel=4, expert_cache_size=4),
              "ep2_seq2": dict(expert_parallel=2, seq_shards=2),
              "ep2_seq2_cache": dict(expert_parallel=2, seq_shards=2,
                                     expert_cache_size=4)}
JIT = dict(compiler_options={"xla_backend_optimization_level": 0,
                             "xla_llvm_disable_expensive_passes": True})


@pytest.fixture(autouse=True, scope="module")
def _cheap():
    """Two intra-op threads (tiny shapes), and JAX's jit at XLA's cheapest
    compile while the module runs (the JAX engine calls ``jax.jit``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    jit = jax.jit
    jax.jit = lambda f=None, **kw: (jit(f, **{**JIT, **kw}) if f is not None
                                    else lambda g: jit(g, **{**JIT, **kw}))
    yield
    jax.jit = jit
    torch.set_num_threads(n)


_LAYERS = {}


def _layer(name, skew=False):
    """(JAX cfg, port cfg, JAX layer params f32, x [2, 9, d] f32), once per
    module."""
    if (name, skew) not in _LAYERS:
        _LAYERS[name, skew] = _make_layer(name, skew)
    return _LAYERS[name, skew]


def _make_layer(name, skew):
    arch = "qwen2-moe-a2.7b" if name == "qwen2-moe" else "olmoe-1b-7b"
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    if name == "qwen2-moe":                   # 20 experts pad to 32
        cfg, tcfg = (c.replace(n_experts=20) for c in (cfg, tcfg))
    p = jax.jit(lambda key: JMOE.moe_init(key, cfg, dtype=jnp.float32))(
        jax.random.key(3))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    if skew:                                  # every row prefers expert 0
        c = rng.normal(size=cfg.d_model).astype(np.float32)
        x += 3.0 * c
        p = dict(p, router=p["router"].at[:, 0].add(jnp.asarray(c)))
    return cfg, tcfg, p, x


def _jax_ep(p, x, cfg, ep):
    """JAX's ``_moe_apply_ep_local`` on each of ``ep`` shards under a
    named vmap (the banks stacked [ep, E_loc, ...], the rest replicated)
    -> (every shard's y, every shard's aux).  Compiled without XLA's
    excess precision, so each bf16 op rounds its own result, as the
    function run op by op does (XLA's CPU compile otherwise keeps fused
    bf16 chains in f32, up to two bf16 ulps off)."""
    e_loc = p["w_gate"].shape[0] // ep
    stacked = {k: (v.reshape((ep, e_loc) + v.shape[1:]) if k in BANKS else v)
               for k, v in p.items()}
    axes = {k: (0 if k in BANKS else None) for k in p}
    fn = functools.partial(JMOE._moe_apply_ep_local, cfg=cfg,
                           axis_name="expert", return_stats=True)
    f = jax.vmap(fn, in_axes=(axes, None), axis_name="expert")
    opts = {**JIT["compiler_options"], "xla_allow_excess_precision": False}
    return jax.jit(f, compiler_options=opts)(stacked, x)


def _dropped(aux, cfg, x, shard=None) -> int:
    """The dispatch's dropped assignments, from its ``frac_dropped`` (JAX's
    jitted reference folds the division into a product, so the fraction
    itself may differ in its last bit)."""
    f = aux["frac_dropped"] if shard is None else aux["frac_dropped"][shard]
    n = x.shape[0] * x.shape[1] * cfg.top_k
    got = float(f) * n
    assert abs(got - round(got)) < 1e-3
    return round(got)


def _cast(p, jdt, tdt):
    """The layer's parameters in ``jdt`` (JAX) and ``tdt`` (port), the
    router kept in f32 as ``moe_init`` keeps it."""
    jp = {k: (v if k == "router" else jax.tree.map(lambda a: a.astype(jdt), v))
          for k, v in p.items()}
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return jp, tp


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ep", [1, 2, 4])
@pytest.mark.parametrize("name", ["olmoe", "qwen2-moe"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ep_dispatch_matches_jax_per_shard(dtype, name, ep):
    cfg, tcfg, p, x = _layer(name)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jp, tp = _cast(p, jdt, tdt)
    ys, aux = _jax_ep(jp, jnp.asarray(x).astype(jdt), cfg, ep)
    for i in range(1, ep):                    # the psum: every shard equal
        assert bool((ys[i] == ys[0]).all())
    want = torch.from_numpy(np.array(ys[0].astype(jnp.float32)))
    xt = torch.from_numpy(x).to(tdt)
    got, ta = TMOE.moe_apply(tp, xt, tcfg, return_stats=True,
                             expert_parallel=ep)
    assert got.dtype == tdt and got.shape == xt.shape
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    torch.testing.assert_close(got.float(), want, **tol)
    assert _dropped(ta, tcfg, x) == _dropped(aux, tcfg, x, shard=0)
    assert np.array_equal(ta["expert_load"].numpy(),
                          np.asarray(aux["expert_load"][0]))
    assert float(ta["frac_dropped"]) == float(
        TMOE.moe_apply(tp, xt, tcfg, return_stats=True)[1]["frac_dropped"])
    if dtype == "bf16" and ep > 1:
        # the control: the unsharded dispatch sums the shards' f32
        # contributions before its one cast, and fails the tolerance
        plain, _ = TMOE.moe_apply(tp, xt, tcfg)
        assert not torch.allclose(plain.float(), want, **tol)


def test_skewed_routing_drops_as_unsharded():
    """Every row prefers expert 0, so at the default capacity factor the
    dispatch drops: the shards keep exactly the unsharded assignments, in
    the port and in JAX alike."""
    cfg, tcfg, p, x = _layer("olmoe", skew=True)
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    xt = torch.from_numpy(x)
    _, base = TMOE.moe_apply(tp, xt, tcfg, return_stats=True)
    _, jbase = jax.jit(functools.partial(JMOE.moe_apply, cfg=cfg,
                                         return_stats=True))(p, jnp.asarray(x))
    assert _dropped(base, tcfg, x) == _dropped(jbase, tcfg, x) > 0
    assert float(base["frac_dropped"]) > 0.5
    for ep in (2, 4):
        _, aux = TMOE.moe_apply(tp, xt, tcfg, return_stats=True,
                                expert_parallel=ep)
        _, jaux = _jax_ep(p, jnp.asarray(x), cfg, ep)
        assert float(aux["frac_dropped"]) == float(base["frac_dropped"])
        assert _dropped(aux, tcfg, x) == _dropped(jaux, tcfg, x, shard=0)
        assert torch.equal(aux["expert_load"], base["expert_load"])


def test_shards_are_views_of_the_banks():
    """Shard e's banks are slices of the layer's, sharing its storage: no
    bank is copied."""
    _, _, p, _ = _layer("olmoe")
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    shards = TMOE.expert_shards(tp, 4)
    e_loc = tp["w_gate"].shape[0] // 4
    for e, bank in enumerate(shards):
        for w in BANKS:
            assert bank[w].shape[0] == e_loc
            assert bank[w].untyped_storage().data_ptr() == \
                tp[w].untyped_storage().data_ptr()
            assert torch.equal(bank[w], tp[w][e * e_loc:(e + 1) * e_loc])


def test_expert_param_specs_name_jax_sharded_leaves():
    """``expert_param_specs`` marks the leaves JAX's shards over its expert
    axis (the routed banks), and no other (router, shared expert, the
    rest replicated)."""
    cfg = reduced(get_config("qwen2-moe-a2.7b"))
    jp = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.key(0),
                                               dtype=jnp.float32))
    jspecs = JMOE.expert_param_specs(jp, "expert")
    want = sorted(jax.tree_util.keystr(path) for path, spec in
                  jax.tree_util.tree_leaves_with_path(
                      jspecs, is_leaf=lambda s: isinstance(
                          s, jax.sharding.PartitionSpec))
                  if tuple(spec) == (None, "expert"))
    tp = TM.init_params(t_reduced(t_get_config("qwen2-moe-a2.7b")),
                        device="cpu", dtype=torch.float32)
    specs = TMOE.expert_param_specs(tp)
    got, n_layers = [], 0
    for li, layer in enumerate(specs["layers"]):
        n_layers += 1
        for key, spec in layer["moe"].items():
            if spec == 0:
                got.append(key)
        assert layer["moe"]["router"] is None
        assert all(v is None for v in layer["moe"]["shared"]["gate"].values())
    assert specs["embed"]["table"] is None
    assert sorted(set(got)) == sorted({w.split("'")[-2] for w in want})
    assert len(got) == 3 * n_layers == 3 * cfg.n_layers


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def olmoe():
    """(JAX cfg, port cfg, JAX params, port params), reduced olmoe at fp32,
    and the JAX unsharded engine's tokens on the mix."""
    cfg = reduced(get_config("olmoe-1b-7b"))
    jp = jax.jit(lambda key: JM.init_params(cfg, key, dtype=jnp.float32))(
        jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    eng = JEngine(cfg, jp, **ENGINE)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=5)
    want = {r.rid: tuple(r.out_tokens) for r in eng.run_until_drained()}
    return cfg, t_reduced(t_get_config("olmoe-1b-7b")), tp, want


def _drain(tcfg, tp, **kw):
    eng = TEngine(tcfg, tp, **ENGINE, **kw)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=5)
    return {r.rid: tuple(r.out_tokens) for r in eng.run_until_drained()}, eng


@pytest.mark.parametrize("opt", list(EP_OPTIONS))
def test_ep_engine_matches_jax_unsharded(olmoe, opt, monkeypatch):
    """The EP engine token-identical to JAX's unsharded engine and to the
    port's; ``sum(expert_load) == L * k * routed tokens``; with the cache,
    hits and misses counted and the migration bytes at the expert's size,
    every ``expert_*`` stat equal to the port's unsharded cached engine's;
    every MoE dispatch ran over its shards."""
    cfg, tcfg, tp, want = olmoe
    seen = []
    apply = TMOE._moe_apply_ep_local

    def watched(p, xt, r, cap, k, ep, dtype):
        seen.append(ep)
        return apply(p, xt, r, cap, k, ep, dtype)

    monkeypatch.setattr(TMOE, "_moe_apply_ep_local", watched)
    kw = EP_OPTIONS[opt]
    got, eng = _drain(tcfg, tp, **kw)
    assert got == want
    assert seen and set(seen) == {kw["expert_parallel"]}
    s = eng.stats
    load = np.asarray(s["expert_load"], np.float64)
    assert int(load.sum()) == (cfg.n_layers * cfg.top_k
                               * int(s["expert_routed_tokens"]))
    monkeypatch.undo()
    base_kw = {k: v for k, v in kw.items() if k != "expert_parallel"}
    if "expert_cache_size" in kw:
        assert s["expert_hits"] + s["expert_misses"] > 0
        assert (s["expert_migration_bytes"] == s["expert_migrations"]
                * eng.expert_cache.expert_bytes)
        base, beng = _drain(tcfg, tp, **base_kw)
        assert base == want
        for k, v in beng.stats.items():
            if k.startswith("expert_"):
                assert np.array_equal(np.asarray(s[k]), np.asarray(v)), k
    else:
        assert eng.expert_cache is None and s["expert_hits"] == 0


def test_ep_telemetry_without_cache(olmoe):
    """Expert parallelism turns the telemetry on without the cache, as
    JAX's engine does; an engine with neither asks for none."""
    _, tcfg, tp, _ = olmoe
    eng = TEngine(tcfg, tp, **ENGINE, expert_parallel=2)
    assert eng._moe_stats and eng._moe_kw == {"expert_stats": True,
                                              "expert_parallel": 2}
    assert eng.stats["expert_load"].shape == (tcfg.n_experts,)
    plain = TEngine(tcfg, tp, **ENGINE)
    assert not plain._moe_stats and plain._moe_kw == {}


def test_ep_validation_matches_jax(olmoe):
    """The JAX engine's ValueErrors, message for message: ep 0, ep 3 on 64
    padded experts, a dense family, the dense slabs."""
    cfg, tcfg, tp, _ = olmoe
    full, tfull = get_config("olmoe-1b-7b"), t_get_config("olmoe-1b-7b")
    dense, tdense = (reduced(get_config("stablelm-1.6b")),
                     t_reduced(t_get_config("stablelm-1.6b")))
    jdummy = {"embed": {"table": jnp.zeros((4, 4), jnp.float32)}}
    tdummy = {"embed": {"table": torch.zeros(4, 4)}}
    cases = [(cfg, tcfg, dict(expert_parallel=0)),
             (full, tfull, dict(expert_parallel=3)),
             (dense, tdense, dict(expert_parallel=2)),
             (cfg, tcfg, dict(expert_parallel=2, paged=False))]
    for jc, tc, kw in cases:
        with pytest.raises(ValueError) as jerr:
            JEngine(jc, jdummy, max_seq=32, slots=1, **kw)
        with pytest.raises(ValueError) as terr:
            TEngine(tc, tdummy, max_seq=32, slots=1, **kw)
        assert str(terr.value) == str(jerr.value)
    # every divisor of the padded count builds, at full width too
    for ep in (1, 2, 4, 8, 16, 32, 64):
        assert TEngine(tfull, tdummy, max_seq=32, slots=1, block_size=16,
                       expert_parallel=ep).expert_parallel == ep


def test_launch_serve_expert_parallel_cpu(capsys):
    """``--expert-parallel 4`` builds on the CPU and prints the telemetry
    line with its shard count, alone and beside two sequence shards."""
    for extra, mode in (([], "/ep4"), (["--seq-shards", "2"], "/seq2/ep4")):
        tlaunch.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new-tokens", "3",
                      "--expert-parallel", "4"] + extra)
        out = capsys.readouterr().out
        assert mode in out and "[serve] 3 requests" in out
        line = [ln for ln in out.splitlines()
                if ln.startswith("[serve] experts:")][0]
        assert line.endswith("ep=4")
