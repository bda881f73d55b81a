"""Port parity, Mamba2 and hybrid (Zamba2) serving: the one-token step, the
Mamba2 scan from a carried state, the runner's entry points over the
hybrid's paged shared-attention KV beside its Mamba2 slot state, and the
serving engine on both paths (the runner's chunked prefill and the
dense-slab baseline) against the JAX package, on reduced zamba2-7b (5
layers: 2 groups of 2 and a 1-layer tail, head dim 16) and on the JAX
tests' pure-Mamba2 ``family="ssm"`` variant of it (``_mamba_cfg`` of
``tests/test_serve_families.py``), at fp32 with the JAX parameters carried
over through ``repro_torch.models.convert``; inputs from numpy seeds.  Each
test names its tolerance; the engines must agree token for token.  The JAX
engines' outputs are computed once per module and shared by the tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models.runner import ModelRunner as JRunner  # noqa: E402
from repro.models.runner import cache_spec as j_cache_spec  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.models.runner import ModelRunner as TRunner  # noqa: E402
from repro_torch.models.runner import cache_spec as t_cache_spec  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402

STEP_TOL = dict(rtol=1e-5, atol=1e-5)     # one f32 step, the same products
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_kernels_scan.py's own
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)    # tests/test_torch_ssm.py's model hold

# the mixes of tests/test_serve_families.py: 3 prompts on 2 slots under a
# budget of 12, the 19-token prompt prefilling in 8-token chunks while the
# other slot decodes; and 26 tokens in 8-token chunks on one slot
INTERLEAVED = dict(prompts=[[3, 1, 4, 1, 5, 9, 2, 6], [2, 7], list(range(1, 20))],
                   max_new=5, engine=dict(max_seq=64, slots=2, block_size=8,
                                          prefill_buckets=(8, 16, 64),
                                          max_tokens_per_tick=12))
CHUNKED = dict(prompts=[list(range(1, 27))], max_new=6,
               engine=dict(max_seq=64, slots=1, block_size=8,
                           prefill_buckets=(8, 64), max_tokens_per_tick=9))
# the hybrid's sharded mix (tests/test_serve_families.py:296), also served
# from an int8 pool
SHARDED = dict(prompts=[list(range(1, 13)), list(range(5, 17))], max_new=40,
               engine=dict(max_seq=64, slots=2, block_size=8,
                           prefill_buckets=(16, 64)))
MIXES = {"interleaved": INTERLEAVED, "chunked": CHUNKED, "sharded": SHARDED}
# (config, mix, engine options) of the engine tests
ENGINE_CASES = [(c, m, o) for c in ("hybrid", "ssm")
                for m in ("interleaved", "chunked")
                for o in ("runner", "slab")] + [("hybrid", "sharded", "int8"),
                                                ("hybrid", "sharded", "seq4")]
OPTIONS = {"runner": {}, "slab": dict(paged=False), "int8": dict(kv_dtype="int8"),
           "seq4": dict(seq_shards=4)}


def _mamba_cfg(get, red):
    """The pure-Mamba2 ssm config of tests/test_serve_families.py:31."""
    return red(get("zamba2-7b")).replace(
        name="mamba-ssm-reduced", family="ssm", attn_every=0, n_layers=2,
        n_heads=0, n_kv_heads=0, head_dim=0)


CFGS = {"hybrid": lambda get, red: red(get("zamba2-7b")), "ssm": _mamba_cfg}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol, **kw)


def _tree_close(got, want, tol, where):
    """Every leaf of two nested dicts (the port's tensors, JAX's arrays)."""
    assert set(got) == set(want), where
    for k in got:
        if isinstance(got[k], dict):
            _tree_close(got[k], want[k], tol, f"{where}/{k}")
        else:
            _close(got[k], want[k], tol, err_msg=f"{where}/{k}")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The shapes here are tiny: two intra-op threads keep this file from
    crowding the CPUs that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{name: (JAX cfg, port cfg, JAX params, port params)} at fp32."""
    out = {}
    for name, make in CFGS.items():
        cfg = make(get_config, reduced)
        p = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
        out[name] = (cfg, make(t_get_config, t_reduced), p,
                     params_from_jax(jax.tree.map(np.asarray, p)))
    return out


def _drain(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: tuple(r.out_tokens) for r in eng.run_until_drained()}


@pytest.fixture(scope="module")
def jax_out(models):
    """JAX's engine outputs and stats by (config, mix, options), each
    engine run once for the module (the int8 case against JAX's int8
    engine; 4 sequence shards against JAX's one shard, which JAX's own
    tests hold equal to 4)."""
    cache = {}

    def get(name, mix, opt):
        key = (name, mix, opt)
        if key not in cache:
            cfg, _, jparams, _ = models[name]
            m = MIXES[mix]
            kw = {} if opt == "seq4" else OPTIONS[opt]
            eng = JEngine(cfg, jparams, **m["engine"], **kw)
            cache[key] = (_drain(eng, m["prompts"], m["max_new"]), dict(eng.stats))
        return cache[key]
    return get


def _mid_stream(cfg, slots, seed, num_blocks=0, block_size=8):
    """A JAX serve state holding random mid-stream values (conv tails and
    any pages ~ N(0, 1), SSM states ~ N(0, 0.3^2)) and the port's copy of
    it through state_from_jax."""
    rng = np.random.default_rng(seed)
    js = JM.init_serve_state(cfg, slots, num_blocks, block_size, dtype=jnp.float32)

    def draw(path, a):
        scale = 0.3 if "ssm" in jax.tree_util.keystr(path) else 1.0
        return jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * scale)

    js = jax.tree_util.tree_map_with_path(draw, js)
    return js, state_from_jax(jax.tree.map(np.asarray, js))


# ---------------------------------------------------------------------------
# the one-token step and the scan from a carried state
# ---------------------------------------------------------------------------

def test_step_and_decode_step_match_jax(models):
    """ref.mamba2_step (1e-5; ops.mamba2_step is it on every device) and
    ssm.mamba_decode_step from a carried (conv tail, state) pair (1e-4)
    against the JAX functions; the new conv tail's carried rows are the old
    tail's, bit for bit; mamba_state_init has JAX's shapes and dtypes."""
    cfg, tcfg, jparams, tparams = models["hybrid"]
    rng = np.random.default_rng(1)
    b, h, p, n = 3, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 2.0, size=(b, h)).astype(np.float32)
    A = -rng.uniform(0.3, 16.0, size=(h,)).astype(np.float32)
    B, C = (rng.normal(size=(b, n)).astype(np.float32) for _ in range(2))
    S = rng.normal(size=(b, h, p, n)).astype(np.float32)
    jy, jS = jref.mamba2_step(x, dt, A, B, C, jnp.asarray(S))
    args = [_t(a) for a in (x, dt, A, B, C, S)]
    ty, tS = tref.mamba2_step(*args)
    _close(ty, jy, STEP_TOL)
    _close(tS, jS, STEP_TOL)
    assert all(torch.equal(a, b_) for a, b_ in zip(ops.mamba2_step(*args), (ty, tS)))

    jl0 = jax.tree.map(lambda a: a[0, 0], jparams["groups"])["mamba"]
    tl0 = tparams["groups"][0][0]["mamba"]
    xin = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(b, cfg.conv_width - 1,
                            cfg.d_inner + 2 * n)).astype(np.float32)
    jy, (jconv, jS) = JSSM.mamba_decode_step(jl0, jnp.asarray(xin), cfg,
                                             (jnp.asarray(conv), jnp.asarray(S)))
    ty, (tconv, tS) = TSSM.mamba_decode_step(tl0, _t(xin), tcfg, (_t(conv), _t(S)))
    _close(ty, jy, MODEL_TOL)
    _close(tS, jS, MODEL_TOL)
    _close(tconv, jconv, MODEL_TOL)
    np.testing.assert_array_equal(tconv[:, :-1].numpy(), conv[:, 1:])
    for tt, jj in zip(TSSM.mamba_state_init(tcfg, 3, 2, torch.float32, "cpu"),
                      JSSM.mamba_state_init(cfg, 3, 2, jnp.float32)):
        assert tuple(tt.shape) == jj.shape and not bool(tt.any())
        assert str(tt.dtype).removeprefix("torch.") == str(jj.dtype)


@pytest.mark.parametrize("s", [1, 7, 64, 70])
def test_scan_from_carried_state_matches_jax(s):
    """ops.mamba2_scan(h0=) against JAX's ops.mamba2_scan(h0=) within 2e-4
    (one token, below one 64-row chunk, one chunk and past it); dropping h0
    is caught at this tolerance (the control of the card check)."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 16, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.7, size=(b, s, h)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    B, C = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    h0 = (rng.normal(size=(b, h, p, n)) * 0.5).astype(np.float32)
    jy, jhf = jops.mamba2_scan(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                               h0=jnp.asarray(h0))
    tin = [_t(a) for a in (x, dt, A, B, C)]
    ty, thf = ops.mamba2_scan(*tin, h0=_t(h0))
    _close(ty, jy, SCAN_TOL)
    _close(thf, jhf, SCAN_TOL)
    assert not np.allclose(ops.mamba2_scan(*tin)[0].numpy(), np.asarray(jy),
                           **SCAN_TOL)


# ---------------------------------------------------------------------------
# the model's serving entry points and the runner
# ---------------------------------------------------------------------------

# the runner-path scenario: slot 1 of 3 continues a sequence 16 tokens in
# (its first two pages and its slot state mid-stream), two right-padded
# 8-token chunks of 7 and 3 valid rows, then one decode step over all slots
NB, BS = 9, 8
TABLES = np.array([[1, 4, 0, 0], [3, 5, 2, 7], [6, 0, 0, 0]], np.int32)
DECODE_LENS = np.array([9, 26, 2], np.int32)


@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_chunks_and_decode_match_jax(models, name):
    """From the same mid-stream state (state_from_jax, the hybrid's page
    pool included): two chunks through serve_prefill_chunk at slot 1 and
    q_offset 16 and 23, then a batched serve_decode_step; logits and every
    state key, pages included, within 1e-4 after each call."""
    cfg, tcfg, jparams, tparams = models[name]
    hybrid = name == "hybrid"
    js, ts = _mid_stream(cfg, 3, seed=2, num_blocks=NB if hybrid else 0)
    rng = np.random.default_rng(3)
    qoff = 16
    for n in (7, 3):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
        bt = TABLES[1] if hybrid else None
        jl, js = JM.serve_prefill_chunk(
            cfg, jparams, js, tokens=jnp.asarray(toks), length=jnp.int32(n),
            q_offset=jnp.int32(qoff), slot=jnp.int32(1),
            block_table=None if bt is None else jnp.asarray(bt))
        tl, ts = TM.serve_prefill_chunk(
            tcfg, tparams, ts, tokens=_t(toks), length=n, q_offset=qoff, slot=1,
            block_table=None if bt is None else _t(bt))
        _close(tl, jl, MODEL_TOL, err_msg=f"chunk of {n}")
        _tree_close(ts, js, MODEL_TOL, f"after the chunk of {n}")
        qoff += n
    nxt = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
    jl, js = JM.serve_decode_step(cfg, jparams, js, jnp.asarray(nxt),
                                  jnp.asarray(DECODE_LENS),
                                  jnp.asarray(TABLES) if hybrid else None)
    tl, ts = TM.serve_decode_step(tcfg, tparams, ts, _t(nxt), _t(DECODE_LENS),
                                  _t(TABLES) if hybrid else None)
    _close(tl, jl, MODEL_TOL)
    _tree_close(ts, js, MODEL_TOL, "after the decode step")


@pytest.mark.parametrize("name", list(CFGS))
def test_slab_prefill_and_decode_match_jax(models, name):
    """The dense-slab baseline's entry points: a batched prefill of two
    right-padded prompts (lengths 12 and 5) from any prior state, then two
    decode steps; logits and every state key (the hybrid's slabs included)
    within 1e-4."""
    cfg, tcfg, jparams, tparams = models[name]
    rng = np.random.default_rng(4)
    js = JM.init_decode_state(cfg, 2, 32, dtype=jnp.float32)
    js = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), js)    # prefill ignores it
    ts = state_from_jax(jax.tree.map(np.asarray, js))
    tok = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    lens = np.array([12, 5], np.int32)
    jl, js = JM.prefill(cfg, jparams, js, tokens=jnp.asarray(tok),
                        lengths=jnp.asarray(lens))
    tl, ts = TM.prefill(tcfg, tparams, ts, tokens=_t(tok), lengths=_t(lens))
    _close(tl, jl, MODEL_TOL)
    for step in range(2):
        nxt = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        jl, js = JM.decode_step(cfg, jparams, js, jnp.asarray(nxt),
                                jnp.asarray(lens + step))
        tl, ts = TM.decode_step(tcfg, tparams, ts, _t(nxt), _t(lens + step))
        _close(tl, jl, MODEL_TOL, err_msg=f"decode step {step}")
    if name == "hybrid":         # slab rows past each prompt's end hold junk
        for k in ("k", "v"):
            for i, n in enumerate(lens + 2):
                _close(ts["attn"][k][:, i, :n], js["attn"][k][:, i, :n], MODEL_TOL)
        ts, js = dict(ts), dict(js)
        del ts["attn"], js["attn"]
    _tree_close(ts, js, MODEL_TOL, "slab state")


@pytest.mark.parametrize("name", list(CFGS))
def test_cache_spec_matches_jax(models, name):
    """The spec's paged components (name, applications, kv heads, head dim)
    and slot-state keys with their batch axes equal JAX's."""
    cfg, tcfg, _, _ = models[name]
    j, t = j_cache_spec(cfg), t_cache_spec(tcfg)
    assert [(s.key, s.batch_axis) for s in t.slot_state] == \
        [(s.key, s.batch_axis) for s in j.slot_state]
    assert [(c.name, c.n_apps, c.kv_heads, c.head_dim) for c in t.paged] == \
        [(c.name, c.n_apps, c.kv_heads, c.head_dim) for c in j.paged]
    assert (t.has_paged, t.has_slot_state) == (j.has_paged, j.has_slot_state)
    assert TRunner(tcfg, 2, 64).attn_applications == \
        JRunner(cfg, 2, 64).attn_applications


def test_reset_slot_zeroes_one_slot(models):
    """reset_slot zeroes one slot's rows of every slot-state key in place,
    on axis 2 (conv_g, ssm_g) and axis 1 (conv_t, ssm_t), and leaves the
    other slots and the page pool bit for bit; slot_state_bytes is JAX's;
    copy_page touches the pool only."""
    cfg, tcfg, _, _ = models["hybrid"]
    js, ts = _mid_stream(cfg, 3, seed=6, num_blocks=NB)
    before = {k: v.clone() for k, v in ts.items() if k != "attn"}
    pool = {k: v.clone() for k, v in ts["attn"].items()}
    runner = TRunner(tcfg, 3, 64)
    assert runner.reset_slot(ts, 1) is ts
    for key, axis in (("conv_g", 2), ("ssm_g", 2), ("conv_t", 1), ("ssm_t", 1)):
        assert not bool(ts[key].select(axis, 1).any()), key
        for slot in (0, 2):
            assert torch.equal(ts[key].select(axis, slot),
                               before[key].select(axis, slot)), key
    assert all(torch.equal(ts["attn"][k], pool[k]) for k in pool)
    assert runner.slot_state_bytes(ts) == JRunner(cfg, 3, 64).slot_state_bytes(js)
    runner.copy_page(ts, 3, 5)
    assert all(torch.equal(ts["attn"][k][:, :, 5], pool[k][:, :, 3]) for k in pool)
    assert not bool(ts["conv_g"][:, :, 1].any())


def test_masked_slot_keeps_its_state_through_decode(models):
    """runner.decode with slot 1 masked off: slots 0 and 2 advance as JAX's
    runner advances them and the pool takes every row's K/V as JAX's does
    (1e-4); slot 1's Mamba2 rows stay bit for bit."""
    cfg, tcfg, jparams, tparams = models["hybrid"]
    js, ts = _mid_stream(cfg, 3, seed=7, num_blocks=NB)
    before = {k: v.clone() for k, v in ts.items() if k != "attn"}
    nxt = np.array([5, 9, 11], np.int32)
    mask = np.array([True, False, True])
    jl, js = JRunner(cfg, 3, 64).decode(jparams, js, jnp.asarray(nxt),
                                        jnp.asarray(DECODE_LENS),
                                        jnp.asarray(TABLES), jnp.asarray(mask))
    tl, ts = TRunner(tcfg, 3, 64).decode(tparams, ts, _t(nxt), _t(DECODE_LENS),
                                         _t(TABLES), mask)
    _close(tl[mask], np.asarray(jl)[mask], MODEL_TOL)
    _tree_close(ts, js, MODEL_TOL, "masked decode")
    for key, axis in (("conv_g", 2), ("ssm_g", 2), ("conv_t", 1), ("ssm_t", 1)):
        assert torch.equal(ts[key].select(axis, 1), before[key].select(axis, 1)), key
        assert not torch.equal(ts[key].select(axis, 0), before[key].select(axis, 0))


# ---------------------------------------------------------------------------
# the engine on both paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mix,opt", ENGINE_CASES)
def test_engine_matches_jax(models, jax_out, name, mix, opt):
    """The port's ServeEngine token-identical to JAX's: the runner path
    (the hybrid's page pool beside its slot state; Mamba2's slot state
    alone) and the dense-slab baseline on both mixes, and for the hybrid an
    int8 pool and 4 sequence shards on its sharded mix; the same token
    counts and dispatches, and no prefix hit (a slot-state family never
    attaches a cached prefix)."""
    _, tcfg, _, tparams = models[name]
    m = MIXES[mix]
    teng = TEngine(tcfg, tparams, **m["engine"], **OPTIONS[opt])
    want, jstats = jax_out(name, mix, opt)
    assert teng.has_slot_state == (opt != "slab")
    assert teng.paged == (name == "hybrid" and opt != "slab")
    assert teng.prefix_caching == teng.paged and not teng.prefix_attach
    assert _drain(teng, m["prompts"], m["max_new"]) == want
    for key in ("prefill_tokens", "decode_tokens", "padded_tokens",
                "prefill_dispatches", "ticks", "prefix_hit_tokens"):
        assert teng.stats[key] == jstats[key], key
    if opt == "seq4":
        n_apps = teng.runner.attn_applications
        assert teng.stats["noc_combines"] == n_apps * (
            teng.stats["prefill_dispatches"] + teng.stats["decode_dispatches"])
    if mix == "chunked" and opt == "runner":        # it really chunked
        assert teng.stats["prefill_dispatches"] == 4 and teng.stats["ticks"] >= 4


def test_prefix_attach_control(models):
    """Two prompts on one slot that share two full pages: with prefix
    caching on, the hybrid publishes the first prompt's pages but the
    second prefills whole (0 prefix-hit tokens) and matches JAX's engine;
    the control, an engine that attaches the cached prefix anyway (so it
    skips the Mamba2 prefill of those tokens), hits and diverges."""
    cfg, tcfg, jparams, tparams = models["hybrid"]
    shared = list(range(1, 17))
    prompts = [shared + [30, 31, 32], shared + [40, 41, 42, 43]]
    kw = dict(max_seq=64, slots=1, block_size=8, prefill_buckets=(8, 16, 64))
    want = _drain(JEngine(cfg, jparams, **kw), prompts, 6)
    eng = TEngine(tcfg, tparams, **kw)
    assert _drain(eng, prompts, 6) == want
    assert eng.stats["prefix_hit_tokens"] == 0 and eng.alloc.pages_shared == 0
    bad = TEngine(tcfg, tparams, **kw)
    bad.prefix_attach = True
    got = _drain(bad, prompts, 6)
    assert bad.stats["prefix_hit_tokens"] == 16
    assert got[0] == want[0] and got[1] != want[1]


def test_engine_that_ignores_the_mask_diverges(models, jax_out):
    """The control: a runner decode that writes every slot's Mamba2 state
    (the mask ignored) advances the prefilling neighbour's state and
    diverges from JAX on the interleaved mix."""
    _, tcfg, _, tparams = models["hybrid"]
    m = INTERLEAVED
    want, _ = jax_out("hybrid", "interleaved", "runner")
    eng = TEngine(tcfg, tparams, **m["engine"])
    decode = eng.runner.decode

    def unmasked(params, state, toks, lens, tables, mask, local=None):
        return decode(params, state, toks, lens, tables, np.ones_like(mask), local)

    eng.runner.decode = unmasked
    assert _drain(eng, m["prompts"], m["max_new"]) != want


def test_mamba_engine_refusals_match_jax(models):
    """paged=True, prefix caching, an int8 pool and sequence shards are
    refused for the pure-Mamba2 (slot-state-only) family with the JAX
    engine's messages."""
    cfg, tcfg, jparams, tparams = models["ssm"]
    for kw, match in ((dict(paged=True), "no paged cache components"),
                      (dict(prefix_caching=True), "prefix_caching requires"),
                      (dict(kv_dtype="int8"), "quantizes the paged page pool"),
                      (dict(seq_shards=2), "requires the paged KV cache")):
        for engine, c, params in ((JEngine, cfg, jparams), (TEngine, tcfg, tparams)):
            with pytest.raises(ValueError, match=match):
                engine(c, params, max_seq=32, slots=1, **kw)


@pytest.mark.parametrize("extra,mode", [
    ([], "kv=paged + slot state"), (["--dense"], "kv=dense"),
    (["--kv-dtype", "int8"], "kv=paged + slot state/int8"),
    (["--seq-shards", "4"], "kv=paged + slot state/seq4")],
    ids=["runner", "slab", "int8", "seq4"])
def test_launch_serve_zamba_cpu(capsys, extra, mode):
    """``launch/serve.py --arch zamba2-7b --reduced --device cpu`` serves on
    the runner path (also from an int8 pool and over 4 sequence shards,
    whose NoC totals it prints) and on the slab path."""
    tlaunch.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                  "--requests", "4", "--max-new-tokens", "4"] + extra)
    out = capsys.readouterr().out
    assert "4 requests, 16 tokens" in out and mode in out
    assert ("[serve] noc:" in out) == (extra[:1] == ["--seq-shards"])


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::mamba2_fwd_tc_kernel<64, 64>(...)",
     "port CUDA kernels: Mamba2"),
    ("void (anonymous namespace)::mamba2_fwd_cb_kernel<64>(...)",
     "port CUDA kernels: Mamba2"),
    ("void (anonymous namespace)::mamba2_fwd_kernel<16, 8>(...)",
     "port CUDA kernels: Mamba2"),
    ("void (anonymous namespace)::flash_fwd_kernel<float, 112>(...)",
     "port CUDA kernels: slab prefill (flash)"),
    ("void (anonymous namespace)::flash_fwd_bf16_kernel<112>(...)",
     "port CUDA kernels: slab prefill (flash)"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other PyTorch ops")])
def test_trace_serve_files_the_mamba_kernels(name, group):
    """trace_serve files the Mamba2 forward and the slab prefill's flash
    forward (either form) under their own groups, and ranges
    Mamba2's plain one-token step and its conv (whose non-GEMM kernels
    leave "other PyTorch ops") through the modules the model calls them
    from."""
    from repro_torch.launch import trace_serve

    assert trace_serve._group(name) == group
    ranged = {(mod.__name__, attr) for mod, attr, _ in trace_serve.RANGED}
    assert {("repro_torch.kernels.ops", "mamba2_step"),
            ("repro_torch.models.ssm", "_causal_conv"),
            ("repro_torch.models.ssm", "_conv_step")} <= ranged
