"""Port parity, RWKV6 serving: the one-token steps, the wkv scan from a
carried state, the runner's slot-state entry points and the serving engine
on both paths (the runner's slot-state continuous batching and the
dense-slab baseline) against the JAX package, on reduced rwkv6-3b at fp32
with the JAX parameters carried over through ``repro_torch.models.convert``
(a random nonzero ``w_b``, zero at init, so the decay depends on the data);
inputs from numpy seeds.  Each test names its tolerance; the engines must
agree token for token."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models.runner import ModelRunner as JRunner  # noqa: E402
from repro.models.runner import cache_spec as j_cache_spec  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rwkv as TR  # noqa: E402
from repro_torch.models.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.models.runner import ModelRunner as TRunner  # noqa: E402
from repro_torch.models.runner import cache_spec as t_cache_spec  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402

STEP_TOL = dict(rtol=1e-5, atol=1e-5)     # one f32 step, the same products
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_kernels_scan.py's own
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)    # tests/test_torch_rwkv.py's model hold
KEYS = ("tm_shift", "wkv", "cm_shift")

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
MIXES = {"interleaved": INTERLEAVED, "chunked": CHUNKED}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol, **kw)


@pytest.fixture(scope="module")
def rwkv():
    """(cfg, JAX params, port params): reduced rwkv6-3b at fp32 with a
    random nonzero w_b in every layer."""
    cfg = reduced(get_config("rwkv6-3b"))
    p = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    wb = np.asarray(p["layers"]["tm"]["w_b"])
    p["layers"]["tm"]["w_b"] = jnp.asarray(
        np.random.default_rng(10).normal(size=wb.shape).astype(np.float32))
    return cfg, p, params_from_jax(jax.tree.map(np.asarray, p))


def _mid_stream(cfg, slots, seed):
    """A JAX serve state holding random mid-stream values (shifts ~ N(0, 1),
    wkv ~ N(0, 0.3^2)) and the port's copy of it."""
    rng = np.random.default_rng(seed)
    js = JM.init_serve_state(cfg, slots, 0, 8, dtype=jnp.float32)
    js = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)
                         * (0.3 if k == "wkv" else 1.0)) for k, v in js.items()}
    return js, state_from_jax(jax.tree.map(np.asarray, js))


def _layer0(jparams, tparams):
    return jax.tree.map(lambda a: a[0], jparams["layers"]), tparams["layers"][0]


# ---------------------------------------------------------------------------
# the one-token steps and the scan from a carried state
# ---------------------------------------------------------------------------

def test_step_and_step_mixes_match_jax(rwkv):
    """ref.rwkv6_step (1e-5) and time_mix_step / channel_mix_step from a
    carried state (1e-4) against the JAX functions; the mixes' new shift
    state is their input row, bit for bit."""
    cfg, jparams, tparams = rwkv
    rng = np.random.default_rng(1)
    b, h, d = 3, cfg.rwkv_heads, cfg.rwkv_head_dim
    r, k, v = (rng.normal(size=(b, h, d)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.05, 0.999, size=(b, h, d)).astype(np.float32)
    u = rng.normal(size=(h, d)).astype(np.float32)
    S = rng.normal(size=(b, h, d, d)).astype(np.float32)
    jo, jS = jref.rwkv6_step(r, k, v, w, u, jnp.asarray(S))
    to, tS = tref.rwkv6_step(_t(r), _t(k), _t(v), _t(w), _t(u), _t(S))
    _close(to, jo, STEP_TOL)
    _close(tS, jS, STEP_TOL)
    assert torch.equal(ops.rwkv6_step(_t(r), _t(k), _t(v), _t(w), _t(u), _t(S))[1], tS)

    jl0, tl0 = _layer0(jparams, tparams)
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    last, last_cm = (rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
                     for _ in range(2))
    jy, (jsh, jS) = JR.time_mix_step(jl0["tm"], jnp.asarray(x), cfg,
                                     (jnp.asarray(last), jnp.asarray(S)))
    ty, (tsh, tS) = TR.time_mix_step(tl0["tm"], _t(x), cfg, (_t(last), _t(S)))
    _close(ty, jy, MODEL_TOL)
    _close(tS, jS, MODEL_TOL)
    np.testing.assert_array_equal(tsh.numpy(), np.asarray(jsh))
    jc, jcs = JR.channel_mix_step(jl0["cm"], jnp.asarray(x), jnp.asarray(last_cm))
    tc, tcs = TR.channel_mix_step(tl0["cm"], _t(x), _t(last_cm))
    _close(tc, jc, MODEL_TOL)
    np.testing.assert_array_equal(tcs.numpy(), np.asarray(jcs))
    # rwkv_state_init: JAX's shapes and dtypes
    for tt, jj in zip(TR.rwkv_state_init(cfg, 3, 2, torch.float32, "cpu"),
                      JR.rwkv_state_init(cfg, 3, 2, jnp.float32)):
        assert tuple(tt.shape) == jj.shape and not bool(tt.any())


@pytest.mark.parametrize("s", [1, 7, 32, 70])
def test_scan_from_carried_state_matches_jax(s):
    """ops.rwkv6_scan(s0=) against JAX's ops.rwkv6_scan(s0=) within 2e-4 (S
    below and past the plain chunked form's switch at 32, and one token);
    the port's chunked form at the kernels' chunks (32, 64) from the same
    state against the exact recurrence, the card kernel's plain version."""
    rng = np.random.default_rng(s)
    b, h, d = 2, 3, 16
    r, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.05, 0.999, size=(b, s, h, d)).astype(np.float32)
    u = rng.normal(size=(h, d)).astype(np.float32)
    s0 = rng.normal(size=(b, h, d, d)).astype(np.float32)
    jo, jsf = jops.rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                              s0=jnp.asarray(s0))
    tin = [_t(a) for a in (r, k, v, w, u)]
    to, tsf = ops.rwkv6_scan(*tin, s0=_t(s0))
    _close(to, jo, SCAN_TOL)
    _close(tsf, jsf, SCAN_TOL)
    rec = tref.rwkv6_scan(*tin, s0=_t(s0))
    for chunk in (32, 64):
        got = tref.rwkv6_scan_chunked(*tin, s0=_t(s0), chunk=chunk)
        for g, want in zip(got, rec):
            _close(g, want, SCAN_TOL)
    # dropping s0 is caught at this tolerance (the control of the card check)
    assert not np.allclose(ops.rwkv6_scan(*tin)[0].numpy(), np.asarray(jo), **SCAN_TOL)


# ---------------------------------------------------------------------------
# the model's serving entry points and the runner
# ---------------------------------------------------------------------------

def test_prefill_chunks_and_decode_match_jax(rwkv):
    """From the same mid-stream state (state_from_jax): two right-padded
    8-token chunks (7 and 3 valid rows) through serve_prefill_chunk at slot
    1, then a batched serve_decode_step; logits and every state key within
    1e-4 after each call."""
    cfg, jparams, tparams = rwkv
    js, ts = _mid_stream(cfg, 3, seed=2)
    rng = np.random.default_rng(3)
    for n in (7, 3):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
        jl, js = JM.serve_prefill_chunk(cfg, jparams, js, tokens=jnp.asarray(toks),
                                        length=jnp.int32(n), q_offset=jnp.int32(0),
                                        block_table=None, slot=jnp.int32(1))
        tl, ts = TM.serve_prefill_chunk(cfg, tparams, ts, tokens=_t(toks),
                                        length=n, q_offset=0, block_table=None,
                                        slot=1)
        _close(tl, jl, MODEL_TOL, err_msg=f"chunk of {n}")
        for key in KEYS:
            _close(ts[key], js[key], MODEL_TOL, err_msg=key)
    nxt = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
    lens = np.array([4, 10, 2], np.int32)
    jl, js = JM.serve_decode_step(cfg, jparams, js, jnp.asarray(nxt),
                                  jnp.asarray(lens))
    tl, ts = TM.serve_decode_step(cfg, tparams, ts, _t(nxt), _t(lens))
    _close(tl, jl, MODEL_TOL)
    for key in KEYS:
        _close(ts[key], js[key], MODEL_TOL, err_msg=key)


def test_slab_prefill_and_decode_match_jax(rwkv):
    """The dense-slab baseline's entry points: a batched prefill of two
    right-padded prompts (lengths 12 and 5) from any prior state, then two
    decode steps; logits and state within 1e-4."""
    cfg, jparams, tparams = rwkv
    js, ts = _mid_stream(cfg, 2, seed=4)        # prefill ignores it, as JAX's
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    lens = np.array([12, 5], np.int32)
    jl, js = JM.prefill(cfg, jparams, js, tokens=jnp.asarray(tok),
                        lengths=jnp.asarray(lens))
    tl, ts = TM.prefill(cfg, tparams, ts, tokens=_t(tok), lengths=_t(lens))
    _close(tl, jl, MODEL_TOL)
    for step in range(2):
        nxt = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        jl, js = JM.decode_step(cfg, jparams, js, jnp.asarray(nxt),
                                jnp.asarray(lens + step))
        tl, ts = TM.decode_step(cfg, tparams, ts, _t(nxt), _t(lens + step))
        _close(tl, jl, MODEL_TOL, err_msg=f"decode step {step}")
    for key in KEYS:
        _close(ts[key], js[key], MODEL_TOL, err_msg=key)


def test_cache_spec_matches_jax():
    """The slot-state keys and batch axes of rwkv6-3b's spec equal JAX's
    (no paged component); the dense family's spec stays paged-only."""
    for arch in ("rwkv6-3b", "granite-3-2b"):
        j = j_cache_spec(reduced(get_config(arch)))
        t = t_cache_spec(t_reduced(t_get_config(arch)))
        assert [(s.key, s.batch_axis) for s in t.slot_state] == \
            [(s.key, s.batch_axis) for s in j.slot_state]
        assert [(c.name, c.n_apps, c.kv_heads, c.head_dim) for c in t.paged] == \
            [(c.name, c.n_apps, c.kv_heads, c.head_dim) for c in j.paged]
        assert (t.has_paged, t.has_slot_state) == (j.has_paged, j.has_slot_state)


def test_reset_slot_zeroes_one_slot(rwkv):
    """reset_slot zeroes every key's rows of one slot in place and leaves
    the other slots bit for bit; slot_state_bytes is JAX's."""
    cfg, _, _ = rwkv
    js, ts = _mid_stream(cfg, 3, seed=6)
    before = {k: v.clone() for k, v in ts.items()}
    runner = TRunner(cfg, 3, 64)
    out = runner.reset_slot(ts, 1)
    assert out is ts
    for key in KEYS:
        assert not bool(ts[key][:, 1].any())
        for slot in (0, 2):
            assert torch.equal(ts[key][:, slot], before[key][:, slot])
    assert runner.slot_state_bytes(ts) == JRunner(cfg, 3, 64).slot_state_bytes(js)


def test_masked_slot_keeps_its_state_through_decode(rwkv):
    """runner.decode with slot 1 masked off: slots 0 and 2 advance as JAX's
    runner advances them (1e-4), slot 1's rows stay bit for bit."""
    cfg, jparams, tparams = rwkv
    js, ts = _mid_stream(cfg, 3, seed=7)
    before = {k: v.clone() for k, v in ts.items()}
    nxt = np.array([5, 9, 11], np.int32)
    lens = np.array([3, 0, 6], np.int32)
    mask = np.array([True, False, True])
    jl, js = JRunner(cfg, 3, 64).decode(jparams, js, jnp.asarray(nxt),
                                        jnp.asarray(lens), None, jnp.asarray(mask))
    tl, ts = TRunner(cfg, 3, 64).decode(tparams, ts, _t(nxt), _t(lens), None, mask)
    _close(tl[mask], np.asarray(jl)[mask], MODEL_TOL)
    for key in KEYS:
        assert torch.equal(ts[key][:, 1], before[key][:, 1]), key
        _close(ts[key], js[key], MODEL_TOL, err_msg=key)
        assert not torch.equal(ts[key][:, 0], before[key][:, 0]), key


# ---------------------------------------------------------------------------
# the engine on both paths
# ---------------------------------------------------------------------------

def _drain(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: tuple(r.out_tokens) for r in eng.run_until_drained()}


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("paged", [None, False], ids=["runner", "slab"])
def test_engine_matches_jax(rwkv, mix, paged):
    """The port's ServeEngine token-identical to JAX's on the runner path
    (slot state, chunked prefill) and on the dense-slab baseline, with the
    same token counts and dispatches."""
    cfg, jparams, tparams = rwkv
    m = MIXES[mix]
    jeng = JEngine(cfg, jparams, paged=paged, **m["engine"])
    teng = TEngine(cfg, tparams, paged=paged, **m["engine"])
    assert teng.has_slot_state == jeng.has_slot_state == (paged is None)
    assert not teng.paged and not teng.prefix_caching and teng.alloc is None
    jout = _drain(jeng, m["prompts"], m["max_new"])
    assert _drain(teng, m["prompts"], m["max_new"]) == jout
    for key in ("prefill_tokens", "decode_tokens", "padded_tokens",
                "prefill_dispatches", "ticks"):
        assert teng.stats[key] == jeng.stats[key], key
    if mix == "chunked" and paged is None:        # it really chunked
        assert teng.stats["prefill_dispatches"] == 4 and teng.stats["ticks"] >= 4
    assert teng.kv_cache_bytes() == sum(v.numel() * v.element_size()
                                        for v in teng.state.values())


def test_engine_that_ignores_the_mask_diverges(rwkv):
    """The control: a runner decode that writes every slot's state (the
    mask ignored) advances the prefilling neighbour's state and diverges
    from JAX on the interleaved mix."""
    cfg, jparams, tparams = rwkv
    m = INTERLEAVED
    want = _drain(JEngine(cfg, jparams, **m["engine"]), m["prompts"], m["max_new"])
    eng = TEngine(cfg, tparams, **m["engine"])
    decode = eng.runner.decode

    def unmasked(params, state, toks, lens, tables, mask, local=None):
        return decode(params, state, toks, lens, tables, np.ones_like(mask), local)

    eng.runner.decode = unmasked
    assert _drain(eng, m["prompts"], m["max_new"]) != want


def test_engine_has_no_page_pressure(rwkv):
    """Slot-state-only serving runs the same scheduler under a token budget
    with no allocator: five requests through two slots all finish,
    token-identical to JAX's engine (the counterpart of
    tests/test_serve_families.py::test_ssm_engine_has_no_page_pressure)."""
    cfg, jparams, tparams = rwkv
    kw = dict(max_seq=64, slots=2, prefill_buckets=(8, 16, 64),
              max_tokens_per_tick=10)
    prompts = [list(range(1 + i, 14 + i)) for i in range(5)]
    jeng, teng = JEngine(cfg, jparams, **kw), TEngine(cfg, tparams, **kw)
    assert teng.alloc is None and not hasattr(jeng, "alloc")
    out = _drain(teng, prompts, 6)
    assert len(out) == 5 and out == _drain(jeng, prompts, 6)
    assert jeng.stats["preemptions"] == 0 and jeng.stats["stalled_ticks"] == 0


def test_engine_refusals_match_jax(rwkv):
    """paged=True, prefix caching, an int8 pool and sequence shards are
    refused for a slot-state-only family with the JAX engine's messages."""
    cfg, jparams, tparams = rwkv
    for kw, match in ((dict(paged=True), "no paged cache components"),
                      (dict(prefix_caching=True), "prefix_caching requires"),
                      (dict(kv_dtype="int8"), "quantizes the paged page pool"),
                      (dict(seq_shards=2), "requires the paged KV cache")):
        for engine, params in ((JEngine, jparams), (TEngine, tparams)):
            with pytest.raises(ValueError, match=match):
                engine(cfg, params, max_seq=32, slots=1, **kw)


@pytest.mark.parametrize("dense", [False, True], ids=["runner", "slab"])
def test_launch_serve_rwkv_cpu(capsys, dense):
    """``launch/serve.py --arch rwkv6-3b --reduced --device cpu`` serves on
    both paths, and refuses an int8 pool and sequence shards."""
    argv = ["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
            "--requests", "4", "--max-new-tokens", "4"] + (["--dense"] if dense else [])
    tlaunch.main(argv)
    out = capsys.readouterr().out
    assert "4 requests, 16 tokens" in out
    assert ("kv=dense" if dense else "kv=slot state") in out
    for extra in (["--kv-dtype", "int8"], ["--seq-shards", "2"]):
        with pytest.raises(ValueError):
            tlaunch.main(argv + extra)


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::rwkv6_fwd_scan_kernel(float*, float const*, "
     "float const*, float*, long, int, int)", "port CUDA kernels: wkv6"),
    ("void (anonymous namespace)::rwkv6_fwd_out_kernel<64>(...)", "port CUDA kernels: wkv6"),
    ("void (anonymous namespace)::rwkv6_fwd_kernel<float, 16>(...)", "port CUDA kernels: wkv6"),
    ("void (anonymous namespace)::rmsnorm_kernel<__nv_bfloat16, 1>(...)",
     "port CUDA kernels: rmsnorm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other PyTorch ops")])
def test_trace_serve_files_the_rwkv_kernels(name, group):
    """trace_serve files the wkv6 forward and rmsnorm under their own
    groups, and ranges RWKV6's plain step, decay and shift (whose non-GEMM
    kernels leave "other PyTorch ops") through the modules the model calls
    them from."""
    from repro_torch.launch import trace_serve

    assert trace_serve._group(name) == group
    ranged = {(mod.__name__, attr) for mod, attr, _ in trace_serve.RANGED}
    assert {("repro_torch.kernels.ops", "rwkv6_step"),
            ("repro_torch.models.rwkv", "_decay"),
            ("repro_torch.models.rwkv", "_shift")} <= ranged
