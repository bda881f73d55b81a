"""Port parity, MoE serving: the routed-expert layer (GShard capacity,
drops, padded experts, shared experts, ties), the model's serving entry
points over the paged pool and the dense slabs, and the serving engine on
both paths (the runner's chunked prefill over the pool, in the engine
dtype, in int8 and over 4 sequence shards, and the dense-slab baseline)
against the JAX package at the default ``capacity_factor`` 1.25, where
assignments really drop; on reduced olmoe-1b-7b (2 layers, d 64, 8
experts, top 2, expert width 32) and reduced qwen2-moe-a2.7b (a shared
expert) at fp32, with the JAX parameters carried over through
``repro_torch.models.convert``; inputs from numpy seeds.

The serving tests run a *skewed* olmoe: a shared direction added to every
embedding row, and the routers of experts 0 and 1 leaning towards it, so
every token routes to experts 0 and 1 and each dispatch of more rows than
its capacity drops assignments, in row order.  Engines are compared with
engines at equal chunking, never with a monolithic reference (at the
default capacity the drops follow the dispatch size).  Each test names its
tolerance; the engines must agree token for token.  The JAX engines'
outputs are computed once per module and shared by the tests."""
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import run_subprocess  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models.runner import ModelRunner as JRunner  # noqa: E402
from repro.models.runner import cache_spec as j_cache_spec  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.models.runner import ModelRunner as TRunner  # noqa: E402
from repro_torch.models.runner import cache_spec as t_cache_spec  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.engine import BlockAllocator  # noqa: E402

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)    # one MoE layer, the same f32 products
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)    # tests/test_torch_model.py's model hold

INTERLEAVED = dict(prompts=[[3, 1, 4, 1, 5, 9, 2, 6], [2, 7], list(range(1, 20))],
                   max_new=5, engine=dict(max_seq=64, slots=2, block_size=8,
                                          prefill_buckets=(8, 16, 64),
                                          max_tokens_per_tick=12))
CHUNKED = dict(prompts=[list(range(1, 27))], max_new=6,
               engine=dict(max_seq=64, slots=1, block_size=8,
                           prefill_buckets=(8, 64), max_tokens_per_tick=9))
SHARDED = dict(prompts=[list(range(1, 13)), list(range(5, 17))], max_new=40,
               engine=dict(max_seq=64, slots=2, block_size=8,
                           prefill_buckets=(16, 64)))
# 8 slots whose first four requests finish early: the decode then routes
# four idle rows (token 0) ahead of the four live ones, at a capacity of 4
# (8 rows) that the skewed experts overflow
STAGGERED = dict(prompts=[[5 + i, 9, 2 * i + 1] for i in range(8)],
                 max_new=[2] * 4 + [7] * 4,
                 engine=dict(max_seq=32, slots=8, block_size=8,
                             prefill_buckets=(8, 32)))
MIXES = {"interleaved": INTERLEAVED, "chunked": CHUNKED, "sharded": SHARDED,
         "staggered": STAGGERED}
OPTIONS = {"runner": {}, "slab": dict(paged=False), "int8": dict(kv_dtype="int8"),
           "seq4": dict(seq_shards=4)}
ENGINE_CASES = [(m, o) for m in ("interleaved", "chunked") for o in ("runner", "slab")] \
    + [("sharded", "int8"), ("sharded", "seq4"), ("staggered", "runner"),
       ("staggered", "slab"), ("staggered", "seq4")]


def _skew(p, seed=5):
    """JAX parameters (numpy leaves) whose every token routes to experts 0
    and 1: a unit direction c added three times to each embedding row, and
    c (once, half) added to the router columns of experts 0 and 1 in every
    layer."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.array(a), p)
    c = rng.normal(size=p["embed"]["table"].shape[1]).astype(np.float32)
    c /= np.linalg.norm(c)
    p["embed"]["table"] += 3.0 * c
    p["layers"]["moe"]["router"][:, :, 0] += c
    p["layers"]["moe"]["router"][:, :, 1] += 0.5 * c
    return p


def _drain(eng, prompts, max_new):
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    for p, n in zip(prompts, news):
        eng.submit(p, max_new_tokens=n)
    return {r.rid: tuple(r.out_tokens) for r in eng.run_until_drained()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol, **kw)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The shapes here are tiny: two intra-op threads keep this file from
    crowding the CPUs that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params, port params) of the skewed reduced
    olmoe-1b-7b at fp32."""
    cfg = reduced(get_config("olmoe-1b-7b"))
    jp = jax.tree.map(jnp.asarray, _skew(
        JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)))
    return cfg, t_reduced(t_get_config("olmoe-1b-7b")), jp, \
        params_from_jax(jax.tree.map(np.asarray, jp))


_JAX_SHARDED = """
import json, jax, numpy as np, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.models import model as M
from repro.serve import ServeEngine
cfg = reduced(get_config("olmoe-1b-7b"))
params = jax.tree.map(jnp.asarray, _skew(
    M.init_params(cfg, jax.random.key(0), dtype=jnp.float32)))
eng = ServeEngine(cfg, params, seq_shards=4, **MIX["engine"])
out = _drain(eng, MIX["prompts"], MIX["max_new"])
print("RESULT " + json.dumps({"toks": {str(k): v for k, v in out.items()},
                              "stats": {k: float(v) for k, v in eng.stats.items()}}))
"""


@pytest.fixture(scope="module")
def jax_out(model):
    """JAX's engine outputs and stats by (mix, options), each engine run
    once for the module: the int8 case against JAX's int8 engine, 4
    sequence shards against JAX's at 4 shards, in a subprocess a mix (its
    mesh needs four host devices)."""
    cache = {}
    cfg, _, jparams, _ = model

    def get(mix, opt):
        key = (mix, opt)
        if key not in cache:
            m = MIXES[mix]
            if opt == "seq4":
                code = "\n".join([f"MIX = {m!r}", inspect.getsource(_skew),
                                  inspect.getsource(_drain), _JAX_SHARDED])
                line = [ln for ln in run_subprocess(code, devices=4).splitlines()
                        if ln.startswith("RESULT ")][-1]
                res = json.loads(line[len("RESULT "):])
                cache[key] = ({int(k): tuple(v) for k, v in res["toks"].items()},
                              res["stats"])
            else:
                eng = JEngine(cfg, jparams, **m["engine"], **OPTIONS[opt])
                cache[key] = (_drain(eng, m["prompts"], m["max_new"]), dict(eng.stats))
        return cache[key]
    return get


@pytest.fixture
def drops(monkeypatch):
    """Counts the assignments that the port's dispatches drop (a host read
    per dispatch: for the tests only)."""
    seen = {"dispatches": 0, "dropping": 0, "dropped": 0}
    route = TMOE.route

    def counted(*args, **kwargs):
        r = route(*args, **kwargs)
        n = int((~r.keep).sum())
        seen["dispatches"] += 1
        seen["dropping"] += n > 0
        seen["dropped"] += n
        return r

    monkeypatch.setattr(TMOE, "route", counted)
    return seen


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer_case(name):
    """(JAX cfg, port cfg, JAX layer params, x [2, 9, d], capacity factor)."""
    arch = "qwen2-moe-a2.7b" if name == "shared" else "olmoe-1b-7b"
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    if name == "padded":                      # 20 experts pad to 32
        cfg, tcfg = (c.replace(n_experts=20) for c in (cfg, tcfg))
    p = JMOE.moe_init(jax.random.key(3), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    if name == "skewed":                      # every row prefers expert 0
        c = rng.normal(size=cfg.d_model).astype(np.float32)
        x += 3.0 * c
        p = dict(p, router=p["router"].at[:, 0].add(jnp.asarray(c)))
    if name == "zero_router":                 # all logits tie
        p = dict(p, router=jnp.zeros_like(p["router"]))
    cf = cfg.n_experts / cfg.top_k if name == "dropless" else None
    return cfg, tcfg, p, x, cf


LAYER_CASES = ("skewed", "dropless", "padded", "shared", "zero_router")


@pytest.mark.parametrize("name", LAYER_CASES)
def test_moe_apply_matches_jax(name):
    """moe_apply against JAX's within 1e-5: the output, and with
    ``losses`` and ``return_stats`` lb_loss, z_loss, frac_dropped and
    expert_load (exact); ``return_stats`` alone gives only expert_load and
    frac_dropped, ``losses`` alone no expert_load; without either the aux
    dict is empty.  The skewed router drops (at the
    default capacity factor), the dropless cf = E / k keeps every
    assignment, 20 experts pad to 32 (the padded ones never routed), the
    shared expert is added, and a zero router takes experts 0..k-1 (the
    lower index first among equal values, as jax.lax.top_k)."""
    cfg, tcfg, p, x, cf = _layer_case(name)
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    jy, ja = JMOE.moe_apply(p, jnp.asarray(x), cfg, capacity_factor=cf,
                            return_stats=True)
    if cf is not None:                        # the port reads cfg.capacity_factor
        tcfg = tcfg.replace(capacity_factor=cf)
    ty, ta = TMOE.moe_apply(tp, _t(x), tcfg, losses=True, return_stats=True)
    _close(ty, jy, LAYER_TOL)
    assert set(ta) == set(ja)
    _, stats = TMOE.moe_apply(tp, _t(x), tcfg, return_stats=True)
    assert set(stats) == {"expert_load", "frac_dropped"}
    assert torch.equal(stats["expert_load"], ta["expert_load"])
    assert torch.equal(stats["frac_dropped"], ta["frac_dropped"])
    _, lossed = TMOE.moe_apply(tp, _t(x), tcfg, losses=True)
    assert set(lossed) == {"lb_loss", "z_loss", "frac_dropped"}
    for k in ("lb_loss", "z_loss", "frac_dropped"):
        _close(ta[k], ja[k], LAYER_TOL, err_msg=k)
    np.testing.assert_array_equal(ta["expert_load"].numpy(), np.asarray(ja["expert_load"]))
    y2, aux = TMOE.moe_apply(tp, _t(x), tcfg)
    assert aux == {} and torch.equal(y2, ty)
    load = ta["expert_load"].numpy()
    frac = float(ta["frac_dropped"])
    e_pad = TMOE.moe_padded_experts(tcfg)
    assert tp["router"].shape == (cfg.d_model, e_pad) and len(load) == e_pad
    if name == "skewed":
        assert frac > 0
    if name == "dropless":
        assert frac == 0
    if name == "padded":
        assert e_pad == 32 and not load[20:].any()
    if name == "shared":
        assert "shared" in tp and tcfg.n_shared_experts == 1
    if name == "zero_router":
        assert list(load[:cfg.top_k]) == [18.0] * cfg.top_k and not load[cfg.top_k:].any()


def test_moe_init_matches_jax_shapes():
    """moe_init's leaves have JAX's shapes and dtypes (the router f32 among
    bf16 banks; qwen2-moe's 60 experts padded to 64, its 4 shared experts one
    FFN of width 4 x 1408), and moe_padded_experts is JAX's for every MoE
    config and the reduced ones."""
    for arch in ("olmoe-1b-7b", "qwen2-moe-a2.7b"):
        for red in (False, True):
            cfg, tcfg = get_config(arch), t_get_config(arch)
            if red:
                cfg, tcfg = reduced(cfg), t_reduced(tcfg)
            assert TMOE.moe_padded_experts(tcfg) == JMOE.moe_padded_experts(cfg)
    cfg, tcfg = (c.replace(d_model=32, moe_d_ff=16) for c in (
        get_config("qwen2-moe-a2.7b"), t_get_config("qwen2-moe-a2.7b")))
    jp = jax.eval_shape(lambda: JMOE.moe_init(jax.random.key(0), cfg))
    tp = TMOE.moe_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == 7
    for path, leaf in jl:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and \
            str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
    assert tp["router"].shape == (32, 64) and tp["shared"]["gate"]["w"].shape == (32, 64)


# ---------------------------------------------------------------------------
# the model's serving entry points and the runner
# ---------------------------------------------------------------------------

NB, BS = 9, 8
TABLES = np.array([[1, 4, 0, 0], [3, 5, 2, 7], [6, 0, 0, 0]], np.int32)
DECODE_LENS = np.array([9, 26, 2], np.int32)


def test_prefill_chunks_and_decode_match_jax(model, drops):
    """From the same mid-stream pool (random pages, state_from_jax): two
    right-padded 8-token chunks (7 and 3 valid rows) through
    serve_prefill_chunk at q_offset 16 and 23, then a batched
    serve_decode_step of 3 slots; logits and the pages within 1e-4 after
    each call, the skewed chunks dropping."""
    cfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(2)
    js = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
                      JM.init_serve_state(cfg, 3, NB, BS, dtype=jnp.float32))
    ts = state_from_jax(jax.tree.map(np.asarray, js))
    qoff = 16
    for n in (7, 3):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
        jl, js = JM.serve_prefill_chunk(
            cfg, jparams, js, tokens=jnp.asarray(toks), length=jnp.int32(n),
            q_offset=jnp.int32(qoff), slot=jnp.int32(1),
            block_table=jnp.asarray(TABLES[1]))
        tl, ts = TM.serve_prefill_chunk(tcfg, tparams, ts, tokens=_t(toks), length=n,
                                        q_offset=qoff, slot=1, block_table=_t(TABLES[1]))
        _close(tl, jl, MODEL_TOL, err_msg=f"chunk of {n}")
        for k in ("k_pages", "v_pages"):
            _close(ts["attn"][k], js["attn"][k], MODEL_TOL, err_msg=k)
        qoff += n
    nxt = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
    jl, js = JM.serve_decode_step(cfg, jparams, js, jnp.asarray(nxt),
                                  jnp.asarray(DECODE_LENS), jnp.asarray(TABLES))
    tl, ts = TM.serve_decode_step(tcfg, tparams, ts, _t(nxt), _t(DECODE_LENS),
                                  _t(TABLES))
    _close(tl, jl, MODEL_TOL)
    for k in ("k_pages", "v_pages"):
        _close(ts["attn"][k], js["attn"][k], MODEL_TOL, err_msg=k)
    assert drops["dropping"] >= 2 * tcfg.n_layers      # both chunks, every layer


def test_slab_prefill_and_decode_match_jax(model, drops):
    """The dense-slab entry points: a batched prefill of two right-padded
    prompts (lengths 12 and 5; 24 rows in one dispatch, capacity 7) from
    any prior state, then two decode steps; logits within 1e-4, the slabs
    at each prompt's valid rows too."""
    cfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(4)
    js = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
                      JM.init_decode_state(cfg, 2, 32, dtype=jnp.float32))
    ts = state_from_jax(jax.tree.map(np.asarray, js))
    tok = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    lens = np.array([12, 5], np.int32)
    jl, js = JM.prefill(cfg, jparams, js, tokens=jnp.asarray(tok),
                        lengths=jnp.asarray(lens))
    tl, ts = TM.prefill(tcfg, tparams, ts, tokens=_t(tok), lengths=_t(lens))
    _close(tl, jl, MODEL_TOL)
    assert drops["dropping"] == tcfg.n_layers
    for step in range(2):
        nxt = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        jl, js = JM.decode_step(cfg, jparams, js, jnp.asarray(nxt),
                                jnp.asarray(lens + step))
        tl, ts = TM.decode_step(tcfg, tparams, ts, _t(nxt), _t(lens + step))
        _close(tl, jl, MODEL_TOL, err_msg=f"decode step {step}")
    for k in ("k", "v"):
        for i, n in enumerate(lens + 2):
            _close(ts["attn"][k][:, i, :n], js["attn"][k][:, i, :n], MODEL_TOL)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("red", [False, True], ids=["full", "reduced"])
def test_cache_spec_and_experts_match_jax(arch, red):
    """The MoE CacheSpec is JAX's (one paged component of L applications, no
    slot state); the runner's padded_experts and expert_weight_bytes (at 2
    and 4 bytes) and attn_applications are JAX's runner's."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    if red:
        cfg, tcfg = reduced(cfg), t_reduced(tcfg)
    j, t = j_cache_spec(cfg), t_cache_spec(tcfg)
    assert [(c.name, c.n_apps, c.kv_heads, c.head_dim) for c in t.paged] == \
        [(c.name, c.n_apps, c.kv_heads, c.head_dim) for c in j.paged]
    assert (t.has_paged, t.has_slot_state) == (j.has_paged, j.has_slot_state) \
        == (True, False)
    jr, tr = JRunner(cfg, 2, 64), TRunner(tcfg, 2, 64)
    assert tr.padded_experts() == jr.padded_experts()
    assert tr.attn_applications == jr.attn_applications == cfg.n_layers
    for itemsize in (2, 4):
        assert tr.expert_weight_bytes(itemsize) == jr.expert_weight_bytes(itemsize)


# ---------------------------------------------------------------------------
# the engine on both paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix,opt", ENGINE_CASES)
def test_engine_matches_jax(model, jax_out, drops, mix, opt):
    """The port's ServeEngine token-identical to JAX's at the default
    capacity factor: the runner path and the dense-slab baseline on the
    interleaved, chunked and staggered mixes, an int8 pool and 4 sequence
    shards (against JAX's engine at 4 shards) on the sharded mix, and 4
    shards on the staggered mix, whose idle decode rows see no key in any
    shard (ROADMAP queue C: they read 0, JAX's plain path the mean of its
    null pages; the routing and every token agree); the same
    token counts, dispatches and ticks; and the dispatches dropped
    assignments."""
    _, tcfg, _, tparams = model
    m = MIXES[mix]
    teng = TEngine(tcfg, tparams, **m["engine"], **OPTIONS[opt])
    want, jstats = jax_out(mix, opt)
    assert teng.paged == (opt != "slab") and not teng.has_slot_state
    assert _drain(teng, m["prompts"], m["max_new"]) == want
    for key in ("prefill_tokens", "decode_tokens", "padded_tokens",
                "prefill_dispatches", "ticks", "prefix_hit_tokens"):
        assert teng.stats[key] == jstats[key], key
    if opt == "seq4":
        for key in ("noc_combines", "noc_hops", "noc_bytes"):
            assert teng.stats[key] == jstats[key], key
    assert drops["dropped"] > 0 and drops["dispatches"] == tcfg.n_layers * (
        teng.stats["prefill_dispatches"] + teng.stats["decode_dispatches"])
    if mix == "chunked" and opt == "runner":        # it really chunked
        assert teng.stats["prefill_dispatches"] == 4


def test_live_rows_only_control_diverges(model, jax_out, monkeypatch):
    """The control: a decode that routes only the runnable slots' rows (a
    smaller dispatch, so a larger share of each expert's capacity for
    them, and no idle rows ahead of them) diverges from JAX's engine on the
    staggered mix, which the engine itself matches (test_engine_matches_jax)."""
    _, tcfg, _, tparams = model
    m = STAGGERED
    want, _ = jax_out("staggered", "runner")
    eng = TEngine(tcfg, tparams, **m["engine"])
    decode, apply = eng.runner.decode, TMOE.moe_apply
    live = {}

    def live_only(p, x, cfg, **kw):
        rows = live.get("rows")
        if rows is None:
            return apply(p, x, cfg, **kw)
        y = torch.zeros_like(x)
        y[rows] = apply(p, x[rows], cfg, **kw)[0]
        return y, {}

    def masked_decode(params, state, toks, lens, tables, mask, local=None):
        live["rows"] = torch.nonzero(torch.as_tensor(mask)).flatten()
        try:
            return decode(params, state, toks, lens, tables, mask, local)
        finally:
            live.pop("rows")

    monkeypatch.setattr(TMOE, "moe_apply", live_only)
    eng.runner.decode = masked_decode
    got = _drain(eng, m["prompts"], m["max_new"])
    assert {r: len(t) for r, t in got.items()} == {r: len(t) for r, t in want.items()}
    assert got != want


# ---------------------------------------------------------------------------
# ROADMAP queue C: the idle decode row under sequence shards, and the order
# of the K/V scatters' duplicate writes
# ---------------------------------------------------------------------------

def test_idle_decode_row_reads_zero_over_shards(model):
    """One layer's decode over 4 shards of a random pool with an idle row
    (token 0, length 0, a table of zeros: foreign to every shard) between
    live rows: the idle row's output is exactly 0, as the card's zero-weight
    partials give it; the live rows equal the unsharded decode within 1e-5.
    The control (the plain partials' combine without the zeroing) gives the
    idle row the mean of the null pages' rows instead."""
    _, tcfg, _, tparams = model
    rng = np.random.default_rng(11)
    S, nb, bs, mb = 4, 4 * 6, 8, 4
    kvh, hd = tcfg.n_kv_heads, tcfg.hd
    kp = _t(rng.normal(size=(kvh, nb, bs, hd)).astype(np.float32))
    vp = _t(rng.normal(size=(kvh, nb, bs, hd)).astype(np.float32))
    alloc = BlockAllocator(nb, bs, 3, mb, num_shards=S)
    for slot, n in ((0, 19), (2, 30)):
        assert alloc.ensure(slot, n + 1)
    lens = _t(np.array([19, 0, 30], np.int32))
    tables = _t(alloc.table.copy())
    local = _t(alloc.shard_local(alloc.table))
    x = _t(rng.normal(size=(3, 1, tcfg.d_model)).astype(np.float32))
    p = tparams["layers"][0]["attn"]
    args = (p, x, tcfg)
    ys = TL.attention_decode_paged(*args, kp.clone(), vp.clone(), lens, tables,
                                   TL.decode_scatter_index(lens, tables, bs),
                                   local_tables=local)
    y1 = TL.attention_decode_paged(*args, kp.clone(), vp.clone(), lens, tables,
                                   TL.decode_scatter_index(lens, tables, bs))
    assert torch.equal(ys[1], torch.zeros_like(ys[1]))
    _close(ys[[0, 2]], y1[[0, 2]], dict(rtol=1e-5, atol=1e-5))
    q = torch.zeros((3, tcfg.n_heads, hd))
    plain = TL._sharded_attention(ops.paged_decode_attention_partial, q, kp, vp,
                                  None, None, local, lengths=lens + 1)
    assert float(plain[1].abs().max()) > 0            # the control: not 0


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_last_writer_scatter_matches_cpu_index_order(kind):
    """The K/V page scatter with duplicate targets (idle decode rows at row 0
    of the null page; a prefill chunk's padding rows, more than a page of
    them) leaves every target what writing the rows one by one in index
    order leaves there (the CPU's index_put, XLA's scatter): the last
    writer's row.  At decode the earlier writers move to free rows of the
    null page (1, 2, ... in order), so the targets are distinct; a prefill
    chunk's targets take their last writer's row."""
    rng = np.random.default_rng(12)
    kvh, nb, bs, hd = 2, 6, 4, 3
    pages = _t(rng.normal(size=(kvh, nb, bs, hd)).astype(np.float32))
    if kind == "decode":
        tables = _t(np.array([[3, 0], [0, 0], [5, 2], [0, 0], [0, 0]], np.int32))
        lens = _t(np.array([2, 0, 5, 0, 0], np.int32))
        idx = TL.decode_scatter_index(lens, tables, bs)
        first = (_t(np.array([3, 0, 2, 0, 0])), _t(np.array([2, 0, 1, 0, 0])))
        assert idx[2] is None and idx[0].tolist() == [3, 0, 2, 0, 0]
        assert idx[1].tolist() == [2, 1, 1, 2, 0]          # rows 1, 3 moved
    else:
        idx = TL.prefill_scatter_index(_t(np.array([3, 5], np.int32)), 2, 3, 16, bs)
        first = idx[:2]
        assert idx[2].tolist()[:3] == [0, 1, 2] and idx[2].tolist()[3:7] == [15, 12, 13, 14]
        short = TL.prefill_scatter_index(_t(np.array([3, 5], np.int32)), 2, 3, 7, bs)
        assert short[2] is None                          # under a page of padding
    rows = _t(rng.normal(size=(idx[0].shape[0], kvh, hd)).astype(np.float32))
    want = pages.clone()
    for i in range(rows.shape[0]):
        want[:, first[0][i], first[1][i]] = rows[i]
    got = pages.clone()
    TL._scatter(got, idx, rows)
    if kind == "decode":
        assert torch.equal(got[:, 0, 1], rows[1]) and torch.equal(got[:, 0, 2], rows[3])
        got[:, 0, 1:3] = want[:, 0, 1:3]
    assert torch.equal(got, want)


def test_expert_options_raise(model):
    """Every JAX engine expert option builds: ``expert_parallel`` at each
    divisor of the padded expert count (its parity:
    tests/test_torch_expert_parallel.py), a count that does not divide and
    0 refused with JAX's errors, and the expert cache's options (the cache
    and its telemetry: tests/test_torch_expert_cache.py)."""
    _, tcfg, _, tparams = model
    for ep in (1, 2, 4, 8):
        eng = TEngine(tcfg, tparams, max_seq=32, slots=1, expert_parallel=ep)
        assert eng.expert_parallel == ep and eng.expert_cache is None
    for ep, msg in ((3, "must divide"), (0, "must be >= 1")):
        with pytest.raises(ValueError, match=msg):
            TEngine(tcfg, tparams, max_seq=32, slots=1, expert_parallel=ep)
    for kw in (dict(expert_cache_size=4),
               dict(expert_cache_size=4, expert_prefetch=False),
               dict(expert_cache_size=2, expert_placement="static")):
        eng = TEngine(tcfg, tparams, max_seq=32, slots=1, **kw)
        assert eng.expert_cache.capacity == kw["expert_cache_size"]
        assert eng.expert_cache.prefetch == kw.get("expert_prefetch", True)
        assert eng.expert_cache.adaptive == (kw.get("expert_placement")
                                             != "static")
    # the options alone (no cache size) leave the cache off, as in JAX
    assert TEngine(tcfg, tparams, max_seq=32, slots=1,
                   expert_prefetch=True).expert_cache is None


def test_forward_refuses_moe(model, capsys, tmp_path):
    """MoE parameters and serving state build, and (since MoE training was
    ported) the full-sequence forward runs on the skewed model: finite
    logits and a positive aux [lb, z] (its JAX parity is held in
    tests/test_torch_moe_train.py); the train launcher trains a step."""
    _, tcfg, _, tparams = model
    assert set(TM.init_params(tcfg, device="cpu")["layers"][0]) == \
        {"ln1", "attn", "ln2", "moe"}
    toks = torch.arange(12, dtype=torch.int32).reshape(2, 6) % tcfg.vocab_size
    tl, taux = TM.forward(tcfg, tparams, toks)
    assert tl.shape == (2, 6, tcfg.vocab_size) and torch.isfinite(tl).all()
    assert taux.shape == (2,) and bool((taux > 0).all())
    from repro_torch.launch import train as ttrain
    ttrain.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                 "--steps", "1", "--seq-len", "8", "--global-batch", "1",
                 "--ckpt-dir", str(tmp_path)])
    assert "[train] done at step 0" in capsys.readouterr().out


@pytest.mark.parametrize("arch,extra,mode", [
    ("olmoe-1b-7b", [], "kv=paged "), ("olmoe-1b-7b", ["--dense"], "kv=dense"),
    ("olmoe-1b-7b", ["--kv-dtype", "int8"], "kv=paged/int8"),
    ("olmoe-1b-7b", ["--seq-shards", "4"], "kv=paged/seq4"),
    ("qwen2-moe-a2.7b", [], "kv=paged ")],
    ids=["runner", "slab", "int8", "seq4", "qwen2-moe"])
def test_launch_serve_moe_cpu(capsys, arch, extra, mode):
    """``launch/serve.py --arch olmoe-1b-7b --reduced --device cpu`` serves
    on the runner path (also from an int8 pool and over 4 sequence
    shards) and the slab path; qwen2-moe-a2.7b (shared experts) on the
    runner path."""
    tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                  "--requests", "4", "--max-new-tokens", "4"] + extra)
    out = capsys.readouterr().out
    assert "4 requests, 16 tokens" in out and mode in out


@pytest.mark.parametrize("name,group", [
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>(...)",
     "other PyTorch ops"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "GEMM (torch.matmul)"),
    ("void (anonymous namespace)::silu_mul_kernel<__nv_bfloat16, true>(...)",
     "port CUDA kernels: other")])
def test_trace_serve_ranges_the_moe_dispatch(name, group):
    """trace_serve ranges the MoE dispatch's steps (route, dispatch,
    combine) into "MoE dispatch", their GEMMs included, and the routed
    experts' batched GEMMs into "expert GEMMs"; outside those ranges a
    kernel keeps its group (silu_mul stays with the port's kernels)."""
    from repro_torch.launch import trace_serve

    assert trace_serve._group(name) == group
    ranged = {(mod.__name__, attr): g for mod, attr, g in trace_serve.RANGED}
    for attr in ("route", "dispatch", "combine"):
        assert ranged[("repro_torch.models.moe", attr)] == "MoE dispatch"
    assert ranged[("repro_torch.models.moe", "experts")] == "expert GEMMs"
    assert trace_serve.MOVED_FROM["expert GEMMs"] == (trace_serve.GEMMS,)
    assert set(trace_serve.MOVED_FROM["MoE dispatch"]) == {trace_serve.GEMMS,
                                                           trace_serve.OTHER_OPS}
