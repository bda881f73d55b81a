"""Port parity, the expert telemetry and the placement-aware expert cache:
``repro_torch.serve.expert_cache.ExpertCache`` against the JAX package's
on seeded load sequences (adaptive and static, prefetch on and off: the
residents, the staged expert, the EMA and every counter equal tick by
tick), the NoC expert cost model against JAX's over a grid, and
``ServeEngine(expert_cache_size=4)`` on reduced olmoe-1b-7b (8 experts,
top 2) at fp32 against JAX's engine: tokens, every dispatch's expert
load and every ``expert_*`` stat equal, the accounting invariants, a
``reset_stats`` that keeps the placement; the refusals (the slab path, a
family without experts, expert parallelism) and the launcher's flags.
JAX's parameters are carried over through ``repro_torch.models.convert``;
loads and prompts come from numpy seeds.  The JAX engine runs once for
the module."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.core import noc as JNOC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.expert_cache import ExpertCache as JCache  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import noc as TNOC  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.expert_cache import COUNTER_KEYS  # noqa: E402
from repro_torch.serve.expert_cache import ExpertCache as TCache  # noqa: E402

# interleaved arrivals over 2 slots, chunked prefill: 15 prefill chunks
# of 8 or 16 rows and a few dozen decode steps of 2 rows
MIX = dict(prompts=[[3, 1, 4, 1, 5, 9, 2, 6], [2, 7], list(range(1, 20)),
                    [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]],
           max_new=6, engine=dict(max_seq=64, slots=2, block_size=8,
                                  prefill_buckets=(8, 16, 64),
                                  max_tokens_per_tick=12))
CACHE = 4                               # of the 8 experts a layer
VARIANTS = {"adaptive": dict(), "no_prefetch": dict(expert_prefetch=False),
            "static": dict(expert_placement="static")}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cache_kw(variant):
    kw = VARIANTS[variant]
    return dict(prefetch=kw.get("expert_prefetch", True),
                adaptive=kw.get("expert_placement", "adaptive") == "adaptive")


def _same_cache(t, j):
    """Every piece of the two caches' state, exactly."""
    for li in range(j.n_layers):
        assert t.residents(li) == j.residents(li), li
        assert t.staged(li) == j.staged(li), li
    np.testing.assert_array_equal(t.ema, j.ema)
    assert t.counters == j.counters
    assert t.sram_hit_rate == j.sram_hit_rate


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_expert_cache_matches_jax(variant):
    """30 ticks of seeded skewed loads (a hot set that drifts, some empty
    rows) through both caches: the tick deltas and the whole state equal
    after every tick; the invariants hold; reset_counters keeps the
    placement."""
    rng = np.random.default_rng(7)
    layers, experts, eb = 3, 16, 3 * 64 * 32 * 4
    kw = dict(prefetch=_cache_kw(variant)["prefetch"],
              adaptive=_cache_kw(variant)["adaptive"])
    t, j = TCache(layers, experts, 5, eb, **kw), JCache(layers, experts, 5, eb, **kw)
    for tick in range(30):
        hot = (np.arange(4) + tick // 6) % experts
        p = np.full(experts, 0.2)
        p[hot] = 6.0
        counts = np.stack([np.bincount(rng.choice(experts, 24, p=p / p.sum()),
                                       minlength=experts) for _ in range(layers)])
        if tick % 7 == 3:
            counts[1] = 0
        assert t.observe(counts) == j.observe(counts)
        _same_cache(t, j)
    c = t.counters
    assert c["hits"] + c["misses"] == c["lookups"]
    assert c["promotions"] == c["demotions"] == c["migrations"]
    assert c["migration_bytes"] == c["migrations"] * eb
    if kw["adaptive"]:
        assert c["migrations"] > 0
        assert (c["prefetches"] > 0) == kw["prefetch"]
    else:
        assert c["migrations"] == c["prefetches"] == 0
    res = [t.residents(li) for li in range(layers)]
    t.reset_counters()
    j.reset_counters()
    _same_cache(t, j)
    assert [t.residents(li) for li in range(layers)] == res
    assert set(t.counters) == set(COUNTER_KEYS)


def test_noc_expert_costs_match_jax():
    """``expert_placement_cost`` and ``expert_promotion_worthwhile`` equal
    to JAX's (and the EXPERT_* rates) over a grid of sizes and accesses,
    around the crossover."""
    for name in ("SRAM_BYTES_PER_S", "SRAM_E_PJ_PER_BIT", "DRAM_BYTES_PER_S",
                 "DRAM_E_PJ_PER_BIT", "LINK_BYTES_PER_S", "LINK_E_PJ_PER_BIT"):
        assert getattr(TNOC, "EXPERT_" + name) == getattr(JNOC, "EXPERT_" + name)
    flips = set()
    for eb in (1, 12288, 3 * 2048 * 1024 * 2, 3 * 2048 * 1408 * 4):
        for acc in (0.0, 0.1, 0.5, 0.7, 0.708, 0.709, 0.71, 0.72, 1.0, 3.0, 64.0):
            assert TNOC.expert_placement_cost(eb, acc) == \
                JNOC.expert_placement_cost(eb, acc)
            ok = TNOC.expert_promotion_worthwhile(eb, acc)
            assert ok == JNOC.expert_promotion_worthwhile(eb, acc)
            flips.add(ok)
    assert flips == {True, False}


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params, port params): reduced olmoe-1b-7b
    at fp32 from JAX's init."""
    cfg = reduced(get_config("olmoe-1b-7b"))
    jp = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    return cfg, t_reduced(t_get_config("olmoe-1b-7b")), jp, \
        params_from_jax(jax.tree.map(np.asarray, jp))


def _drain(eng):
    for p in MIX["prompts"]:
        eng.submit(p, max_new_tokens=MIX["max_new"])
    return {r.rid: tuple(r.out_tokens) for r in eng.run_until_drained()}


def _recording(eng):
    """Record every dispatch's expert load [L, E_pad] and rows as the
    engine folds it in (``_account_expert``)."""
    seen, fold = [], eng._account_expert

    def account(est, rows):
        seen.append((np.array(np.asarray(est["expert_load"]), np.float64), rows))
        return fold(est, rows)
    eng._account_expert = account
    return seen


@pytest.fixture(scope="module")
def jax_run(model):
    """JAX's engine with the adaptive, prefetching cache: its tokens, its
    stats, its cache's residents, and each dispatch's load."""
    cfg, _, jp, _ = model
    eng = JEngine(cfg, jp, expert_cache_size=CACHE, **MIX["engine"])
    loads = _recording(eng)
    toks = _drain(eng)
    res = [eng.expert_cache.residents(li) for li in range(cfg.n_layers)]
    return toks, dict(eng.stats), res, loads


def _expert_stats(stats):
    return {k: v for k, v in stats.items() if k.startswith("expert_")}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_expert_cache_matches_jax(variant, model, jax_run):
    """``ServeEngine(expert_cache_size=4)``: tokens JAX's, each dispatch's
    load and rows JAX's, and every ``expert_*`` stat equal: to JAX's engine
    for the adaptive, prefetching cache, and for the other placements to
    JAX's ``ExpertCache`` fed JAX's engine's loads (the cache never
    changes what is computed, so JAX's loads are every variant's).  The
    invariants hold; ``reset_stats`` zeroes the counters and keeps the
    residents."""
    cfg, tcfg, _, tp = model
    jtoks, jstats, jres, jloads = jax_run
    eng = TEngine(tcfg, tp, expert_cache_size=CACHE, **VARIANTS[variant],
                  **MIX["engine"])
    loads = _recording(eng)
    assert _drain(eng) == jtoks
    assert len(loads) == len(jloads)
    for (tl, tr), (jl, jr) in zip(loads, jloads):
        assert tr == jr
        np.testing.assert_array_equal(tl, jl)
    got = _expert_stats(eng.stats)
    if variant == "adaptive":
        want, wres = _expert_stats(jstats), jres
    else:
        jc = JCache(cfg.n_layers, TMOE.moe_padded_experts(tcfg), CACHE,
                    eng.runner.expert_weight_bytes(4), **_cache_kw(variant))
        for jl, _ in jloads:
            jc.observe(jl)
        want = dict(_expert_stats(jstats), expert_hits=jc.counters["hits"],
                    expert_misses=jc.counters["misses"],
                    expert_sram_hit_rate=jc.sram_hit_rate,
                    expert_migrations=jc.counters["migrations"],
                    expert_migration_bytes=jc.counters["migration_bytes"],
                    expert_prefetches=jc.counters["prefetches"])
        wres = [jc.residents(li) for li in range(cfg.n_layers)]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
    c = eng.expert_cache.counters
    assert c["hits"] + c["misses"] == c["lookups"]
    assert c["lookups"] == got["expert_load"].sum() == \
        cfg.n_layers * cfg.top_k * got["expert_routed_tokens"]
    assert got["expert_migration_bytes"] == \
        got["expert_migrations"] * eng.expert_cache.expert_bytes
    assert got["expert_dropped_tokens"] > 0
    if variant == "static":
        assert got["expert_migrations"] == got["expert_prefetches"] == 0
    else:
        assert got["expert_migrations"] > 0
    res = [eng.expert_cache.residents(li) for li in range(cfg.n_layers)]
    assert res == wres
    eng.reset_stats()
    assert all(not np.any(v) for v in _expert_stats(eng.stats).values())
    assert [eng.expert_cache.residents(li) for li in range(cfg.n_layers)] == res
    assert eng.expert_cache.counters["lookups"] == 0


def test_telemetry_only_with_the_cache(model, monkeypatch):
    """Without the cache no dispatch asks for the telemetry (no extra
    aux, no read back); with it every dispatch does."""
    _, tcfg, _, tp = model
    asked, apply = [], TMOE.moe_apply

    def watched(p, x, cfg, **kw):
        asked.append(bool(kw.get("return_stats")) or bool(kw.get("losses")))
        return apply(p, x, cfg, **kw)
    monkeypatch.setattr(TMOE, "moe_apply", watched)
    eng = TEngine(tcfg, tp, **MIX["engine"])
    eng.submit([5, 6, 7], max_new_tokens=3)
    eng.run_until_drained()
    assert asked and not any(asked)
    assert eng.stats["expert_load"] == 0.0 and eng.stats["expert_routed_tokens"] == 0
    asked.clear()
    eng = TEngine(tcfg, tp, expert_cache_size=2, **MIX["engine"])
    eng.submit([5, 6, 7], max_new_tokens=3)
    eng.run_until_drained()
    assert asked and all(asked)


def test_engine_refuses_the_cache_off_the_runner(model):
    """The slab path and a family without routed experts refuse the cache
    (ValueError, as JAX's engine); a placement other than adaptive or
    static raises; the cache composes with expert parallelism, which the
    slab path refuses with JAX's error."""
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match="paged=False"):
        TEngine(tcfg, tp, max_seq=32, slots=1, paged=False, expert_cache_size=4)
    dense = t_reduced(t_get_config("stablelm-1.6b"))
    from repro_torch.models import model as TM
    with pytest.raises(ValueError, match="MoE family"):
        TEngine(dense, TM.init_params(dense, device="cpu", dtype=torch.float32),
                max_seq=32, slots=1, expert_cache_size=4)
    with pytest.raises(ValueError, match="expert_placement"):
        TEngine(tcfg, tp, max_seq=32, slots=1, expert_cache_size=4,
                expert_placement="lru")
    eng = TEngine(tcfg, tp, max_seq=32, slots=1, expert_parallel=2,
                  expert_cache_size=4)
    assert eng.expert_parallel == 2 and eng.expert_cache.capacity == 4
    with pytest.raises(ValueError, match="dense-slab baseline"):
        TEngine(tcfg, tp, max_seq=32, slots=1, paged=False, expert_parallel=2)


@pytest.mark.parametrize("flags,label", [
    (["--expert-cache", "4"], "adaptive"),
    (["--expert-cache", "4", "--no-expert-prefetch"], "adaptive, no prefetch"),
    (["--expert-cache", "3", "--expert-placement", "static"], "static")],
    ids=["adaptive", "no_prefetch", "static"])
def test_launch_serve_expert_flags(flags, label, capsys):
    """``launch/serve.py --arch olmoe-1b-7b --reduced --device cpu`` with
    the expert-cache flags prints the telemetry and the cache line;
    with ``--expert-parallel 2`` beside them the telemetry line names the
    two shards and the cache line is the same."""
    tlaunch.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                  "--requests", "3", "--max-new-tokens", "3"] + flags)
    out = capsys.readouterr().out
    assert "[serve] experts: routed_tokens=" in out
    line = [ln for ln in out.splitlines() if ln.startswith("[serve] expert cache")][0]
    assert f"capacity={flags[1]}/layer, {label})" in line
    if label == "static":
        assert "migrations=0," in line
    tlaunch.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                  "--requests", "3", "--max-new-tokens", "3",
                  "--expert-parallel", "2"] + flags)
    ep_out = capsys.readouterr().out
    assert [ln for ln in ep_out.splitlines()
            if ln.startswith("[serve] experts:")][0].endswith("ep=2")
    assert line in ep_out.splitlines()
