"""Port parity, latency classes: deficit round-robin admission, deadlines
and the class-weighted victim score.

The cases of tests/test_serve_slo.py against the port's ServeEngine, each
run through JAX's engine on the same submission stream (reduced
granite-3-2b at fp32, the JAX parameters carried over through
``repro_torch.models.convert``): the engines must agree token for token,
in ``class_stats``, in the preemption statistics (``STATS``, exact) and in
every request's ``submit_tick`` / ``first_tick`` / ``finish_tick``.  Each
case also holds the port to the property the JAX test states (class-then-
age order, DRR's 8:1 and 2:1, a deadline's violations, the class weight
picking the batch victim, a pressured run token-identical to the
unpressured one).  Deadlines are 0 (always missed) or 1e9 ms (never), so
the wall clock cannot split the engines."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import noc as tnoc  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

KW = dict(max_seq=64, slots=2, block_size=8, prefill_buckets=(16, 64))
ONE_SLOT = dict(max_seq=64, slots=1, block_size=8, prefill_buckets=(16, 64))
STATS = ("preemptions", "preempt_proactive", "preempt_swaps",
         "preempt_recomputes", "swap_bytes", "preempted_tokens",
         "restored_tokens", "stalled_ticks", "decode_tokens",
         "prefill_tokens", "ticks", "slo_violations")
TICKS = ("submit_tick", "first_tick", "finish_tick")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tiny shapes: two intra-op threads keep this file from crowding the
    CPUs that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(port cfg, JAX cfg, JAX params, port params): reduced granite-3-2b,
    fp32."""
    cfg = reduced(get_config("granite-3-2b"))
    jp = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    return (t_reduced(t_get_config("granite-3-2b")), cfg, jp,
            params_from_jax(jax.tree.map(np.asarray, jp)))


def _drain(eng, reqs, max_ticks=400):
    rids = [eng.submit(p, **kw) for p, kw in reqs]
    done = {r.rid: r for r in eng.run_until_drained(max_ticks=max_ticks)}
    return rids, done


def _both(model, reqs, kw=KW, **extra):
    """The stream through the port's and JAX's engines: tokens, class
    stats, STATS and every rid's tick clocks equal.  Returns (rids, the
    port's finished requests by rid, the port engine)."""
    tcfg, cfg, jp, tp = model
    jeng, teng = JEngine(cfg, jp, **kw, **extra), TEngine(tcfg, tp, **kw, **extra)
    _, want = _drain(jeng, reqs)
    rids, got = _drain(teng, reqs)
    assert sorted(got) == sorted(want) == sorted(rids)
    for rid in rids:
        assert got[rid].out_tokens == want[rid].out_tokens, rid
        for k in TICKS:
            assert getattr(got[rid], k) == getattr(want[rid], k), (rid, k)
    assert teng.class_order == jeng.class_order
    assert teng.class_stats == jeng.class_stats
    for k in STATS:
        assert teng.stats[k] == jeng.stats[k], k
    return rids, got, teng


def _prompts(n, start=1, width=8):
    return [list(range(start + i, start + i + width)) for i in range(n)]


# ---------------------------------------------------------------------------
# admission order
# ---------------------------------------------------------------------------

def test_admission_is_class_then_age_ordered(model):
    """batch, interactive, batch, interactive on a 1-slot engine: both
    interactive requests start first, FIFO within each class."""
    classes = ("batch", "interactive", "batch", "interactive")
    reqs = [(p, dict(max_new_tokens=4, priority=c))
            for p, c in zip(_prompts(4), classes)]
    rids, done, eng = _both(model, reqs, kw=ONE_SLOT)
    order = sorted(rids, key=lambda rid: done[rid].first_tick)
    assert order == [rids[1], rids[3], rids[0], rids[2]]
    assert eng.queue == [] and eng.queued == 0


def test_drr_batch_never_starved_under_interactive_backlog(model):
    """Weights 8:1, one slot, 12 queued interactive requests and one batch
    request: the batch request starts after exactly 8 interactive ones."""
    reqs = [(p, dict(max_new_tokens=2)) for p in _prompts(12)]
    reqs.append((list(range(2, 10)), dict(max_new_tokens=2, priority="batch")))
    rids, done, _ = _both(model, reqs, kw=ONE_SLOT)
    order = sorted(rids, key=lambda rid: done[rid].first_tick)
    assert order.index(rids[-1]) == 8
    assert [r for r in order if r != rids[-1]] == rids[:-1]


def test_drr_converges_to_weight_ratio(model):
    """Weights 2:1 and a backlog in both classes: i i b, three times."""
    reqs = ([(p, dict(max_new_tokens=2)) for p in _prompts(6)]
            + [(p, dict(max_new_tokens=2, priority="batch"))
               for p in _prompts(6, start=2)])
    rids, done, _ = _both(model, reqs, kw=ONE_SLOT,
                          class_weights={"interactive": 2.0, "batch": 1.0})
    cls = {rid: ("i" if i < 6 else "b") for i, rid in enumerate(rids)}
    order = [cls[rid] for rid in sorted(rids, key=lambda r: done[r].first_tick)]
    assert order[:9] == ["i", "i", "b"] * 3


def test_queue_snapshot_is_class_major(model):
    """The read-only ``queue`` lists queued requests class by class in
    ``class_order`` (heaviest first, by name on ties), by age within a
    class, and a third class slots in by its weight."""
    tcfg, _, _, tp = model
    eng = TEngine(tcfg, tp, **ONE_SLOT,
                  class_weights={"realtime": 16.0, "bulk": 1.0})
    assert eng.class_order == ("realtime", "interactive", "batch", "bulk")
    rids = [eng.submit(p, max_new_tokens=2, priority=c) for p, c in
            zip(_prompts(5), ("batch", "bulk", "interactive", "realtime",
                              "batch"))]
    assert [r.rid for r in eng.queue] == [rids[3], rids[2], rids[0], rids[4],
                                         rids[1]]
    assert eng.queued == 5


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def test_slo_violation_per_request_deadline(model):
    """deadline_ms=0 always misses, 1e9 never."""
    reqs = [(_prompts(1)[0], dict(max_new_tokens=2, deadline_ms=0.0)),
            (_prompts(1, start=2)[0], dict(max_new_tokens=2, deadline_ms=1e9))]
    _, _, eng = _both(model, reqs)
    assert eng.stats["slo_violations"] == 1
    assert eng.class_stats["interactive"]["slo_violations"] == 1


def test_slo_class_deadlines_and_override(model):
    """A class deadline is the default, a request's own deadline overrides
    it, and a class without one never counts; an unknown class in the map
    is refused."""
    reqs = [(_prompts(1)[0], dict(max_new_tokens=2, priority="batch")),
            (_prompts(1, start=2)[0], dict(max_new_tokens=2, priority="batch",
                                           deadline_ms=1e9)),
            (_prompts(1, start=3)[0], dict(max_new_tokens=2))]
    _, _, eng = _both(model, reqs, class_deadlines_ms={"batch": 0.0})
    assert eng.stats["slo_violations"] == 1
    assert eng.class_stats["batch"]["slo_violations"] == 1
    assert eng.class_stats["interactive"]["slo_violations"] == 0
    tcfg, _, _, tp = model
    with pytest.raises(ValueError, match="unknown classes"):
        TEngine(tcfg, tp, **KW, class_deadlines_ms={"realtime": 5.0})


def test_unknown_latency_class_rejected(model):
    tcfg, _, _, tp = model
    eng = TEngine(tcfg, tp, **KW)
    with pytest.raises(ValueError, match="unknown latency class"):
        eng.submit([1, 2, 3], priority="best-effort")
    assert eng.queued == 0 and eng.class_stats["interactive"]["submitted"] == 0
    with pytest.raises(ValueError):
        TEngine(tcfg, tp, **KW, proactive_horizon=-1)
    with pytest.raises(ValueError, match="positive"):
        TEngine(tcfg, tp, **KW, class_weights={"interactive": 0.0})
    assert tengine.LATENCY_CLASSES == ("interactive", "batch")
    assert tengine.CLASS_WEIGHTS == {"interactive": 8.0, "batch": 1.0}


# ---------------------------------------------------------------------------
# victims
# ---------------------------------------------------------------------------

def test_class_weight_dominates_equal_cost_victims(model):
    """Two lockstep decoders, equal pages and restore cost: the batch one
    falls, never the interactive one (which the old tie-break would
    pick)."""
    reqs = [(list(range(1, 13)), dict(max_new_tokens=40, priority="interactive")),
            (list(range(5, 17)), dict(max_new_tokens=40, priority="batch"))]
    _, _, eng = _both(model, reqs, num_blocks=11, prefix_caching=False)
    assert eng.stats["preemptions"] >= 1
    assert eng.class_stats["batch"]["preemptions"] >= 1
    assert eng.class_stats["interactive"]["preemptions"] == 0


def test_victim_score_cost_term_matches_noc(model):
    """After six ticks on both engines, each slot's restore seconds is the
    noc model at its pages and live tokens (the swap arm's seconds), and
    the whole score tuple equals JAX's, class weight and tie-breaks
    included."""
    tcfg, cfg, jp, tp = model
    engines = [JEngine(cfg, jp, **KW, preempt_policy="swap"),
               TEngine(tcfg, tp, **KW, preempt_policy="swap")]
    for eng in engines:
        eng.submit(list(range(1, 13)), max_new_tokens=40)
        eng.submit(list(range(5, 17)), max_new_tokens=30, priority="batch")
        for _ in range(6):
            eng.step()
    jeng, teng = engines
    for slot in range(2):
        live = int(teng.lengths[slot])
        n_pages = -(-live // teng.block_size)
        want = tnoc.restore_cost_seconds(
            n_pages, teng._page_kv_bytes(), live,
            flops_per_token=2.0 * tcfg.param_count(active_only=True),
            state_bytes=teng._slot_state_bytes, policy="swap")
        req = teng.active[slot]
        assert teng._restore_seconds(req, live) == want
        assert want == tnoc.swap_cost(n_pages, teng._page_kv_bytes(),
                                      teng._slot_state_bytes)["seconds"]
        assert teng._victim_score(slot) == jeng._victim_score(slot)
    batch = next(i for i in range(2) if teng.active[i].priority == "batch")
    inter = 1 - batch
    ratio = teng._victim_score(inter)[0] / teng._victim_score(batch)[0]
    costs = [teng.alloc.used[i] * teng._restore_seconds(
        teng.active[i], int(teng.lengths[i])) for i in (inter, batch)]
    assert ratio == pytest.approx(8.0 * costs[0] / costs[1])


@pytest.mark.parametrize("policy", ["swap", "recompute", "auto"])
def test_class_mixed_oversubscription_token_identity(model, policy):
    """Interactive and batch mixed over an oversubscribed pool with the
    proactive horizon on: token-identical to JAX's pressured engine (class
    stats, preemptions by arm and tick clocks equal) and to the unpressured
    run, with no decoded token replayed."""
    reqs = [(list(range(1, 13)), dict(max_new_tokens=40, priority="batch")),
            (list(range(5, 17)), dict(max_new_tokens=40, priority="batch")),
            (list(range(3, 9)), dict(max_new_tokens=4, priority="interactive")),
            (list(range(7, 15)), dict(max_new_tokens=6, priority="interactive"))]
    tcfg, _, _, tp = model
    base_eng = TEngine(tcfg, tp, **KW)
    _, base = _drain(base_eng, reqs)
    assert base_eng.stats["preemptions"] == 0
    rids, got, eng = _both(model, reqs, num_blocks=11, preempt_policy=policy,
                           proactive_horizon=4)
    assert {r: got[r].out_tokens for r in rids} == \
        {r: base[r].out_tokens for r in rids}
    assert eng.stats["preemptions"] >= 1
    assert eng.stats["decode_tokens"] == base_eng.stats["decode_tokens"]
    assert eng.stats["restored_tokens"] <= eng.stats["preempted_tokens"]
    arm = {"swap": "preempt_swaps", "recompute": "preempt_recomputes"}
    if policy in arm:
        assert eng.stats[arm[policy]] == eng.stats["preemptions"]


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_restores_readmit_ahead_of_lighter_new_work(model, policy):
    """A parked restore holds back fresh work of its own and every lighter
    class: two lockstep batch decoders deadlock a 10-page pool behind a
    backlog of small batch requests; around every ``_admit``, no fresh
    request of weight <= a restore still parked after the call is
    admitted, restores leave the queue ahead of the backlog, and the run
    matches JAX's."""
    reqs = [(list(range(1, 13)), dict(max_new_tokens=40, priority="batch")),
            (list(range(5, 17)), dict(max_new_tokens=40, priority="batch")),
            (list(range(3, 11)), dict(max_new_tokens=6, priority="batch")),
            (list(range(20, 28)), dict(max_new_tokens=6, priority="batch")),
            (list(range(7, 15)), dict(max_new_tokens=6)),
            (list(range(9, 17)), dict(max_new_tokens=6))]
    tcfg, _, _, tp = model
    eng = TEngine(tcfg, tp, **KW, num_blocks=11, preempt_policy=policy)
    admit, parked_with_backlog = eng._admit, []

    def checked():
        parked = list(eng.restore_queue)
        queued = {r.rid for r in eng.queue}
        admit()
        fresh = [r for r in eng.active if r is not None and r.rid in queued]
        held = [r for r in parked if r in eng.restore_queue]
        for r in fresh:
            for h in held:
                assert eng.class_weights[r.priority] > \
                    eng.class_weights[h.priority], (r.rid, h.rid)
        if parked and queued:
            parked_with_backlog.append(len(held))

    eng._admit = checked
    _drain(eng, reqs)
    assert eng.stats["preemptions"] >= 1 and parked_with_backlog
    assert eng.class_stats["batch"]["preemptions"] == eng.stats["preemptions"]
    _both(model, reqs, num_blocks=11, preempt_policy=policy)


# ---------------------------------------------------------------------------
# class stats
# ---------------------------------------------------------------------------

def test_class_stats_accounting(model):
    reqs = [(_prompts(1)[0], dict(max_new_tokens=4, priority="interactive")),
            (_prompts(1, start=2)[0], dict(max_new_tokens=4, priority="interactive")),
            (_prompts(1, start=3)[0], dict(max_new_tokens=6, priority="batch"))]
    rids, done, eng = _both(model, reqs)
    ci, cb = eng.class_stats["interactive"], eng.class_stats["batch"]
    assert ci["submitted"] == 2 and ci["finished"] == 2
    assert cb["submitted"] == 1 and cb["finished"] == 1
    assert ci["finished_tokens"] == 8 and cb["finished_tokens"] == 6
    assert (ci["finished_tokens"] + cb["finished_tokens"]
            == sum(len(done[r].out_tokens) for r in rids))
    assert sum(c["preemptions"] for c in eng.class_stats.values()) == \
        eng.stats["preemptions"]
    eng.reset_stats()
    assert eng.class_stats["interactive"]["submitted"] == 0
    assert eng.stats["slo_violations"] == 0


def test_one_class_greedy_schedule_unchanged(model):
    """One class at T = 0 (the path every earlier slice served): the DRR
    admission is FIFO, and the tick clocks and tokens equal JAX's on a
    pressured 2-slot engine with a backlog of six requests."""
    reqs = [(p, dict(max_new_tokens=10)) for p in _prompts(6, width=12)]
    rids, done, eng = _both(model, reqs, num_blocks=11)
    starts = sorted(rids, key=lambda r: (done[r].first_tick, r))
    assert starts == rids
    assert eng.class_stats["batch"]["submitted"] == 0
