"""Port parity, preemption and swap: an oversubscribed page pool.

The port's ServeEngine under page pressure against the JAX ServeEngine, on
the prompts and knobs of tests/test_preemption.py (reduced granite-3-2b:
two decoders of 12-token prompts and 40 new tokens, 7 pages each, over a
pool of 10 usable pages), the deadlock of tests/test_serve_paged.py, the
int8 swap of tests/test_quant_kv.py, the hybrid cases of
tests/test_serve_families.py, olmoe at the dropless capacity factor, and 4
sequence shards (JAX's side in one subprocess with 4 host devices).  Every
engine runs at fp32 with the JAX parameters carried over through
``repro_torch.models.convert``; the engines must agree token for token and
in the preemption statistics (``STATS``, exact), and each pressured run
must match its unpressured counterpart with no decoded token replayed.
Below the engine: the cost model and the paper's constants, exact against
JAX's; the host arena's round trip and all-or-nothing ``alloc``; the page
extract / insert (float, int8, per shard) and the slot-state blob against
JAX's, bit for bit; the launcher's flags.  Inputs come from numpy seeds."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import run_subprocess  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.core import noc as jnoc  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.runner import ModelRunner as JRunner  # noqa: E402
from repro.pimsim import params as jhw  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import noc as tnoc  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.models.runner import ModelRunner as TRunner  # noqa: E402
from repro_torch.pimsim import params as thw  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.swap import SwapArena, SwapHandle  # noqa: E402

# the preemption statistics held equal to JAX's, exactly
STATS = ("preemptions", "preempt_proactive", "preempt_swaps",
         "preempt_recomputes", "swap_bytes", "swap_demotions",
         "preempted_tokens", "restored_tokens", "stalled_ticks",
         "stall_events", "decode_tokens", "prefill_tokens", "ticks",
         "prefix_hit_tokens", "pages_shared")

KW = dict(max_seq=64, slots=2, block_size=8, prefill_buckets=(16, 64))
REQS = [list(range(1, 13)), list(range(5, 17))]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The shapes here are tiny: two intra-op threads keep this file from
    crowding the CPUs that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(arch, **over):
    """(port cfg, JAX cfg, JAX params, port params) of a reduced arch at
    fp32, once per module."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        cfg = reduced(get_config(arch)).replace(**over)
        jp = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
        _MODELS[key] = (t_reduced(t_get_config(arch)).replace(**over), cfg, jp,
                        params_from_jax(jax.tree.map(np.asarray, jp)))
    return _MODELS[key]


def _drain(eng, reqs=REQS, max_new=40, max_ticks=600):
    news = max_new if isinstance(max_new, list) else [max_new] * len(reqs)
    for p, n in zip(reqs, news):
        eng.submit(p, max_new_tokens=n)
    done = eng.run_until_drained(max_ticks=max_ticks)
    return {r.rid: tuple(r.out_tokens) for r in done}


def _both(arch, reqs=REQS, max_new=40, kw=KW, over=None, **extra):
    """The port's and JAX's engines on the same requests: tokens equal and
    the STATS equal.  Returns (tokens, port engine)."""
    tcfg, cfg, jp, tp = _model(arch, **(over or {}))
    jeng = JEngine(cfg, jp, **kw, **extra)
    teng = TEngine(tcfg, tp, **kw, **extra)
    want, got = _drain(jeng, reqs, max_new), _drain(teng, reqs, max_new)
    assert got == want
    for k in STATS:
        assert teng.stats[k] == jeng.stats[k], k
    return got, teng


@pytest.fixture(scope="module")
def base():
    """The unpressured run (full pool, no preemption) of the granite mix."""
    toks, eng = _both("granite-3-2b")
    assert eng.stats["preemptions"] == 0
    return toks, int(eng.stats["decode_tokens"])


# ---------------------------------------------------------------------------
# the cost model (the paper's CXL link and PIM banks)
# ---------------------------------------------------------------------------

def test_cost_model_constants_match_jax():
    """The four rates and the three hardware classes they come from are
    JAX's, field for field."""
    for name in ("SWAP_LINK_BYTES_PER_S", "SWAP_E_PJ_PER_BIT",
                 "RECOMPUTE_FLOPS_PER_S", "RECOMPUTE_E_PJ_PER_FLOP"):
        assert getattr(tnoc, name) == getattr(jnoc, name), name
    for cls in ("DramPim", "SramPim", "Cxl"):
        assert dataclasses.asdict(getattr(thw, cls)()) == \
            dataclasses.asdict(getattr(jhw, cls)()), cls
    assert thw.DramPim().banks == jhw.DramPim().banks
    assert thw.SramPim().bank_flops() == jhw.SramPim().bank_flops()
    assert thw.DramPim().row_overhead_s == jhw.DramPim().row_overhead_s


@pytest.mark.parametrize("n_pages,page_bytes,tokens,fpt,state", [
    (3, 1000, 24, 1e6, 0), (4, 1 << 20, 64, 1e9, 0), (1, 6144, 8, 2.5e7, 512),
    (52, 1572864, 830, 3.2e9, 0), (7, 417, 50, 1e3, 99)])
def test_cost_functions_match_jax(n_pages, page_bytes, tokens, fpt, state):
    """swap_cost, recompute_cost, preempt_decision and restore_cost_seconds
    under every policy give JAX's numbers exactly."""
    assert tnoc.swap_cost(n_pages, page_bytes, state) == \
        jnoc.swap_cost(n_pages, page_bytes, state)
    assert tnoc.recompute_cost(tokens, fpt) == jnoc.recompute_cost(tokens, fpt)
    args = (n_pages, page_bytes, tokens, fpt, state)
    assert tnoc.preempt_decision(*args) == jnoc.preempt_decision(*args)
    for pol in ("swap", "recompute", "auto"):
        assert tnoc.restore_cost_seconds(*args, policy=pol) == \
            jnoc.restore_cost_seconds(*args, policy=pol)
    c = tnoc.swap_cost(n_pages, page_bytes, state)
    assert c["bytes"] == 2 * (n_pages * page_bytes + state)


@pytest.mark.parametrize("attr,value,arm", [
    ("SWAP_LINK_BYTES_PER_S", 1e30, "swap"),
    ("SWAP_LINK_BYTES_PER_S", 1e3, "recompute"),
    ("RECOMPUTE_FLOPS_PER_S", 1e30, "recompute"),
    ("RECOMPUTE_FLOPS_PER_S", 1e3, "swap")])
def test_preempt_decision_crossovers(monkeypatch, attr, value, arm):
    """The arm follows the re-pointed rate, as in tests/test_preemption.py;
    restore_cost_seconds under "auto" is always the taken arm's cost."""
    kw = dict(n_pages=4, page_bytes=1 << 20, tokens=64, flops_per_token=1e9)
    monkeypatch.setattr(tnoc, attr, value)
    assert tnoc.preempt_decision(**kw) == arm
    assert tnoc.restore_cost_seconds(**kw, policy="auto") == \
        tnoc.restore_cost_seconds(**kw, policy=arm)


def test_preempt_decision_flips_once_across_ratio_sweep(monkeypatch):
    monkeypatch.setattr(tnoc, "SWAP_LINK_BYTES_PER_S", 1e9)
    monkeypatch.setattr(tnoc, "RECOMPUTE_FLOPS_PER_S", 1e12)
    decisions = [tnoc.preempt_decision(n_pages=8, page_bytes=pb, tokens=128,
                                       flops_per_token=1e8)
                 for pb in (1 << s for s in range(8, 28, 2))]
    assert decisions[0] == "swap" and decisions[-1] == "recompute"
    assert sum(a != b for a, b in zip(decisions, decisions[1:])) == 1


# ---------------------------------------------------------------------------
# the host arena
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_swap_arena_roundtrip_and_free(rng, quantized):
    """Pages (and an int8 arena's scales) come back bit for bit, in the
    handle's slot order; freeing returns every slot."""
    shape = (2, 1, 8, 4)
    dtype = torch.int8 if quantized else torch.float32
    ar = SwapArena(4, page_shape=shape, dtype=dtype, quantized=quantized)
    h = ar.alloc(3)
    assert isinstance(h, SwapHandle) and h.n_pages == 3 and h.slots == [0, 1, 2]
    if quantized:
        k = _t(rng.integers(-127, 128, size=(3,) + shape).astype(np.int8))
        sc = [_t(rng.uniform(0.1, 2, size=(3, 2, 1)).astype(np.float32))
              for _ in range(2)]
        ar.write(h.slots, k, -k, *sc)
        rk, rv, rks, rvs = ar.read(h.slots[::-1])
        assert torch.equal(rks, sc[0].flip(0)) and torch.equal(rvs, sc[1].flip(0))
    else:
        k = _t(rng.normal(size=(3,) + shape).astype(np.float32))
        ar.write(h.slots, k, -k)
        rk, rv = ar.read(h.slots[::-1])
    assert torch.equal(rk, k.flip(0)) and torch.equal(rv, (-k).flip(0))
    assert ar.used_pages == 3 and ar.free_pages == 1
    assert ar.page_bytes == 2 * 64 * k.element_size() + (16 if quantized else 0)
    ar.free(h)
    assert ar.free_pages == 4 and h.n_pages == 0


def test_swap_arena_alloc_is_all_or_nothing():
    ar = SwapArena(2, page_shape=(1, 1, 4, 2), dtype=torch.float32)
    assert ar.alloc(3) is None and ar.alloc(0) is None
    assert ar.free_pages == 2
    h = ar.alloc(2)
    assert h is not None and ar.alloc(1) is None
    ar.free(h)
    assert sorted(ar.alloc(2).slots) == [0, 1] and ar.free_pages == 0
    with pytest.raises(ValueError):
        SwapArena(0, page_shape=(1, 1, 4, 2), dtype=torch.float32)


# ---------------------------------------------------------------------------
# the device halves: pages and the slot-state blob
# ---------------------------------------------------------------------------

def _pool(rng, quant, a=2, kvh=2, nb=16, bs=4, hd=3):
    st = {"k_pages": rng.normal(size=(a, kvh, nb, bs, hd)).astype(np.float32),
          "v_pages": rng.normal(size=(a, kvh, nb, bs, hd)).astype(np.float32)}
    if quant:
        st = {k: rng.integers(-127, 128, size=v.shape).astype(np.int8)
              for k, v in st.items()}
        st["k_scales"] = rng.uniform(0.1, 2, size=(a, kvh, nb)).astype(np.float32)
        st["v_scales"] = rng.uniform(0.1, 2, size=(a, kvh, nb)).astype(np.float32)
    return {"attn": st}


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("shards", [1, 4])
def test_extract_insert_pages_match_jax(rng, quant, shards):
    """extract_kv_pages / insert_kv_pages against JAX's, bit for bit: the
    gather of a power-of-two padded id list (the null page repeated), and
    the scatter of the pages into other ids of a blank pool with zero
    padding into the null page.  At 4 shards (4 pages a shard) the victim's
    pages span the shards and each shard's pages go in one call, as the
    engine batches them."""
    st = _pool(rng, quant)
    ts = state_from_jax(st)
    src = [5, 2, 9, 14, 6] if shards == 4 else [5, 2, 9]
    dst = [7, 3, 13, 10, 1] if shards == 4 else [7, 3, 13]
    groups = {}
    for i, p in enumerate(dst):
        groups.setdefault(p // (16 // shards), []).append(i)
    blank = jax.tree.map(np.zeros_like, st)
    jback = jax.tree.map(jnp.asarray, blank)
    tback = state_from_jax(blank)
    for _, idx in sorted(groups.items()):
        n = len(idx)
        ids = np.zeros(1 << (n - 1).bit_length(), np.int32)
        ids[:n] = [src[i] for i in idx]
        jk = JM.extract_kv_pages(jax.tree.map(jnp.asarray, st), jnp.asarray(ids))
        tk = TM.extract_kv_pages(ts, _t(ids))
        for a, b in zip(tk, jk):
            assert (a is None) == (b is None) == (not quant and a is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        out = np.zeros_like(ids)
        out[:n] = [dst[i] for i in idx]
        pad = [None if a is None else
               torch.cat([a[:, :, :n], torch.zeros_like(a[:, :, n:])], dim=2)
               for a in tk]
        jback = JM.insert_kv_pages(jback, jnp.asarray(out),
                                   *[None if a is None else jnp.asarray(a.numpy())
                                     for a in pad])
        tback = TM.insert_kv_pages(tback, _t(out), *pad)
    for key, want in jback["attn"].items():
        np.testing.assert_array_equal(tback["attn"][key].numpy(), np.asarray(want),
                                      err_msg=key)
    for s, d in zip(src, dst):
        np.testing.assert_array_equal(tback["attn"]["v_pages"][:, :, d].numpy(),
                                      st["attn"]["v_pages"][:, :, s])


def test_slot_state_blob_matches_jax(rng):
    """The hybrid runner's extract_slot_state against JAX's runner (conv_g /
    ssm_g with the slot on axis 2, conv_t / ssm_t on axis 1): the same keys,
    shapes and bits; slot_state_bytes is JAX's and the blob's size; reset
    then insert gives the state back, neighbours untouched."""
    tcfg, cfg, _, _ = _model("zamba2-7b")
    jr, tr = JRunner(cfg, slots=3, max_seq=32), TRunner(tcfg, slots=3, max_seq=32)
    js = jr.init_state(num_blocks=8, block_size=8, dtype=jnp.float32)
    js = {k: (jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), v) if k != "attn" else v)
          for k, v in js.items()}
    ts = state_from_jax(jax.tree.map(np.asarray, js))
    jblob, tblob = jr.extract_slot_state(js, 1), tr.extract_slot_state(ts, 1)
    assert set(tblob) == set(jblob) == {"conv_g", "ssm_g", "conv_t", "ssm_t"}
    for k in jblob:
        np.testing.assert_array_equal(tblob[k].numpy(), jblob[k], err_msg=k)
    assert tr.slot_state_bytes(ts) == jr.slot_state_bytes(js) == \
        sum(b.numel() * b.element_size() for b in tblob.values())
    before = {k: ts[k].clone() for k in tblob}
    ts = tr.reset_slot(ts, 1)
    assert float(ts["ssm_g"].select(2, 1).abs().max()) == 0.0
    ts = tr.insert_slot_state(ts, 1, tblob)
    for k in tblob:
        assert torch.equal(ts[k], before[k]), k


# ---------------------------------------------------------------------------
# the engine on the dense family: pressured == JAX's == unpressured
# ---------------------------------------------------------------------------

ENGINE_CASES = {
    "swap": dict(preempt_policy="swap"),
    "recompute": dict(preempt_policy="recompute"),
    "auto": dict(preempt_policy="auto"),
    "no_prefix_cache": dict(preempt_policy="recompute", prefix_caching=False),
    "full_arena": dict(preempt_policy="swap", swap_pages=1, prefix_caching=False),
    "pinned_chain": dict(preempt_policy="swap", swap_pages=4),
    "proactive": dict(preempt_policy="swap", proactive_horizon=2),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_under_pressure_matches_jax(base, case):
    """num_blocks=11 (10 usable pages): the port token-identical to JAX's
    engine with equal STATS, and to the unpressured run with the same
    decode work (no decoded token replayed); each case takes its arm:
    swap only, recompute only (re-attaching decoded pages through the
    prefix cache; nothing re-attaches with the cache off), auto at the
    paper's rates (recompute for this small model), a one-page arena
    falling back to recompute, the pinned prefix chain fitting a 4-page
    arena, and the proactive horizon preempting before a stall."""
    base_toks, base_decode = base
    toks, eng = _both("granite-3-2b", num_blocks=11, **ENGINE_CASES[case])
    s = eng.stats
    assert toks == base_toks
    assert s["preemptions"] >= 1 and s["decode_tokens"] == base_decode
    assert s["restored_tokens"] <= s["preempted_tokens"]
    assert s["preemptions"] >= s["preempt_swaps"] + s["preempt_recomputes"]
    if case in ("swap", "pinned_chain", "proactive"):
        assert s["preempt_swaps"] >= 1 and s["preempt_recomputes"] == 0
        assert s["swap_bytes"] > 0 and s["restored_tokens"] > 0
    else:
        assert s["preempt_recomputes"] >= 1 and s["preempt_swaps"] == 0
        assert s["swap_bytes"] == 0
    if case == "recompute":
        assert s["restored_tokens"] > 0
    if case in ("no_prefix_cache", "full_arena"):
        assert s["restored_tokens"] == 0
    if case == "proactive":
        assert s["preempt_proactive"] >= 1
    assert eng.alloc.free_blocks == eng.alloc.usable_blocks
    assert not eng.restore_queue


def test_auto_follows_the_cost_model(base, monkeypatch):
    """auto takes the swap arm once the modeled link is fast enough (the
    rate re-pointed in both packages), and stays token-identical."""
    monkeypatch.setattr(jnoc, "SWAP_LINK_BYTES_PER_S", 1e30)
    monkeypatch.setattr(tnoc, "SWAP_LINK_BYTES_PER_S", 1e30)
    toks, eng = _both("granite-3-2b", num_blocks=11, preempt_policy="auto")
    assert toks == base[0]
    assert eng.stats["preempt_swaps"] >= 1 and eng.stats["preempt_recomputes"] == 0


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_interrupted_restore_matches_jax(policy):
    """A budget of one 8-token chunk a tick leaves a recompute victim's
    replay gap across ticks while the other slot decodes: it must not
    decode before its whole resume target is back (tests/test_preemption.py
    :253); token-identical to JAX's and to the unpressured run."""
    kw = dict(max_seq=64, slots=2, block_size=8, prefill_buckets=(8, 16, 64),
              max_tokens_per_tick=10)
    base_toks, beng = _both("granite-3-2b", kw=kw)
    toks, eng = _both("granite-3-2b", kw=kw, num_blocks=11,
                      preempt_policy=policy, prefix_caching=False)
    assert eng.stats["preemptions"] >= 1 and toks == base_toks
    assert eng.stats["decode_tokens"] == beng.stats["decode_tokens"]


def test_restores_admit_ahead_of_new_requests():
    """A preempted request re-admits before a later submission takes a
    slot (tests/test_preemption.py:218)."""
    tcfg, _, _, tp = _model("granite-3-2b")
    eng = TEngine(tcfg, tp, num_blocks=11, preempt_policy="swap", **KW)
    for p in REQS:
        eng.submit(p, max_new_tokens=40)
    order = []
    for _ in range(400):
        order += [r.rid for r in eng.step()]
        if eng.stats["preemptions"] >= 1:
            break
    assert eng.stats["preemptions"] >= 1
    victim = eng.restore_queue[0].rid
    late = eng.submit([9, 8, 7], max_new_tokens=4)
    seen = False
    for _ in range(400):
        order += [r.rid for r in eng.step()]
        if any(r is not None and r.rid == late for r in eng.active):
            seen = True
            assert all(r.rid != victim for r in eng.restore_queue)
        if not eng.queued and not eng.restore_queue and \
                all(r is None for r in eng.active):
            break
    assert seen and set(order) == {0, 1, late}


def test_deadlock_broken_by_preemption_matches_jax():
    """tests/test_serve_paged.py:297: two 72-token prompts of 10 pages each
    over 12 usable pages, one mid-prefill and one decode-stalled, untangled
    by a preemption; JAX's tokens and STATS; the pool whole after the
    drain, the counter reset."""
    kw = dict(max_seq=128, slots=2, block_size=8, prefill_buckets=(32, 128),
              max_tokens_per_tick=66)
    reqs = [list(range(1, 73))] * 2
    toks, eng = _both("granite-3-2b", reqs=reqs, max_new=4, kw=kw, num_blocks=13)
    assert all(len(t) == 4 for t in toks.values())
    assert eng.stats["preemptions"] >= 1 and eng.alloc.free_blocks == 12
    eng.reset_stats()
    assert eng.stats["preemptions"] == 0


def test_engine_options_and_strict_drain(monkeypatch):
    """preempt_policy and proactive_horizon are validated as in JAX; a pool
    below full capacity stands up; the strict drain error names the
    preemptions by arm and the restore backlog; the roles build, and of the
    JAX engine's options only a ``q_tile`` is refused (no counterpart)."""
    tcfg, _, _, tp = _model("granite-3-2b")
    with pytest.raises(ValueError, match="preempt_policy"):
        TEngine(tcfg, tp, preempt_policy="restart", **KW)
    with pytest.raises(ValueError, match="proactive_horizon"):
        TEngine(tcfg, tp, proactive_horizon=-1, **KW)
    for role in (None, "prefill", "decode"):
        assert TEngine(tcfg, tp, role=role, q_tile=None, **KW).role == role
    with pytest.raises(NotImplementedError, match="q_tile has no counterpart"):
        TEngine(tcfg, tp, q_tile=64, **KW)
    eng = TEngine(tcfg, tp, num_blocks=3, **KW)
    assert eng.alloc.usable_blocks == 2 and eng.preempt_policy == "auto"
    eng.submit([1, 2, 3], max_new_tokens=4)
    monkeypatch.setattr(eng, "step", lambda: [])
    with pytest.raises(RuntimeError, match=r"awaiting_restore=0.*preempt_swaps="
                                           r".*preempt_recomputes="):
        eng.run_until_drained(max_ticks=3)


def test_int8_swap_matches_jax():
    """tests/test_quant_kv.py:268: swap preemption over an int8 pool parks
    int8 pages and their scales and brings them back; token-identical to
    JAX's int8 engine under the same pressure and to the unpressured int8
    run."""
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, 128, 10).tolist() for _ in range(3)]
    kw = dict(paged=True, max_seq=48, slots=2, block_size=8,
              prefill_buckets=(16,), kv_dtype="int8")
    base_toks, _ = _both("stablelm-1.6b", reqs=reqs, max_new=14, kw=kw)
    toks, eng = _both("stablelm-1.6b", reqs=reqs, max_new=14, kw=kw,
                      num_blocks=1 + (7 * 3) // 5, preempt_policy="swap")
    assert eng.stats["preempt_swaps"] >= 1 and eng.stats["swap_bytes"] > 0
    assert toks == base_toks
    assert eng._arena.quantized and eng._arena._k.dtype == torch.int8


# ---------------------------------------------------------------------------
# the hybrid and MoE under pressure
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hybrid_base():
    toks, eng = _both("zamba2-7b")
    assert eng.stats["preemptions"] == 0
    return toks, int(eng.stats["decode_tokens"])


@pytest.mark.parametrize("policy", ["swap", "recompute", "auto"])
def test_hybrid_under_pressure_matches_jax(hybrid_base, policy):
    """tests/test_serve_families.py:214: reduced zamba2-7b over 10 usable
    pages: the Mamba2 slot-state blob travels with the shared block's pages
    (swap) or is rebuilt by the replay (recompute); JAX's tokens and STATS,
    the unpressured run's tokens and decode work."""
    base_toks, base_decode = hybrid_base
    toks, eng = _both("zamba2-7b", num_blocks=11, preempt_policy=policy)
    s = eng.stats
    assert toks == base_toks and s["preemptions"] >= 1
    assert s["decode_tokens"] == base_decode
    if policy == "swap":
        assert s["preempt_swaps"] >= 1 and s["restored_tokens"] > 0
        # the parked payload includes the slot-state blob
        assert s["swap_bytes"] % eng._page_kv_bytes() != 0


def test_hybrid_swap_pins_the_registered_chain(hybrid_base):
    """tests/test_serve_families.py:236: with prefix caching on, the
    victim's registered pages are pinned, not copied: fewer swap bytes than
    with caching off, pages shared back at restore; both runs JAX's."""
    on_toks, on = _both("zamba2-7b", num_blocks=11, preempt_policy="swap")
    off_toks, off = _both("zamba2-7b", num_blocks=11, preempt_policy="swap",
                          prefix_caching=False)
    assert on_toks == off_toks == hybrid_base[0]
    assert on.stats["preempt_swaps"] >= 1 and off.stats["preempt_swaps"] >= 1
    assert on.stats["swap_bytes"] < off.stats["swap_bytes"]
    assert on.stats["pages_shared"] > 0


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_moe_dropless_under_pressure_matches_jax(policy):
    """Reduced olmoe at the dropless cf = E/k (so the replay's chunking
    moves no routing): JAX's tokens and STATS, and the unpressured run's."""
    cfg = reduced(get_config("olmoe-1b-7b"))
    over = dict(capacity_factor=float(cfg.n_experts) / cfg.top_k)
    base_toks, _ = _both("olmoe-1b-7b", over=over)
    toks, eng = _both("olmoe-1b-7b", over=over, num_blocks=11,
                      preempt_policy=policy)
    assert toks == base_toks and eng.stats["preemptions"] >= 1


# ---------------------------------------------------------------------------
# 4 sequence shards: against JAX's engine at 4 shards (one subprocess)
# ---------------------------------------------------------------------------

_JAX_SHARDED = """
import json, jax, numpy as np, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.models import model as M
from repro.serve import ServeEngine
KW = dict(max_seq=64, slots=2, block_size=8, prefill_buckets=(16, 64))
REQS = [list(range(1, 13)), list(range(5, 17))]
out = {}
for arch in ("granite-3-2b", "zamba2-7b"):
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    for pol in ("swap", "recompute"):
        eng = ServeEngine(cfg, params, num_blocks=12, preempt_policy=pol,
                          seq_shards=4, **KW)
        for p in REQS:
            eng.submit(p, max_new_tokens=40)
        done = eng.run_until_drained(max_ticks=600)
        out[arch + "/" + pol] = {
            "toks": {str(r.rid): list(r.out_tokens) for r in done},
            "stats": {k: float(v) for k, v in eng.stats.items()
                      if np.ndim(v) == 0}}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_sharded():
    line = [ln for ln in run_subprocess(_JAX_SHARDED, devices=4).splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-7b"])
@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_sharded_under_pressure_matches_jax(jax_sharded, arch, policy):
    """num_blocks=12 over 4 shards (3 pages a shard, a null page each):
    the port token-identical to JAX's engine at 4 shards with equal STATS
    and NoC totals, and to the unpressured one-shard run (JAX's own tests
    hold JAX's 4 shards to it)."""
    tcfg, cfg, jp, tp = _model(arch)
    want = jax_sharded[f"{arch}/{policy}"]
    eng = TEngine(tcfg, tp, num_blocks=12, preempt_policy=policy, seq_shards=4,
                  **KW)
    toks = _drain(eng)
    assert toks == {int(k): tuple(v) for k, v in want["toks"].items()}
    for k in STATS + ("noc_combines", "noc_hops", "noc_bytes"):
        assert eng.stats[k] == want["stats"][k], k
    assert eng.stats["preemptions"] >= 1
    base = _drain(TEngine(tcfg, tp, **KW))
    assert toks == base


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--preempt-policy", "swap"], ["--preempt-policy", "recompute"],
    ["--preempt-policy", "auto"],
    ["--preempt-policy", "swap", "--proactive-horizon", "2", "--swap-pages", "64"]],
    ids=["swap", "recompute", "auto", "proactive"])
def test_launch_serve_oversubscribed_pool(capsys, flags):
    """launch/serve.py --num-blocks below full capacity on the CPU: every
    request finishes and the summary line counts the preemptions by arm
    (and the proactive ones)."""
    tlaunch.main(["--reduced", "--device", "cpu", "--num-blocks", "8",
                  "--max-new-tokens", "40"] + flags)
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if "tok/s" in ln][-1]
    assert line.startswith("[serve] 8 requests, 320 tokens")
    n = int(line.split("preemptions=")[1].split(" ")[0])
    swaps = int(line.split("(swap=")[1].split("/")[0])
    recs = int(line.split("recompute=")[1].split(",")[0])
    assert n >= 1 and n >= swaps + recs
    arm = flags[1]
    if arm == "swap":
        assert swaps >= 1 and recs == 0
    if arm == "recompute":
        assert recs >= 1 and swaps == 0
    if "--proactive-horizon" in flags:
        assert "[serve] proactive preemptions (horizon=2)" in out


def test_trace_serve_ranges_the_preemption_arms(base, monkeypatch):
    """trace_serve ranges the engine's swap-out and swap-in (every kernel
    under them moved to "swap out" / "swap in"; the handoff's two halves
    likewise, "handoff out" / "handoff in") and a recompute restore's
    replayed chunks ("recompute"), and only those chunks: on the granite
    mix with the cache off, the replay covers the decoded gap of each
    recompute victim, and the outputs stay the unpressured run's."""
    from repro_torch.launch import trace_serve as ts

    assert dict(ts.ARMS) == {"_swap_out": "swap out",
                             "_restore_swapped": "swap in",
                             "stage_handoff": "handoff out",
                             "_admit_handoff": "handoff in"}
    assert all(callable(getattr(TEngine, a)) for a, _ in ts.ARMS)
    for group in ("swap out", "swap in", "recompute", "handoff out",
                  "handoff in"):
        assert ts.MOVED_FROM[group] is None
    seen = []

    class Range:
        def __init__(self, name):
            seen.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setattr(TEngine, "_run_prefill_chunk",
                        ts._replay_ranged(TEngine._run_prefill_chunk))
    tcfg, _, _, tp = _model("granite-3-2b")
    eng = TEngine(tcfg, tp, num_blocks=11, preempt_policy="recompute",
                  prefix_caching=False, **KW)
    assert _drain(eng) == base[0]
    replays = seen.count("trace_serve::recompute")
    assert replays >= 1 and replays < eng.stats["prefill_dispatches"]
    assert set(seen) == {"trace_serve::recompute"}
