"""Port parity, disaggregated prefill/decode serving.

The port's ``DisaggServer`` against the JAX package's, in process, on the
cases of tests/test_disagg.py (reduced granite-3-2b, rwkv6-3b and zamba2-7b
at fp32, the JAX parameters carried over through
``repro_torch.models.convert``): fp16 and int8 round trips, the
prefix-cached remainder, the recurrent blobs riding the handoff, a decode
pool too small to take every handoff, no token replayed, futures and
stream, the roles' validation and the parked prefill.  Every case gates on
token identity with JAX's server and with the port's monolithic engine
(itself held to JAX's engine by tests/test_torch_engine.py and its
neighbours), and on the handoff ledger (``LEDGER`` and the decode side's
``handoff_stalls``, exact).  Each JAX server runs once per module.  Below
the server: ``noc.handoff_cost`` / ``handoff_admission_cost`` bit-equal to
JAX's over a grid, ``handoff_payload_bytes`` equal to JAX's, and the
launcher's ``--disagg``.  Inputs come from numpy seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.core import noc as jnoc  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.runner import ModelRunner as JRunner  # noqa: E402
from repro.serve import DisaggServer as JServer  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import noc as tnoc  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.runner import ModelRunner as TRunner  # noqa: E402
from repro_torch.serve import DisaggServer as TServer  # noqa: E402
from repro_torch.serve import HandoffHandle, RequestFuture  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402

KW = dict(max_seq=64, slots=2, block_size=8, prefill_buckets=(16, 64))
# the server's handoff ledger, held equal to JAX's
LEDGER = ("handoffs", "handoff_pages", "handoff_cached_pages",
          "handoff_bytes", "handoff_hops", "arena_stalls")


# the JAX engines' programs are tiny and their compiles take most of their
# time: XLA's cheapest compile keeps this file's run short
JIT = dict(compiler_options={"xla_backend_optimization_level": 0,
                             "xla_llvm_disable_expensive_passes": True})


@pytest.fixture(autouse=True, scope="module")
def _cheap():
    """Two intra-op threads (tiny shapes: this file does not crowd the CPUs
    the other test workers share), and JAX's jit at ``JIT`` while the
    module runs (the JAX engines call ``jax.jit`` themselves)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    jit = jax.jit
    jax.jit = lambda f=None, **kw: (jit(f, **{**JIT, **kw}) if f is not None
                                    else lambda g: jit(g, **{**JIT, **kw}))
    yield
    jax.jit = jit
    torch.set_num_threads(n)


_MODELS = {}


def _model(arch="granite-3-2b"):
    """(port cfg, JAX cfg, JAX params, port params), reduced, fp32, once
    per module."""
    if arch not in _MODELS:
        cfg = reduced(get_config(arch))
        # jitted: the eager init of the recurrent configs takes seconds
        jp = jax.jit(lambda key: JM.init_params(cfg, key, dtype=jnp.float32))(
            jax.random.key(0))
        _MODELS[arch] = (t_reduced(t_get_config(arch)), cfg, jp,
                         params_from_jax(jax.tree.map(np.asarray, jp)))
    return _MODELS[arch]


def _prompts(vocab, n=4, seed=0):
    """tests/test_disagg.py's prompts."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(ln)).astype(np.int32)
            for ln in rng.integers(6, 30, size=n)]


def _prefix_pair(vocab):
    """Two prompts on one 24-token prefix (3 full pages at block 8)."""
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, vocab, size=24).astype(np.int32)
    tail_a = rng.integers(0, vocab, size=5).astype(np.int32)
    tail_b = rng.integers(0, vocab, size=5).astype(np.int32)
    return np.concatenate([prefix, tail_a]), np.concatenate([prefix, tail_b])


def _run(srv, waves, max_new):
    """Submit each wave of prompts and drain -> (tokens by rid, the
    server's ledger after each wave, the decode side's stalls, futures)."""
    toks, ledgers, futs = {}, [], []
    for wave in waves:
        futs += [srv.submit(p, max_new_tokens=max_new) for p in wave]
        toks.update({r.rid: tuple(r.out_tokens)
                     for r in srv.run_until_drained()})
        ledgers.append({k: srv.stats[k] for k in LEDGER})
    return toks, ledgers, srv.decode.stats["handoff_stalls"], futs


# case -> (arch, server keywords, prompt waves by vocab, new tokens)
CASES = {
    "fp16": ("granite-3-2b", {}, lambda v: [_prompts(v)], 6),
    "int8": ("granite-3-2b", dict(kv_dtype="int8"),
             lambda v: [_prompts(v, seed=1)], 6),
    "prefix": ("granite-3-2b", {}, lambda v: [[p] for p in _prefix_pair(v)], 6),
    "zamba2-7b": ("zamba2-7b", {}, lambda v: [_prompts(v, n=3, seed=3)], 6),
    "rwkv6-3b": ("rwkv6-3b", {}, lambda v: [_prompts(v, n=3, seed=3)], 6),
    # the decode pool: two slots but pages for barely one chain (+ the null)
    "backpressure": ("granite-3-2b", dict(decode={"num_blocks": 7}),
                     lambda v: [_prompts(v, n=5, seed=4)], 4),
}
_JAX, _PORT = {}, {}


def _jax(case):
    """JAX's server on a case, once per module."""
    if case not in _JAX:
        arch, kw, waves, new = CASES[case]
        _, cfg, jp, _ = _model(arch)
        _JAX[case] = _run(JServer(cfg, jp, **KW, **kw), waves(cfg.vocab_size),
                          new)[:3]
    return _JAX[case]


def _port(case):
    """(the port's server, its run, the port's monolithic tokens)."""
    if case not in _PORT:
        arch, kw, waves, new = CASES[case]
        tcfg, _, _, tp = _model(arch)
        srv = TServer(tcfg, tp, **KW, **kw)
        run = _run(srv, waves(tcfg.vocab_size), new)
        mono = TEngine(tcfg, tp, **KW, kv_dtype=kw.get("kv_dtype", "fp16"))
        for wave in waves(tcfg.vocab_size):
            for p in wave:
                mono.submit(p, max_new_tokens=new)
        mono_toks = {r.rid: tuple(r.out_tokens)
                     for r in mono.run_until_drained()}
        _PORT[case] = (srv, run, mono_toks)
    return _PORT[case]


def _held(case):
    """The port's server on ``case``: tokens equal to JAX's server's and
    to the port's monolithic engine's; the ledger after every wave and the
    decode side's handoff stalls equal to JAX's."""
    want, want_ledgers, want_stalls = _jax(case)
    srv, (got, ledgers, stalls, futs), mono = _port(case)
    assert got == want
    assert got == mono
    assert ledgers == want_ledgers
    assert stalls == want_stalls
    return srv, got, futs


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------

def test_disagg_matches_jax_fp16():
    srv, got, _ = _held("fp16")
    n = len(got)
    assert srv.stats["handoffs"] == srv.decode.stats["handoffs"] == n
    assert srv.stats["handoff_bytes"] > 0 and srv.stats["handoff_hops"] >= n
    assert srv.stats["handoff_energy_pj"] > 0
    # every page crossed at the pool's width
    assert srv.stats["handoff_bytes"] == (srv.stats["handoff_pages"]
                                          * srv.prefill._page_kv_bytes())


def test_disagg_matches_jax_int8_scales_ride_along():
    """int8 chains cross at storage width (the scales in the arena beside
    the pages); cheaper than the same stream at fp32."""
    srv, _, _ = _held("int8")
    fp32 = TServer(*_model()[::3], **KW).prefill._page_kv_bytes()
    assert srv.prefill._page_kv_bytes() < fp32
    assert srv._arena.quantized and srv._arena._ks.dtype == torch.float32
    assert srv.stats["handoff_bytes"] == (srv.stats["handoff_pages"]
                                          * srv.prefill._page_kv_bytes())


def test_prefix_cached_chain_transfers_only_uncached_remainder():
    """The second prompt's 3 prefix pages are already registered in the
    decode pool: only its uncached rest crosses."""
    srv, _, futs = _held("prefix")
    first, second = _port("prefix")[1][1]
    assert first["handoff_cached_pages"] == 0
    assert second["handoff_cached_pages"] == 3
    assert second["handoff_bytes"] - first["handoff_bytes"] < first["handoff_bytes"]
    assert all(f.done() for f in futs)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_slot_state_families_ride_handoff(arch):
    """The hybrid hands off pages and its Mamba2 blob, rwkv6 its blob
    alone: each token-identical to JAX's server and the monolithic
    engine, the blob's bytes in the ledger."""
    srv, got, _ = _held(arch)
    assert srv.stats["handoffs"] == len(got)
    blob = srv.prefill._slot_state_bytes
    assert blob > 0
    pages = srv.stats["handoff_pages"] * (srv.prefill._page_kv_bytes()
                                          if srv.prefill.paged else 0)
    assert srv.stats["handoff_bytes"] == pages + len(got) * blob
    assert srv.prefill.paged == (arch == "zamba2-7b")


def test_backpressure_decode_pool_full():
    """A decode pool too small for every staged handoff defers admission,
    holds the rest in the arena or the parked prefill slots, and drains
    token-identically."""
    srv, _, _ = _held("backpressure")
    assert (srv.decode.stats["handoff_stalls"] > 0
            or srv.stats["arena_stalls"] > 0)


def test_arena_backpressure_matches_jax():
    """An arena of three pages defers staging (``arena_stalls``): two
    2-page chains park in one tick and the second waits, the parked prefill
    keeping its pages; tokens and ledger equal to JAX's."""
    tcfg, cfg, jp, tp = _model()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (14, 15, 11)]
    want = _run(JServer(cfg, jp, **KW, handoff_pages=3), [prompts], 4)
    srv = TServer(tcfg, tp, **KW, handoff_pages=3)
    got = _run(srv, [prompts], 4)
    assert got[:3] == want[:3]
    assert srv.stats["arena_stalls"] > 0
    assert srv._arena.free_pages == srv._arena.capacity
    assert not srv.decode.alloc.refcount.any()


def test_no_token_replayed_across_handoff():
    """The prefill side samples one token a request and decodes none; the
    decode side decodes every other token and prefills nothing."""
    srv, got, _ = _held("fp16")
    total = sum(len(t) for t in got.values())
    assert srv.prefill.stats["decode_tokens"] == 0
    assert srv.decode.stats["decode_tokens"] == total - len(got)
    assert srv.decode.stats["prefill_tokens"] == 0
    assert next(srv.decode._rid) == 0            # the decode side adopts rids


# ---------------------------------------------------------------------------
# futures
# ---------------------------------------------------------------------------

def test_futures_resolve_identically_on_both_shapes():
    tcfg, cfg, _, tp = _model()
    prompts = _prompts(cfg.vocab_size)
    want = _jax("fp16")[0]
    mono = TEngine(tcfg, tp, **KW)
    mono_futs = [mono.submit(p, max_new_tokens=6) for p in prompts]
    srv = TServer(tcfg, tp, **KW)
    srv_futs = [srv.submit(p, max_new_tokens=6) for p in prompts]
    for mf, df in zip(mono_futs, srv_futs):
        assert isinstance(mf, RequestFuture) and isinstance(df, RequestFuture)
        assert mf.result() == df.result() == list(want[int(df)])
        assert mf.done() and df.done()
    assert [int(f) for f in mono_futs] == [int(f) for f in srv_futs]


def test_future_stream_yields_the_full_token_list():
    tcfg, cfg, _, tp = _model()
    p = _prompts(cfg.vocab_size)[0]
    want = list(_jax("fp16")[0][0])
    fut = TEngine(tcfg, tp, **KW).submit(p, max_new_tokens=6)
    assert list(fut.stream()) == fut.tokens() == want
    fut = TServer(tcfg, tp, **KW).submit(p, max_new_tokens=6)
    assert list(fut.stream()) == want


# ---------------------------------------------------------------------------
# roles
# ---------------------------------------------------------------------------

def test_role_validation():
    """The JAX engine's and server's refusals, message for message."""
    tcfg, _, _, tp = _model()
    with pytest.raises(ValueError, match="role must be None"):
        TEngine(tcfg, tp, role="both", **KW)
    with pytest.raises(ValueError, match="paged=False"):
        TEngine(tcfg, tp, role="prefill", paged=False, **KW)
    dec = TEngine(tcfg, tp, role="decode", **KW)
    with pytest.raises(RuntimeError, match="handoffs only"):
        dec.submit(np.array([1, 2, 3], np.int32))
    pre = TEngine(tcfg, tp, role="prefill", **KW)
    with pytest.raises(RuntimeError, match="cannot admit"):
        pre.submit_handoff(HandoffHandle())
    with pytest.raises(RuntimeError, match="no handoff-ready"):
        pre.stage_handoff(0, None)
    with pytest.raises(ValueError, match="roles"):
        TServer(tcfg, tp, prefill={"role": "decode"}, **KW)
    with pytest.raises(ValueError, match="layout-identical"):
        TServer(tcfg, tp, **KW, decode={"block_size": 16})
    with pytest.raises(ValueError, match="layout-identical"):
        TServer(tcfg, tp, **KW, decode={"kv_dtype": "int8"})
    # only a swap-only decode role may run below the smallest bucket
    small = dict(KW, max_tokens_per_tick=4)
    with pytest.raises(ValueError, match="exempt"):
        TEngine(tcfg, tp, role="decode", **small)
    assert TEngine(tcfg, tp, role="decode", preempt_policy="swap",
                   **small).max_tokens_per_tick == 4


def test_prefill_role_parks_instead_of_decoding():
    tcfg, cfg, _, tp = _model()
    pre = TEngine(tcfg, tp, role="prefill", **KW)
    p = _prompts(cfg.vocab_size, n=1, seed=8)[0]
    pre.submit(p, max_new_tokens=8)
    for _ in range(30):
        pre.step()
        if pre.poll_handoffs():
            break
    slots = pre.poll_handoffs()
    assert len(slots) == 1
    req = pre.active[slots[0]]
    assert len(req.out_tokens) == 1
    assert pre.stats["decode_tokens"] == 0
    # parked slots are no preemption victims and never decode
    assert pre._victims() == [] and not pre._decode_ready(slots[0])
    for _ in range(5):
        pre.step()
    assert len(req.out_tokens) == 1


def test_handoff_round_trip_into_a_monolithic_engine():
    """A staged handle admitted by a monolithic engine: its pages and
    scales come back bit-equal in the decode pool, the transferred full
    pages registered under their digests, the rid adopted."""
    tcfg, cfg, _, tp = _model()
    p = _prompts(cfg.vocab_size, n=1, seed=10)[0]
    for kv in ("fp16", "int8"):
        srv = TServer(tcfg, tp, **KW, kv_dtype=kv)
        srv.submit(p, max_new_tokens=5)
        while not srv.prefill.poll_handoffs():
            srv.prefill.step()
        (slot,) = srv.prefill.poll_handoffs()
        pre = srv.prefill
        n = -(-int(pre.lengths[slot]) // pre.block_size)
        ids = torch.as_tensor(pre.alloc.table[slot, :n].astype(np.int64))
        before = [t.clone() for t in pre.runner.extract_pages(pre.state, ids)
                  if t is not None]
        handle = pre.stage_handoff(slot, srv._get_arena())
        eng = TEngine(tcfg, tp, **KW, kv_dtype=kv)
        fut = eng.submit_handoff(handle)
        eng._admit()
        ids = torch.as_tensor(eng.alloc.table[0, :n].astype(np.int64))
        after = [t for t in eng.runner.extract_pages(eng.state, ids)
                 if t is not None]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        full = handle.tokens // KW["block_size"]
        assert [eng.alloc.lookup(d) for d in handle.digests[:full]] == \
            [int(x) for x in eng.alloc.table[0, :full]]
        assert int(fut) == handle.rid and eng.stats["handoffs"] == 1
        assert fut.result()[0] == handle.out_tokens[0]


# ---------------------------------------------------------------------------
# the cost model and the payload
# ---------------------------------------------------------------------------

def test_handoff_cost_bit_equal_to_jax():
    for n_pages in range(0, 9):
        for cached in range(0, n_pages + 2):
            for page_bytes in (0, 1536, 49152, 6291456):
                for state_bytes in (0, 1234, 27648):
                    for hops in (1, 2, 5):
                        args = (n_pages, page_bytes, state_bytes, cached, hops)
                        assert tnoc.handoff_cost(*args) == jnoc.handoff_cost(*args)
                    for free in (0, 3, 8):
                        a = (n_pages, page_bytes, free, state_bytes, cached)
                        assert (tnoc.handoff_admission_cost(*a)
                                == jnoc.handoff_admission_cost(*a))


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-7b", "rwkv6-3b"])
def test_handoff_payload_bytes_match_jax(arch):
    tcfg, cfg, _, _ = _model(arch)
    for kv in (("fp16", "int8") if arch != "rwkv6-3b" else ("fp16",)):
        jr, tr = JRunner(cfg, 2, 64, kv_dtype=kv), TRunner(tcfg, 2, 64, kv_dtype=kv)
        js = jr.init_state(9, 8, jnp.float32)
        ts = tr.init_state(9, 8, torch.float32, "cpu")
        for n, c in ((0, 0), (3, 0), (5, 2), (2, 4)):
            for state in ((None, None), (js, ts)):
                assert tr.handoff_payload_bytes(8, 4, n, c, state[1]) == \
                    jr.handoff_payload_bytes(8, 4, n, c, state[0])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_serve_disagg_cpu(capsys):
    """``launch/serve.py --disagg`` on the CPU: the pair splits the slots,
    the two disagg lines and the per-class line with the prefill front
    door's count; ``--disagg --dense`` is refused as in JAX."""
    tlaunch.main(["--reduced", "--device", "cpu", "--disagg", "--slots", "4",
                  "--requests", "5", "--max-new-tokens", "4",
                  "--batch-frac", "0.4"])
    out = capsys.readouterr().out
    assert "[serve] 5 requests" in out
    line = [ln for ln in out.splitlines() if ln.startswith("[serve] disagg:")][0]
    assert "prefill=2 slots / decode=2 slots, arena=16 pages" in line
    assert "handoffs=5 " in line and "arena_stalls=0" in line
    assert "[serve] disagg prefill side:" in out
    classes = [ln for ln in out.splitlines() if ln.startswith("[serve] class ")]
    assert sum(int(ln.split("finished=")[1].split("/")[1].split(",")[0])
               for ln in classes) == 5
    with pytest.raises(SystemExit):
        tlaunch.main(["--reduced", "--device", "cpu", "--disagg", "--dense"])
