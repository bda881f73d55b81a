"""Port parity, engine: the port's ServeEngine gives greedy outputs
token-identical to the JAX ServeEngine on the prompts and knobs of
tests/test_serve_paged.py and tests/test_prefix_cache.py (fp32, reduced
granite-3-2b, parameters carried over from JAX), with the same prefix-cache
statistics; plus the port engine's own bookkeeping and refusals."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.engine import _page_digests as j_digests  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.engine import BlockAllocator  # noqa: E402
from repro_torch.serve.engine import _page_digests as t_digests  # noqa: E402

# the prompt set of tests/test_serve_paged.py (slot reuse, a chunked
# 50-token prompt) and the shared-prefix stream of tests/test_prefix_cache.py
PAGED_PROMPTS = [[3, 1, 4], [1, 5, 9, 2, 6], [5, 3], list(range(2, 52)),
                 [7, 7, 7, 7], [2, 71, 8], [42], [9, 9, 2]]
SYS_PREFIX = list(range(2, 42))
PREFIX_PROMPTS = [SYS_PREFIX + [50 + i, 60 + i] for i in range(6)]
STATS = ("prefill_tokens", "decode_tokens", "prefix_hits", "prefix_hit_tokens",
         "cow_copies", "pages_shared", "prefill_dispatches", "padded_tokens",
         "gather_page_volume")


@pytest.fixture(scope="module")
def granite():
    cfg = reduced(get_config("granite-3-2b"))
    jparams = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    return cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _drain(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: tuple(r.out_tokens) for r in eng.run_until_drained()}


def _both(granite, prompts, max_new, **kw):
    cfg, jparams, tparams = granite
    jeng, teng = JEngine(cfg, jparams, **kw), TEngine(cfg, tparams, **kw)
    jout, tout = _drain(jeng, prompts, max_new), _drain(teng, prompts, max_new)
    assert tout == jout
    for k in STATS:
        assert teng.stats[k] == jeng.stats[k], k
    return tout, teng


@pytest.mark.parametrize("cache", [True, False])
def test_paged_prompts_match_jax(granite, cache):
    out, _ = _both(granite, PAGED_PROMPTS, 5, max_seq=64, slots=3,
                   prefill_buckets=(8, 16, 32), block_size=8,
                   prefix_caching=cache)
    assert len(out) == len(PAGED_PROMPTS)
    assert all(len(t) == 5 for t in out.values())


def test_prefix_cache_on_off_match_jax(granite):
    kw = dict(max_seq=64, slots=2, block_size=8, prefill_buckets=(8, 16, 32))
    on, eng = _both(granite, PREFIX_PROMPTS, 4, prefix_caching=True, **kw)
    off, _ = _both(granite, PREFIX_PROMPTS, 4, prefix_caching=False, **kw)
    assert on == off
    assert eng.stats["prefix_hit_tokens"] >= 4 * 40
    assert eng.alloc.free_blocks == eng.alloc.num_blocks - 1


def test_prefix_cache_cow_matches_jax(granite):
    """A prompt of exactly two full pages re-matches its own earlier run up
    to plen-1 (mid-page): one copy-on-write, outputs unchanged."""
    cfg, jparams, tparams = granite
    p16 = list(range(3, 19))
    kw = dict(max_seq=64, slots=2, block_size=8, prefill_buckets=(8, 16, 32))
    outs = []
    for eng in (JEngine(cfg, jparams, **kw), TEngine(cfg, tparams, **kw)):
        runs = []
        for _ in range(2):
            eng.submit(p16, max_new_tokens=4)
            runs.append(eng.run_until_drained()[0].out_tokens)
        assert runs[0] == runs[1]
        assert eng.stats["cow_copies"] == 1
        assert eng.stats["prefix_hit_tokens"] == 15
        outs.append(runs)
    assert outs[0] == outs[1]


def test_budget_between_buckets_matches_jax(granite):
    """A token budget strictly between two bucket sizes chunks at the
    largest affordable bucket, exactly as the JAX engine does."""
    _both(granite, [list(range(2, 42))], 3, max_seq=64, slots=2, block_size=8,
          prefill_buckets=(8, 32, 64), max_tokens_per_tick=18)


def test_page_digests_match_jax():
    prompt = np.arange(40, dtype=np.int32)
    seed = b"\x07" * 16
    assert t_digests(prompt, 8, 5, seed) == j_digests(prompt, 8, 5, seed)


def test_allocator_share_release_and_lru():
    alloc = BlockAllocator(num_blocks=4, block_size=2, slots=2,
                           max_blocks_per_slot=3)
    assert alloc.ensure(0, 6)
    pages = [int(p) for p in alloc.table[0, :3]]
    digs = t_digests(np.arange(6, dtype=np.int32), 2, 3)
    for p, d in zip(pages, digs):
        assert alloc.register(p, d)
    assert alloc.share(1, pages[0]) and alloc.refcount[pages[0]] == 2
    alloc.release(0)
    assert alloc.cached_blocks == 2 and alloc.free_blocks == 2
    alloc.pin(pages[0])
    alloc.release(1)
    assert alloc.refcount[pages[0]] == 1          # the pin holds it
    alloc.unpin(pages[0])
    assert alloc.cached_blocks == 3
    assert alloc.alloc_page(0) == pages[2]       # suffix parked first, evicted first
    assert alloc.lookup(digs[2]) is None and alloc.pages_evicted == 1
    with pytest.raises(RuntimeError, match="double free"):
        alloc._unref(pages[1])


def test_engine_refuses_unported_options(granite):
    _, _, tparams = granite
    cfg = reduced(get_config("granite-3-2b"))
    for kw in (dict(expert_parallel=2), dict(class_weights={"batch": 1.0}),
               dict(role="prefill")):
        with pytest.raises(NotImplementedError, match="later slices"):
            TEngine(cfg, tparams, max_seq=32, slots=1, **kw)
    # preemption is ported: a pool below full capacity stands up, and a bad
    # policy is refused as in JAX
    small = TEngine(cfg, tparams, max_seq=32, slots=2, block_size=8,
                    num_blocks=5, preempt_policy="swap")
    assert small.alloc.usable_blocks == 4
    with pytest.raises(ValueError, match="preempt_policy"):
        TEngine(cfg, tparams, max_seq=32, slots=1, preempt_policy="restart")
    eng = TEngine(cfg, tparams, max_seq=32, slots=1)
    for bad in ([], [cfg.vocab_size], [-1]):
        with pytest.raises(ValueError):
            eng.submit(bad)


def test_future_result_and_stream(granite):
    cfg, _, tparams = granite
    eng = TEngine(cfg, tparams, max_seq=32, slots=2, block_size=8,
                  prefill_buckets=(8, 16))
    fa = eng.submit([3, 1, 4], max_new_tokens=4)
    fb = eng.submit([2, 7], max_new_tokens=3)
    assert list(fb.stream()) == fb.tokens() and len(fb.tokens()) == 3
    assert len(fa.result()) == 4 and fa.done() and int(fa) == fa.rid == 0
