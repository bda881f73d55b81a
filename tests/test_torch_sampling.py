"""Port parity, temperature sampling.

The port samples a row at ``T > 0`` by Gumbel-max, ``argmax(logits / T +
G)`` in f32 with its noise from one seeded ``torch.Generator``
(``serve/engine.py:sample_tokens``), the form of JAX's
``jax.random.categorical``.  The bits cannot match JAX's threefry stream,
so the distributions are compared: 20000 draws from a fixed logits row at
T = 0.7 (its mass on 32 tokens, the rest at -1e30), from the port's
sampler and from ``jax.random.categorical`` over split keys as JAX's
engine draws them, each within a chi-square bound of softmax(logits / T);
a sampler that skips the division by T fails the same bound.  Rows at T = 0
are the argmax bit for bit and draw nothing; one seed gives one stream
twice; in a stream mixing greedy and T = 0.8 requests the greedy ones stay
token-identical to JAX's engine's (reduced granite-3-2b at fp32, the JAX
parameters carried over).  Inputs come from numpy seeds."""
import sys
from pathlib import Path

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
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.engine import sample_tokens  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

DRAWS = 20000
T = 0.7
SUPPORT = 32          # tokens carrying the mass; the rest sit at -1e30
VOCAB = 512
KW = dict(max_seq=64, slots=4, block_size=8, prefill_buckets=(16, 64))


def _row(seed=0):
    """A fixed logits row [VOCAB] f32: N(0, 1.5) on SUPPORT tokens spread
    over the vocabulary, -1e30 elsewhere."""
    rng = np.random.default_rng(seed)
    row = np.full((VOCAB,), -1e30, np.float32)
    idx = rng.choice(VOCAB, SUPPORT, replace=False)
    row[idx] = rng.normal(0.0, 1.5, SUPPORT).astype(np.float32)
    return row


def chi_square(tokens, row, t=T):
    """(statistic, bound) of the draws against softmax(row / t), through
    chip_smoke.py's ``chi_square`` (bins under 5 expected merged; the bound
    is chi-square's 0.999 quantile at the merged bins' degrees of
    freedom)."""
    probs = torch.softmax(torch.from_numpy(row).double() / t, dim=0)
    stat, bound, _ = cs.chi_square(torch, torch.tensor(np.asarray(tokens)), probs)
    return stat, bound


def _port_draws(row, temps, seed=1):
    gen = torch.Generator().manual_seed(seed)
    logits = torch.from_numpy(row)[None].expand(DRAWS, -1)
    return sample_tokens(logits, temps, gen).numpy()


def test_port_sampler_matches_softmax_over_t():
    row = _row()
    stat, bound = chi_square(_port_draws(row, [T] * DRAWS), row)
    assert stat < bound, (stat, bound)
    # the control: the same draws with the division by T skipped
    bad, _ = chi_square(_port_draws(row, [1.0] * DRAWS), row)
    assert bad > bound, (bad, bound)


def test_jax_categorical_matches_softmax_over_t():
    """The reference's own draw (``ServeEngine._sample``: split key,
    ``categorical(sub, logits / T)``) holds the same bound, and fails it
    without the division."""
    row = _row()
    keys = jax.random.split(jax.random.key(1), DRAWS)
    lj = jnp.asarray(row)

    def draws(t):
        return np.asarray(jax.vmap(lambda k: jax.random.categorical(k, lj / t))(keys))

    stat, bound = chi_square(draws(T), row)
    assert stat < bound, (stat, bound)
    bad, _ = chi_square(draws(1.0), row)
    assert bad > bound, (bad, bound)


def test_greedy_rows_are_the_argmax_and_draw_nothing():
    """T = 0 rows are torch.argmax bit for bit beside sampled rows (first
    index on ties); a batch of greedy rows leaves the generator as it was."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(6, 300)).astype(np.float32))
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1          # a tie
    temps = [0.0, 0.8, 0.0, 1.3, 0.0, 0.5]
    gen = torch.Generator().manual_seed(0)
    got = sample_tokens(logits, temps, gen)
    want = torch.argmax(logits, dim=-1)
    for i, t in enumerate(temps):
        if t == 0:
            assert int(got[i]) == int(want[i])
    assert int(got[2]) == 7
    state = gen.get_state()
    assert torch.equal(sample_tokens(logits, [0.0] * 6, gen), want)
    assert torch.equal(gen.get_state(), state)
    bf = logits.to(torch.bfloat16)
    assert torch.equal(sample_tokens(bf, [0.0] * 6, gen), torch.argmax(bf, dim=-1))


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("granite-3-2b"))
    jp = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    return (t_reduced(t_get_config("granite-3-2b")), cfg, jp,
            params_from_jax(jax.tree.map(np.asarray, jp)))


def _mixed(vocab):
    """Six requests, greedy and T = 0.8 interleaved, prompts of 5-20
    tokens."""
    rng = np.random.default_rng(5)
    return [(rng.integers(0, vocab, int(rng.integers(5, 21))).tolist(),
             dict(max_new_tokens=12, temperature=0.8 if i % 2 else 0.0))
            for i in range(6)]


def _run(eng, reqs):
    rids = [eng.submit(p, **kw) for p, kw in reqs]
    done = {r.rid: r.out_tokens for r in eng.run_until_drained(max_ticks=400)}
    return [done[r] for r in rids]


def test_mixed_stream_greedy_requests_match_jax(model):
    """Greedy requests beside T = 0.8 ones are token-identical to JAX's
    engine's greedy requests on the same stream; the sampled requests give
    in-vocabulary tokens of the right count."""
    tcfg, cfg, jp, tp = model
    reqs = _mixed(tcfg.vocab_size)
    want = _run(JEngine(cfg, jp, **KW, seed=3), reqs)
    got = _run(TEngine(tcfg, tp, **KW, seed=3), reqs)
    for (_, kw), g, w in zip(reqs, got, want):
        assert len(g) == len(w) == 12
        assert all(0 <= t < tcfg.vocab_size for t in g)
        if kw["temperature"] == 0:
            assert g == w


def test_one_seed_gives_one_stream(model):
    """Two engines from one seed give equal tokens on the mixed stream,
    also through the dense-slab path; another seed moves the sampled
    requests and not the greedy ones."""
    tcfg, _, _, tp = model
    reqs = _mixed(tcfg.vocab_size)
    a = _run(TEngine(tcfg, tp, **KW, seed=11), reqs)
    assert _run(TEngine(tcfg, tp, **KW, seed=11), reqs) == a
    slab = TEngine(tcfg, tp, **KW, seed=11, paged=False)
    assert _run(slab, reqs) == _run(TEngine(tcfg, tp, **KW, seed=11, paged=False), reqs)
    b = _run(TEngine(tcfg, tp, **KW, seed=12), reqs)
    greedy = [kw["temperature"] == 0 for _, kw in reqs]
    assert [x for x, g in zip(a, greedy) if g] == [x for x, g in zip(b, greedy) if g]
    assert [x for x, g in zip(a, greedy) if not g] != \
        [x for x, g in zip(b, greedy) if not g]


def test_all_greedy_stream_draws_nothing(model):
    """A stream of greedy requests never touches the generator: its state
    after the drain is the seed's, and the tokens equal JAX's engine's."""
    tcfg, cfg, jp, tp = model
    reqs = [(p, dict(kw, temperature=0.0)) for p, kw in _mixed(tcfg.vocab_size)]
    eng = TEngine(tcfg, tp, **KW, seed=4)
    state = eng.generator.get_state()
    got = _run(eng, reqs)
    assert torch.equal(eng.generator.get_state(), state)
    assert got == _run(JEngine(cfg, jp, **KW, seed=4), reqs)
