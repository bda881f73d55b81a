"""Port parity, dense-slab serving: the plain dense flash-decoding versions
against the JAX oracle and the Pallas kernel (``interpret=True``) within
1e-5; reduced stablelm-1.6b and granite-3-2b ``prefill`` + ``decode_step``
against the JAX model within 1e-4 (logits and slabs); and
``ServeEngine(paged=False)`` token-identical to the JAX dense-slab engine
with equal statistics, and to the port's own paged engine (fp32, parameters
carried over from JAX)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# the prompts and knobs of tests/test_serve_paged.py
PAGED_PROMPTS = [[3, 1, 4], [1, 5, 9, 2, 6], [5, 3], list(range(2, 52)),
                 [7, 7, 7, 7], [2, 71, 8], [42], [9, 9, 2]]
ENGINE_KW = dict(max_seq=64, slots=3, prefill_buckets=(8, 16, 32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **{**TOL, **kw})


# ---------------------------------------------------------------------------
# the plain dense flash-decoding versions
# ---------------------------------------------------------------------------

DECODE_CASES = [  # (H, KvH, Sk, lengths)
    (4, 4, 40, [1, 17, 40]),          # MHA (G = 1), ragged
    (8, 2, 40, [5, 33, 40]),          # GQA (G = 4), ragged
    (8, 2, 40, None),                 # the whole slab
]


def _slab(rng, b, h, kvh, sk, d=16):
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("h,kvh,sk,lens", DECODE_CASES)
def test_decode_attention_matches_jax(rng, h, kvh, sk, lens):
    q, k, v = _slab(rng, 3, h, kvh, sk)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else _t(np.array(lens, np.int32))
    got = ops.decode_attention(_t(q), _t(k), _t(v), lengths=tl)
    _close(got, jref.decode_attention(q, k, v, lengths=jl))
    _close(got, jda.decode_attention(q, k, v, lengths=jl, block_s=16,
                                     interpret=True))
    parts = ops.decode_attention_partial(_t(q), _t(k), _t(v), lengths=tl)
    for a, b_ in zip(parts, jref.decode_attention_partial(q, k, v, lengths=jl)):
        _close(a, b_)
    for a, b_ in zip(parts, jda.decode_attention_partial(
            q, k, v, lengths=jl, block_s=16, interpret=True)):
        _close(a, b_)


@pytest.mark.parametrize("kvh", [4, 1])
def test_decode_partial_kv_offset_and_empty_shard(rng, kvh):
    """A slab cut into two shards at position 24; the second shard's
    partials at ``kv_offset=24``.  Row 2's length (10) reaches no key of
    that shard: its partial is compared after ``combine_partials`` with the
    first shard's, where the port's kernel (identity ``(0, -1e30, 0)``), the
    JAX oracle and the Pallas kernel (masked keys at p = 1) all give zero
    weight.  The other rows are compared directly."""
    q, k, v = _slab(rng, 3, 4, kvh, 40)
    lens = np.array([30, 40, 10], np.int32)
    cut = 24
    shards = [(k[:, :cut], v[:, :cut], 0), (k[:, cut:], v[:, cut:], cut)]
    impls = {
        "port": lambda kk, vv, off: ops.decode_attention_partial(
            _t(q), _t(kk), _t(vv), lengths=_t(lens), kv_offset=off),
        "jax ref": lambda kk, vv, off: jref.decode_attention_partial(
            q, kk, vv, lengths=jnp.asarray(lens), kv_offset=off),
        "pallas": lambda kk, vv, off: jda.decode_attention_partial(
            q, kk, vv, lengths=jnp.asarray(lens), kv_offset=off, block_s=8,
            interpret=True),
    }
    combined, second = {}, {}
    for name, fn in impls.items():
        p1, p2 = (tuple(np.asarray(x) for x in fn(*s)) for s in shards)
        second[name] = p2
        combined[name] = tuple(np.asarray(x) for x in jref.combine_partials(
            tuple(map(jnp.asarray, p1)), tuple(map(jnp.asarray, p2))))
    for name in ("jax ref", "pallas"):
        for a, b_ in zip(combined["port"], combined[name]):
            _close(a, b_, err_msg=name)
        for a, b_ in zip(second["port"], second[name]):
            _close(a[:2], b_[:2], err_msg=name)       # rows that reach the shard
    # the combined partials are the whole slab's attention
    whole = jref.decode_attention(q, k, v, lengths=jnp.asarray(lens))
    acc, _, l = combined["port"]
    _close(acc / l[..., None], whole)


def test_dense_wrappers_check_before_any_launch(rng):
    """The dense decode and flash-``lengths`` wrappers refuse a CPU tensor
    and bad shapes before any build or launch (ops sends CPU tensors to the
    plain version instead)."""
    q, k, v = _slab(rng, 2, 4, 2, 20)
    lens = _t(np.array([3, 20], np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention(_t(q), _t(k), _t(v), lens)
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention_partial(_t(q), _t(k), _t(v), lens, kv_offset=4)
    with pytest.raises(ValueError, match="int32"):
        tda.decode_attention(_t(q), _t(k), _t(v), lens.long())
    with pytest.raises(ValueError, match="head dim"):
        tda.decode_attention(_t(q[..., :8]), _t(k[..., :8]), _t(v[..., :8]))
    qf = _t(rng.normal(size=(2, 20, 4, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(qf, _t(k), _t(v), lengths=lens)
    with pytest.raises(ValueError, match="lengths"):
        tfa.flash_attention_fwd(qf, _t(k), _t(v), lengths=lens[:1])
    assert tda.dense_launches == 0 and tfa.lengths_launches == 0


# ---------------------------------------------------------------------------
# the model: prefill and decode_step over the slabs
# ---------------------------------------------------------------------------

def _pair(arch):
    cfg = reduced(get_config(arch))
    jparams = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    return cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-3-2b"])
def test_prefill_and_decode_step_match_jax(arch):
    """Two right-padded prompts (lengths 12 and 7) prefilled into 24-row
    slabs, then two batched decode steps: logits and every slab row."""
    cfg, jparams, tparams = _pair(arch)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    jstate = JM.init_decode_state(cfg, 2, 24, dtype=jnp.float32)
    tstate = TM.init_decode_state(cfg, 2, 24, dtype=torch.float32, device="cpu")
    jl, jstate = JM.prefill(cfg, jparams, jstate, tokens=jnp.asarray(tok),
                            lengths=jnp.asarray(lens))
    tl, tstate = TM.prefill(cfg, tparams, tstate, tokens=_t(tok),
                            lengths=_t(lens))
    _close(tl, jl, **MODEL_TOL)
    for step in range(2):
        nxt = rng.integers(0, cfg.vocab_size, size=(2,)).astype(np.int32)
        cur = lens + step
        jl, jstate = JM.decode_step(cfg, jparams, jstate, jnp.asarray(nxt),
                                    jnp.asarray(cur))
        tl, tstate = TM.decode_step(cfg, tparams, tstate, _t(nxt), _t(cur))
        _close(tl, jl, **MODEL_TOL, err_msg=f"decode step {step}")
    for key in ("k", "v"):
        _close(tstate["attn"][key], jstate["attn"][key], **MODEL_TOL)


def test_prefill_and_decode_take_embeds():
    """``embeds=`` in place of tokens gives the same logits, as in JAX."""
    cfg, _, tparams = _pair("stablelm-1.6b")
    tok = _t(np.array([[5, 9, 2, 77, 3]], np.int32))
    emb = tparams["embed"]["table"][tok.long()]
    outs = []
    for kw in (dict(tokens=tok), dict(embeds=emb)):
        state = TM.init_decode_state(cfg, 1, 8, dtype=torch.float32, device="cpu")
        lp, state = TM.prefill(cfg, tparams, state, **kw)
        nxt = tok[:, 0]
        ld, _ = TM.decode_step(cfg, tparams, state, nxt, _t(np.array([5], np.int32)),
                               **({"embeds": emb[:, 0]} if "embeds" in kw else {}))
        outs.append((lp, ld))
    for a, b_ in zip(*outs):
        _close(a, b_, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the engine's dense-slab baseline
# ---------------------------------------------------------------------------

def _drain(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: tuple(r.out_tokens) for r in eng.run_until_drained()}


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-3-2b"])
def test_dense_engine_matches_jax_and_paged(arch):
    cfg, jparams, tparams = _pair(arch)
    jeng = JEngine(cfg, jparams, paged=False, **ENGINE_KW)
    teng = TEngine(cfg, tparams, paged=False, **ENGINE_KW)
    jout = _drain(jeng, PAGED_PROMPTS, 5)
    tout = _drain(teng, PAGED_PROMPTS, 5)
    assert tout == jout
    shared = set(teng.stats) & set(jeng.stats)
    assert {"prefill_tokens", "decode_tokens", "padded_tokens",
            "prefill_dispatches", "ticks", "occupancy_sum"} <= shared
    for key in sorted(shared):
        assert teng.stats[key] == jeng.stats[key], key
    assert not teng.prefix_caching and teng.alloc is None
    assert teng.stats["prefill_dispatches"] == len(PAGED_PROMPTS)
    paged = TEngine(cfg, tparams, block_size=8, **ENGINE_KW)
    assert _drain(paged, PAGED_PROMPTS, 5) == tout


def test_dense_engine_refusals():
    cfg, _, tparams = _pair("granite-3-2b")
    with pytest.raises(ValueError, match="prefix_caching"):
        TEngine(cfg, tparams, paged=False, prefix_caching=True, **ENGINE_KW)
    eng = TEngine(cfg, tparams, paged=False, prefix_caching=False, **ENGINE_KW)
    assert not eng.prefix_caching and eng.kv_cache_bytes() == \
        2 * cfg.n_layers * 3 * 64 * cfg.n_kv_heads * cfg.hd * 4


@pytest.mark.parametrize("arch", ["zamba2-7b-ssm", "zamba2-7b", "olmoe-1b-7b"],
                         ids=["zamba2-7b-ssm-recurrent-serving slice",
                              "zamba2-7b-recurrent-serving slice",
                              "olmoe-1b-7b-MoE slice"])
def test_dense_slab_refuses_other_families(arch):
    """The slab path serves every family: the engine stands up over
    zamba2-7b (its Mamba2 slot state beside [G, slots, max_seq] slabs), its
    Mamba2 layers as family="ssm" (``zamba2-7b-ssm``: the slot state alone)
    and olmoe-1b-7b (the dense family's [L, slots, max_seq] slabs); a
    family the port does not know is refused by the engine and the model's
    slab entry points."""
    cfg = reduced(get_config(arch.removesuffix("-ssm")))
    if arch.endswith("-ssm"):
        cfg = cfg.replace(family="ssm")
    _, _, tparams = _pair("granite-3-2b")        # only the embedding is read
    eng = TEngine(cfg, tparams, paged=False, **ENGINE_KW)
    assert eng.dense_baseline and not eng.has_slot_state
    keys = {"conv", "ssm"} if cfg.family == "ssm" else \
        {"attn"} if cfg.family == "moe" else \
        {"conv_g", "ssm_g", "conv_t", "ssm_t", "attn"}
    assert set(eng.state) == keys
    unknown = cfg.replace(family="encoder")
    with pytest.raises(NotImplementedError, match="not ported"):
        TEngine(unknown, tparams, paged=False, **ENGINE_KW)
    for call in (lambda: TM.init_decode_state(unknown, 1, 8, device="cpu"),
                 lambda: TM.prefill(unknown, tparams, {}, tokens=_t([[1]])),
                 lambda: TM.decode_step(unknown, tparams, {}, _t([1]), _t([0]))):
        with pytest.raises(NotImplementedError, match="not ported"):
            call()
