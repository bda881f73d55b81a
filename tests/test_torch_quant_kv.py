"""Port parity, int8 paged KV: the plain int8 paged attention (decode and
prefill, outputs and partials) against the JAX oracle and the Pallas
kernels in ``interpret=True`` (f32, 1e-5); the quantizing scatters
bit-equal to the JAX package's on the same float rows (page 0, the null
sink, left out); ``ServeEngine(kv_dtype="int8")`` token-identical to the
JAX int8 engine at fp32 on reduced stablelm-1.6b and granite-3-2b, prefix
caching on and off; the engine's validation, digest seeds and page bytes as
in JAX; and the argument checks of the kernel wrappers' int8 variant."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import prefill_attention as jpf  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.runner import ModelRunner as JRunner  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.kernels import _paged, ops  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import prefill_attention as tpf  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.runner import ModelRunner as TRunner  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
STATS = ("prefill_tokens", "decode_tokens", "prefix_hits", "prefix_hit_tokens",
         "cow_copies", "pages_shared", "prefill_dispatches", "padded_tokens",
         "gather_page_volume", "kv_bytes_per_page")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **{**TOL, **kw})


def _quantize(pages):
    """Per-(kv head, page) symmetric int8 quantization of [KvH, NB, BS, d]
    (tests/test_quant_kv.py's helper): numpy int8 pages and f32 scales."""
    s = np.maximum(np.abs(pages).max(axis=(2, 3)) / 127.0, JL.KV_SCALE_EPS)
    q = np.clip(np.round(pages / s[..., None, None]), -127, 127)
    return q.astype(np.int8), s.astype(np.float32)


def _pool(rng, kvh, nb, bs, d):
    """int8 K and V pages with their scales, as numpy arrays."""
    k8, ks = _quantize(rng.normal(size=(kvh, nb, bs, d)).astype(np.float32))
    v8, vs = _quantize(rng.normal(size=(kvh, nb, bs, d)).astype(np.float32))
    return k8, ks, v8, vs


def _both(*arrays):
    """Each numpy array as (jax array, torch tensor)."""
    return [(jnp.asarray(a), _t(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the plain int8 paged attention against the JAX oracle and the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,kvh", [(6, 2), (4, 4), (8, 1)])
def test_quant_paged_decode_matches_jax(rng, h, kvh):
    """Decode over an int8 pool at each GQA shape (grouped, MHA, one kv
    head for all query heads): output and partials, with a retired slot."""
    b, nb, bs, d, mb = 3, 10, 8, 16, 4
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k8, ks, v8, vs = _pool(rng, kvh, nb, bs, d)
    bt = np.stack([rng.permutation(nb - 1)[:mb] + 1 for _ in range(b)])
    bt[2] = 0                                     # a retired slot: null page
    bt = bt.astype(np.int32)
    lens = np.array([1, mb * bs, 1], np.int32)
    lens[0] = rng.integers(1, mb * bs + 1)
    (jq, tq), (jk, tk), (jks, tks), (jv, tv), (jvs, tvs), (jbt, tbt), \
        (jl, tl) = _both(q, k8, ks, v8, vs, bt, lens)
    got = tref.paged_decode_attention(tq, tk, tv, tbt, lengths=tl,
                                      k_scales=tks, v_scales=tvs)
    _close(got, jref.paged_decode_attention(jq, jk, jv, jbt, lengths=jl,
                                            k_scales=jks, v_scales=jvs))
    _close(got, jda.paged_decode_attention(jq, jk, jv, jbt, lengths=jl,
                                           k_scales=jks, v_scales=jvs,
                                           interpret=True))
    # the dequantized float pool gives the same output
    deq = [a.astype(np.float32) * s[..., None, None] for a, s in ((k8, ks), (v8, vs))]
    _close(got, tref.paged_decode_attention(tq, _t(deq[0]), _t(deq[1]), tbt,
                                            lengths=tl))
    parts = tref.paged_decode_attention_partial(tq, tk, tv, tbt, lengths=tl,
                                                k_scales=tks, v_scales=tvs)
    wparts = jda.paged_decode_attention_partial(jq, jk, jv, jbt, lengths=jl,
                                                k_scales=jks, v_scales=jvs,
                                                interpret=True)
    for a, w in zip(parts, wparts):
        _close(a, w)
    # on the CPU the ops entry point routes to the same plain version
    _close(ops.paged_decode_attention(tq, tk, tv, tbt, lengths=tl,
                                      k_scales=tks, v_scales=tvs), got)


@pytest.mark.parametrize("h,kvh,c,cases", [
    (6, 2, 12, [(0, 12), (5, 12), (17, 3)]),      # q tiles that split C
    (4, 4, 10, [(7, 10)]),                        # MHA
    (8, 1, 10, [(7, 10), (0, 1)]),                # one kv head
])
def test_quant_paged_prefill_matches_jax(rng, h, kvh, c, cases):
    """Prefill over an int8 pool: the plain version (output and partials)
    against the JAX oracle and the Pallas kernel at q tiles that do and do
    not divide the chunk (tests/test_quant_kv.py's corners)."""
    nb, bs, d = 14, 8, 16
    q = rng.normal(size=(1, c, h, d)).astype(np.float32)
    k8, ks, v8, vs = _pool(rng, kvh, nb, bs, d)
    bt = (rng.permutation(nb - 1)[:5] + 1).astype(np.int32)
    (jq, tq), (jk, tk), (jks, tks), (jv, tv), (jvs, tvs), (jbt, tbt) = \
        _both(q, k8, ks, v8, vs, bt)
    quant_j = dict(k_scales=jks, v_scales=jvs)
    quant_t = dict(k_scales=tks, v_scales=tvs)
    for qoff, ln in cases:
        got = tref.paged_prefill_attention(tq, tk, tv, tbt, q_offset=qoff,
                                           length=ln, **quant_t)
        jkw = dict(q_offset=jnp.int32(qoff), length=jnp.int32(ln), **quant_j)
        _close(got[0, :ln], jref.paged_prefill_attention(
            jq, jk, jv, jbt, **jkw)[0, :ln])
        for tile in (None, 4, 5, 8, c):
            _close(got[0, :ln], jpf.paged_prefill_attention(
                jq, jk, jv, jbt, q_tile=tile, interpret=True, **jkw)[0, :ln],
                err_msg=f"q_tile={tile} q_offset={qoff} length={ln}")
        parts = tref.paged_prefill_attention_partial(
            tq, tk, tv, tbt, q_offset=qoff, length=ln, **quant_t)
        wparts = jpf.paged_prefill_attention_partial(
            jq, jk, jv, jbt, q_tile=4, interpret=True, **jkw)
        for a, w in zip(parts, wparts):
            _close(a[0, :ln], w[0, :ln])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_prefill_cpu_route_matches_jax_ops(rng, dtype):
    """``ops.paged_prefill_attention`` on the CPU gathers the int8 pages
    dequantized (f32) while q is in the engine dtype, and the plain flash
    attention promotes them, as JAX's non-kernel route does."""
    kvh, h, nb, bs, d, c = 2, 6, 9, 8, 16, 11
    q = rng.normal(size=(1, c, h, d)).astype(np.float32)
    k8, ks, v8, vs = _pool(rng, kvh, nb, bs, d)
    bt = np.array([3, 6, 1, 8], np.int32)
    kw = dict(q_offset=9, length=c)
    got = ops.paged_prefill_attention(_t(q).to(getattr(torch, dtype)), _t(k8),
                                      _t(v8), _t(bt), k_scales=_t(ks),
                                      v_scales=_t(vs), **kw)
    assert got.dtype == getattr(torch, dtype)
    want = jops.paged_prefill_attention(
        jnp.asarray(q).astype(dtype), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(bt), k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        q_offset=jnp.int32(9), length=jnp.int32(c))
    _close(got.float(), np.asarray(want, np.float32),
           **({} if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)))


def test_quant_wrappers_check_scales(rng):
    """The kernel wrappers' int8 variant refuses bad scales before anything
    reaches a kernel: one of the two missing, a wrong shape, dtype or
    device, float pages with scales, and int8 pages without them."""
    kvh, nb, bs, d = 2, 6, 8, 16
    q = _t(rng.normal(size=(2, 4, d)).astype(np.float32))
    k8, ks, v8, vs = (_t(a) for a in _pool(rng, kvh, nb, bs, d))
    bt = torch.ones((2, 3), dtype=torch.int32)
    lens = torch.tensor([5, 9], dtype=torch.int32)
    bad = {"both": dict(k_scales=ks, v_scales=None),
           r"\[2, 6\] float32": dict(k_scales=ks[:, :5].contiguous(), v_scales=vs),
           "float32": dict(k_scales=ks.double(), v_scales=vs),
           "meta": dict(k_scales=ks, v_scales=torch.empty_like(vs, device="meta"))}
    for match, kw in bad.items():
        with pytest.raises(ValueError, match=match):
            tda.paged_decode_attention(q, k8, v8, bt, lens, **kw)
        with pytest.raises(ValueError, match=match):
            tpf.paged_prefill_attention(q[None], k8, v8, bt[0], q_offset=0,
                                        length=2, **kw)
    with pytest.raises(ValueError, match="int8 pool"):
        tda.paged_decode_attention(q, k8.float(), v8.float(), bt, lens, ks, vs)
    with pytest.raises(ValueError, match="needs its scales"):
        tda.paged_decode_attention(q, k8, v8, bt, lens)
    # good scales pass the checks; the CPU tensors then stop at the kernel,
    # and nothing was counted as a launch
    n = tda.q8_launches, tpf.q8_launches
    assert _paged.check_scales(q.dtype, k8, v8, ks, vs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tda.paged_decode_attention(q, k8, v8, bt, lens, ks, vs)
    assert (tda.q8_launches, tpf.q8_launches) == n


# ---------------------------------------------------------------------------
# the quantizing scatters, bit for bit against the JAX package's
# ---------------------------------------------------------------------------

def _int8_layer(rng, layers, kvh, nb, bs, hd):
    pages = rng.integers(-127, 128, (layers, kvh, nb, bs, hd)).astype(np.int8)
    scales = rng.uniform(1e-3, 5e-2, (layers, kvh, nb)).astype(np.float32)
    return pages, scales


def _assert_bit_equal(jp, js, tp, ts):
    """Every page but the null page 0 (its duplicate writes land in an
    order neither package defines) and its scales, bit for bit."""
    jp, js = np.asarray(jp), np.asarray(js)
    np.testing.assert_array_equal(tp.numpy()[:, :, 1:], jp[:, :, 1:])
    np.testing.assert_array_equal(ts.numpy()[:, :, 1:].view(np.int32),
                                  js[:, :, 1:].view(np.int32))


@pytest.mark.parametrize("case", ["page_start", "growth", "mixed"])
def test_decode_scatter_quant_bit_equal_to_jax(rng, case):
    """One row per sequence into its page: every page starting (offset 0,
    the old scale dropped), every page growing (offset > 0, rows scaled by
    6-10 so that the scale grows and earlier rows are requantized), and a
    mix with retired slots on the null page.  64 sequences x 2 kv heads:
    enough scales that ``amax / 127`` as a true division would differ from
    the reference's reciprocal product in several."""
    layers, kvh, nb, bs, hd, b = 2, 2, 70, 8, 16, 64
    pages, scales = _int8_layer(rng, layers, kvh, nb, bs, hd)
    phys = (rng.permutation(nb - 1)[:b] + 1).astype(np.int32)
    off = rng.integers(1, bs, b).astype(np.int32)
    row = rng.normal(size=(b, kvh, hd)).astype(np.float32)
    if case == "page_start":
        off[:] = 0
    elif case == "growth":
        row *= rng.uniform(6.0, 10.0, (b, 1, 1)).astype(np.float32)
    else:
        off[::3] = 0
        phys[::5] = 0                             # retired slots
    jfn = jax.jit(JL._decode_scatter_quant, static_argnums=2)
    jp, js = jfn(jnp.asarray(pages), jnp.asarray(scales), 1,
                 jnp.asarray(phys), jnp.asarray(off), jnp.asarray(row))
    tp, ts = _t(pages), _t(scales)
    TL._decode_scatter_quant(tp[1], ts[1], (_t(phys).long(), _t(off).long()),
                             _t(row))
    _assert_bit_equal(jp, js, tp, ts)
    if case == "growth":                          # the scales really grew
        assert (ts[1, :, phys] > _t(scales)[1, :, phys]).float().mean() > 0.9


@pytest.mark.parametrize("q_offset,length,mb", [
    (0, 20, 5),        # page start, a chunk that ends mid-page
    (13, 20, 5),       # a chunk that starts and ends mid-page
    (27, 5, 5),        # a short tail chunk: rows past the live end zeroed
    (24, 16, 5),       # the window runs past the table's end (null entries)
    (35, 3, 5),        # window start near the end of the table
])
def test_prefill_scatter_quant_bit_equal_to_jax(rng, q_offset, length, mb):
    """A chunk of C = 20 rows (``length`` valid) through the window of
    ceil(C / BS) + 1 pages: dequantize, write, zero past the live end,
    requantize at fresh scales; the same block-table slice as the JAX
    engine passes."""
    layers, kvh, nb, bs, hd, c = 2, 2, 12, 8, 16, 20
    pages, scales = _int8_layer(rng, layers, kvh, nb, bs, hd)
    bt = (rng.permutation(nb - 1)[:mb] + 1).astype(np.int32)
    rows = (rng.normal(size=(c, kvh, hd)) * 3).astype(np.float32)
    jfn = jax.jit(JL._prefill_scatter_quant, static_argnums=2)
    jp, js = jfn(jnp.asarray(pages), jnp.asarray(scales), 0, jnp.asarray(bt),
                 jnp.int32(q_offset), jnp.int32(length), jnp.asarray(rows))
    tp, ts = _t(pages), _t(scales)
    TL._prefill_scatter_quant(tp[0], ts[0], _t(bt), q_offset, length, _t(rows))
    _assert_bit_equal(jp, js, tp, ts)
    # the rows past the live end of the last touched page are zero
    end = q_offset + length
    if end % bs and end // bs < mb:
        assert not tp[0, :, bt[end // bs], end % bs:].any()


def test_paged_kv_cache_init_int8():
    cfg = reduced(get_config("stablelm-1.6b"))
    st = TL.paged_kv_cache_init(cfg, 5, 8, torch.float32, n_slots=2,
                                device="cpu", kv_dtype="int8")
    want = JL.paged_kv_cache_init(cfg, 5, 8, jnp.float32, n_slots=2,
                                  kv_dtype="int8")
    assert sorted(st) == sorted(want)
    for key, a in want.items():
        assert tuple(st[key].shape) == a.shape
        assert str(st[key].dtype).removeprefix("torch.") == str(a.dtype)
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(a))
    with pytest.raises(ValueError, match="kv_dtype"):
        TL.paged_kv_cache_init(cfg, 5, 8, device="cpu", kv_dtype="int4")


# ---------------------------------------------------------------------------
# the int8 engine against the JAX int8 engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["stablelm-1.6b", "granite-3-2b"])
def arch(request):
    cfg = reduced(get_config(request.param))
    jparams = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    return cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _drain(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: tuple(r.out_tokens) for r in eng.run_until_drained()}


def _engines_match(arch, prompts, max_new, **kw):
    cfg, jparams, tparams = arch
    mk = dict(max_seq=48, slots=2, block_size=8, kv_dtype="int8", **kw)
    jeng, teng = JEngine(cfg, jparams, **mk), TEngine(cfg, tparams, **mk)
    jout, tout = _drain(jeng, prompts, max_new), _drain(teng, prompts, max_new)
    assert tout == jout
    for k in STATS:
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.state["attn"]["k_pages"].dtype == torch.int8
    assert teng.kv_cache_bytes() == jeng.kv_cache_bytes()
    return tout, teng


@pytest.mark.parametrize("cache", [True, False])
def test_int8_engine_matches_jax(arch, cache):
    """Mixed prompt lengths through buckets of 12 and 20 tokens over
    8-token pages under a 22-token budget: prefill chunks that start and
    end mid-page, slot reuse, and decode rows that start pages and grow
    their scales."""
    rng = np.random.default_rng(0)
    cfg = arch[0]
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in (12, 30, 5, 21, 17)]
    out, eng = _engines_match(arch, prompts, 6, prefill_buckets=(12, 20),
                              max_tokens_per_tick=22, prefix_caching=cache)
    assert eng.stats["prefill_dispatches"] > len(prompts)   # chunked
    assert all(len(t) == 6 for t in out.values())


def test_int8_engine_prefix_cow_matches_jax(arch):
    """tests/test_quant_kv.py's prompt: 16 tokens, two full pages, whose
    match is capped at 15 (mid-page), so the trailing shared page is split
    copy-on-write with its scales; caching on and off give the same tokens,
    each equal to the JAX engine's."""
    prompts = [list(range(1, 17))] * 3
    on, eng = _engines_match(arch, prompts, 5, prefill_buckets=(32,),
                             prefix_caching=True)
    off, _ = _engines_match(arch, prompts, 5, prefill_buckets=(32,),
                            prefix_caching=False)
    assert on == off
    assert eng.stats["cow_copies"] >= 1 and eng.stats["prefix_hits"] >= 1


def test_int8_copy_kv_page_copies_scales():
    cfg = reduced(get_config("stablelm-1.6b"))
    from repro_torch.models import model as TM
    st = TM.init_serve_state(cfg, 1, 4, 8, dtype=torch.float32, device="cpu",
                             kv_dtype="int8")
    for t in st["attn"].values():
        t[:, :, 2] = torch.arange(t[:, :, 2].numel()).reshape(
            t[:, :, 2].shape).to(t.dtype)
    TM.copy_kv_page(st, 2, 3)
    for key, t in st["attn"].items():
        assert torch.equal(t[:, :, 3], t[:, :, 2]), key


def test_engine_kv_dtype_validation_digests_and_page_bytes():
    """As in JAX: an unknown kv_dtype and an int8 pool without pages
    raise; the digest seed folds in kv_dtype; a page costs 1-byte values
    plus a scale per (layer, kv head) for K and V."""
    cfg = reduced(get_config("stablelm-1.6b"))
    jparams = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    for eng_cls, params in ((JEngine, jparams), (TEngine, tparams)):
        with pytest.raises(ValueError, match="kv_dtype"):
            eng_cls(cfg, params, max_seq=32, slots=2, kv_dtype="int4")
        with pytest.raises(ValueError, match="paged"):
            eng_cls(cfg, params, paged=False, max_seq=32, slots=2,
                    kv_dtype="int8")
    for kv in ("fp16", "int8"):
        jeng = JEngine(cfg, jparams, max_seq=32, slots=2, kv_dtype=kv)
        teng = TEngine(cfg, tparams, max_seq=32, slots=2, kv_dtype=kv)
        assert teng._digest_seed == jeng._digest_seed
        assert teng.stats["kv_bytes_per_page"] == jeng.stats["kv_bytes_per_page"]
        for bs, itemsize in ((8, 4), (16, 2)):
            assert (TRunner(cfg, 1, 32, kv_dtype=kv).page_kv_bytes(bs, itemsize)
                    == JRunner(cfg, 1, 32, kv_dtype=kv).page_kv_bytes(bs, itemsize))
    assert TEngine(cfg, tparams, max_seq=32, slots=2)._digest_seed == \
        TEngine(cfg, tparams, max_seq=32, slots=2, kv_dtype="fp16")._digest_seed
    with pytest.raises(ValueError, match="kv_dtype"):
        TRunner(cfg, 1, 32, kv_dtype="int4")
