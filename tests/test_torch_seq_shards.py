"""Port parity, sequence-sharded serving: the port's BlockAllocator(num_shards)
against the JAX package's on one operation sequence; the plain skip_null and
kv_offset partials against the JAX oracle and the Pallas kernels in
``interpret=True`` (f32, 1e-5), an all-foreign row included; the NoC tree
combine (S - 1 combines) bit-equal to the full butterfly, and its cost model
equal to JAX's; ``ServeEngine(seq_shards=S)`` at fp32 on reduced granite-3-2b
and stablelm-1.6b token-identical to the port and the JAX engine at one
shard, and, in one subprocess, to the JAX engine at four shards in tokens,
block tables and stats; an int8 pool at two shards; a shard that holds no
page of a sequence; the bad configurations; ``launch/serve.py
--seq-shards``.

Partials are compared as the kernels' contract allows: ``acc`` and ``l`` on
rows that see a key (``m > -1e29``), ``m`` on every row, and the combined,
normalized output on every row.  A row that sees no key comes out ``(0,
-1e30, 0)`` from the Pallas kernel and ``(sum of v, -1e30, count)`` from the
oracles (the port's plain version follows the oracle); both weigh nothing in
a combine beside a row that sees a key."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import run_subprocess  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.core import noc as jnoc  # noqa: E402
from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import prefill_attention as jpf  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.engine import BlockAllocator as JAlloc  # noqa: E402
from repro_torch.core import noc as tnoc  # noqa: E402
from repro_torch.kernels import _paged, ops  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.engine import BlockAllocator as TAlloc  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LIVE = -1e29          # m above this: the row saw a key
STATS = ("prefill_tokens", "decode_tokens", "prefix_hits", "prefix_hit_tokens",
         "cow_copies", "pages_shared", "prefill_dispatches", "padded_tokens",
         "gather_page_volume", "noc_combines", "noc_hops", "noc_bytes")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **{**TOL, **kw})


def _close_parts(got, want, err_msg=""):
    """(acc, m, l) as the contract allows: m everywhere, acc and l where the
    row saw a key (by ``want``'s m)."""
    acc, m, l = (np.asarray(a) for a in got)
    wacc, wm, wl = (np.asarray(a) for a in want)
    _close(m, wm, err_msg=err_msg)
    live = wm > LIVE
    _close(acc[live], wacc[live], err_msg=err_msg)
    _close(l[live], wl[live], err_msg=err_msg)
    return live


# ---------------------------------------------------------------------------
# the allocator against the JAX package's
# ---------------------------------------------------------------------------

def _alloc_trace(cls, num_shards):
    """One operation sequence through an allocator class: grants across
    shards, shared prefix pages, parking, fill-local under pressure, LRU
    eviction; returns every observable after each operation."""
    a = cls(num_blocks=16, block_size=4, slots=3, max_blocks_per_slot=6,
            num_shards=num_shards)
    seen = []

    def snap():
        seen.append(dict(table=a.table.tolist(), used=a.used.tolist(),
                         free=a.free_blocks, cached=a.cached_blocks,
                         usable=a.usable_blocks,
                         owners=[a.owner(int(p)) for p in a.table.flat],
                         local=a.shard_local(a.table).tolist(),
                         counters=(a.pages_allocated, a.pages_freed,
                                   a.pages_shared, a.pages_evicted)))

    assert a.ensure(0, 17)                       # 5 pages, round-robin
    snap()
    for i in range(3):
        a.register(int(a.table[0, i]), bytes([i]) * 16)
    assert a.ensure(1, 6)
    a.share(2, a.lookup(bytes([0]) * 16))
    a.share(2, a.lookup(bytes([1]) * 16))
    snap()
    a.release(0)                                 # registered pages park
    snap()
    assert a.ensure(2, 24) and a.ensure(1, 20)   # pressure: fill-local, evict
    snap()
    assert not a.ensure(0, 25)                   # over the slot's table
    a.release(1)
    a.release(2)
    snap()
    return seen


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_allocator_matches_jax(num_shards):
    """Tables, owners, shard-local tables, free and cached counts and the
    counters after each operation, for one, two and four shards."""
    assert _alloc_trace(TAlloc, num_shards) == _alloc_trace(JAlloc, num_shards)


def test_allocator_errors_and_shard_local_match_jax():
    """The indivisible pool and the too-small shard raise as in JAX; a
    bucketed prefix slice of a table maps through the pool's nb_local, not
    the slice's length."""
    for kw in (dict(num_blocks=10, num_shards=4), dict(num_blocks=4, num_shards=4),
               dict(num_blocks=1, num_shards=1)):
        msgs = []
        for cls in (JAlloc, TAlloc):
            with pytest.raises(ValueError) as e:
                cls(block_size=4, slots=1, max_blocks_per_slot=2, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    rng = np.random.default_rng(0)
    ja, ta = (cls(num_blocks=40, block_size=8, slots=2, max_blocks_per_slot=16,
                  num_shards=4) for cls in (JAlloc, TAlloc))
    for a in (ja, ta):
        assert a.ensure(0, 70)
    bt = np.zeros((4,), np.int32)                # a 4-page bucket
    bt[:4] = ta.table[0, :4]
    np.testing.assert_array_equal(ta.shard_local(bt), ja.shard_local(bt))
    assert ta.shard_local(bt).max() < ta.nb_local
    t = rng.integers(0, 40, (3, 5))
    np.testing.assert_array_equal(ta.shard_local(t), ja.shard_local(t))


# ---------------------------------------------------------------------------
# the plain skip_null / kv_offset partials against the oracle and Pallas
# ---------------------------------------------------------------------------

def _shard_setup(rng, kvh, nb, bs, d, b, mb, n_shards):
    """A pool, global tables placed round-robin by the allocator, and each
    shard's local tables and view of the pool, as numpy arrays."""
    kp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    vp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    a = TAlloc(nb, bs, b, mb, num_shards=n_shards)
    for s in range(b):
        assert a.ensure(s, mb * bs)
    return kp, vp, a, a.table.copy(), a.shard_local(a.table)


@pytest.mark.parametrize("h,kvh,dtype", [(6, 2, "float32"), (8, 1, "float32"),
                                         (4, 4, "int8")])
def test_skip_null_decode_partial_matches_jax(rng, h, kvh, dtype):
    """Each of 4 shards' skip_null partials over its view of the pool and
    its local table: the plain version against the oracle and the Pallas
    kernel, a sequence no shard-2 page reaches (all-foreign there), and the
    tree combine of the shards against the unsharded output; float and int8
    pools."""
    S, b, nb, bs, d, mb = 4, 3, 4 + 3 * 8, 8, 16, 8
    kp, vp, alloc, table, local = _shard_setup(rng, kvh, nb, bs, d, b, mb, S)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    lens = np.array([mb * bs, 13, 2], np.int32)   # seq 2 lives on page 0 only
    quant = {}
    if dtype == "int8":
        ks = np.maximum(np.abs(kp).max(axis=(2, 3)) / 127.0, 1e-8).astype(np.float32)
        vs = np.maximum(np.abs(vp).max(axis=(2, 3)) / 127.0, 1e-8).astype(np.float32)
        kp = np.clip(np.round(kp / ks[..., None, None]), -127, 127).astype(np.int8)
        vp = np.clip(np.round(vp / vs[..., None, None]), -127, 127).astype(np.int8)
        quant = dict(k_scales=ks, v_scales=vs)
    nbl = nb // S
    parts = []
    for s in range(S):
        sl = slice(s * nbl, (s + 1) * nbl)
        qs = {k: v[:, sl] for k, v in quant.items()}
        got = tref.paged_decode_attention_partial(
            _t(q), _t(kp)[:, sl], _t(vp)[:, sl], _t(local[s]), lengths=_t(lens),
            skip_null=True, **{k: _t(v) for k, v in qs.items()})
        jkw = dict(lengths=jnp.asarray(lens), skip_null=True,
                   **{k: jnp.asarray(v) for k, v in qs.items()})
        jargs = (jnp.asarray(q), jnp.asarray(kp[:, sl]), jnp.asarray(vp[:, sl]),
                 jnp.asarray(local[s]))
        oracle = jref.paged_decode_attention_partial(*jargs, **jkw)
        for a, w in zip(got, oracle):            # the oracle's bits, every row
            _close(a, w)
        live = _close_parts(got, jda.paged_decode_attention_partial(
            *jargs, interpret=True, **jkw), err_msg=f"shard {s}")
        if s == 2:                               # seq 2: one page, on shard 0
            assert not live[2].any()
        parts.append(got)
        # ops routes a CPU tensor to the same plain version
        via_ops = ops.paged_decode_attention_partial(
            _t(q), _t(kp)[:, sl], _t(vp)[:, sl], _t(local[s]), lengths=_t(lens),
            skip_null=True, **{k: _t(v) for k, v in qs.items()})
        for a, w in zip(via_ops, got):
            assert torch.equal(a, w)
    whole = tref.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(table), lengths=_t(lens),
        **{k: _t(v) for k, v in quant.items()})
    _close(tnoc.tree_softmax_combine(parts), whole)


def test_kv_offset_decode_partial_matches_jax(rng):
    """Keys at global positions ``kv_offset + j``: a table whose rows start
    at 40, with lengths below, inside and past its span, against the oracle
    and the Pallas kernel, skip_null off and on."""
    kvh, h, nb, bs, d, b, mb, off = 2, 4, 12, 8, 16, 4, 3, 40
    kp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    vp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    bt = np.stack([rng.permutation(nb - 1)[:mb] + 1 for _ in range(b)]).astype(np.int32)
    bt[1, 1] = 0                                  # a foreign page mid-table
    lens = np.array([30, 41, 53, 90], np.int32)   # none, 1, 13, all 24 keys
    for skip in (False, True):
        kw = dict(lengths=_t(lens), kv_offset=off, skip_null=skip)
        got = tref.paged_decode_attention_partial(_t(q), _t(kp), _t(vp), _t(bt), **kw)
        jkw = dict(lengths=jnp.asarray(lens), kv_offset=off, skip_null=skip)
        jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt))
        for a, w in zip(got, jref.paged_decode_attention_partial(*jargs, **jkw)):
            _close(a, w)
        live = _close_parts(got, jda.paged_decode_attention_partial(
            *jargs, interpret=True, **jkw), err_msg=f"skip_null={skip}")
        assert not live[0].any() and live[1:].all()


@pytest.mark.parametrize("h,kvh,c,q_offset,length", [
    (6, 2, 12, 0, 12),        # the first chunk
    (6, 2, 12, 21, 9),        # a mid-page chunk, padding rows
    (8, 1, 10, 37, 10),       # one kv head
])
def test_skip_null_prefill_partial_matches_jax(rng, h, kvh, c, q_offset, length):
    """A chunk's skip_null partials per shard (2 and 4 shards) against the
    oracle and the Pallas kernel at two q tiles, causal on global positions,
    and the combine against the unsharded prefill; the first chunk's rows
    whose keys all lie on other shards come out as the identity."""
    nb, bs, d, mb = 4 * 10, 8, 16, 8
    kp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    vp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    q = rng.normal(size=(1, c, h, d)).astype(np.float32)
    for S in (2, 4):
        alloc = TAlloc(nb, bs, 1, mb, num_shards=S)
        assert alloc.ensure(0, q_offset + length)
        n_live = -(-(q_offset + length) // bs)
        bt = np.zeros((max(1, 1 << (n_live - 1).bit_length()),), np.int32)
        bt[:n_live] = alloc.table[0, :n_live]
        local = alloc.shard_local(bt)
        nbl = nb // S
        parts = []
        for s in range(S):
            sl = slice(s * nbl, (s + 1) * nbl)
            kw = dict(q_offset=q_offset, length=length, skip_null=True)
            got = tref.paged_prefill_attention_partial(
                _t(q), _t(kp)[:, sl], _t(vp)[:, sl], _t(local[s]), **kw)
            jargs = (jnp.asarray(q), jnp.asarray(kp[:, sl]), jnp.asarray(vp[:, sl]),
                     jnp.asarray(local[s]))
            jkw = dict(q_offset=jnp.int32(q_offset), length=jnp.int32(length),
                       skip_null=True)
            for a, w in zip(got, jref.paged_prefill_attention_partial(*jargs, **jkw)):
                _close(a[0, :length], w[0, :length])
            for tile in (4,):
                live = _close_parts(
                    [a[0, :length] for a in got],
                    [w[0, :length] for w in jpf.paged_prefill_attention_partial(
                        *jargs, q_tile=tile, interpret=True, **jkw)],
                    err_msg=f"S={S} shard {s} q_tile={tile}")
            if q_offset == 0 and s > 0:          # rows before shard s's first key
                assert not live[:bs * s].any()
            parts.append(got)
        whole = tref.paged_prefill_attention(
            _t(q), _t(kp), _t(vp), _t(bt), q_offset=q_offset, length=length)
        _close(tnoc.tree_softmax_combine(parts)[0, :length], whole[0, :length])


def test_shard_views_and_strides():
    """A shard's view of the pool keeps the pool's kv-head strides, which
    the kernel reads it through; K and V must share them."""
    kp = torch.zeros(2, 12, 8, 16)
    ks = torch.ones(2, 12)
    views = TL.pool_shards(kp, 4)
    assert [v.shape[1] for v in views] == [3] * 4
    assert views[2].data_ptr() == kp[:, 6].data_ptr()
    assert TL.pool_shards(None, 4) == [None] * 4
    kv, sv = views[1], TL.pool_shards(ks, 4)[1]
    assert _paged.pool_strides(kv, kv, sv, sv) == (12 * 8 * 16, 12)
    assert _paged.pool_strides(kv, kv) == (12 * 8 * 16, 0)
    with pytest.raises(ValueError, match="strides"):
        _paged.pool_strides(kv, kv.contiguous())
    # the wrapper checks reach the device check; nothing is counted
    n = tda.shard_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tda.paged_decode_attention_partial(
            torch.zeros(1, 2, 16), kv, kv, torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), skip_null=True)
    with pytest.raises(ValueError, match="kv_offset"):
        tda.paged_decode_attention_partial(
            torch.zeros(1, 2, 16), kv, kv, torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), kv_offset=-1)
    assert tda.shard_launches == n


# ---------------------------------------------------------------------------
# the NoC tree combine and its cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_tree_combine_is_the_butterfly(rng, S):
    """S - 1 pairwise combines give every shard's butterfly result bit for
    bit (``combine_partials`` is commutative bit for bit), with empty
    shards among them; the output agrees with JAX's combine in the same
    order and with the centralized softmax."""
    b, h, d = 3, 4, 8
    parts = []
    for s in range(S):
        m = rng.normal(size=(b, h)).astype(np.float32) * 3
        if s % 3 == 1:
            m[0] = -1e30                            # shard s empty for row 0
        l = rng.uniform(0.5, 4.0, (b, h)).astype(np.float32) * (m > LIVE)
        acc = rng.normal(size=(b, h, d)).astype(np.float32) * l[..., None]
        parts.append((_t(acc), _t(m), _t(l)))
    fly = tnoc.butterfly_all_reduce(parts, tref.combine_partials)
    tree = tnoc.tree_combine(parts, tref.combine_partials)
    for r in fly:
        for a, w in zip(r, tree):
            assert torch.equal(a, w)
    out = tnoc.tree_softmax_combine(parts)
    jparts = [tuple(jnp.asarray(a.numpy()) for a in p) for p in parts]
    while len(jparts) > 1:                          # JAX's combine, same tree
        jparts = [jref.combine_partials(jparts[i], jparts[i + 1])
                  for i in range(0, len(jparts), 2)]
    jacc, _, jl = jparts[0]
    _close(out, np.asarray(jacc) / np.maximum(np.asarray(jl), 1e-30)[..., None],
           rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="power-of-two"):
        tnoc.tree_softmax_combine(parts[:3] if S > 2 else parts * 3)


def test_combine_cost_matches_jax():
    for args in ((8, 32, 64, 4), (512, 32, 64, 2), (3, 4, 16, 1), (1, 1, 1, 8)):
        assert tnoc.softmax_combine_cost(*args) == jnoc.softmax_combine_cost(*args)
    assert tnoc.softmax_combine_cost(8, 32, 64, 4, itemsize=2) == \
        jnoc.softmax_combine_cost(8, 32, 64, 4, itemsize=2)
    assert tnoc.E_HOP_PJ_PER_BIT == jnoc.E_HOP_PJ_PER_BIT
    with pytest.raises(ValueError, match="power of two"):
        tnoc.softmax_combine_cost(8, 32, 64, 3)


# ---------------------------------------------------------------------------
# the engine: against one shard, the JAX engine in-process and, once, in a
# subprocess at four shards
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_seq=64, slots=3, prefill_buckets=(8, 16, 32), block_size=8)


def _mixed(vocab):
    """tests/test_serve_sharded.py's parity workload: mixed lengths, a
    shared 20-token prefix (cache hits) and, resubmitted at the end, a
    48-token prompt whose match is capped mid-page (a copy-on-write, which
    crosses shards)."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(2, vocab, 20).tolist()
    return [[3, 1, 4], list(range(2, 50)), [42], [7, 7, 7, 7],
            prefix + [9], prefix + [11]]


def _drive(eng, prompts):
    """Submit, step to drained with a table snapshot after every tick, then
    resubmit the 48-token prompt; tokens by rid, snapshots, stats."""
    for p in prompts:
        eng.submit(p, max_new_tokens=5)
    toks, tables = {}, []

    def run():
        while eng.queued or any(r is not None for r in eng.active):
            for r in eng.step():
                toks[str(r.rid)] = list(r.out_tokens)
            tables.append(eng.alloc.table.tolist())
    run()
    eng.submit(prompts[1], max_new_tokens=5)
    run()
    return dict(toks=toks, tables=tables,
                stats={k: float(eng.stats[k]) for k in STATS + ("noc_energy_pj",)})


_JAX_SHARDED = """
import json, jax, numpy as np, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.models import model as M
from repro.serve import ServeEngine
out = {}
for arch in ("granite-3-2b", "stablelm-1.6b"):
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    eng = ServeEngine(cfg, params, paged=True, seq_shards=4, **ENGINE_KW)
    out[arch] = _drive(eng, _mixed(cfg.vocab_size))
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX engine at four shards on both archs, in one subprocess (its
    mesh needs four host devices, fixed at the backend's first start)."""
    import inspect
    code = "\n".join([f"ENGINE_KW = {ENGINE_KW!r}", f"STATS = {STATS!r}",
                      inspect.getsource(_mixed), inspect.getsource(_drive),
                      _JAX_SHARDED])
    line = [ln for ln in run_subprocess(code, devices=4).splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module", params=["granite-3-2b", "stablelm-1.6b"])
def arch(request):
    cfg = reduced(get_config(request.param))
    jparams = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    return (request.param, cfg, jparams,
            params_from_jax(jax.tree.map(np.asarray, jparams)))


def test_sharded_engine_matches_jax(arch, jax_sharded):
    """Four shards: tokens, the block tables after every tick and the
    stats (noc totals, prefix hits, the cross-shard copy-on-write) equal to
    the JAX engine's at four shards; two and four shards token-identical to
    the port and the JAX engine at one."""
    name, cfg, jparams, tparams = arch
    prompts = _mixed(cfg.vocab_size)
    got = _drive(TEngine(cfg, tparams, seq_shards=4, **ENGINE_KW), prompts)
    want = jax_sharded[name]
    assert got["toks"] == want["toks"]
    assert got["tables"] == want["tables"]
    for k, v in want["stats"].items():
        assert got["stats"][k] == pytest.approx(v, rel=1e-12), k
    assert got["stats"]["cow_copies"] >= 1 and got["stats"]["prefix_hits"] >= 1
    assert got["stats"]["noc_combines"] > 0
    one = _drive(TEngine(cfg, tparams, **ENGINE_KW), prompts)
    assert one["stats"]["noc_combines"] == 0
    assert _drive(JEngine(cfg, jparams, paged=True, **ENGINE_KW),
                  prompts)["toks"] == one["toks"] == got["toks"]
    two = _drive(TEngine(cfg, tparams, seq_shards=2, **ENGINE_KW), prompts)
    assert two["toks"] == one["toks"]


def test_sharded_int8_pool_matches_jax(arch):
    """An int8 pool at two shards: token-identical to the port's and the
    JAX engine's int8 pools at one shard (the scales ride the global
    scatter)."""
    name, cfg, jparams, tparams = arch
    prompts = _mixed(cfg.vocab_size)
    kw = dict(ENGINE_KW, kv_dtype="int8")
    two = _drive(TEngine(cfg, tparams, seq_shards=2, **kw), prompts)
    one = _drive(TEngine(cfg, tparams, **kw), prompts)
    assert two["toks"] == one["toks"]
    assert _drive(JEngine(cfg, jparams, paged=True, **kw), prompts)["toks"] == \
        one["toks"]
    assert two["stats"]["cow_copies"] >= 1


def test_sharded_engine_zero_page_shard(arch):
    """tests/test_serve_sharded.py's case: a one-page request leaves three
    of four shards with no page of the slot; their all-null local tables
    contribute nothing and the tokens equal one shard's."""
    _, cfg, _, tparams = arch
    kw = dict(max_seq=32, slots=1, prefill_buckets=(8, 16, 32), block_size=8)
    outs = {}
    for S in (1, 4):
        eng = TEngine(cfg, tparams, seq_shards=S, **kw)
        eng.submit([5, 3, 2], max_new_tokens=3)
        eng.step()
        used = int(eng.alloc.used[0])
        owners = {eng.alloc.owner(int(p)) for p in eng.alloc.table[0, :used]}
        if S == 4:
            assert len(owners) < 4
        outs[S] = tuple(eng.run_until_drained()[0].out_tokens)
    assert outs[1] == outs[4]


def test_sharded_engine_bad_configs(arch):
    """As in JAX: a shard count that is not a power of two, and sharding
    without the page pool, raise with JAX's messages; the pool rounds up to
    whole shards and keeps one null page per shard."""
    _, cfg, jparams, tparams = arch
    for eng_cls, params in ((JEngine, jparams), (TEngine, tparams)):
        with pytest.raises(ValueError, match="power of two"):
            eng_cls(cfg, params, max_seq=32, slots=1, seq_shards=3)
        with pytest.raises(ValueError, match="paged"):
            eng_cls(cfg, params, max_seq=32, slots=1, paged=False, seq_shards=2)
    eng = TEngine(cfg, tparams, max_seq=32, slots=3, block_size=8, seq_shards=4)
    assert eng.alloc.num_blocks == 16 and eng.alloc.usable_blocks == 12
    assert eng.state["attn"]["k_pages"].shape[2] == 16
    assert TEngine(cfg, tparams, max_seq=32, slots=3, block_size=8,
                   seq_shards=4, num_blocks=17).alloc.num_blocks == 20


def test_serve_cli_seq_shards(capsys):
    tserve.main(["--seq-shards", "2", "--device", "cpu", "--reduced",
                 "--requests", "3", "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "kv=paged/seq2" in out and "[serve] noc: combines=" in out
