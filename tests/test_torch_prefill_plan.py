"""The bf16 paged prefill's walk (``csrc/paged_attention.cu``, its
tensor-core form) on the CPU.

The kernel cannot run here, so its arithmetic is held in two pieces.  The
plain mirror ``ref.paged_prefill_staged_partial`` (64-row query tiles, the
tile's owned pages compacted in table order, 64-key stages, the online
softmax in f32, the int8 K scale on each score column, V's scale folded into
P, P as a bf16 hi + lo pair) against the plain partials
``ref.paged_prefill_attention_partial``, the JAX oracle and the Pallas
kernel in ``interpret=True``: float and int8 pools, skip_null off and on,
BS 8, 16 and 128, G 1 and 4 with C x G not a multiple of the tile, and a
shard that owns no page of a tile.  And the host-side mirrors of what the
kernel computes for itself (``_paged.prefill_rows``, ``geometry``,
``tile_key_ends``, ``owned_pages``, ``stage_positions``) against brute force
and against the kernel's ballot-and-popc compaction written out in Python.
The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import prefill_attention as jpf  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _paged  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SHARDS = 4
# P carried as a bf16 hi + lo pair is ~2^-17 relative off the f32 p, summed
# over the stages in another order than the plain version's einsums
TOL = dict(rtol=1e-4, atol=1e-5)

# (BS, H, KvH, C, MB, q_offset, length): G = 1 over two tiles of 64 rows
# (70 rows), G = 4 over 80 rows (a 16-row tail tile), BS 128 with stages of
# half a page and a chunk that straddles its pages
CASES = [(8, 2, 2, 70, 16, 40, 70), (16, 8, 2, 20, 8, 37, 20),
         (128, 4, 1, 18, 2, 120, 18), (8, 8, 2, 20, 8, 0, 20)]


def _bf16(a):
    """f32 values a bf16 kernel operand can hold exactly."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _quantize(pages):
    s = np.maximum(np.abs(pages).max(axis=(2, 3)) / 127.0, 1e-8).astype(np.float32)
    return np.clip(np.round(pages / s[..., None, None]), -127, 127).astype(np.int8), s


def _case(seed, bs, h, kvh, c, mb, kind, shard):
    """q, pages (float, or int8 with scales), and a table: distinct nonzero
    pages, or with ``shard`` the shard-local table of a round-robin
    placement over SHARDS shards (entry j nonzero iff j % SHARDS == shard)."""
    rng = np.random.default_rng(seed)
    d, nb = 16, mb + 3
    q = _bf16(rng.normal(size=(1, c, h, d)).astype(np.float32))
    kp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    vp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    scales = {}
    if kind == "int8":
        kp, ks = _quantize(kp)
        vp, vs = _quantize(vp)
        scales = dict(k_scales=ks, v_scales=vs)
    else:
        kp, vp = _bf16(kp), _bf16(vp)
    bt = (rng.permutation(nb - 1)[:mb] + 1).astype(np.int32)
    if shard is not None:
        bt = np.where(np.arange(mb) % SHARDS == shard, bt, 0).astype(np.int32)
    return q, kp, vp, bt, scales


def _t(a):
    return torch.from_numpy(np.array(a))


def _live_close(got, want, err_msg=""):
    """Partials on the rows that see a key (m, l, acc / l); returns them."""
    acc, m, l = (np.asarray(x) for x in got)
    wacc, wm, wl = (np.asarray(x) for x in want)
    live = wm > -1e29
    np.testing.assert_allclose(m[live], wm[live], **TOL, err_msg=err_msg)
    np.testing.assert_allclose(l[live], wl[live], **TOL, err_msg=err_msg)
    np.testing.assert_allclose((acc / np.maximum(l, 1e-30)[..., None])[live],
                               (wacc / np.maximum(wl, 1e-30)[..., None])[live], **TOL,
                               err_msg=err_msg)
    return live


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("shard", [None, 1, 3])
@pytest.mark.parametrize("bs,h,kvh,c,mb,qoff,length", CASES)
def test_staged_mirror_matches_plain_and_pallas(kind, shard, bs, h, kvh, c, mb,
                                                qoff, length):
    """The kernel's walk gives the plain partials on every row that sees a
    key, and (0, -1e30, 0) on every row that sees none."""
    q, kp, vp, bt, sc = _case(7, bs, h, kvh, c, mb, kind, shard)
    skip = shard is not None
    kw = dict(q_offset=qoff, length=length, skip_null=skip)
    tsc = {k: _t(v) for k, v in sc.items()}
    got = tref.paged_prefill_staged_partial(_t(q), _t(kp), _t(vp), _t(bt), **kw,
                                            **tsc)
    plain = tref.paged_prefill_attention_partial(_t(q), _t(kp), _t(vp), _t(bt),
                                                 **kw, **tsc)
    live = _live_close(got, plain, "plain")
    jkw = dict(q_offset=jnp.int32(qoff), length=jnp.int32(length),
               skip_null=skip, **{k: jnp.asarray(v) for k, v in sc.items()})
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt))
    assert np.array_equal(_live_close(got, jref.paged_prefill_attention_partial(
        *jargs, **jkw), "oracle"), live)
    assert np.array_equal(_live_close(got, jpf.paged_prefill_attention_partial(
        *jargs, interpret=True, **jkw), "pallas"), live)
    acc, m, l = got
    dead = torch.from_numpy(~live)
    assert bool((acc[dead] == 0).all() and (m[dead] == -1e30).all()
                and (l[dead] == 0).all())
    if not skip:
        assert live.all()
    if skip and qoff == 0:
        # shard 3 owns none of the first tile's pages (positions 0-15 at G 4:
        # pages 0 and 1): the whole tile is the identity
        g = h // kvh
        first = min(_paged.TC_ROWS // g, c)
        assert live[0, :first].any() == (shard < 2)


def test_staged_mirror_normalized_matches_flash_path():
    """Normalised, the mirror's partials give the plain paged prefill's
    output at bf16 rounding (the kernel's output form)."""
    bs, h, kvh, c, mb, qoff, length = CASES[1]
    q, kp, vp, bt, _ = _case(11, bs, h, kvh, c, mb, "float", None)
    kw = dict(q_offset=qoff, length=length)
    acc, _, l = tref.paged_prefill_staged_partial(_t(q), _t(kp), _t(vp), _t(bt), **kw)
    got = (acc / torch.clamp(l, min=1e-30)[..., None]).to(torch.bfloat16)
    want = tref.paged_prefill_attention(_t(q).to(torch.bfloat16), _t(kp).to(torch.bfloat16),
                                        _t(vp).to(torch.bfloat16), _t(bt), **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=1e-5)


def test_hi_lo_pair_carries_p():
    """bf16 hi + lo holds p to ~2^-17 relative, where hi alone is 2^-9 off:
    why the kernel feeds P V two MMAs."""
    p = torch.rand(4096, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    hi, lo = tref._bf16_pair(p)
    assert float(((hi + lo - p).abs() / p).max()) < 2 ** -16
    assert float(((hi - p).abs() / p).max()) > 2 ** -10


# ---------------------------------------------------------------------------
# the host-side mirrors of the kernel's tiles, page list and stages
# ---------------------------------------------------------------------------

def test_prefill_rows_by_route():
    assert _paged.prefill_rows(torch.bfloat16) == _paged.TC_ROWS == 64
    assert _paged.prefill_rows(torch.float32) == _paged.ROWS == 16
    assert _paged.PREFILL_STAGE == 64


@pytest.mark.parametrize("rows", [_paged.ROWS, _paged.TC_ROWS])
@pytest.mark.parametrize("c,h,kvh,qoff,ln,bs,mb", [
    (11, 6, 2, 5, 11, 8, 4), (512, 32, 32, 256, 512, 16, 64),
    (1, 8, 2, 40, 1, 16, 4), (40, 4, 1, 0, 33, 8, 8), (70, 2, 2, 40, 70, 8, 16),
    (20, 8, 2, 2048, 20, 128, 17)])
def test_tile_key_ends_by_route(rows, c, h, kvh, qoff, ln, bs, mb):
    """Each route's tile count, and the key bound each of its tiles walks:
    every key a row of the tile may attend lies below it, and it is tight."""
    g = _paged.geometry((1, c, h, 64), (kvh, 9, bs, 64), (1, mb), rows)
    grp = h // kvh
    assert g.rows == rows and g.n_tiles == -(-(c * grp) // rows)
    total = min(qoff + ln, mb * bs)
    ends = _paged.tile_key_ends(g, qoff, total)
    assert len(ends) == g.n_tiles
    for t, end in enumerate(ends):
        last = min((t + 1) * rows, c * grp) - 1
        assert end == min(total, qoff + last // grp + 1)
        assert all(kp < end for r in range(t * rows, last + 1)
                   for kp in range(min(qoff + r // grp + 1, total)))


def _kernel_list(table, end, bs, skip_null):
    """Warp 0's loop in the kernel: 32 table entries a pass, a ballot of the
    live ones, each written at its popc prefix; returns (list, count)."""
    n_prefix = (end + bs - 1) // bs if end > 0 else 0
    out, n = {}, 0
    for base in range(0, n_prefix, 32):
        lanes = range(base, min(base + 32, n_prefix))
        mask = [p for p in lanes if not skip_null or int(table[p]) != 0]
        for p in mask:
            out[n + sum(1 for x in mask if x < p)] = (int(table[p]), p)
        n += len(mask)
    return [out[i] for i in range(n)], n


@pytest.mark.parametrize("bs", [8, 16, 128])
@pytest.mark.parametrize("skip_null", [False, True])
@pytest.mark.parametrize("end", [0, 1, 7, 64, 100, 1000, 2100])
def test_owned_pages_and_stages(bs, skip_null, end):
    """owned_pages is the kernel's compaction; the walk (n_walk from the last
    listed page, key w at row w % BS of entry w / BS) gives the positions of
    stage_positions: the owned keys below ``end``, increasing, in stages of
    64."""
    rng = np.random.default_rng(bs + end)
    mb = -(-2100 // bs) + 1
    table = (rng.permutation(4 * mb)[:mb] + 1).astype(np.int32)
    table[rng.random(mb) < 0.4] = 0
    pages = _paged.owned_pages(table, end, bs, skip_null)
    listed, n = _kernel_list(table, end, bs, skip_null)
    assert pages == listed and n == len(pages)
    n_walk = (n - 1) * bs + min(bs, end - pages[-1][1] * bs) if n else 0
    walk = [pages[w // bs][1] * bs + w % bs for w in range(n_walk)]
    stages = _paged.stage_positions(pages, end, bs)
    assert [k for st in stages for k in st] == walk
    assert all(len(st) == _paged.PREFILL_STAGE for st in stages[:-1])
    assert all(0 < len(st) <= _paged.PREFILL_STAGE for st in stages)
    want = [k for k in range(end) if not skip_null or table[k // bs] != 0]
    assert walk == want
    assert all(table[k // bs] == pages[i // bs][0] for i, k in enumerate(walk))


@pytest.mark.parametrize("bs", [8, 16])
def test_round_robin_shard_walks_its_share(bs):
    """The engine's round-robin placement (logical page j on shard j % S):
    a shard's walk over a 768-key prefix is 1/S of the keys (to a page),
    where a per-key mask over 32-key steps walked half the steps at BS 16;
    and every key is walked by exactly one shard."""
    end, mb = 768, 768 // bs
    table = np.arange(1, mb + 1, dtype=np.int32)
    walked = []
    for s in range(SHARDS):
        local = np.where(np.arange(mb) % SHARDS == s, table, 0)
        keys = [k for st in _paged.stage_positions(
            _paged.owned_pages(local, end, bs, True), end, bs) for k in st]
        assert abs(len(keys) - end / SHARDS) <= bs
        walked += keys
    assert sorted(walked) == list(range(end))


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::paged_prefill_tc_kernel<__nv_bfloat16, 64>(...)",
    "void (anonymous namespace)::paged_prefill_tc_kernel<signed char, 64>(...)",
    "void (anonymous namespace)::paged_attention_kernel<float, float, 64>(...)"])
def test_traces_count_both_forms_as_the_paged_prefill(name):
    """trace_serve and trace_train file both forms of the kernel under the
    paged prefill (trace_serve's group) and the port's kernels."""
    from repro_torch.launch import trace_serve, trace_train

    assert trace_serve._group(name) == "port CUDA kernels: paged prefill"
    assert trace_train._group(name) == "port CUDA kernels, other"
