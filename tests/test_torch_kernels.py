"""Port parity, kernels: each plain PyTorch version in repro_torch.kernels.ref
matches the JAX oracle (repro.kernels.ref) and the Pallas kernel run with
``interpret=True``, on the same numpy inputs at fp32, within 1e-5; plus the
host-side logic of the CUDA wrappers that the CPU can reach."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import prefill_attention as jpf  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import rmsnorm as jrn  # noqa: E402
from repro.kernels import rope as jrope  # noqa: E402
from repro.kernels import swiglu as jsw  # noqa: E402
from repro_torch.kernels import _paged, ops  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import prefill_attention as tpf  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **{**TOL, **kw})


def test_rmsnorm_matches_jax(rng):
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    got = tref.rmsnorm(_t(x), _t(w), 1e-5)
    _close(got, jref.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    _close(got, jrn.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-5,
                            block_rows=4, interpret=True))
    _close(ops.rmsnorm(_t(x), _t(w), eps=1e-5), got, rtol=0, atol=0)


def test_silu_mul_matches_jax(rng):
    g = (3 * rng.normal(size=(7, 96))).astype(np.float32)
    u = rng.normal(size=(7, 96)).astype(np.float32)
    got = tref.silu_mul(_t(g), _t(u))
    _close(got, jref.silu_mul(jnp.asarray(g), jnp.asarray(u)))
    _close(got, jsw.silu_mul(jnp.asarray(g), jnp.asarray(u), block_rows=4,
                             interpret=True))
    _close(ops.silu_mul(_t(g), _t(u)), got, rtol=0, atol=0)


@pytest.mark.parametrize("max_pos", [64, 4096])
def test_rope_matches_jax(rng, max_pos):
    """Against the oracle at any position.  The Pallas kernel forms the
    inverse frequency as exp(-ln(theta) j/half), a few ulp from the
    oracle's theta^(-j/half); the angle error grows with the position, so
    the 1e-5 comparison with it runs at positions below 64 only."""
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, max_pos, size=(2, 7)).astype(np.int32)
    got = tref.apply_rope(_t(x), _t(pos), 10_000.0)
    _close(got, jref.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    if max_pos <= 64:
        _close(got, jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     block_s=4, interpret=True))
    # [S] positions broadcast over the batch, as in the JAX oracle
    p1 = pos[0]
    _close(tref.apply_rope(_t(x), _t(p1)),
           jref.apply_rope(jnp.asarray(x), jnp.asarray(p1)))
    _close(ops.apply_rope(_t(x), _t(pos)), got, rtol=0, atol=0)


def test_flash_attention_lengths_and_offset_matches_jax(rng):
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 23, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 23, 2, 16)).astype(np.float32)
    lens = np.array([17, 23], np.int32)
    for kw in (dict(q_offset=9), dict(q_offset=0, causal=False)):
        got = tref.flash_attention(_t(q), _t(k), _t(v), lengths=_t(lens),
                                   block_k=8, **kw)
        want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), lengths=jnp.asarray(lens),
                                    block_k=8, **kw)
        _close(got, want, err_msg=str(kw))


def _paged_case(rng, *, b=3, h=8, kvh=4, d=16, bs=8, mb=6, nb=20):
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    vp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    bt = rng.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32)
    lens = rng.integers(1, mb * bs, size=(b,)).astype(np.int32)
    return q, kp, vp, bt, lens


def test_gather_and_combine_match_jax(rng):
    q, kp, vp, bt, lens = _paged_case(rng)
    _close(tref.gather_pages(_t(kp), _t(bt)), jref.gather_pages(kp, bt),
           rtol=0, atol=0)
    _close(tref.gather_pages(_t(kp), _t(bt[0])), jref.gather_pages(kp, bt[0]),
           rtol=0, atol=0)
    k_lin, v_lin = jref.gather_pages(kp, bt), jref.gather_pages(vp, bt)
    half = 3 * kp.shape[2]
    j1 = jref.decode_attention_partial(q, k_lin[:, :half], v_lin[:, :half],
                                       lengths=lens)
    j2 = jref.decode_attention_partial(q, k_lin[:, half:], v_lin[:, half:],
                                       lengths=lens, kv_offset=half)
    t1 = tref.decode_attention_partial(_t(q), _t(np.asarray(k_lin[:, :half])),
                                       _t(np.asarray(v_lin[:, :half])),
                                       lengths=_t(lens))
    t2 = tref.decode_attention_partial(_t(q), _t(np.asarray(k_lin[:, half:])),
                                       _t(np.asarray(v_lin[:, half:])),
                                       lengths=_t(lens), kv_offset=half)
    for a, b_ in zip(tref.combine_partials(t1, t2), jref.combine_partials(j1, j2)):
        _close(a, b_)


@pytest.mark.parametrize("bs,mb,nb", [(8, 6, 20), (128, 3, 10)])
def test_paged_decode_matches_jax(rng, bs, mb, nb):
    """Output and (acc, m, l) partials vs the oracle and the Pallas kernel;
    bs=128 exercises the TPU kernel's 64-row K-subtiling."""
    q, kp, vp, bt, lens = _paged_case(rng, bs=bs, mb=mb, nb=nb)
    got = tref.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                      lengths=_t(lens))
    _close(got, jref.paged_decode_attention(q, kp, vp, bt, lengths=lens))
    _close(got, jda.paged_decode_attention(q, kp, vp, bt, lengths=lens,
                                           interpret=True))
    _close(ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                      lengths=_t(lens)), got, rtol=0, atol=0)
    parts = tref.paged_decode_attention_partial(_t(q), _t(kp), _t(vp), _t(bt),
                                                lengths=_t(lens))
    for want in (jref.paged_decode_attention_partial(q, kp, vp, bt,
                                                     lengths=lens),
                 jda.paged_decode_attention_partial(q, kp, vp, bt, lengths=lens,
                                                    interpret=True)):
        for a, b_ in zip(parts, want):
            _close(a, b_)


@pytest.mark.parametrize("bs,c,table", [
    (8, 8, "full"),
    (8, 11, "prefix"),      # C not a multiple of the tile; table slice
    (128, 10, "full"),      # K-subtiling in the TPU kernel
])
def test_paged_prefill_matches_jax(rng, bs, c, table):
    kvh, nb, d, h = 2, 14, 16, 6
    q = rng.normal(size=(1, c, h, d)).astype(np.float32)
    kp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    vp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
    bt = (rng.permutation(nb - 1)[:6] + 1).astype(np.int32)
    cases = [(0, c), (3 * bs - 4, 3), (2 * bs + 5, c)]
    for qoff, ln in cases:
        tbl = bt
        if table == "prefix":       # the engine's pow2 slice of the live prefix
            n_live = -(-(qoff + ln) // bs)
            tbl = bt[:min(1 << max(n_live - 1, 0).bit_length(), len(bt))]
        kw = dict(q_offset=qoff, length=ln)
        jkw = dict(q_offset=jnp.int32(qoff), length=jnp.int32(ln))
        got = tref.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(tbl), **kw)
        _close(got, jref.paged_prefill_attention(q, kp, vp, tbl, **jkw),
               err_msg=str(kw))
        parts = tref.paged_prefill_attention_partial(_t(q), _t(kp), _t(vp),
                                                     _t(tbl), **kw)
        want = jpf.paged_prefill_attention_partial(q, kp, vp, tbl, q_tile=4,
                                                   interpret=True, **jkw)
        for a, b_ in zip(parts, want):
            _close(a, b_, err_msg=str(kw))
        _close(got, (parts[0] / torch.clamp(parts[2], min=1e-30)[..., None]),
               err_msg=str(kw))
        # the CPU path of ops (gather + flash) agrees on the valid rows
        _close(np.asarray(ops.paged_prefill_attention(
            _t(q), _t(kp), _t(vp), _t(tbl), **kw))[0, :ln],
            np.asarray(got)[0, :ln], err_msg=str(kw))


# ---------------------------------------------------------------------------
# host side of the CUDA wrappers (reachable on CPU tensors)
# ---------------------------------------------------------------------------

def test_paged_geometry_and_tile_key_ends():
    """Tile count and the per-tile key bound the kernel walks: every key a
    row of the tile may attend lies below the bound, and the bound is tight
    (its last key is attended by the tile's last row)."""
    for (c, h, kvh, qoff, ln, bs, mb) in [(11, 6, 2, 5, 11, 8, 4),
                                          (512, 32, 32, 256, 512, 16, 64),
                                          (1, 8, 2, 40, 1, 16, 4),
                                          (40, 4, 1, 0, 33, 8, 8)]:
        g = _paged.geometry((1, c, h, 64), (kvh, 9, bs, 64), (1, mb))
        grp = h // kvh
        assert g.n_tiles == -(-(c * grp) // _paged.ROWS)
        total = min(qoff + ln, mb * bs)
        ends = _paged.tile_key_ends(g, qoff, total)
        for t, end in enumerate(ends):
            rows = range(t * _paged.ROWS, min((t + 1) * _paged.ROWS, c * grp))
            attended = [kp for r in rows for kp in range(mb * bs)
                        if kp <= qoff + r // grp and kp < total]
            assert max(attended) + 1 == end


def test_paged_geometry_rejects_bad_shapes():
    with pytest.raises(ValueError, match="disagree"):
        _paged.geometry((2, 1, 8, 64), (4, 9, 16, 32), (2, 4))
    with pytest.raises(ValueError, match="multiple"):
        _paged.geometry((1, 4, 6, 64), (4, 9, 16, 64), (1, 4))
    with pytest.raises(ValueError, match="head dim"):
        _paged.geometry((1, 4, 8, 48), (4, 9, 16, 48), (1, 4))


def test_cuda_wrappers_refuse_cpu_tensors(rng):
    """The kernel wrappers never fall back: a CPU tensor raises before any
    build or launch (ops sends CPU tensors to the plain version instead)."""
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        trn.rmsnorm(x, torch.ones(64))
    q, kp, vp, bt, lens = _paged_case(rng)
    with pytest.raises(ValueError, match="CUDA"):
        tda.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lens))
    with pytest.raises(ValueError, match="CUDA"):
        tpf.paged_prefill_attention(_t(q[:1, None][:, :, :8]), _t(kp), _t(vp),
                                    _t(bt[0]), q_offset=0, length=1)
    assert trn.launches == 0 and tda.launches == 0 and tpf.launches == 0
