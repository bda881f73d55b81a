"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one;
run them on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

No JAX here: the machine with the card has none.  Inputs are made with
numpy from a seed.  fp32 cases hold the kernel to 1e-5 (the same sums in
another order); bf16 cases to 2 bf16 ulps relative plus 1e-2 absolute, the
rounding of the output and, for attention, of p before the PV product in
the plain version.  The flash-attention backward at fp32 is held to 1e-4:
its sums run over every visible query or key, in another order than the
plain version's block einsums, and ``dp - D`` cancels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import noc  # noqa: E402
from repro_torch.kernels import _build, _paged  # noqa: E402
from repro_torch.kernels import decode_attention as kda  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import mamba_chunk as kmamba  # noqa: E402
from repro_torch.kernels import matmul as kmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import prefill_attention as kpf  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as krn  # noqa: E402
from repro_torch.kernels import rope as krope  # noqa: E402
from repro_torch.kernels import rwkv_chunk as kwkv  # noqa: E402
from repro_torch.kernels import swiglu as ksw  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.engine import BlockAllocator  # noqa: E402

pytestmark = pytest.mark.cuda

TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5),
        torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev, scale=1.0):
    return (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale)
            .to(dev).to(dtype))


def _close(got, want, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_elementwise_kernels(dev, dtype):
    rng = np.random.default_rng(0)
    x = _rand(rng, (3, 7, 2048), dtype, dev)
    w = _rand(rng, (2048,), dtype, dev)
    _close(krn.rmsnorm(x, w, 1e-5), ref.rmsnorm(x, w, 1e-5), dtype)
    g = _rand(rng, (5, 5632), dtype, dev, 3.0)
    u = _rand(rng, (5, 5632), dtype, dev)
    _close(ksw.silu_mul(g, u), ref.silu_mul(g, u), dtype)
    q = _rand(rng, (2, 9, 6, 64), dtype, dev)
    pos = torch.from_numpy(rng.integers(0, 1024, size=(2, 9)).astype(np.int32)).to(dev)
    _close(krope.apply_rope(q, pos), ref.apply_rope(q, pos), dtype)
    # zamba2-7b's widths: rope at head dim 112, the gated norm over 7168
    q = _rand(rng, (2, 9, 4, 112), dtype, dev)
    _close(krope.apply_rope(q, pos), ref.apply_rope(q, pos), dtype)
    x = _rand(rng, (3, 7168), dtype, dev)
    w = _rand(rng, (7168,), dtype, dev)
    _close(krn.rmsnorm(x, w, 1e-5), ref.rmsnorm(x, w, 1e-5), dtype)


# (H, KvH, D, BS, MB): G = 2 at each head dim over a 4-page table; then
# G = 1, 4 and 8 over caches of 4096 keys, cut into the plan's largest
# splits; then zamba2-7b's head dim 112 (3.5 lanes' worth of 32: each of
# the first 28 lanes holds 4 output dims) at G = 2, 1 and 4
PAGED_DECODE_CASES = [(8, 4, 64, 16, 4), (4, 2, 16, 8, 4), (8, 2, 128, 128, 4),
                      (8, 8, 64, 16, 256), (8, 2, 64, 16, 256),
                      (16, 2, 128, 16, 256), (8, 1, 16, 8, 512),
                      (4, 2, 112, 16, 4), (8, 8, 112, 16, 256), (8, 2, 112, 16, 256)]


def _decode_lengths(dev, b_hint, h, kvh, bs, mb, keys_grain):
    """Lengths at page and split edges of the card's plan for this cache:
    1 beside the whole cache, BS - 1, BS + 1, a split edge -1 / +0 / +1 and
    two splits and a page; on a 4-page table the earlier cases' lengths."""
    if mb <= 4:
        return [1, bs, mb * bs, 2 * bs + 3, 1]
    plan = _paged.decode_plan(b_hint, kvh, h // kvh, mb * bs, keys_grain,
                              _build.n_sms(dev))
    e = plan.split_keys
    assert plan.n_split > 1
    return [1, mb * bs, bs - 1, bs + 1, e - 1, e, e + 1, 2 * e + bs, 1]


def _repeat_equal(fn):
    """Two calls on the same inputs give the same bits (no atomics, a fixed
    merge order); returns the first."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y)
    return a


def _decode_pool(rng, dev, b, mb, nb, kvh, bs, d, dtype, int8):
    """A decode test's K/V pool (float, or int8 with its scales) and table:
    distinct pages per sequence, the last sequence a retired slot (an
    all-zero table row)."""
    if int8:
        kp, ks, vp, vs = _int8_pool(rng, kvh, nb, bs, d, dev)
    else:
        kp = _rand(rng, (kvh, nb, bs, d), dtype, dev)
        vp = _rand(rng, (kvh, nb, bs, d), dtype, dev)
        ks = vs = None
    bt = torch.from_numpy((rng.permutation(nb - 1)[:b * mb] + 1).reshape(b, mb)
                          .astype(np.int32)).to(dev)
    bt[-1] = 0                                  # a retired slot: null page
    return kp, vp, ks, vs, bt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,bs,mb", PAGED_DECODE_CASES)
def test_paged_decode_kernel(dev, dtype, h, kvh, d, bs, mb):
    """Output and f32 partials against the plain version at lengths on page
    and split edges, each launch bitwise repeatable."""
    rng = np.random.default_rng(1)
    lens = _decode_lengths(dev, 9, h, kvh, bs, mb, bs)
    b = len(lens)
    q = _rand(rng, (b, h, d), dtype, dev)
    kp, vp, _, _, bt = _decode_pool(rng, dev, b, mb, b * mb + 4, kvh, bs, d,
                                    dtype, False)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    _close(_repeat_equal(lambda: kda.paged_decode_attention(q, kp, vp, bt, lens)),
           ref.paged_decode_attention(q, kp, vp, bt, lengths=lens), dtype)
    if dtype == torch.float32:
        got = _repeat_equal(
            lambda: kda.paged_decode_attention_partial(q, kp, vp, bt, lens))
        want = ref.paged_decode_attention_partial(q, kp, vp, bt, lengths=lens)
        for a, b_ in zip(got, want):
            _close(a, b_, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,bs,c", [(8, 8, 64, 16, 40), (6, 2, 16, 8, 11),
                                          (8, 2, 128, 128, 33), (8, 2, 112, 16, 40)])
def test_paged_prefill_kernel(dev, dtype, h, kvh, d, bs, c):
    rng = np.random.default_rng(2)
    nb = 12
    q = _rand(rng, (1, c, h, d), dtype, dev)
    kp = _rand(rng, (kvh, nb, bs, d), dtype, dev)
    vp = _rand(rng, (kvh, nb, bs, d), dtype, dev)
    bt = torch.from_numpy((rng.permutation(nb - 1)[:8] + 1).astype(np.int32)).to(dev)
    for qoff, ln in [(0, c), (bs + 3, c), (3 * bs - 2, 1), (0, 1)]:
        n_live = -(-(qoff + ln) // bs)
        tbl = bt[:min(1 << max(n_live - 1, 0).bit_length(), 8)].contiguous()
        kw = dict(q_offset=qoff, length=ln)
        got = kpf.paged_prefill_attention(q, kp, vp, tbl, **kw)
        want = ref.paged_prefill_attention(q, kp, vp, tbl, **kw)
        _close(got[0, :ln], want[0, :ln], dtype)
        if dtype == torch.float32:
            parts = kpf.paged_prefill_attention_partial(q, kp, vp, tbl, **kw)
            wparts = ref.paged_prefill_attention_partial(q, kp, vp, tbl, **kw)
            for a, b_ in zip(parts, wparts):
                _close(a[0, :ln], b_[0, :ln], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_minitron_paged_kernels(dev, dtype):
    """minitron-4b's grouped heads, 24 query heads over 8 kv heads of 128
    (G = 3, a group short of the decode block's 8 rows): the paged decode
    over a 64-page table at lengths on page and split edges, and a 512-row
    prefill chunk at offset 256 (C x G = 1536 rows, 24 bf16 tiles), each
    against the plain version and bitwise repeatable; a version that reads
    q head h against kv head h mod 8 instead of h // 3 fails the same
    tolerance."""
    h, kvh, d, bs, mb = 24, 8, 128, 16, 64
    rng = np.random.default_rng(32)
    lens = _decode_lengths(dev, 8, h, kvh, bs, mb, bs)
    b = len(lens)
    q = _rand(rng, (b, h, d), dtype, dev)
    kp, vp, _, _, bt = _decode_pool(rng, dev, b, mb, b * mb + 4, kvh, bs, d,
                                    dtype, False)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    wrong = torch.arange(h, device=dev) % kvh
    got = _repeat_equal(lambda: kda.paged_decode_attention(q, kp, vp, bt, lens))
    _close(got, ref.paged_decode_attention(q, kp, vp, bt, lengths=lens), dtype)
    bad = ref.paged_decode_attention(q, kp[wrong], vp[wrong], bt, lengths=lens)
    assert not torch.allclose(got.float(), bad.float(), **TOLS[dtype])
    c, qoff = 512, 256
    qp = _rand(rng, (1, c, h, d), dtype, dev)
    table = bt[0].contiguous()
    kw = dict(q_offset=qoff, length=c)
    got = _repeat_equal(lambda: kpf.paged_prefill_attention(qp, kp, vp, table, **kw))
    _close(got, ref.paged_prefill_attention(qp, kp, vp, table, **kw), dtype)
    bad = ref.paged_prefill_attention(qp, kp[wrong], vp[wrong], table, **kw)
    assert not torch.allclose(got.float(), bad.float(), **TOLS[dtype])


def _int8_pool(rng, kvh, nb, bs, d, dev):
    """int8 K and V pages [KvH, NB, BS, D] with their per-(kv head, page)
    f32 scales, quantized from N(0, 1) pages with numpy."""
    out = []
    for _ in range(2):
        p = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
        s = np.maximum(np.abs(p).max(axis=(2, 3)) / 127.0, 1e-8).astype(np.float32)
        q8 = np.clip(np.round(p / s[..., None, None]), -127, 127).astype(np.int8)
        out += [torch.from_numpy(q8).to(dev), torch.from_numpy(s).to(dev)]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,bs,mb", PAGED_DECODE_CASES)
def test_paged_decode_kernel_int8(dev, dtype, h, kvh, d, bs, mb):
    """The int8-page variant at each instantiated head dim and at lengths on
    page and split edges: output (and the f32 partials) against the plain
    version on the same int8 pages and scales, bitwise repeatable, counted
    as int8 launches only."""
    rng = np.random.default_rng(3)
    lens = _decode_lengths(dev, 9, h, kvh, bs, mb, bs)
    b = len(lens)
    q = _rand(rng, (b, h, d), dtype, dev)
    k8, v8, ks, vs, bt = _decode_pool(rng, dev, b, mb, b * mb + 4, kvh, bs, d,
                                      dtype, True)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    n_float, n_q8 = kda.launches, kda.q8_launches
    _close(_repeat_equal(
        lambda: kda.paged_decode_attention(q, k8, v8, bt, lens, ks, vs)),
        ref.paged_decode_attention(q, k8, v8, bt, lengths=lens, k_scales=ks,
                                   v_scales=vs), dtype)
    assert (kda.launches, kda.q8_launches) == (n_float, n_q8 + 2)
    if dtype == torch.float32:
        got = _repeat_equal(lambda: kda.paged_decode_attention_partial(
            q, k8, v8, bt, lens, ks, vs))
        want = ref.paged_decode_attention_partial(q, k8, v8, bt, lengths=lens,
                                                  k_scales=ks, v_scales=vs)
        for a, b_ in zip(got, want):
            _close(a, b_, dtype)
    with pytest.raises(ValueError, match="k_scales"):
        kda.paged_decode_attention(q, k8, v8, bt, lens, ks[:, :-1].contiguous(), vs)
    with pytest.raises(ValueError, match="on cpu"):
        kda.paged_decode_attention(q, k8, v8, bt, lens, ks.cpu(), vs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,bs,c", [(8, 8, 64, 16, 40), (6, 2, 16, 8, 11),
                                          (8, 2, 128, 128, 33), (8, 2, 112, 16, 40)])
def test_paged_prefill_kernel_int8(dev, dtype, h, kvh, d, bs, c):
    rng = np.random.default_rng(4)
    nb = 12
    q = _rand(rng, (1, c, h, d), dtype, dev)
    k8, ks, v8, vs = _int8_pool(rng, kvh, nb, bs, d, dev)
    bt = torch.from_numpy((rng.permutation(nb - 1)[:8] + 1).astype(np.int32)).to(dev)
    n_float, n_q8 = kpf.launches, kpf.q8_launches
    for qoff, ln in [(0, c), (bs + 3, c), (3 * bs - 2, 1), (0, 1)]:
        n_live = -(-(qoff + ln) // bs)
        tbl = bt[:min(1 << max(n_live - 1, 0).bit_length(), 8)].contiguous()
        kw = dict(q_offset=qoff, length=ln, k_scales=ks, v_scales=vs)
        got = kpf.paged_prefill_attention(q, k8, v8, tbl, **kw)
        want = ref.paged_prefill_attention(q, k8, v8, tbl, **kw)
        _close(got[0, :ln], want[0, :ln], dtype)
        if dtype == torch.float32:
            parts = kpf.paged_prefill_attention_partial(q, k8, v8, tbl, **kw)
            wparts = ref.paged_prefill_attention_partial(q, k8, v8, tbl, **kw)
            for a, b_ in zip(parts, wparts):
                _close(a[0, :ln], b_[0, :ln], dtype)
    n_calls = 4 * (2 if dtype == torch.float32 else 1)
    assert (kpf.launches, kpf.q8_launches) == (n_float, n_q8 + n_calls)


FLASH_CASES = [  # (B, Sq, Sk, H, KvH, D, causal, window)
    (2, 100, 100, 8, 2, 64, True, None),
    (2, 100, 100, 8, 2, 64, True, 17),
    (1, 130, 130, 4, 4, 16, True, None),
    (1, 70, 70, 4, 1, 128, True, 40),
    (2, 64, 64, 6, 3, 16, False, None),
    (1, 33, 90, 4, 2, 64, False, 20),
    (2, 150, 150, 4, 4, 112, True, None),      # zamba2-7b's head dim
    (1, 70, 70, 4, 2, 112, True, 40),
    # where the bf16 tensor-core tiling (128- or 64-row query tiles, 64-key
    # tiles, 32-query backward tiles at head dims 112 and 128) can fail:
    (1, 300, 300, 8, 2, 64, True, None),       # granite's GQA 4:1, ragged tiles
    (1, 300, 300, 4, 4, 112, True, 100),       # a window across tile edges
    (2, 33, 200, 4, 2, 64, False, 25),         # non-causal, Sq < Sk, a window
    (1, 257, 257, 4, 4, 128, True, None),      # one row past the last tile
    (2, 512, 512, 16, 16, 128, True, None),    # olmoe-1b-7b's heads, training
]
BWD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernels(dev, dtype, case):
    """Forward (output and lse) and backward against the plain versions;
    the backward twice on the same inputs gives the same bits."""
    b, sq, sk, h, kvh, d, causal, window = case
    rng = np.random.default_rng(3)
    q = _rand(rng, (b, sq, h, d), dtype, dev)
    k = _rand(rng, (b, sk, kvh, d), dtype, dev)
    v = _rand(rng, (b, sk, kvh, d), dtype, dev)
    do = _rand(rng, (b, sq, h, d), dtype, dev)
    o, lse = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want_o, want_lse = ref.flash_attention_lse(q, k, v, causal=causal,
                                               window=window)
    _close(o, want_o, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    got = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    tol = BWD_TOL if dtype == torch.float32 else TOLS[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **tol)
    again = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_flash_unaligned_base_raises(dev):
    """The bf16 kernels copy 16-byte chunks: a bf16 tensor that does not
    start on a 16-byte boundary is refused with a CUDA error, not read
    wrong."""
    rng = np.random.default_rng(3)
    base = _rand(rng, (2 * 64 * 2 * 64 + 1,), torch.bfloat16, dev)
    q = base[1:].view(2, 64, 2, 64)
    k = _rand(rng, (2, 64, 2, 64), torch.bfloat16, dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kfa.flash_attention_fwd(q, k, k)
    o, lse = kfa.flash_attention_fwd(k, k, k)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kfa.flash_attention_bwd(k, k, k, o, lse, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels(dev, dtype):
    rng = np.random.default_rng(4)
    x = _rand(rng, (600, 2048), dtype, dev)
    w = _rand(rng, (2048,), dtype, dev)
    dy = _rand(rng, (600, 2048), dtype, dev)
    got = krn.rmsnorm_bwd(x, w, dy, 1e-5)
    want = ref.rmsnorm_bwd(x, w, dy, 1e-5)
    _close(got[0], want[0], dtype)
    # dw sums 600 rows: per-block partials vs one reduction
    torch.testing.assert_close(got[1].float(), want[1].float(),
                               **(BWD_TOL if dtype == torch.float32 else TOLS[dtype]))
    g = _rand(rng, (7, 5632), dtype, dev, 3.0)
    u = _rand(rng, (7, 5632), dtype, dev)
    dy = _rand(rng, (7, 5632), dtype, dev)
    for a, b_ in zip(ksw.silu_mul_bwd(g, u, dy), ref.silu_mul_bwd(g, u, dy)):
        _close(a, b_, dtype)
    # rope's vjp is the forward kernel at -pos
    q = _rand(rng, (2, 9, 6, 64), dtype, dev).requires_grad_()
    pos = torch.from_numpy(rng.integers(0, 4096, size=(2, 9)).astype(np.int32)).to(dev)
    dq = _rand(rng, (2, 9, 6, 64), dtype, dev)
    (want,) = torch.autograd.grad(ref.apply_rope(q, pos), q, dq)
    _close(krope.apply_rope(dq, -pos), want, dtype)


def test_autograd_functions_match_plain_autograd(dev):
    """Each Function (kernel forward + kernel backward) against autograd of
    the plain version on the same fp32 inputs on the card."""
    rng = np.random.default_rng(5)
    f32 = torch.float32

    def grads(fn, *xs):
        xs = [x.detach().requires_grad_() for x in xs]
        y = fn(*xs)
        dy = torch.from_numpy(np.random.default_rng(6).normal(size=y.shape)
                              .astype(np.float32)).to(dev)
        return [y] + list(torch.autograd.grad(y, xs, dy))

    x, w = _rand(rng, (3, 50, 96), f32, dev), _rand(rng, (96,), f32, dev)
    g, u = _rand(rng, (4, 300), f32, dev, 3.0), _rand(rng, (4, 300), f32, dev)
    q = _rand(rng, (2, 77, 4, 16), f32, dev)
    k = _rand(rng, (2, 77, 2, 16), f32, dev)
    v = _rand(rng, (2, 77, 2, 16), f32, dev)
    pos = torch.arange(77, dtype=torch.int32, device=dev)[None].expand(2, 77)
    pairs = [
        (lambda a, b_: ops.rmsnorm(a, b_, eps=1e-5),
         lambda a, b_: ref.rmsnorm(a, b_, 1e-5), (x, w)),
        (ops.silu_mul, ref.silu_mul, (g, u)),
        (lambda a: ops.apply_rope(a, pos), lambda a: ref.apply_rope(a, pos), (q,)),
        # RopeQK: q and k (H 4, KvH 2) in one launch each way
        (lambda a, b_: torch.cat([t.flatten() for t in ops.apply_rope_qk(a, b_, pos)]),
         lambda a, b_: torch.cat([ref.apply_rope(a, pos).flatten(),
                                  ref.apply_rope(b_, pos).flatten()]), (q, k)),
        (lambda a, b_, c: ops.flash_attention(a, b_, c, window=30),
         lambda a, b_, c: ref.flash_attention(a, b_, c, window=30), (q, k, v)),
    ]
    for kern, plain, xs in pairs:
        for a, b_ in zip(grads(kern, *xs), grads(plain, *xs)):
            torch.testing.assert_close(a, b_, **BWD_TOL)
    with pytest.raises(NotImplementedError, match="dense-slab"):
        ops.flash_attention(q, k, v, q_offset=3)


def test_model_on_card_matches_cpu(dev):
    """Reduced stablelm at fp32: a prefill chunk and two decode steps on the
    card (CUDA kernels) against the CPU (plain versions), same parameters."""
    cfg = reduced(get_config("stablelm-1.6b"))
    params = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    gparams = _to(params, dev)
    logits = {}
    for d, p in (("cpu", params), ("cuda", gparams)):
        state = M.init_serve_state(cfg, 2, 9, 8, dtype=torch.float32, device=d)
        tok = torch.tensor([[5, 9, 2, 77, 3, 3, 41, 0]], dtype=torch.int32)
        bt = torch.tensor([[2, 4, 6, 8], [1, 3, 0, 0]], dtype=torch.int32)
        out = []
        lg, state = M.prefill_paged(cfg, p, state, tokens=tok.to(d), length=7,
                                    q_offset=0, block_table=bt[0].to(d))
        out.append(lg)
        lens = torch.tensor([7, 0], dtype=torch.int32)
        for t in (11, 64):
            toks = torch.tensor([t, 0], dtype=torch.int32)
            lg, state = M.decode_step_paged(cfg, p, state, toks.to(d),
                                            lens.to(d), bt.to(d))
            out.append(lg[:1])
            lens = lens + torch.tensor([1, 0], dtype=torch.int32)
        logits[d] = torch.cat([o.cpu() for o in out])
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4, atol=1e-4)


def test_int8_model_on_card_matches_cpu(dev):
    """Reduced stablelm at fp32 over an int8 pool: two prefill chunks (the
    second from mid-page) and four decode steps on the card against the
    CPU.  K/V rows that differ by float rounding can land one int8 step
    apart at a rounding tie; one such step moves these logits by up to
    7.4e-3, so they are held to 2e-2 absolute."""
    cfg = reduced(get_config("stablelm-1.6b"))
    params = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    gparams = _to(params, dev)
    tok = torch.tensor([[5, 9, 2, 77, 3, 3, 41, 0, 8, 1, 6, 2]], dtype=torch.int32)
    bt = torch.tensor([[2, 4, 6, 8], [1, 3, 0, 0]], dtype=torch.int32)
    logits = {}
    for d, p in (("cpu", params), ("cuda", gparams)):
        state = M.init_serve_state(cfg, 2, 9, 8, dtype=torch.float32, device=d,
                                   kv_dtype="int8")
        out = []
        for off, n, mbk in ((0, 5, 1), (5, 6, 2)):
            lg, state = M.prefill_paged(cfg, p, state, tokens=tok[:, off:off + 8].to(d),
                                        length=n, q_offset=off,
                                        block_table=bt[0, :mbk].to(d))
            out.append(lg)
        lens = torch.tensor([11, 0], dtype=torch.int32)
        for t in (11, 64, 7, 99):
            toks = torch.tensor([t, 0], dtype=torch.int32)
            lg, state = M.decode_step_paged(cfg, p, state, toks.to(d),
                                            lens.to(d), bt.to(d))
            out.append(lg[:1])
            lens = lens + torch.tensor([1, 0], dtype=torch.int32)
        logits[d] = torch.cat([o.cpu() for o in out])
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=0.0, atol=2e-2)


DENSE_CASES = [  # (H, KvH, D, Sk, lengths): MHA and GQA at head dims 16, 64
    (8, 8, 64, 300, [1, 32, 33, 300, 129]),
    (8, 2, 64, 200, [7, 200, 64, 1, 150]),
    (4, 4, 16, 70, [70, 3, 31, 64, 65]),
    (6, 2, 16, 50, [50, 1, 17, 32, 49]),
    # G = 1, 4 and 8 over 4096-key slabs, at the split edges of the card's
    # plan (lengths None: _decode_lengths)
    (8, 8, 64, 4096, None),
    (8, 2, 128, 4096, None),
    (16, 2, 16, 4096, None),
    # zamba2-7b's head dim 112: MHA as the model runs it, and GQA
    (8, 8, 112, 300, [1, 32, 33, 300, 129]),
    (8, 8, 112, 4096, None),
    (8, 2, 112, 200, [7, 200, 64, 1, 150]),
]


def _partials_close(got, want, dtype):
    """(acc, m, l) partials: m and l, and acc / l (in bf16 the plain version
    rounds p before the PV product, an error that grows with l in acc
    itself)."""
    acc, m, l = got
    wacc, wm, wl = want
    _close(m, wm, dtype)
    _close(l, wl, dtype)
    _close(acc / l[..., None], wacc / wl[..., None], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,sk,lens", DENSE_CASES)
def test_dense_decode_kernel(dev, dtype, h, kvh, d, sk, lens):
    """Normalized output and partials over the whole slab, at split edges on
    the 4096-key slabs, each launch bitwise repeatable; then the slab cut at
    40 into two shards, the second at ``kv_offset=40`` (rows of length <= 40
    reach none of its keys: the kernel's identity and the plain version's p
    = 1 rows are compared after ``combine_partials``)."""
    rng = np.random.default_rng(11)
    if lens is None:
        lens = _decode_lengths(dev, 9, h, kvh, _paged.STAGE_KEYS,
                               sk // _paged.STAGE_KEYS, _paged.STAGE_KEYS)
    b = len(lens)
    q = _rand(rng, (b, h, d), dtype, dev)
    k = _rand(rng, (b, sk, kvh, d), dtype, dev)
    v = _rand(rng, (b, sk, kvh, d), dtype, dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    _close(_repeat_equal(lambda: kda.decode_attention(q, k, v, ln)),
           ref.decode_attention(q, k, v, lengths=ln), dtype)
    _close(_repeat_equal(lambda: kda.decode_attention(q, k, v)),
           ref.decode_attention(q, k, v), dtype)
    _partials_close(_repeat_equal(lambda: kda.decode_attention_partial(q, k, v, ln)),
                    ref.decode_attention_partial(q, k, v, lengths=ln), dtype)
    cut = 40
    k1, v1 = k[:, :cut].contiguous(), v[:, :cut].contiguous()
    k2, v2 = k[:, cut:].contiguous(), v[:, cut:].contiguous()
    got = ref.combine_partials(kda.decode_attention_partial(q, k1, v1, ln),
                               kda.decode_attention_partial(q, k2, v2, ln, cut))
    want = ref.combine_partials(
        ref.decode_attention_partial(q, k1, v1, lengths=ln),
        ref.decode_attention_partial(q, k2, v2, lengths=ln, kv_offset=cut))
    _partials_close(got, want, dtype)
    empty = kda.decode_attention_partial(q, k2, v2, ln, cut)
    short = ln <= cut
    assert bool(short.any())
    torch.cuda.synchronize()
    assert bool((empty[0][short] == 0).all() and (empty[1][short] == -1e30).all()
                and (empty[2][short] == 0).all())


FLASH_LEN_CASES = [  # (B, S, H, KvH, D, lengths)
    (3, 150, 8, 8, 64, [1, 100, 150]),
    (2, 129, 8, 2, 64, [64, 65]),
    (3, 70, 4, 4, 16, [70, 9, 33]),
    (2, 300, 8, 2, 64, [165, 0]),      # a bound inside a 64-key tile; a bound of 0
    (2, 200, 4, 4, 128, [130, 64]),    # a bound on a tile edge
    (2, 257, 4, 2, 128, [200, 0]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_LEN_CASES)
def test_flash_lengths_kernel(dev, dtype, case):
    """The flash forward with a per-sequence key bound, causal, against the
    plain version (every row: a row past its length attends the keys below
    it), through ``ops`` as the dense-slab prefill calls it.  A sequence
    bounded at 0 reads no key tile and comes out zero (the plain version,
    as the JAX oracle, counts its masked keys at p = 1: the mean of v)."""
    b, s, h, kvh, d, lens = case
    rng = np.random.default_rng(12)
    q = _rand(rng, (b, s, h, d), dtype, dev)
    k = _rand(rng, (b, s, kvh, d), dtype, dev)
    v = _rand(rng, (b, s, kvh, d), dtype, dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = kfa.lengths_launches
    got = ops.flash_attention(q, k, v, lengths=ln)
    live = ln > 0
    _close(got[live], ref.flash_attention(q, k, v, lengths=ln)[live], dtype)
    assert bool((got[~live] == 0).all())
    assert kfa.lengths_launches == n0 + 1
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.flash_attention(q.requires_grad_(), k, v, lengths=ln)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q.detach(), k, v, lengths=ln.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        kda.decode_attention(q[:, 0].detach().contiguous(), k, v, ln.cpu())


def test_dense_model_on_card_matches_cpu(dev):
    """Reduced stablelm at fp32 over the dense slabs: a batched prefill of
    two ragged prompts and two decode steps on the card (CUDA kernels)
    against the CPU (plain versions), same parameters."""
    cfg = reduced(get_config("stablelm-1.6b"))
    params = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    gparams = _to(params, dev)
    tok = torch.tensor([[5, 9, 2, 77, 3, 3, 41, 0], [8, 1, 6, 0, 0, 0, 0, 0]],
                       dtype=torch.int32)
    lens = torch.tensor([7, 3], dtype=torch.int32)
    logits = {}
    for d, p in (("cpu", params), ("cuda", gparams)):
        state = M.init_decode_state(cfg, 2, 16, dtype=torch.float32, device=d)
        lg, state = M.prefill(cfg, p, state, tokens=tok.to(d), lengths=lens.to(d))
        out = [lg[:, 0]]
        for t in (11, 64):
            toks = torch.tensor([t, t + 1], dtype=torch.int32)
            cur = lens + (t == 64)
            lg, state = M.decode_step(cfg, p, state, toks.to(d), cur.to(d))
            out.append(lg)
        logits[d] = torch.cat([o.cpu() for o in out])
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4, atol=1e-4)


def _wkv_inputs(rng, b, s, h, d, dtype, dev):
    """r, k, v, do in ``dtype``; w = exp(-exp(logit)) f32 with the logit
    clipped to [-12, 4] as ``models/rwkv.py:_decay`` clips it, ~4% of the
    entries at 4, below the 1e-20 clamp; u [H, D] f32."""
    r, k, v, do = (_rand(rng, (b, s, h, d), dtype, dev) for _ in range(4))
    logit = np.clip(rng.uniform(-8.0, 4.5, size=(b, s, h, d)), -12.0, 4.0)
    w = torch.from_numpy(np.exp(-np.exp(logit)).astype(np.float32)).to(dev)
    u = _rand(rng, (h, d), torch.float32, dev, 0.5)
    return r, k, v, w, u, do


def _wkv_close(got, want):
    """Held as the module docstring says (finite, and within the rtol of
    the output's dtype plus 1e-4 of ``want``'s largest entry)."""
    torch.cuda.synchronize()
    got, want = got.detach(), want.detach()
    assert bool(torch.isfinite(got.float()).all())
    rtol = 2 ** -7 if got.dtype == torch.bfloat16 else 1e-4
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-4 * scale)


def _wkv_close_grads(got, want, w):
    """(dr, dk, dv, dw, du) against the plain version's.  dw is dl / w, with
    dl a difference of two running sums: where w is tiny but above the
    1e-20 clamp, both versions' dw is that difference's f32 rounding times
    1 / w.  So dw is held as dl = dw w (what the decay's own gradient,
    d logit = -dl e^logit, uses) and must be exactly 0 where the clamp
    holds."""
    clamped = w <= 1e-20
    assert bool(clamped.any())
    for i, (g, wt) in enumerate(zip(got, want)):
        if i == 3:
            assert not bool(g[clamped].any()) and not bool(wt[clamped].any())
            g, wt = g * w, wt * w
        _wkv_close(g, wt)


# (B, S, H, D): at each head dim an S below one chunk of either route (17,
# 40, 50) and an S of several chunks with a ragged tail (96, 130, 200, 300)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d", [(2, 40, 3, 16), (1, 96, 2, 64),
                                     (2, 17, 2, 64), (1, 130, 4, 32),
                                     (1, 50, 2, 32), (2, 200, 3, 16),
                                     (1, 300, 2, 64)])
def test_rwkv6_kernels(dev, dtype, b, s, h, d):
    """Forward (o, S_final, the chunk-entry states) and backward (dr, dk,
    dv, dw, du) against the plain versions at the route's chunk, ragged S
    included; the backward twice on the same inputs gives the same bits."""
    rng = np.random.default_rng(7)
    r, k, v, w, u, do = _wkv_inputs(rng, b, s, h, d, dtype, dev)
    chunk = kwkv.chunk_of(dtype)
    o, sf, states = kwkv.rwkv6_fwd(r, k, v, w, u, save_states=True)
    want_o, want_sf = ref.rwkv6_scan_chunked(r, k, v, w, u, chunk=chunk)
    _wkv_close(o, want_o)
    _wkv_close(sf, want_sf)
    _wkv_close(states, ref.rwkv6_chunk_states(k, v, w, chunk=chunk))
    got = kwkv.rwkv6_bwd(r, k, v, w, u, do, states)
    want = ref.rwkv6_bwd(r, k, v, w, u, do, chunk=chunk)
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype and g.shape == wt.shape
    _wkv_close_grads(got, want, w)
    again = kwkv.rwkv6_bwd(r, k, v, w, u, do, states)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_rwkv6_routes(dev):
    """A bf16 call runs the tensor-core route (3 CUDA launches forward, 4
    backward), counted in tc_launches / tc_bwd_launches beside the calls;
    an f32 call keeps the CUDA-core kernels and leaves those counts; a
    forward without saved states returns none."""
    rng = np.random.default_rng(11)
    for dtype, tc in ((torch.bfloat16, 1), (torch.float32, 0)):
        r, k, v, w, u, do = _wkv_inputs(rng, 1, 70, 2, 16, dtype, dev)
        before = (kwkv.launches, kwkv.bwd_launches, kwkv.tc_launches,
                  kwkv.tc_bwd_launches)
        assert kwkv.rwkv6_fwd(r, k, v, w, u)[2] is None
        _, _, states = kwkv.rwkv6_fwd(r, k, v, w, u, save_states=True)
        assert states.shape[2] == -(-70 // kwkv.chunk_of(dtype))
        kwkv.rwkv6_bwd(r, k, v, w, u, do, states)
        after = (kwkv.launches, kwkv.bwd_launches, kwkv.tc_launches,
                 kwkv.tc_bwd_launches)
        assert [a - b_ for a, b_ in zip(after, before)] == [2, 1, 2 * tc, tc]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 33, 64, 65, 512])
def test_rwkv6_kernel_from_carried_state(dev, dtype, d, s):
    """The forward from a carried state s0 (recurrent serving) against the
    plain chunked version at the route's chunk and the exact recurrence
    from the same s0, B = 2, the last quarter of the rows right-padded as
    the serving chunk pads them (k = 0, w = 1): o and S_final held as the
    module docstring says; S_final also equal within it to the state after
    the unpadded rows alone; a second call bitwise equal; s0 = 0 gives the
    bits of the zero-state kernel; and the hold fails a result that drops
    s0 (the control)."""
    rng = np.random.default_rng(s + d)
    b, h = 2, 3
    r, k, v, w, u, _ = _wkv_inputs(rng, b, s, h, d, dtype, dev)
    n = s - s // 4                               # valid rows
    k[:, n:] = 0.0
    w[:, n:] = 1.0
    s0 = _rand(rng, (b, h, d, d), torch.float32, dev, 0.5)
    before = (kwkv.launches, kwkv.s0_launches)
    o, sf, _ = kwkv.rwkv6_fwd(r, k, v, w, u, s0=s0)
    assert (kwkv.launches - before[0], kwkv.s0_launches - before[1]) == (1, 1)
    want_o, want_sf = ref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0,
                                             chunk=kwkv.chunk_of(dtype))
    _wkv_close(o, want_o)
    _wkv_close(sf, want_sf)
    if s <= 65:
        for g, wt in zip((o, sf), ref.rwkv6_scan(r, k, v, w, u, s0=s0)):
            _wkv_close(g, wt)
    _wkv_close(sf, ref.rwkv6_scan_chunked(r[:, :n], k[:, :n], v[:, :n], w[:, :n],
                                          u, s0=s0, chunk=kwkv.chunk_of(dtype))[1])
    again = kwkv.rwkv6_fwd(r, k, v, w, u, s0=s0)
    assert torch.equal(o, again[0]) and torch.equal(sf, again[1])
    zero = kwkv.rwkv6_fwd(r, k, v, w, u, s0=torch.zeros_like(s0))
    none = kwkv.rwkv6_fwd(r, k, v, w, u)
    assert torch.equal(zero[0], none[0]) and torch.equal(zero[1], none[1])
    with pytest.raises(AssertionError):         # the first rows read S0
        _wkv_close(none[0], want_o)


def test_rwkv6_carried_state_checks(dev):
    """ops.rwkv6_scan with s0 launches the forward kernel on inputs that
    need no gradient; the wrapper refuses an s0 of the wrong shape or
    dtype, and on the bf16 route one off a 16-byte boundary, before any
    launch."""
    rng = np.random.default_rng(12)
    r, k, v, w, u, _ = _wkv_inputs(rng, 1, 40, 2, 16, torch.bfloat16, dev)
    s0 = _rand(rng, (1, 2, 16, 16), torch.float32, dev)
    before = kwkv.s0_launches
    o, sf = ops.rwkv6_scan(r, k, v, w, u, s0=s0)
    assert kwkv.s0_launches == before + 1
    _wkv_close(o, ref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0, chunk=64)[0])
    off = torch.empty(s0.numel() + 1, device=dev)[1:].view(s0.shape)
    for bad in (s0[:, :1], s0.double(), off):
        with pytest.raises(ValueError):
            kwkv.rwkv6_fwd(r, k, v, w, u, s0=bad)
    assert kwkv.s0_launches == before + 1


def test_rwkv6_autograd_matches_plain_autograd(dev):
    """``ops.rwkv6_scan`` on the card (the Function: kernel forward + kernel
    backward) against autograd of the plain chunked version, fp32; a
    carried state with inputs that require grad raises on the card (its
    kernel is forward only)."""
    rng = np.random.default_rng(8)
    xs = _wkv_inputs(rng, 2, 75, 3, 16, torch.float32, dev)[:5]
    dy = _rand(rng, (2, 75, 3, 16), torch.float32, dev)

    def grads(fn):
        live = [x.detach().requires_grad_() for x in xs]
        o, sf = fn(*live)
        return [o, sf] + list(torch.autograd.grad(o, live, dy))

    got = grads(ops.rwkv6_scan)
    want = grads(lambda *a: ref.rwkv6_scan_chunked(*a, chunk=kwkv.CHUNK))
    for g, wt in zip(got[:2], want[:2]):
        _wkv_close(g, wt)
    _wkv_close_grads(got[2:], want[2:], xs[3])
    live = [x.detach().requires_grad_() for x in xs]
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.rwkv6_scan(*live, s0=torch.zeros((2, 3, 16, 16), device=dev))


def test_rwkv_serving_on_card_matches_cpu(dev):
    """Reduced rwkv6-3b at fp32 (a random nonzero w_b) served on the card
    (the wkv6 kernel from a carried state in 8-token chunks, f32 route)
    against the CPU (plain versions), same parameters: two right-padded
    chunks at slot 1 and a batched decode step from a random mid-stream
    state, logits and every state key within 1e-4; then the engine on both
    paths token-identical to the CPU's on 3 prompts over 2 slots, one
    prefilling in 8-token chunks while the other decodes."""
    cfg = reduced(get_config("rwkv6-3b"))
    params = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    for lp in params["layers"]:
        lp["tm"]["w_b"].copy_(torch.randn(lp["tm"]["w_b"].shape, generator=gen))
    start = {k: torch.randn(v.shape, generator=gen) * (0.3 if k == "wkv" else 1.0)
             for k, v in M.init_serve_state(cfg, 3, 0, 8, dtype=torch.float32,
                                            device="cpu").items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 1, 8), generator=gen, dtype=torch.int32)
    nxt = torch.tensor([5, 9, 11], dtype=torch.int32)
    lens = torch.tensor([4, 10, 2], dtype=torch.int32)
    out = {}
    for d, p in (("cpu", params), ("cuda", _to(params, dev))):
        st = {k: v.to(d, copy=True) for k, v in start.items()}
        got = []
        for n, t in zip((7, 3), toks):
            lg, st = M.serve_prefill_chunk(cfg, p, st, tokens=t.to(d), length=n,
                                           q_offset=0, block_table=None, slot=1)
            got.append(lg.cpu())
        lg, st = M.serve_decode_step(cfg, p, st, nxt.to(d), lens.to(d))
        out[d] = [torch.cat(got + [lg.cpu()])] + [st[k].cpu() for k in M.RWKV_STATE]
    for g, w in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7], list(range(1, 20))]
    kw = dict(max_seq=64, slots=2, prefill_buckets=(8, 16, 64), max_tokens_per_tick=12)
    for paged in (None, False):
        outs = []
        for p in (params, _to(params, dev)):
            eng = ServeEngine(cfg, p, paged=paged, **kw)
            for q in prompts:
                eng.submit(q, max_new_tokens=5)
            outs.append({r.rid: r.out_tokens for r in eng.run_until_drained()})
        assert outs[0] == outs[1], paged


def test_hybrid_serving_on_card_matches_cpu(dev):
    """Reduced zamba2-7b at fp32 served on the card (the Mamba2 kernel from a
    carried state in 8-token chunks, f32 route; the paged kernels at head
    dim 16) against the CPU (plain versions), same parameters: two
    right-padded chunks at slot 1 and q_offset 16 from a random mid-stream
    state (slot state and pages), then a batched decode step; logits and
    every state key within 1e-4; then the engine token-identical to the
    CPU's on 3 prompts over 2 slots, one prefilling in 8-token chunks while
    the other decodes, on the runner path, the slab path, an int8 pool and
    4 sequence shards."""
    cfg = reduced(get_config("zamba2-7b"))
    params = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(4)
    start = M.init_serve_state(cfg, 3, 9, 8, dtype=torch.float32, device="cpu")
    start = {k: ({kk: torch.randn(vv.shape, generator=gen) for kk, vv in v.items()}
                 if k == "attn" else
                 torch.randn(v.shape, generator=gen) * (0.3 if "ssm" in k else 1.0))
             for k, v in start.items()}
    tables = torch.tensor([[1, 4, 0, 0], [3, 5, 2, 7], [6, 0, 0, 0]], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (2, 1, 8), generator=gen, dtype=torch.int32)
    nxt = torch.tensor([5, 9, 11], dtype=torch.int32)
    lens = torch.tensor([9, 26, 2], dtype=torch.int32)
    out = {}
    for d, p in (("cpu", params), ("cuda", _to(params, dev))):
        st = _to(start, d)
        if d == "cpu":                          # the calls update it in place
            st = {k: ({kk: vv.clone() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.clone()) for k, v in st.items()}
        got, qoff = [], 16
        for n, t in zip((7, 3), toks):
            lg, st = M.serve_prefill_chunk(cfg, p, st, tokens=t.to(d), length=n,
                                           q_offset=qoff, block_table=tables[1].to(d),
                                           slot=1)
            got.append(lg.cpu())
            qoff += n
        lg, st = M.serve_decode_step(cfg, p, st, nxt.to(d), lens.to(d), tables.to(d))
        out[d] = [torch.cat(got + [lg.cpu()])] + [
            st[k].cpu() for k in M.HYBRID_STATE] + [st["attn"][k].cpu() for k in
                                                    ("k_pages", "v_pages")]
    for g, w in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7], list(range(1, 20))]
    kw = dict(max_seq=64, slots=2, block_size=8, prefill_buckets=(8, 16, 64),
              max_tokens_per_tick=12)
    for opts in (dict(), dict(paged=False), dict(kv_dtype="int8"), dict(seq_shards=4)):
        outs = []
        for p in (params, _to(params, dev)):
            eng = ServeEngine(cfg, p, **kw, **opts)
            for q in prompts:
                eng.submit(q, max_new_tokens=5)
            outs.append({r.rid: r.out_tokens for r in eng.run_until_drained()})
        assert outs[0] == outs[1], opts


def _idx_to(idx, dev):
    """A ScatterIndex on ``dev`` (its writer entry may be None)."""
    return tuple(None if t is None else t.to(dev) for t in idx)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _mamba_inputs(rng, b, s, h, p, n, dtype, dev):
    """x, B, C, dy in ``dtype``; dt = softplus(N(0, 1)) f32 as the model
    draws it at init (dt_bias = 0); A = -linspace(1, 16, H) f32, the
    init's -exp(A_log)."""
    x, dy = (_rand(rng, (b, s, h, p), dtype, dev) for _ in range(2))
    B, C = (_rand(rng, (b, s, n), dtype, dev) for _ in range(2))
    dt = torch.nn.functional.softplus(_rand(rng, (b, s, h), torch.float32, dev))
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    return x, dt, A, B, C, dy


def _mamba_close(got, want):
    """Finite, and within the rtol of the output's dtype (one bf16 ulp, or
    1e-4 in f32) plus 1e-4 of ``want``'s largest entry."""
    torch.cuda.synchronize()
    got, want = got.detach(), want.detach()
    assert bool(torch.isfinite(got.float()).all())
    rtol = 2 ** -7 if got.dtype == torch.bfloat16 else 1e-4
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n", [(2, 70, 3, 16, 8), (1, 33, 2, 16, 8),
                                       (1, 128, 2, 64, 64), (2, 100, 3, 64, 64),
                                       (2, 200, 20, 64, 64)])
def test_mamba2_kernels(dev, dtype, b, s, h, p, n, monkeypatch):
    """Forward (y, h_final, the chunk-entry states) and backward (dx, ddt,
    dA, dB, dC) against the plain versions, ragged S included; the
    backward twice on the same inputs gives the same bits.  In bf16 the
    backward runs with its plan's head group and with a plan of groups of
    3, which leave a partial last group where 3 does not divide H."""
    rng = np.random.default_rng(9)
    x, dt, A, B, C, dy = _mamba_inputs(rng, b, s, h, p, n, dtype, dev)
    y, hf, states = kmamba.mamba2_fwd(x, dt, A, B, C, save_states=True)
    want_y, want_hf = ref.mamba2_scan(x, dt, A, B, C, chunk=kmamba.CHUNK)
    _mamba_close(y, want_y)
    _mamba_close(hf, want_hf)
    _mamba_close(states, ref.mamba2_chunk_states(x, dt, A, B, chunk=kmamba.CHUNK))
    want = ref.mamba2_bwd(x, dt, A, B, C, dy, chunk=kmamba.CHUNK)
    plans = [kmamba.bwd_plan]
    if dtype == torch.bfloat16:
        plans.append(lambda *a, **k: 3)
    for plan in plans:
        monkeypatch.setattr(kmamba, "bwd_plan", plan)
        got = kmamba.mamba2_bwd(x, dt, A, B, C, dy, states)
        for gt, wt in zip(got, want):
            assert gt.dtype == wt.dtype and gt.shape == wt.shape
            _mamba_close(gt, wt)
        again = kmamba.mamba2_bwd(x, dt, A, B, C, dy, states)
        for gt, a in zip(got, again):
            assert torch.equal(gt, a)


def test_mamba2_bwd_slots(dev):
    """The gradient kernel's resident-block slots, the backward plan's input:
    a whole number of blocks on every SM, for each built (P, N); at
    zamba2-7b's shapes on an H100 (2 blocks an SM) the plan takes groups of
    56 heads, as ``tests/test_torch_mamba_plan.py`` assumes."""
    sms = _build.n_sms(dev)
    for p, n in kmamba.SHAPES:
        slots = kmamba.bwd_slots(dev, p, n)
        assert slots > 0 and slots % sms == 0
    if sms == 132:
        assert kmamba.bwd_slots(dev, 64, 64) == 264
        assert kmamba.bwd_plan(2, 4096, 112, 264) == 56


def test_mamba2_autograd_matches_plain_autograd(dev):
    """``ops.mamba2_scan`` on the card (the Function: kernel forward +
    kernel backward) against autograd of the plain chunked version, fp32;
    a carried state raises on the card.  dA is held to 1e-3 of its largest
    entry: autograd reaches it through running sums of nearly cancelling
    terms (on the CPU it reads 7.1e-5 of the largest entry off the
    explicit backward for these inputs)."""
    rng = np.random.default_rng(10)
    xs = _mamba_inputs(rng, 2, 90, 3, 16, 8, torch.float32, dev)
    dy = xs[5]

    def grads(fn):
        live = [t.detach().requires_grad_() for t in xs[:5]]
        y, hf = fn(*live)
        return [y, hf] + list(torch.autograd.grad(y, live, dy))

    got = grads(ops.mamba2_scan)
    want = grads(lambda *a: ref.mamba2_scan(*a, chunk=kmamba.CHUNK))
    for i, (g, wt) in enumerate(zip(got, want)):
        if i == 4:
            torch.cuda.synchronize()
            assert float((g - wt).abs().max()) <= 1e-3 * float(wt.abs().max())
        else:
            _mamba_close(g, wt)
    live = [t.detach().requires_grad_() for t in xs[:5]]
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.mamba2_scan(*live, h0=torch.zeros((2, 3, 16, 8), device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,n", kmamba.SHAPES)
@pytest.mark.parametrize("s", [1, 33, 64, 65, 512])
def test_mamba2_kernel_from_carried_state(dev, dtype, p, n, s):
    """The forward from a carried state h0 (recurrent serving) against the
    plain chunked version from the same h0, B = 2, the last quarter of the
    rows right-padded as the serving chunk pads them (dt = 0): y and
    h_final held as ``_mamba_close`` holds them; h_final also equal within
    it to the state after the unpadded rows alone; a second call bitwise
    equal; h0 = 0 gives the bits of the zero-state kernel; and the hold
    fails a result that drops h0 (the control)."""
    rng = np.random.default_rng(s + p)
    b, h = 2, 3
    x, dt, A, B, C, _ = _mamba_inputs(rng, b, s, h, p, n, dtype, dev)
    m = s - s // 4                               # valid rows
    dt[:, m:] = 0.0
    h0 = _rand(rng, (b, h, p, n), torch.float32, dev, 0.5)
    before = (kmamba.launches, kmamba.h0_launches, kmamba.states_launches)
    y, hf, states = kmamba.mamba2_fwd(x, dt, A, B, C, h0=h0)
    assert states is None
    assert (kmamba.launches - before[0], kmamba.h0_launches - before[1],
            kmamba.states_launches - before[2]) == (1, 1, 0)
    want_y, want_hf = ref.mamba2_scan(x, dt, A, B, C, h0=h0, chunk=kmamba.CHUNK)
    _mamba_close(y, want_y)
    _mamba_close(hf, want_hf)
    _mamba_close(hf, ref.mamba2_scan(x[:, :m], dt[:, :m], A, B[:, :m], C[:, :m],
                                     h0=h0, chunk=kmamba.CHUNK)[1])
    again = kmamba.mamba2_fwd(x, dt, A, B, C, h0=h0)
    assert torch.equal(y, again[0]) and torch.equal(hf, again[1])
    zero = kmamba.mamba2_fwd(x, dt, A, B, C, h0=torch.zeros_like(h0))
    none = kmamba.mamba2_fwd(x, dt, A, B, C)
    assert torch.equal(zero[0], none[0]) and torch.equal(zero[1], none[1])
    with pytest.raises(AssertionError):         # the first rows read h0
        _mamba_close(none[0], want_y)


def test_mamba2_carried_state_checks(dev):
    """ops.mamba2_scan with h0 launches the forward kernel (no chunk-entry
    states) on inputs that need no gradient; the wrapper refuses an h0 of
    the wrong shape or dtype, one that is not contiguous and one off a
    16-byte boundary, before any launch."""
    rng = np.random.default_rng(13)
    x, dt, A, B, C, _ = _mamba_inputs(rng, 1, 40, 2, 16, 8, torch.bfloat16, dev)
    h0 = _rand(rng, (1, 2, 16, 8), torch.float32, dev)
    before = (kmamba.h0_launches, kmamba.states_launches)
    y, hf = ops.mamba2_scan(x, dt, A, B, C, h0=h0)
    assert (kmamba.h0_launches, kmamba.states_launches) == (before[0] + 1, before[1])
    _mamba_close(y, ref.mamba2_scan(x, dt, A, B, C, h0=h0, chunk=kmamba.CHUNK)[0])
    off = torch.empty(h0.numel() + 1, device=dev)[1:].view(h0.shape)
    strided = torch.empty((1, 2, 16, 16), device=dev)[..., :8]
    for bad in (h0[:, :1], h0.double(), off, strided):
        with pytest.raises(ValueError, match="h0"):
            kmamba.mamba2_fwd(x, dt, A, B, C, h0=bad)
    assert kmamba.h0_launches == before[0] + 1


def _mm_close(got, want):
    """An f32 output to 1e-5 (the same products summed in another order);
    a bf16 output to one bf16 ulp relative (2^-7: both round one f32 sum
    once) plus 1e-5 for sums that cancel towards zero."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    rtol = 2 ** -7 if got.dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-5)


# (m, k, n) in f32 and bf16: the JAX sweep's odd shapes (ragged M, N and K,
# rows that are not 16-byte aligned) and full-width stablelm-1.6b [2048,
# 2048] projections at decode and prefill
MM_SHAPES = [(16, 8, 16), (100, 40, 50), (128, 128, 128), (33, 17, 9),
             (8, 24, 40), (5, 130, 70), (8, 2048, 2048), (512, 2048, 2048)]
# in bf16, shapes for the wgmma route: M 1, 8, 65 and 513 (ragged against
# its 64- and 128-row tiles), N 8, 72 and 100352 (the lm_head), K 40 and
# 5624 (not a multiple of its 64-deep stage)
MM_BF16_SHAPES = [(1, 40, 8), (8, 5624, 72), (65, 40, 72), (513, 5624, 136),
                  (8, 2048, 100352), (65, 2048, 100352)]
MM_CASES = ([(dt, *s) for dt in (torch.float32, torch.bfloat16) for s in MM_SHAPES]
            + [(torch.bfloat16, *s) for s in MM_BF16_SHAPES])


def _mm_routes(x, w):
    """Every bf16 route that can take x @ w, each with the tile the plan
    picks there."""
    k, n = w.shape
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return [r for r in ("wgmma", "mma_sync")
            if r == "mma_sync" or kmm.tma_loadable(k, n, aligned)]


@pytest.mark.parametrize("dtype,m,k,n", MM_CASES)
def test_matmul_kernel(dev, dtype, m, k, n):
    """The weight-stationary GEMM against the plain version at the plan's
    route and tile; two launches give the same bits; bf16 inputs also give
    an f32 output, and every bf16 route that can take the shape (wgmma
    where TMA can load the rows, mma.sync always, on both of its tiles) is
    held and repeated at the same shape."""
    rng = np.random.default_rng(11)
    x = _rand(rng, (m, k), dtype, dev)
    w = _rand(rng, (k, n), dtype, dev, scale=k ** -0.5)
    want = ref.matmul(x, w)
    got = kmm.weight_stationary_matmul(x, w)
    _mm_close(got, want)
    assert torch.equal(got, kmm.weight_stationary_matmul(x, w))
    if dtype == torch.float32:
        return
    _mm_close(kmm.weight_stationary_matmul(x, w, out_dtype=torch.float32),
              ref.matmul(x, w, out_dtype=torch.float32))
    for route in _mm_routes(x, w):
        tiles = kmm.TILES[route] if route == "mma_sync" else (None,)
        for tile in tiles:
            got = kmm.weight_stationary_matmul(x, w, route=route, tile=tile)
            _mm_close(got, want)
            assert torch.equal(got, kmm.weight_stationary_matmul(x, w, route=route,
                                                                 tile=tile))
            _mm_close(kmm.weight_stationary_matmul(x, w, out_dtype=torch.float32,
                                                   route=route, tile=tile),
                      ref.matmul(x, w, out_dtype=torch.float32))


@pytest.mark.parametrize("tile", kmm.TILES["wgmma"])
def test_matmul_wgmma_tiles(dev, tile):
    """Every wgmma tile at a shape ragged in M, N and K against it (M one
    tile and 3 rows, N two tiles and 8 columns, K 200 = three 64-deep
    stages and 8), bf16 and f32 out, twice bitwise equal."""
    bm, bn = tile
    m, k, n = bm + 3, 200, 2 * bn + 8
    rng = np.random.default_rng(14)
    x = _rand(rng, (m, k), torch.bfloat16, dev)
    w = _rand(rng, (k, n), torch.bfloat16, dev, scale=k ** -0.5)
    kmm.wgmma_launches = 0
    got = kmm.weight_stationary_matmul(x, w, route="wgmma", tile=tile)
    _mm_close(got, ref.matmul(x, w))
    assert torch.equal(got, kmm.weight_stationary_matmul(x, w, route="wgmma", tile=tile))
    _mm_close(kmm.weight_stationary_matmul(x, w, out_dtype=torch.float32,
                                           route="wgmma", tile=tile),
              ref.matmul(x, w, out_dtype=torch.float32))
    assert kmm.wgmma_launches == 3


@pytest.mark.parametrize("tile", kmm.TILES["wgmma"])
def test_matmul_wgmma_single_tile_probe(dev, tile):
    """One [64 or 128, 16] @ [16, BN] product on each wgmma tile, with small
    integers so that every product and sum is exact in f32 and in bf16: the
    output must equal the plain version bit for bit, which pins the
    accumulator fragment, the descriptors and the swizzle of both operands
    (a misplaced element changes some sum)."""
    bm, bn = tile
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.integers(-4, 5, size=(bm, 16)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-4, 5, size=(16, bn)).astype(np.float32))
    x, w = x.to(dev).to(torch.bfloat16), w.to(dev).to(torch.bfloat16)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = kmm.weight_stationary_matmul(x, w, out_dtype, route="wgmma", tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.matmul(x, w, out_dtype))


def test_matmul_kernel_unaligned_base(dev):
    """Rows that would take 16-byte loads but start 2 bytes off alignment
    take the mma.sync route (TMA needs 16-byte aligned bases) and its
    guarded scalar path; the wgmma route refuses them."""
    rng = np.random.default_rng(12)
    base = _rand(rng, (40 * 64 + 1,), torch.bfloat16, dev)
    x = base[1:].view(40, 64)
    assert x.data_ptr() % 16 != 0
    w = _rand(rng, (64, 24), torch.bfloat16, dev, scale=0.125)
    kmm.mma_sync_launches = kmm.wgmma_launches = 0
    _mm_close(kmm.weight_stationary_matmul(x, w), ref.matmul(x, w))
    assert (kmm.mma_sync_launches, kmm.wgmma_launches) == (1, 0)
    with pytest.raises(ValueError, match="wgmma route"):
        kmm.weight_stationary_matmul(x, w, route="wgmma")


def test_matmul_routes_by_the_reference_rule(dev):
    """ops.matmul launches the kernel exactly when the reference's rule
    holds, and otherwise computes the library dot in f32; a bf16 pair
    takes the wgmma route, x and w of different dtypes the kernel in f32
    (the FFMA route); each route's counter counts its own launches."""
    rng = np.random.default_rng(13)
    x = _rand(rng, (8, 2048), torch.bfloat16, dev)
    w = _rand(rng, (2048, 512), torch.bfloat16, dev, scale=2048 ** -0.5)
    kmm.launches = kmm.wgmma_launches = kmm.mma_sync_launches = kmm.ffma_launches = 0
    _mm_close(ops.matmul(x, w), ref.matmul(x, w))
    assert kmm.launches == 1 and kmm.wgmma_launches == 1
    _mm_close(ops.matmul(x[None], w), ref.matmul(x[None], w))   # 3-D
    xf = _rand(rng, (8, 5632), torch.float32, dev)
    wf = _rand(rng, (5632, 300), torch.float32, dev, scale=0.01)  # 5.5 MiB
    _mm_close(ops.matmul(xf, wf), ref.matmul(xf, wf))
    assert kmm.launches == 1
    # a mixed pair runs the kernel in f32, as the plain version computes it
    _mm_close(ops.matmul(x, w.float()), ref.matmul(x, w.float()))
    _mm_close(ops.matmul(x.float(), w), ref.matmul(x.float(), w))
    assert kmm.launches == 3
    assert (kmm.wgmma_launches, kmm.mma_sync_launches, kmm.ffma_launches) == (1, 0, 2)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.matmul(x, w.detach().requires_grad_())


# the curry forms in f32, relative only: the kernels take the plain
# version's f32 steps one by one (silu_mul read bitwise equal, rmsnorm a
# few ulps: its mean of squares is summed in another order), while the
# native forms sit up to ~6e-6 (rmsnorm against one Newton step) and ~5e-3
# (silu_mul against six Taylor terms, in the tail of exp) relative away
CURRY_F32_TOL = dict(rtol=2e-6, atol=0.0)


def _curry_close(got, want, dtype):
    if dtype == torch.bfloat16:
        _close(got, want, dtype)
    else:
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **CURRY_F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2048, 5632])
def test_curry_kernels(dev, dtype, d):
    """The Curry-ALU forms of rmsnorm (Newton rsqrt) and silu_mul (Taylor
    exp) against their plain versions at stablelm-1.6b's widths, f32 the
    point (ROADMAP C asks an f32 card test of each new form); in f32 the
    native kernels fail the same hold against the fewest rounds (the
    control); through ops they launch the curry form, forward only."""
    rng = np.random.default_rng(14)
    x = _rand(rng, (3, 7, d), dtype, dev)
    w = _rand(rng, (d,), dtype, dev)
    for rounds in (1, 3):
        _curry_close(krn.rmsnorm(x, w, 1e-5, curry_rounds=rounds),
                     ref.rmsnorm(x, w, 1e-5, curry_rounds=rounds), dtype)
    g = _rand(rng, (5, d), dtype, dev, 3.0)
    u = _rand(rng, (5, d), dtype, dev)
    for rounds in (4, 6, 8):
        _curry_close(ksw.silu_mul(g, u, curry_rounds=rounds),
                     ref.silu_mul(g, u, curry_rounds=rounds), dtype)
    if dtype == torch.float32:
        with pytest.raises(AssertionError):
            _curry_close(krn.rmsnorm(x, w, 1e-5),
                         ref.rmsnorm(x, w, 1e-5, curry_rounds=1), dtype)
        with pytest.raises(AssertionError):
            _curry_close(ksw.silu_mul(g, u), ref.silu_mul(g, u, 6), dtype)
    krn.curry_launches = ksw.curry_launches = 0
    _curry_close(ops.rmsnorm(x, w, curry_rounds=3), ref.rmsnorm(x, w, 1e-5, 3),
                 dtype)
    _curry_close(ops.silu_mul(g, u, curry_rounds=6), ref.silu_mul(g, u, 6), dtype)
    assert krn.curry_launches == 1 and ksw.curry_launches == 1
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.silu_mul(g.requires_grad_(), u, curry_rounds=6)


# ---------------------------------------------------------------------------
# the sequence-sharded pool: skip_null over a shard's view, kv_offset
# ---------------------------------------------------------------------------

SHARDS = 4
SHARD_CASES = [(8, 4, 64, 16), (4, 2, 16, 8), (8, 2, 128, 16),  # H, KvH, D, BS
               (8, 2, 112, 16)]


def _pool(rng, kvh, nb, bs, d, dtype, dev, kind):
    """(k_pages, v_pages, k_scales, v_scales): float pages in ``dtype``, or
    int8 pages with their scales."""
    if kind == "int8":
        k8, ks, v8, vs = _int8_pool(rng, kvh, nb, bs, d, dev)
        return k8, v8, ks, vs
    return (_rand(rng, (kvh, nb, bs, d), dtype, dev),
            _rand(rng, (kvh, nb, bs, d), dtype, dev), None, None)


def _shard_parts_close(got, want, dtype):
    """A skip_null partial against its plain version: m on every row; l and
    acc / l on rows that see a key; on rows that see none the kernel's
    identity (0, -1e30, 0) exactly (the plain version's p = 1 rows differ
    there and weigh nothing in a combine).  Returns the live rows."""
    acc, m, l = got
    wacc, wm, wl = want
    torch.cuda.synchronize()
    live = wm > -1e29
    _close(m, wm, dtype)
    _close(l[live], wl[live], dtype)
    _close((acc / l[..., None])[live], (wacc / wl[..., None])[live], dtype)
    dead = ~live
    assert bool((acc[dead] == 0).all() and (m[dead] == -1e30).all()
                and (l[dead] == 0).all())
    return live


def _counts(mod):
    return (mod.launches, mod.q8_launches, mod.shard_launches,
            mod.shard_q8_launches)


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,bs", SHARD_CASES)
@pytest.mark.parametrize("mb", [6, 256])
def test_sharded_paged_decode_kernel(dev, dtype, kind, h, kvh, d, bs, mb):
    """Four shards placed round-robin by the allocator: each shard's
    skip_null partial over its view of the pool against the plain version
    (sequence 0 has one key, so shards 1-3 give the identity), bitwise
    repeatable and counted as a shard launch; at MB 256 at the split edges
    of the card's plan; the tree combine against the unsharded kernel;
    skip_null over a table with no zero entry bit-equal to skip_null off;
    and the control, the local tables with skip_null off, caught."""
    rng = np.random.default_rng(21)
    lens = ([1, bs, mb * bs, 2 * bs + 3, bs + 1] if mb == 6 else
            _decode_lengths(dev, 8, h, kvh, bs, mb, bs)[:-1])
    b = len(lens)
    # the null page of each shard and the sequences' pages, whole shards
    alloc = BlockAllocator(SHARDS * (1 + -(-(b * mb + 2) // SHARDS)), bs, b, mb,
                           num_shards=SHARDS)
    for s in range(b):
        assert alloc.ensure(s, mb * bs)
    table = torch.from_numpy(alloc.table).to(dev)
    local = torch.from_numpy(alloc.shard_local(alloc.table)).to(dev)
    q = _rand(rng, (b, h, d), dtype, dev)
    kp, vp, ks, vs = _pool(rng, kvh, alloc.num_blocks, bs, d, dtype, dev, kind)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    views = [TL.pool_shards(t, SHARDS) for t in (kp, vp, ks, vs)]
    n = _counts(kda)
    parts, bad, dead = [], [], 0
    for s, (kps, vps, kss, vss) in enumerate(zip(*views)):
        kw = dict(k_scales=kss, v_scales=vss)
        got = _repeat_equal(lambda: kda.paged_decode_attention_partial(
            q, kps, vps, local[s], lens, skip_null=True, **kw))
        want = ref.paged_decode_attention_partial(q, kps, vps, local[s],
                                                  lengths=lens, skip_null=True, **kw)
        dead += int((~_shard_parts_close(got, want, dtype)).sum())
        parts.append(got)
        bad.append(kda.paged_decode_attention_partial(q, kps, vps, local[s], lens,
                                                      **kw))
    assert dead >= 3 * h
    i8 = kind == "int8"
    assert _counts(kda) == (n[0] + SHARDS * (not i8), n[1] + SHARDS * i8,
                            n[2] + 2 * SHARDS * (not i8), n[3] + 2 * SHARDS * i8)
    whole = kda.paged_decode_attention(q, kp, vp, table, lens, ks, vs)
    _close(noc.tree_softmax_combine(parts).to(dtype), whole, dtype)
    control = noc.tree_softmax_combine(bad).to(dtype)
    torch.cuda.synchronize()
    assert not torch.allclose(control.float(), whole.float(), **TOLS[dtype])
    on = kda.paged_decode_attention_partial(q, kp, vp, table, lens, skip_null=True,
                                            k_scales=ks, v_scales=vs)
    off = kda.paged_decode_attention_partial(q, kp, vp, table, lens,
                                             k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(on, off))


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 112, 128])
@pytest.mark.parametrize("mb", [3, 256])
def test_kv_offset_paged_decode_kernel(dev, dtype, kind, d, mb):
    """Key j of the table at global position 40 + j: lengths below, inside
    and past the table's keys (at MB 256, also at the split edges of the
    card's plan), skip_null off and on (one table entry 0 mid-table), each
    launch bitwise repeatable; a row below the offset gives the identity."""
    rng = np.random.default_rng(22)
    h, kvh, bs, off = 8, 2, 16, 40
    lens = [30, 41, 70, 100]
    if mb > 3:
        lens += [off + n for n in _decode_lengths(dev, 11, h, kvh, bs, mb, bs)[1:-1]]
    b = len(lens)
    nb = b * mb + 1
    q = _rand(rng, (b, h, d), dtype, dev)
    kp, vp, ks, vs = _pool(rng, kvh, nb, bs, d, dtype, dev, kind)
    bt = torch.from_numpy(np.stack([rng.permutation(nb - 1)[:mb] + 1
                                    for _ in range(b)]).astype(np.int32)).to(dev)
    bt[2, 1] = 0
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    for skip in (False, True):
        got = _repeat_equal(lambda: kda.paged_decode_attention_partial(
            q, kp, vp, bt, lens, ks, vs, off, skip))
        want = ref.paged_decode_attention_partial(
            q, kp, vp, bt, lengths=lens, kv_offset=off, skip_null=skip,
            k_scales=ks, v_scales=vs)
        live = _shard_parts_close(got, want, dtype)
        assert not bool(live[0].any()) and bool(live[1:].all())


# The decode kernel's tensor-core form: every (head dim, G) that
# _paged.decode_form routes to it among D 64 / 112 / 128 x G 1 / 2 / 3 / 4 / 8
TC_DECODE_CASES = [(d, g) for d in (64, 112, 128) for g in (1, 2, 3, 4, 8)
                   if _paged.decode_form(torch.bfloat16, d, g) == "tc"]
# held as chip_smoke.py holds it: the float pool and the slab to one bf16
# ulp relative plus 4e-3 (DECODE_TOL: the plain version rounds p to bf16,
# the kernel carries it as a hi + lo pair), the int8 pool to one ulp plus
# 1e-5 (Q8_BF16_TOL: the plain int8 version is f32 throughout); m and l of
# the partials to 1e-4 (the same f32 scores summed in another order)
TC_TOL = dict(rtol=2 ** -7, atol=4e-3)
TC_Q8_TOL = dict(rtol=2 ** -7, atol=1e-5)
TC_ML_TOL = dict(rtol=1e-4, atol=1e-4)


def _tc_parts_close(got, want, tol):
    """Tensor-core partials against the plain ones: m on every row; l and
    acc / l on the rows that see a key; the others the identity (0, -1e30,
    0) exactly.  Returns the live rows."""
    acc, m, l = got
    wacc, wm, wl = want
    torch.cuda.synchronize()
    live = wm > -1e29
    torch.testing.assert_close(m, wm, **TC_ML_TOL)
    torch.testing.assert_close(l[live], wl[live], **TC_ML_TOL)
    torch.testing.assert_close((acc / l[..., None])[live],
                               (wacc / wl[..., None])[live], **tol)
    dead = ~live
    assert bool((acc[dead] == 0).all() and (m[dead] == -1e30).all()
                and (l[dead] == 0).all())
    return live


def _normalised(parts, dtype):
    acc, _, l = parts
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def _caught(got, bad, tol):
    torch.cuda.synchronize()
    return not torch.allclose(got.float(), bad.float(), **tol)


@pytest.mark.parametrize("source", ["pool", "int8", "slab"])
@pytest.mark.parametrize("d,g", TC_DECODE_CASES)
def test_decode_tc_form(dev, d, g, source):
    """The tensor-core form (bf16 queries) over a bf16 pool, an int8 pool or
    a bf16 slab, at the split edges of its own plan over 1024 keys:
    normalised output and f32 partials against the plain version, every
    launch twice bitwise equal and counted in ``tc_launches``; skip_null
    with a zero entry mid-table and kv_offset 40 on the pool, two slab
    shards combined and a shard past every length (the identity) on the
    slab.  Controls a wrong kernel gives, each failing the tolerance the
    kernel passes: the last 16 output dims dropped, q head h read against
    kv head h mod KvH (G > 1), the longest sequence's second split
    dropped."""
    rng = np.random.default_rng(37)
    bf = torch.bfloat16
    kvh, bs, mb, off = 2, 16, 64, 40
    h, keys = kvh * g, mb * bs
    pool, int8 = source != "slab", source == "int8"
    grain = bs if pool else _paged.TC_STAGE_KEYS
    plan = _paged.tc_decode_plan(9, kvh, g, d, keys, grain)
    e = plan.split_keys
    assert plan.n_split > 1
    lens = [keys, 1, bs - 1, bs + 1, e - 1, e, e + 1, 2 * e + bs, keys - 1]
    b = len(lens)
    q = _rand(rng, (b, h, d), bf, dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    tol = TC_Q8_TOL if int8 else TC_TOL
    wrong = torch.arange(h, device=dev) % kvh
    n0 = kda.tc_launches
    if pool:
        kp, vp, ks, vs, bt = _decode_pool(rng, dev, b, mb, b * mb + 4, kvh, bs, d,
                                          bf, int8)
        kw = dict(k_scales=ks, v_scales=vs)
        got = _repeat_equal(lambda: kda.paged_decode_attention(q, kp, vp, bt, ln, **kw))
        want = ref.paged_decode_attention(q, kp, vp, bt, lengths=ln, **kw)
        parts = _repeat_equal(
            lambda: kda.paged_decode_attention_partial(q, kp, vp, bt, ln, **kw))
        _tc_parts_close(parts, ref.paged_decode_attention_partial(
            q, kp, vp, bt, lengths=ln, **kw), tol)
        # skip_null and kv_offset: one zero entry mid-table, key j at 40 + j,
        # a row below the offset (the identity)
        bz = bt.clone()
        bz[0, 3] = 0
        lo = torch.cat([ln[:-1] + off, torch.tensor([30], dtype=torch.int32, device=dev)])
        for skip in (False, True):
            sp = _repeat_equal(lambda: kda.paged_decode_attention_partial(
                q, kp, vp, bz, lo, kv_offset=off, skip_null=skip, **kw))
            live = _tc_parts_close(sp, ref.paged_decode_attention_partial(
                q, kp, vp, bz, lengths=lo, kv_offset=off, skip_null=skip, **kw), tol)
            assert not bool(live[-1].any()) and bool(live[:-2].all())
        assert kda.tc_launches == n0 + 8
        bad_group = ref.paged_decode_attention(q, kp[wrong], vp[wrong], bt, lengths=ln,
                                               **(dict(k_scales=ks[wrong], v_scales=vs[wrong])
                                                  if int8 else {}))
        cut = bt.clone()
        cut[0, e // bs:2 * e // bs] = 0
        bad_split = _normalised(ref.paged_decode_attention_partial(
            q, kp, vp, cut, lengths=ln, skip_null=True, **kw), bf)
    else:
        k = _rand(rng, (b, keys, kvh, d), bf, dev)
        v = _rand(rng, (b, keys, kvh, d), bf, dev)
        got = _repeat_equal(lambda: kda.decode_attention(q, k, v, ln))
        want = ref.decode_attention(q, k, v, lengths=ln)
        _tc_parts_close(_repeat_equal(lambda: kda.decode_attention_partial(q, k, v, ln)),
                        ref.decode_attention_partial(q, k, v, lengths=ln), tol)
        half = keys // 2
        k1, v1, k2, v2 = (t.contiguous() for t in (k[:, :half], v[:, :half],
                                                   k[:, half:], v[:, half:]))
        comb = ref.combine_partials(kda.decode_attention_partial(q, k1, v1, ln),
                                    kda.decode_attention_partial(q, k2, v2, ln, half))
        _tc_parts_close(comb, ref.decode_attention_partial(q, k, v, lengths=ln), tol)
        empty = kda.decode_attention_partial(q, k2, v2, ln, keys)
        torch.cuda.synchronize()
        assert bool((empty[0] == 0).all() and (empty[1] == -1e30).all()
                    and (empty[2] == 0).all())
        assert kda.tc_launches == n0 + 7
        bad_group = ref.decode_attention(q, k[:, :, wrong], v[:, :, wrong], lengths=ln)
        valid = torch.arange(keys, device=dev)[None, :] < ln[:, None]
        valid[0, e:2 * e] = False
        bad_split = _normalised(ref.decode_attention_partial(
            q, k, v, lengths=ln, kv_valid=valid), bf)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    dropped = got.clone()
    dropped[..., -16:] = 0
    assert _caught(dropped, want, tol)
    if g > 1:
        assert _caught(got, bad_group, tol)
    assert _caught(got[0], bad_split[0], tol)


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,bs,c", [(8, 8, 64, 16, 40), (6, 2, 16, 8, 11),
                                          (8, 2, 128, 16, 33), (8, 2, 112, 16, 33)])
def test_sharded_paged_prefill_kernel(dev, dtype, kind, h, kvh, d, bs, c):
    """A chunk's skip_null partials per shard over bucketed prefix slices of
    a round-robin table, causal on global positions (the first chunk's
    early rows see no key of shards 1-3), against the plain version; the
    tree combine against the unsharded kernel; the skip-off control
    caught."""
    rng = np.random.default_rng(23)
    mb = 8
    alloc = BlockAllocator(SHARDS + mb, bs, 1, mb, num_shards=SHARDS)
    assert alloc.ensure(0, mb * bs)
    q = _rand(rng, (1, c, h, d), dtype, dev)
    kp, vp, ks, vs = _pool(rng, kvh, alloc.num_blocks, bs, d, dtype, dev, kind)
    views = [TL.pool_shards(t, SHARDS) for t in (kp, vp, ks, vs)]
    n = _counts(kpf)
    for qoff, ln in [(0, c), (bs + 3, c), (3 * bs - 2, 1)]:
        n_live = -(-(qoff + ln) // bs)
        bt = alloc.table[0, :min(1 << max(n_live - 1, 0).bit_length(), mb)]
        local = torch.from_numpy(alloc.shard_local(bt)).to(dev)
        kw = dict(q_offset=qoff, length=ln)
        parts, bad = [], []
        for s, (kps, vps, kss, vss) in enumerate(zip(*views)):
            qkw = dict(kw, k_scales=kss, v_scales=vss)
            got = kpf.paged_prefill_attention_partial(q, kps, vps, local[s],
                                                      skip_null=True, **qkw)
            want = ref.paged_prefill_attention_partial(q, kps, vps, local[s],
                                                       skip_null=True, **qkw)
            live = _shard_parts_close([a[0, :ln] for a in got],
                                      [w[0, :ln] for w in want], dtype)
            if qoff == 0 and s > 0:
                assert not bool(live[:min(bs * s, ln)].any())
            parts.append(got)
            bad.append(kpf.paged_prefill_attention_partial(q, kps, vps, local[s],
                                                           **qkw))
        whole = kpf.paged_prefill_attention(
            q, kp, vp, torch.from_numpy(bt.copy()).to(dev), k_scales=ks,
            v_scales=vs, **kw)
        _close(noc.tree_softmax_combine(parts).to(dtype)[0, :ln], whole[0, :ln],
               dtype)
        control = noc.tree_softmax_combine(bad).to(dtype)[0, :ln]
        torch.cuda.synchronize()
        assert not torch.allclose(control.float(), whole[0, :ln].float(),
                                  **TOLS[dtype])
    i8 = kind == "int8"
    assert _counts(kpf)[2:] == (n[2] + 3 * SHARDS * (not i8), n[3] + 3 * SHARDS * i8)


# The bf16 paged prefill (its tensor-core form: 64-row tiles, 64-key stages).
# (H, KvH, D, BS, C, q_offset): GQA 4:1 with C x G ragged (84 rows: a 20-row
# tail tile), its first chunk (shards 1-3 own none of tile 0's keys); MHA over
# 150 rows at BS 8 (a stage spans 8 pages); BS 128 (a page spans two
# stages) at a mid-page offset; offsets of 2048 keys at BS 16 and 8; head
# dim 112 (7 k-steps and 14 n-tiles, 2 ring stages) ragged and MHA.
TC_PREFILL_CASES = [(8, 2, 64, 16, 21, 37), (8, 2, 64, 16, 21, 0),
                    (4, 4, 128, 8, 150, 5), (8, 2, 16, 128, 40, 100),
                    (8, 2, 64, 16, 64, 2048), (6, 2, 128, 8, 33, 2048 + 3),
                    (8, 2, 112, 16, 21, 37), (4, 4, 112, 8, 150, 256)]
# a bf16 output to one bf16 ulp relative plus chip_smoke.py's PREFILL_TOL
# term; f32 partials from bf16 operands to the f32 sums' order (P enters P V
# as a bf16 hi + lo pair, ~2^-17 relative)
TC_OUT_TOL = dict(rtol=2 ** -7, atol=2e-3)
TC_PARTS_TOL = dict(rtol=1e-3, atol=1e-4)


def _parts_close(got, want, tol):
    """Partials on the rows that see a key (m, l, acc / l); the others must
    be the identity (0, -1e30, 0).  Returns the live rows."""
    acc, m, l = got
    wacc, wm, wl = want
    torch.cuda.synchronize()
    live = wm > -1e29
    torch.testing.assert_close(m[live], wm[live], **tol)
    torch.testing.assert_close(l[live], wl[live], **tol)
    torch.testing.assert_close((acc / l[..., None])[live],
                               (wacc / wl[..., None])[live], **tol)
    dead = ~live
    assert bool((acc[dead] == 0).all() and (m[dead] == -1e30).all()
                and (l[dead] == 0).all())
    return live


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("h,kvh,d,bs,c,qoff", TC_PREFILL_CASES)
def test_paged_prefill_tc_kernel(dev, kind, h, kvh, d, bs, c, qoff):
    """The bf16 form over a whole table, output and partials, against the
    plain version; each launch bitwise repeatable and counted as a bf16
    launch of its pool."""
    rng = np.random.default_rng(25)
    bf = torch.bfloat16
    mb = -(-(qoff + c) // bs) + 1
    nb = mb + 3
    q = _rand(rng, (1, c, h, d), bf, dev)
    kp, vp, ks, vs = _pool(rng, kvh, nb, bs, d, bf, dev, kind)
    bt = torch.from_numpy((rng.permutation(nb - 1)[:mb] + 1).astype(np.int32)).to(dev)
    n, tc = _counts(kpf), kpf.tc_launches
    for ln in (c, c - 3):
        kw = dict(q_offset=qoff, length=ln, k_scales=ks, v_scales=vs)
        got = _repeat_equal(lambda: kpf.paged_prefill_attention(q, kp, vp, bt, **kw))
        want = ref.paged_prefill_attention(q, kp, vp, bt, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TC_OUT_TOL)
        parts = _repeat_equal(
            lambda: kpf.paged_prefill_attention_partial(q, kp, vp, bt, **kw))
        live = _parts_close(parts, ref.paged_prefill_attention_partial(
            q, kp, vp, bt, **kw), TC_PARTS_TOL)
        assert bool(live.all())
    i8 = kind == "int8"
    assert _counts(kpf) == (n[0] + 8 * (not i8), n[1] + 8 * i8, n[2], n[3])
    assert kpf.tc_launches == tc + 8


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("h,kvh,d,bs,c,qoff", TC_PREFILL_CASES)
def test_sharded_paged_prefill_tc_kernel(dev, kind, h, kvh, d, bs, c, qoff):
    """The bf16 form over each shard's view of a round-robin pool with its
    local table (skip_null: only the owned pages are walked), against the
    plain version; a shard that owns no page of a tile gives the identity;
    each launch bitwise repeatable; the tree combine against the unsharded
    kernel."""
    rng = np.random.default_rng(26)
    bf = torch.bfloat16
    total = qoff + c
    mb = -(-total // bs) + 1
    alloc = BlockAllocator(SHARDS * (-(-mb // SHARDS) + 2), bs, 1, mb,
                           num_shards=SHARDS)
    assert alloc.ensure(0, total)
    q = _rand(rng, (1, c, h, d), bf, dev)
    kp, vp, ks, vs = _pool(rng, kvh, alloc.num_blocks, bs, d, bf, dev, kind)
    local = torch.from_numpy(alloc.shard_local(alloc.table[0])).to(dev)
    n, tc = _counts(kpf), kpf.tc_launches
    kw = dict(q_offset=qoff, length=c)
    parts, dead = [], 0
    for s, (kps, vps, kss, vss) in enumerate(zip(*(TL.pool_shards(t, SHARDS)
                                                   for t in (kp, vp, ks, vs)))):
        skw = dict(kw, skip_null=True, k_scales=kss, v_scales=vss)
        got = _repeat_equal(lambda: kpf.paged_prefill_attention_partial(
            q, kps, vps, local[s], **skw))
        live = _parts_close(got, ref.paged_prefill_attention_partial(
            q, kps, vps, local[s], **skw), TC_PARTS_TOL)
        dead += int((~live).sum())
        parts.append(got)
    if qoff == 0:
        assert dead >= 2 * c * h      # shards 2 and 3 own no key of the chunk
    whole = kpf.paged_prefill_attention(
        q, kp, vp, torch.from_numpy(alloc.table[0].copy()).to(dev), k_scales=ks,
        v_scales=vs, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(noc.tree_softmax_combine(parts).to(bf).float(),
                               whole.float(), **TC_OUT_TOL)
    i8 = kind == "int8"
    assert _counts(kpf)[2:] == (n[2] + 2 * SHARDS * (not i8), n[3] + 2 * SHARDS * i8)
    assert kpf.tc_launches == tc + 2 * SHARDS + 1


def test_paged_prefill_tc_refuses_unaligned(dev):
    """The bf16 form reads q and the pages by 16-byte cp.async: a tensor that
    starts off a 16-byte boundary is refused, not misread."""
    rng = np.random.default_rng(27)
    bf = torch.bfloat16
    kp, vp, _, _ = _pool(rng, 2, 6, 16, 64, bf, dev, "float")
    bt = torch.arange(1, 5, dtype=torch.int32, device=dev)
    buf = _rand(rng, (1 + 9 * 8 * 64,), bf, dev)
    q = buf[1:].view(1, 9, 8, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kpf.paged_prefill_attention(q, kp, vp, bt, q_offset=0, length=9)


@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"])
def test_sharded_engine_on_card_matches_cpu(dev, kv_dtype):
    """Reduced stablelm at fp32 through ServeEngine(seq_shards=4): greedy
    tokens on the card equal the CPU's and the card's at one shard (a
    shared prefix with a mid-page copy-on-write across shards); on the
    card every attention call is a skip_null launch."""
    cfg = reduced(get_config("stablelm-1.6b"))
    params = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    gparams = _to(params, dev)
    rng = np.random.default_rng(24)
    prefix = rng.integers(2, cfg.vocab_size, 20).tolist()
    prompts = [list(range(2, 50)), [42], prefix + [9], prefix + [11],
               list(range(2, 50))]
    kw = dict(max_seq=64, slots=3, prefill_buckets=(8, 16, 32), block_size=8,
              kv_dtype=kv_dtype)

    def drain(p, shards):
        eng = ServeEngine(cfg, p, seq_shards=shards, **kw)
        for x in prompts:
            eng.submit(x, max_new_tokens=5)
        out = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        return out, eng.stats

    before = _counts(kda) + _counts(kpf)
    card, stats = drain(gparams, SHARDS)
    after = _counts(kda) + _counts(kpf)
    assert after[:2] == before[:2] and after[4:6] == before[4:6]
    assert stats["cow_copies"] >= 1
    assert card == drain(params, SHARDS)[0] == drain(gparams, 1)[0]


# ---------------------------------------------------------------------------
# rmsnorm and rope: the 16-byte vector routes, the scalar routes, q + k in
# one launch.  Kernel and plain version round one f32 result once and differ
# only in the order of rmsnorm's sum of squares (rope: the contraction of
# its products), so a bf16 output is held to one bf16 ulp relative plus 1e-5
# for results that cancel towards zero; f32 to 1e-5.
# ---------------------------------------------------------------------------

ULP_TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
NORM_ROWS = (1, 8, 512, 8192)
NORM_WIDTHS = (64, 2048, 2560, 3584, 7168, 8192)
ROPE_HEAD_DIMS = (16, 64, 112, 128)


def _ulp_close(got, want, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ULP_TOLS[dtype])


def _routes(module):
    return dict(module.launches_by_route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", NORM_WIDTHS)
def test_rmsnorm_vector_route(dev, dtype, d):
    """Every row count of the plan's shapes at one width: the vector route,
    held, twice bitwise equal, and the curry form at 1 and 3 rounds."""
    rng = np.random.default_rng(30)
    w = _rand(rng, (d,), dtype, dev)
    before = _routes(krn)
    for rows in NORM_ROWS:
        x = _rand(rng, (rows, d), dtype, dev)
        got = krn.rmsnorm(x, w, 1e-5)
        _ulp_close(got, ref.rmsnorm(x, w, 1e-5), dtype)
        assert torch.equal(got, krn.rmsnorm(x, w, 1e-5))
        for rounds in (1, 3):
            _curry_close(krn.rmsnorm(x, w, 1e-5, curry_rounds=rounds),
                         ref.rmsnorm(x, w, 1e-5, curry_rounds=rounds), dtype)
    after = _routes(krn)
    assert after["vector"] - before["vector"] == 4 * len(NORM_ROWS)
    assert after["scalar"] == before["scalar"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_scalar_route(dev, dtype):
    """An odd width and a view off a 16-byte boundary take the scalar
    route and agree with the plain version."""
    rng = np.random.default_rng(31)
    before = _routes(krn)
    for rows, d in ((8, 2049), (512, 2050), (3, 6)):
        x, w = _rand(rng, (rows, d), dtype, dev), _rand(rng, (d,), dtype, dev)
        got = krn.rmsnorm(x, w, 1e-5)
        _ulp_close(got, ref.rmsnorm(x, w, 1e-5), dtype)
        assert torch.equal(got, krn.rmsnorm(x, w, 1e-5))
    base = _rand(rng, (512 * 2048 + 1,), dtype, dev)
    x = base[1:].view(512, 2048)
    w = _rand(rng, (2048,), dtype, dev)
    assert x.is_contiguous() and x.data_ptr() % 16
    _ulp_close(krn.rmsnorm(x, w, 1e-5), ref.rmsnorm(x, w, 1e-5), dtype)
    _curry_close(krn.rmsnorm(x, w, 1e-5, curry_rounds=3),
                 ref.rmsnorm(x, w, 1e-5, curry_rounds=3), dtype)
    after = _routes(krn)
    assert after["scalar"] - before["scalar"] == 8
    assert after["vector"] == before["vector"]


def _rope_grads(q, k, pos, dq, dk):
    qs, ks = q.detach().requires_grad_(), k.detach().requires_grad_()
    return torch.autograd.grad((ref.apply_rope(qs, pos), ref.apply_rope(ks, pos)),
                               (qs, ks), (dq, dk))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", ROPE_HEAD_DIMS)
def test_rope_qk_kernel(dev, dtype, hd):
    """q and k (H 32 / KvH 8 and 24 / 8) in one launch at a prefill
    chunk, decode and a training batch, positions up to 4096: held, twice
    bitwise equal, bitwise equal to the one-tensor launch; [S] positions;
    sign -1 against autograd of the plain version."""
    rng = np.random.default_rng(32)
    before = _routes(krope), krope.qk_launches
    n = 0
    for (h, kvh), (b, s) in [((32, 8), (1, 512)), ((32, 8), (8, 1)),
                             ((24, 8), (2, 300)), ((24, 8), (8, 1))]:
        q = _rand(rng, (b, s, h, hd), dtype, dev)
        k = _rand(rng, (b, s, kvh, hd), dtype, dev)
        pos = torch.from_numpy(rng.integers(0, 4097, size=(b, s)).astype(np.int32)).to(dev)
        gq, gk = krope.apply_rope_qk(q, k, pos)
        _ulp_close(gq, ref.apply_rope(q, pos), dtype)
        _ulp_close(gk, ref.apply_rope(k, pos), dtype)
        again = krope.apply_rope_qk(q, k, pos)
        assert torch.equal(gq, again[0]) and torch.equal(gk, again[1])
        assert torch.equal(gq, krope.apply_rope(q, pos))
        assert torch.equal(gk, krope.apply_rope(k, pos))
        p1 = pos[0].contiguous()
        gq1, gk1 = krope.apply_rope_qk(q, k, p1)
        _ulp_close(gq1, ref.apply_rope(q, p1), dtype)
        _ulp_close(gk1, ref.apply_rope(k, p1), dtype)
        dq, dk = _rand(rng, q.shape, dtype, dev), _rand(rng, k.shape, dtype, dev)
        wq, wk = _rope_grads(q, k, pos, dq, dk)
        gq, gk = krope.apply_rope_qk(dq, dk, pos, sign=-1)
        _ulp_close(gq, wq, dtype)
        _ulp_close(gk, wk, dtype)
        _ulp_close(krope.apply_rope(dq, pos, sign=-1), wq, dtype)
        n += 1
    after = _routes(krope), krope.qk_launches
    assert after[0]["vector"] - before[0]["vector"] == 7 * n
    assert after[0]["scalar"] == before[0]["scalar"]
    assert after[1] - before[1] == 4 * n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_scalar_route(dev, dtype):
    """A head dim that is not a multiple of the vector and q off a 16-byte
    boundary take the scalar route and agree with the plain version."""
    rng = np.random.default_rng(33)
    before = _routes(krope)
    q = _rand(rng, (2, 9, 4, 6), dtype, dev)
    k = _rand(rng, (2, 9, 2, 6), dtype, dev)
    pos = torch.from_numpy(rng.integers(0, 4097, size=(2, 9)).astype(np.int32)).to(dev)
    gq, gk = krope.apply_rope_qk(q, k, pos)
    _ulp_close(gq, ref.apply_rope(q, pos), dtype)
    _ulp_close(gk, ref.apply_rope(k, pos), dtype)
    base = _rand(rng, (1 * 512 * 32 * 64 + 1,), dtype, dev)
    q = base[1:].view(1, 512, 32, 64)
    k = _rand(rng, (1, 512, 8, 64), dtype, dev)
    pos = torch.arange(256, 768, dtype=torch.int32, device=dev)[None]
    gq, gk = krope.apply_rope_qk(q, k, pos)
    _ulp_close(gq, ref.apply_rope(q, pos), dtype)
    _ulp_close(gk, ref.apply_rope(k, pos), dtype)
    dq = _rand(rng, (q.numel() + 1,), dtype, dev)[1:].view(q.shape)
    dk = _rand(rng, k.shape, dtype, dev)
    wq, wk = _rope_grads(q, k, pos, dq, dk)
    gq, gk = krope.apply_rope_qk(dq, dk, pos, sign=-1)
    _ulp_close(gq, wq, dtype)
    _ulp_close(gk, wk, dtype)
    after = _routes(krope)
    assert after["scalar"] - before["scalar"] == 3
    assert after["vector"] == before["vector"]


# ---------------------------------------------------------------------------
# silu_mul's 16-byte streams and the rmsnorm backward's rows in registers:
# the vector routes at the shapes the serving and training paths give them,
# element counts and widths off the vector, views off a 16-byte boundary
# (the scalar routes), bitwise reruns.  silu_mul rounds the same f32 values
# as the plain version; the backward sums in another order (dw over its
# blocks' partials), so f32 holds dx to 1e-5 and dw to BWD_TOL, bf16 both to
# TOLS.
# ---------------------------------------------------------------------------

# silu_mul: decode's hidden, a prefill chunk's, a training batch's, the
# gated norm's width and odd element counts, within one wave of the card's
# threads (the element route) and past it (the vector route)
SILU_SHAPES = ((8, 5632), (512, 5632), (8192, 8192), (3, 7168), (40, 7168),
               (5, 5631), (61, 5631))
BWD_NORM_ROWS = (1, 8, 600, 8192)
BWD_NORM_WIDTHS = (64, 2048, 2560, 3584, 7168)


def _bwd_close(got, want, dtype):
    _close(got[0], want[0], dtype)
    torch.testing.assert_close(got[1].float(), want[1].float(),
                               **(BWD_TOL if dtype == torch.float32 else TOLS[dtype]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_silu_mul_vector_and_element_routes(dev, dtype):
    """Each shape on the route its plan gives (the odd counts past one
    wave: whole vectors, then the last elements one a thread), held, twice
    bitwise equal; the curry form at 6 and 8 rounds."""
    rng = np.random.default_rng(40)
    before = _routes(ksw)
    want = {"vector": 0, "element": 0, "scalar": 0}
    for shape in SILU_SHAPES:
        g = _rand(rng, shape, dtype, dev, 3.0)
        u = _rand(rng, shape, dtype, dev)
        route = ksw.plan(g.numel(), g.element_size(), True, _build.n_sms(dev)).route
        got = ksw.silu_mul(g, u)
        _close(got, ref.silu_mul(g, u), dtype)
        assert torch.equal(got, ksw.silu_mul(g, u))
        want[route] += 2
        if shape[0] <= 512:
            for rounds in (6, 8):
                _curry_close(ksw.silu_mul(g, u, curry_rounds=rounds),
                             ref.silu_mul(g, u, curry_rounds=rounds), dtype)
            want[route] += 2
        del g, u, got
    after = _routes(ksw)
    assert {k: after[k] - before[k] for k in want} == want
    assert want["vector"] and want["element"] and not want["scalar"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_silu_mul_scalar_route(dev, dtype):
    """gate or up off a 16-byte boundary takes the scalar route and agrees
    with the plain version, native and curry; the backward beside it."""
    rng = np.random.default_rng(41)
    before = _routes(ksw)
    n = 512 * 5632
    g = _rand(rng, (n + 1,), dtype, dev, 3.0)[1:].view(512, 5632)
    u = _rand(rng, (512, 5632), dtype, dev)
    assert g.is_contiguous() and g.data_ptr() % 16
    for gate, up in ((g, u), (u, g)):
        got = ksw.silu_mul(gate, up)
        _close(got, ref.silu_mul(gate, up), dtype)
        assert torch.equal(got, ksw.silu_mul(gate, up))
    _curry_close(ksw.silu_mul(g, u, curry_rounds=6), ref.silu_mul(g, u, 6), dtype)
    dy = _rand(rng, (512, 5632), dtype, dev)
    for a, b_ in zip(ksw.silu_mul_bwd(g, u, dy), ref.silu_mul_bwd(g, u, dy)):
        _close(a, b_, dtype)
    after = _routes(ksw)
    assert after["scalar"] - before["scalar"] == 5
    assert after["vector"] == before["vector"] and after["element"] == before["element"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", BWD_NORM_WIDTHS)
def test_rmsnorm_bwd_vector_route(dev, dtype, d):
    """Every row count at one width: the vector route, dx and dw held, twice
    bitwise equal."""
    rng = np.random.default_rng(42)
    w = _rand(rng, (d,), dtype, dev)
    before = dict(krn.bwd_launches_by_route)
    for rows in BWD_NORM_ROWS:
        x = _rand(rng, (rows, d), dtype, dev)
        dy = _rand(rng, (rows, d), dtype, dev)
        got = krn.rmsnorm_bwd(x, w, dy, 1e-5)
        _bwd_close(got, ref.rmsnorm_bwd(x, w, dy, 1e-5), dtype)
        again = krn.rmsnorm_bwd(x, w, dy, 1e-5)
        assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
        del x, dy, got, again
    after = krn.bwd_launches_by_route
    assert after["vector"] - before["vector"] == 2 * len(BWD_NORM_ROWS)
    assert after["scalar"] == before["scalar"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_scalar_route(dev, dtype):
    """Odd widths and an x off a 16-byte boundary take the scalar route
    (several rows a block at the narrow width) and agree with the plain
    version, twice bitwise equal; through autograd too."""
    rng = np.random.default_rng(43)
    before = dict(krn.bwd_launches_by_route)
    for rows, d in ((8, 2049), (600, 2050), (3, 6), (8192, 2049)):
        x, w = _rand(rng, (rows, d), dtype, dev), _rand(rng, (d,), dtype, dev)
        dy = _rand(rng, (rows, d), dtype, dev)
        got = krn.rmsnorm_bwd(x, w, dy, 1e-5)
        _bwd_close(got, ref.rmsnorm_bwd(x, w, dy, 1e-5), dtype)
        assert all(torch.equal(a, b_) for a, b_ in zip(got, krn.rmsnorm_bwd(x, w, dy, 1e-5)))
    x = _rand(rng, (600 * 2048 + 1,), dtype, dev)[1:].view(600, 2048)
    w = _rand(rng, (2048,), dtype, dev)
    dy = _rand(rng, (600, 2048), dtype, dev)
    assert x.is_contiguous() and x.data_ptr() % 16
    _bwd_close(krn.rmsnorm_bwd(x, w, dy, 1e-5), ref.rmsnorm_bwd(x, w, dy, 1e-5), dtype)
    xs = x.detach().requires_grad_()
    ws = w.detach().requires_grad_()
    got = torch.autograd.grad(ops.rmsnorm(xs, ws, eps=1e-5), (xs, ws), dy)
    _bwd_close(got, ref.rmsnorm_bwd(x, w, dy, 1e-5), dtype)
    after = krn.bwd_launches_by_route
    assert after["scalar"] - before["scalar"] == 10
    assert after["vector"] == before["vector"]


# ---------------------------------------------------------------------------
# MoE serving: silu_mul at the routed experts' 3-D shapes, and one MoE layer
# at full width on the card against the CPU
# ---------------------------------------------------------------------------

# [E_pad, cap, moe_d_ff] of olmoe-1b-7b: a decode step of 8 slots (cap 4,
# 262144 elements, within one wave: the element route) and a 512-row
# prefill chunk (cap 80: the vector route)
EXPERT_SILU_SHAPES = {(64, 4, 1024): "element", (64, 80, 1024): "vector",
                      # one of olmoe's 4 expert shards (rows 5ep / 5epd)
                      (16, 4, 1024): "element", (16, 80, 1024): "vector"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(EXPERT_SILU_SHAPES))
def test_silu_mul_expert_shapes(dev, dtype, shape):
    """ops.silu_mul on the experts' [E_pad, cap, ff] (a 3-D input, made
    contiguous and sized by element count) on the route its plan gives,
    held to one ulp relative plus 1e-5 (f32: 1e-5), twice bitwise equal."""
    rng = np.random.default_rng(42)
    g = _rand(rng, shape, dtype, dev, 3.0)
    u = _rand(rng, shape, dtype, dev)
    assert ksw.plan(g.numel(), g.element_size(), True,
                    _build.n_sms(dev)).route == EXPERT_SILU_SHAPES[shape]
    before = _routes(ksw)
    got = ops.silu_mul(g, u)
    _ulp_close(got, ref.silu_mul(g, u), dtype)
    assert got.shape == shape and torch.equal(got, ops.silu_mul(g, u))
    after = _routes(ksw)
    assert after[EXPERT_SILU_SHAPES[shape]] - before[EXPERT_SILU_SHAPES[shape]] == 2


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_moe_apply_on_card_matches_cpu(dev, arch):
    """One MoE layer at the config's full width (olmoe-1b-7b: d 2048, 64
    experts of 1024, top 8; qwen2-moe-a2.7b: 60 experts padded to 64, of
    1408, top 4, 4 shared) in f32 on the card against the CPU, same
    parameters: 40 rows leaning towards expert 0 at the default capacity
    factor, so the dispatch drops; the routing (each assignment's buffer
    row, the kept set) equal, the gates and the output within 1e-4."""
    from repro_torch.models import moe as TMOE

    cfg = get_config(arch)
    p = TMOE.moe_init(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                      device="cpu")
    rng = np.random.default_rng(43)
    c = rng.normal(size=cfg.d_model).astype(np.float32)
    x = rng.normal(size=(1, 40, cfg.d_model)).astype(np.float32) + 2.0 * c / np.linalg.norm(c)
    p["router"][:, 0] += torch.from_numpy(c / np.linalg.norm(c))
    xs = torch.from_numpy(x)
    out = {}
    for d in ("cpu", dev):
        pd, xd = _to(p, d), xs.to(d)
        e_pad = pd["router"].shape[1]
        cap = TMOE.capacity(40, cfg.top_k, cfg.capacity_factor, e_pad)
        r = TMOE.route(pd, xd[0], cfg, cap)
        y, aux = TMOE.moe_apply(pd, xd, cfg, return_stats=True)
        out[str(d)] = (r.slot.cpu(), r.keep.cpu(), r.gates.cpu(), y.cpu(),
                       aux["expert_load"].cpu(), float(aux["frac_dropped"]))
        del pd
    (s0, k0, g0, y0, l0, f0), (s1, k1, g1, y1, l1, f1) = out["cpu"], out["cuda"]
    assert torch.equal(s0, s1) and torch.equal(k0, k1) and torch.equal(l0, l1)
    assert f0 == f1 > 0 and not l0[cfg.n_experts:].any()
    torch.testing.assert_close(g1, g0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_ep_moe_layer_on_card_matches_cpu(dev, arch):
    """The expert-parallel dispatch at 4 shards on one MoE layer at the
    config's full width in f32 (the rows of the test above), on the card
    against the CPU and against the card's unsharded dispatch: the drops
    and loads equal, the output within 1e-4; the shards' banks are views
    (the card's storage, no copy)."""
    from repro_torch.models import moe as TMOE

    cfg = get_config(arch)
    p = TMOE.moe_init(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                      device="cpu")
    rng = np.random.default_rng(44)
    c = rng.normal(size=cfg.d_model).astype(np.float32)
    x = rng.normal(size=(1, 40, cfg.d_model)).astype(np.float32) + 2.0 * c / np.linalg.norm(c)
    p["router"][:, 0] += torch.from_numpy(c / np.linalg.norm(c))
    xs = torch.from_numpy(x)
    out = {}
    for d in ("cpu", dev):
        pd, xd = _to(p, d), xs.to(d)
        y, aux = TMOE.moe_apply(pd, xd, cfg, return_stats=True, expert_parallel=4)
        y1, aux1 = TMOE.moe_apply(pd, xd, cfg, return_stats=True)
        for bank in TMOE.expert_shards(pd, 4):
            assert bank["w_up"].untyped_storage().data_ptr() == \
                pd["w_up"].untyped_storage().data_ptr()
        assert torch.equal(aux["expert_load"], aux1["expert_load"])
        assert float(aux["frac_dropped"]) == float(aux1["frac_dropped"]) > 0
        torch.testing.assert_close(y, y1, rtol=1e-4, atol=1e-4)
        out[str(d)] = (y.cpu(), aux["expert_load"].cpu(), float(aux["frac_dropped"]))
        del pd
    (y0, l0, f0), (y1, l1, f1) = out["cpu"], out["cuda"]
    assert torch.equal(l0, l1) and f0 == f1
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"])
def test_disagg_handoff_on_card_matches_cpu(dev, kv_dtype):
    """Reduced stablelm-1.6b at fp32 through a ``DisaggServer`` on the card
    and on the CPU: tokens and the handoff ledger equal, and equal to the
    card's monolithic engine; one handoff staged by hand through the pinned
    arena comes back bit for bit in the decode pool (an int8 pool's scales
    too)."""
    from repro_torch.serve import DisaggServer

    cfg = reduced(get_config("stablelm-1.6b"))
    params = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    kw = dict(max_seq=64, slots=2, block_size=8, prefill_buckets=(16, 64),
              kv_dtype=kv_dtype)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in (14, 27, 9, 22)]
    res = {}
    for d in ("cpu", dev):
        srv = DisaggServer(cfg, _to(params, d), **kw)
        for p in prompts:
            srv.submit(p, max_new_tokens=6)
        out = {r.rid: r.out_tokens for r in srv.run_until_drained()}
        res[str(d)] = (out, {k: srv.stats[k] for k in (
            "handoffs", "handoff_pages", "handoff_cached_pages", "handoff_bytes",
            "arena_stalls")}, srv._arena._k.is_pinned())
    mono = ServeEngine(cfg, _to(params, dev), **kw)
    for p in prompts:
        mono.submit(p, max_new_tokens=6)
    want = {r.rid: r.out_tokens for r in mono.run_until_drained()}
    assert res["cpu"][:2] == res["cuda"][:2] and res["cuda"][0] == want
    assert res["cuda"][2] and not res["cpu"][2]

    srv = DisaggServer(cfg, _to(params, dev), **kw)
    srv.submit(prompts[1], max_new_tokens=4)
    pre = srv.prefill
    while not pre.poll_handoffs():
        pre.step()
    (slot,) = pre.poll_handoffs()
    n = -(-int(pre.lengths[slot]) // pre.block_size)
    ids = torch.as_tensor(pre.alloc.table[slot, :n].astype(np.int64), device=dev)
    before = [t.clone() for t in pre.runner.extract_pages(pre.state, ids)
              if t is not None]
    handle = pre.stage_handoff(slot, srv._get_arena())
    srv.decode.submit_handoff(handle)
    srv.decode._admit()
    dec = srv.decode
    ids = torch.as_tensor(dec.alloc.table[0, :n].astype(np.int64), device=dev)
    after = [t for t in dec.runner.extract_pages(dec.state, ids) if t is not None]
    assert len(before) == len(after) == (4 if kv_dtype == "int8" else 2)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


# ---------------------------------------------------------------------------
# preemption and swap: the page round trip through pinned host memory, the
# ordered K/V scatter, and an engine under page pressure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_swap_arena_round_trip_through_pinned_memory(dev, quantized):
    """Pages gathered from a card pool by ``extract_kv_pages``, parked in a
    ``SwapArena`` (pinned host slabs: the device-to-host copies complete
    when ``write`` returns) and written back into other pages through
    ``read`` and ``insert_kv_pages`` come back bit for bit, an int8 pool's
    scales too; the pool's other pages are untouched."""
    from repro_torch.serve.swap import SwapArena

    rng = np.random.default_rng(50)
    a, kvh, nb, bs, hd = 3, 2, 12, 16, 64
    if quantized:
        att = {k: torch.from_numpy(rng.integers(-127, 128, (a, kvh, nb, bs, hd))
                                   .astype(np.int8)).to(dev)
               for k in ("k_pages", "v_pages")}
        att.update({k: torch.from_numpy(rng.uniform(0.1, 2, (a, kvh, nb))
                                        .astype(np.float32)).to(dev)
                    for k in ("k_scales", "v_scales")})
    else:
        att = {k: _rand(rng, (a, kvh, nb, bs, hd), torch.bfloat16, dev)
               for k in ("k_pages", "v_pages")}
    state = {"attn": att}
    before = {k: t.clone() for k, t in att.items()}
    src = torch.tensor([5, 2, 9], device=dev)
    got = M.extract_kv_pages(state, src)
    arena = SwapArena(4, (a, kvh, bs, hd), torch.int8 if quantized else torch.bfloat16,
                      quantized=quantized, device=dev)
    assert arena._k.is_pinned()
    h = arena.alloc(3)
    arena.write(h.slots, *[None if t is None else t.movedim(2, 0).contiguous()
                           for t in got])
    for t in got:                        # the device copies may be reused now
        if t is not None:
            t.zero_()
    parked = arena.read(h.slots)
    dst = torch.tensor([7, 3, 11], device=dev)
    M.insert_kv_pages(state, dst, *[t.movedim(0, 2) for t in parked])
    torch.cuda.synchronize()
    for key, t in att.items():
        assert torch.equal(t[:, :, dst], before[key][:, :, src]), key
        keep = torch.ones(nb, dtype=torch.bool, device=dev)
        keep[dst] = False
        assert torch.equal(t[:, :, keep], before[key][:, :, keep]), key


def test_ordered_scatter_matches_cpu(dev):
    """The K/V scatter with duplicate targets (idle decode rows at row 0 of
    the null page; a prefill chunk's padding rows) on the card gives the
    CPU's bytes, the last writer's in index order, at bf16 and f32, twice
    alike; so does the int8 decode scatter's whole-page write."""
    rng = np.random.default_rng(51)
    kvh, nb, bs, hd = 4, 10, 16, 64
    tables = torch.tensor([[3, 0, 0], [0, 0, 0], [5, 2, 0], [0, 0, 0],
                           [0, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([2, 0, 21, 0, 0], dtype=torch.int32)
    cases = [(TL.decode_scatter_index(lens, tables, bs), 5),
             (TL.prefill_scatter_index(torch.tensor([4, 6], dtype=torch.int32), 7,
                                       9, 64, bs), 64)]
    for dtype in (torch.float32, torch.bfloat16):
        for idx, n in cases:
            pages = _rand(rng, (kvh, nb, bs, hd), dtype, "cpu")
            rows = _rand(rng, (n, kvh, hd), dtype, "cpu")
            want = pages.clone()
            TL._scatter(want, idx, rows)
            outs = []
            for _ in range(2):
                got = pages.to(dev)
                TL._scatter(got, _idx_to(idx, dev), rows.to(dev))
                outs.append(got.cpu())
            assert torch.equal(outs[0], want) and torch.equal(outs[1], want)
    idx = cases[0][0]
    pages = torch.from_numpy(rng.integers(-127, 128, (kvh, nb, bs, hd)).astype(np.int8))
    scales = torch.from_numpy(rng.uniform(0.01, 0.05, (kvh, nb)).astype(np.float32))
    row = _rand(rng, (5, kvh, hd), torch.float32, "cpu")
    want_p, want_s = pages.clone(), scales.clone()
    TL._decode_scatter_quant(want_p, want_s, idx, row)
    got_p, got_s = pages.to(dev), scales.to(dev)
    TL._decode_scatter_quant(got_p, got_s, _idx_to(idx, dev), row.to(dev))
    assert torch.equal(got_s.cpu(), want_s)
    assert (got_p.cpu().int() - want_p.int()).abs().max() <= 1   # one int8 step


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_engine_under_pressure_on_card_matches_cpu(dev, policy):
    """Reduced stablelm-1.6b at fp32 over 10 usable pages (the granite mix
    of tests/test_torch_preemption.py): the card engine token-identical to
    the CPU engine with the same preemption statistics, and to the
    unpressured card run."""
    cfg = reduced(get_config("stablelm-1.6b"))
    params = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    kw = dict(max_seq=64, slots=2, block_size=8, prefill_buckets=(16, 64))
    reqs = [list(range(1, 13)), list(range(5, 17))]

    def drain(p, **extra):
        eng = ServeEngine(cfg, p, **kw, **extra)
        for r in reqs:
            eng.submit(r, max_new_tokens=40)
        out = {r.rid: r.out_tokens for r in eng.run_until_drained(max_ticks=600)}
        return out, eng.stats

    gpu_params = _to(params, dev)
    base, _ = drain(gpu_params)
    got, gst = drain(gpu_params, num_blocks=11, preempt_policy=policy)
    want, cst = drain(params, num_blocks=11, preempt_policy=policy)
    assert got == want == base and gst["preemptions"] >= 1
    for k in ("preemptions", "preempt_swaps", "preempt_recomputes", "swap_bytes",
              "preempted_tokens", "restored_tokens", "decode_tokens"):
        assert gst[k] == cst[k], k



# ---------------------------------------------------------------------------
# MoE training: the silu_mul backward on the routed experts' 3-D tensor, the
# reduced model's gradients on the card against the CPU, and the engine's
# expert telemetry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 80, 1024), (8, 37, 32)])
def test_silu_mul_bwd_expert_shapes(dev, dtype, shape):
    """The silu_mul backward on an experts' [E_pad, cap, ff] (olmoe's
    prefill-chunk cap, and a reduced model's ragged one) against its plain
    version, directly and through autograd of ``ops.silu_mul``, twice
    bitwise equal; one backward launch a call."""
    rng = np.random.default_rng(44)
    g = _rand(rng, shape, dtype, dev, 3.0)
    u = _rand(rng, shape, dtype, dev)
    dy = _rand(rng, shape, dtype, dev)
    want = ref.silu_mul_bwd(g, u, dy)
    n0 = ksw.bwd_launches
    got = ksw.silu_mul_bwd(g, u, dy)
    _bwd_close(got, want, dtype)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, ksw.silu_mul_bwd(g, u, dy)))
    gs, us = g.detach().requires_grad_(), u.detach().requires_grad_()
    auto = torch.autograd.grad(ops.silu_mul(gs, us), (gs, us), dy)
    assert all(torch.equal(a, b_) for a, b_ in zip(auto, got))
    assert ksw.bwd_launches - n0 == 3


def test_moe_train_gradients_on_card_match_cpu(dev):
    """Reduced olmoe-1b-7b at fp32: the loss's routing on the card equal to
    the CPU's in every layer's forward and remat recompute (so a flip
    would show as a flip), then the loss and every gradient leaf within
    1e-4 of the leaf's largest entry."""
    from repro_torch import tree as T
    from repro_torch.data import SyntheticLM
    from repro_torch.models import moe as TMOE
    from repro_torch.train import step as TS

    cfg = reduced(get_config("olmoe-1b-7b"))
    params = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = SyntheticLM(cfg.vocab_size, 64, 4, seed=1).batch(0)
    grad_fn = TS.value_and_grad(TS.make_loss_fn(cfg))
    route, out = TMOE.route, {}
    for d in ("cpu", dev):
        seen = []

        def recorded(*args):
            r = route(*args)
            seen.append(r.slot.cpu())
            return r
        TMOE.route = recorded
        try:
            (loss, met), grads = grad_fn(_to(params, d), {
                k: torch.from_numpy(v).to(d) for k, v in batch.items()})
        finally:
            TMOE.route = route
        out[str(d)] = (seen, float(loss), [g.cpu() for g in T.leaves(grads)])
    (r0, l0, g0), (r1, l1, g1) = out["cpu"], out["cuda"]
    assert len(r0) == len(r1) == 2 * cfg.n_layers
    for i, (a, b_) in enumerate(zip(r0, r1)):
        assert torch.equal(a, b_), f"routing {i} differs"
    assert abs(l0 - l1) <= 1e-4
    for (path, _), a, b_ in zip(T.leaves_with_paths(params), g1, g0):
        assert float((a - b_).abs().max() / b_.abs().max().clamp_min(1e-30)) <= 1e-4, path


def test_engine_expert_telemetry_on_card_matches_cpu(dev):
    """``ServeEngine(expert_cache_size=4)`` on reduced olmoe-1b-7b at fp32:
    the card engine token-identical to the CPU engine with every
    ``expert_*`` stat equal and the cache's residents equal."""
    cfg = reduced(get_config("olmoe-1b-7b"))
    params = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    kw = dict(max_seq=64, slots=2, block_size=8, prefill_buckets=(8, 16, 64),
              max_tokens_per_tick=12, expert_cache_size=4)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7], list(range(1, 20))]
    res = {}
    for d in ("cpu", dev):
        eng = ServeEngine(cfg, _to(params, d), **kw)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        out = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        res[str(d)] = (out, {k: v for k, v in eng.stats.items() if k.startswith("expert_")},
                       [eng.expert_cache.residents(li) for li in range(cfg.n_layers)])
    (o0, s0, c0), (o1, s1, c1) = res["cpu"], res["cuda"]
    assert o0 == o1 and c0 == c1 and set(s0) == set(s1)
    for k in s0:
        np.testing.assert_array_equal(np.asarray(s1[k]), np.asarray(s0[k]), err_msg=k)
    assert s0["expert_routed_tokens"] > 0 and s0["expert_migrations"] > 0


# the windowed paged prefill (row 2w): (H, KvH, D, BS, C, q_offset, window)
WINDOW_CASES = [(8, 8, 64, 16, 150, 100, 40),     # late rows see none of keys 0-127
                (8, 2, 64, 16, 150, 100, 1),      # each row itself only
                (8, 2, 112, 16, 70, 33, 20),
                (8, 2, 128, 8, 150, 0, 64),       # a window inside the chunk
                (4, 4, 128, 128, 90, 300, 130)]   # a page of 128 keys


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,bs,c,qoff,window", WINDOW_CASES)
def test_windowed_paged_prefill_kernel(dev, dtype, kind, h, kvh, d, bs, c, qoff, window):
    """The paged prefill's window on both forms and pools against the plain
    version on the valid rows (whole chunk, and 3 padding rows), each launch
    bitwise repeatable and counted in ``window_launches``; a window past
    every key gives the unwindowed kernel's bits; the unwindowed kernel (a
    kernel that ignores the window) fails the hold."""
    rng = np.random.default_rng(29)
    mb = -(-(qoff + c) // bs) + 1
    nb = mb + 3
    q = _rand(rng, (1, c, h, d), dtype, dev)
    kp, vp, ks, vs = _pool(rng, kvh, nb, bs, d, dtype, dev, kind)
    bt = torch.from_numpy((rng.permutation(nb - 1)[:mb] + 1).astype(np.int32)).to(dev)
    tol = TC_OUT_TOL if dtype == torch.bfloat16 else TOLS[torch.float32]
    n0 = kpf.window_launches
    for ln in (c, c - 3):
        kw = dict(q_offset=qoff, length=ln, k_scales=ks, v_scales=vs)
        got = _repeat_equal(lambda: kpf.paged_prefill_attention(
            q, kp, vp, bt, window=window, **kw))
        want = ref.paged_prefill_attention(q, kp, vp, bt, window=window, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0, :ln].float(), want[0, :ln].float(), **tol)
        blind = kpf.paged_prefill_attention(q, kp, vp, bt, **kw)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(blind[0, :ln].float(), want[0, :ln].float(), **tol)
        wide = kpf.paged_prefill_attention(q, kp, vp, bt, window=qoff + c + 1, **kw)
        torch.cuda.synchronize()
        assert torch.equal(wide, blind)
    assert kpf.window_launches == n0 + 6
    torch.testing.assert_close(
        ops.paged_prefill_attention(q, kp, vp, bt, q_offset=qoff, length=c,
                                    window=window, k_scales=ks, v_scales=vs)[0],
        ref.paged_prefill_attention(q, kp, vp, bt, q_offset=qoff, length=c,
                                    window=window, k_scales=ks, v_scales=vs)[0],
        **tol)
    assert kpf.window_launches == n0 + 7
    with pytest.raises(ValueError, match="positive"):
        kpf.paged_prefill_attention(q, kp, vp, bt, q_offset=qoff, length=c, window=0)


def test_windowed_model_prefill_on_card_matches_cpu(dev):
    """Reduced stablelm-1.6b at fp32: three ``serve_prefill_chunk`` calls at
    ``attn_window`` 5 on the card against the CPU, every attention a
    windowed kernel launch."""
    cfg = reduced(get_config("stablelm-1.6b"))
    params = M.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    prompt = torch.arange(3, 24) % cfg.vocab_size
    out = {}
    n0 = kpf.window_launches
    for d in ("cpu", dev):
        p = _to(params, d)
        state = M.init_serve_state(cfg, 1, 12, 8, dtype=torch.float32, device=d)
        table = torch.tensor([3, 7, 1, 9], dtype=torch.int32, device=d)
        res = []
        for off in range(0, 21, 8):
            n = min(8, 21 - off)
            tok = torch.zeros((1, 8), dtype=torch.int64)
            tok[0, :n] = prompt[off:off + n]
            lg, state = M.serve_prefill_chunk(cfg, p, state, tokens=tok.to(d),
                                              length=n, q_offset=off,
                                              block_table=table, attn_window=5)
            res.append(lg.cpu())
        out[str(d)] = torch.cat(res)
    assert kpf.window_launches == n0 + 3 * cfg.n_layers
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)


def test_isa_machine_on_card_matches_cpu(dev):
    """The ISA's Machine on CUDA buffers against the CPU: the softmax
    program (fused and unfused bitwise equal on the card; card vs CPU to the
    order of two f32 sums), the rope program and every exchange mode bit for
    bit, the bank reduce under ``max=``."""
    from repro_torch.core import isa

    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.normal(size=(16, 512)).astype(np.float32))
    for rounds in (6, 8):
        yf, pf = isa.softmax_execute(x.to(dev), rounds, True)
        yu, pu = isa.softmax_execute(x.to(dev), rounds, False)
        yc, pc = isa.softmax_execute(x, rounds, True)
        torch.cuda.synchronize()
        assert torch.equal(yf, yu)
        assert (pf.n_packets(), pf.alu_ops()) == (pc.n_packets(), pc.alu_ops())
        torch.testing.assert_close(yf.cpu(), yc, rtol=1e-5, atol=0)
    R = isa.RowInstr
    bufs = {"x": x, "w": torch.from_numpy(rng.normal(size=(16, 512)).astype(np.float32))}
    for prog in ([R("NoC_Exchange", m, "x", "y", off, g)]
                 for m, off, g in (("R+", 1, 2), ("R-", 3, 4), ("T+", 1, 4), ("T-", 2, 8))):
        prog = prog + [R("NoC_Reduce", "max=", "y", "r", None, 2),
                       R("DRAM_EWMUL", None, "y", "z", None, "w")]
        plan = isa.lower(prog)
        card = isa.Machine({k: v.to(dev) for k, v in bufs.items()}).run(plan)
        cpu = isa.Machine(dict(bufs)).run(plan)
        for key in ("y", "r", "z"):
            assert torch.equal(card[key].cpu(), cpu[key]), key
    cos = torch.from_numpy(rng.normal(size=(16, 512)).astype(np.float32))
    sin = torch.from_numpy(rng.normal(size=(16, 512)).astype(np.float32))
    yc, _ = isa.rope_execute(x, cos, sin)
    yd, _ = isa.rope_execute(x.to(dev), cos.to(dev), sin.to(dev))
    assert torch.equal(yd.cpu(), yc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_internvl_gqa2_hd128_slab_kernels(dev, dtype):
    """internvl2-2b's attention (16 heads over 8 kv heads of 128: G = 2) on
    the slab decode and the flash forward with lengths."""
    rng = np.random.default_rng(31)
    h, kvh, d = 16, 8, 128
    q = _rand(rng, (4, h, d), dtype, dev)
    k = _rand(rng, (4, 700, kvh, d), dtype, dev)
    v = _rand(rng, (4, 700, kvh, d), dtype, dev)
    ln = torch.tensor([700, 1, 64, 513], dtype=torch.int32, device=dev)
    _close(_repeat_equal(lambda: kda.decode_attention(q, k, v, ln)),
           ref.decode_attention(q, k, v, lengths=ln), dtype)
    qf = _rand(rng, (2, 300, h, d), dtype, dev)
    kf, vf = k[:2, :300].contiguous(), v[:2, :300].contiguous()
    lf = torch.tensor([300, 263], dtype=torch.int32, device=dev)
    _close(ops.flash_attention(qf, kf, vf, lengths=lf),
           ref.flash_attention(qf, kf, vf, lengths=lf), dtype)
