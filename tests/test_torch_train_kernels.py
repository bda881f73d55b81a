"""Port parity, training kernels: the plain PyTorch versions of the
flash-attention forward (with ``window``) and of the backward passes in
repro_torch.kernels.ref against the JAX oracles (repro.kernels.ref), the
Pallas flash-attention kernel run with ``interpret=True``, and ``jax.vjp``
of the oracles -- what the JAX package differentiates -- on the same numpy
inputs at fp32, within 1e-5.  Each backward is also held to torch.autograd
of the port's own plain forward.  Plus the host-side checks of the new CUDA
wrappers that the CPU can reach."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import swiglu as tsw  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, S, H, KvH, D, causal, window): GQA and MHA, S not a multiple of the
# 16-row blocks used below, windows shorter than S
CASES = [
    (2, 37, 4, 2, 16, True, None),
    (2, 37, 4, 2, 16, True, 9),
    (1, 50, 4, 4, 16, True, 16),
    (1, 50, 8, 2, 32, False, None),
    (1, 45, 4, 1, 16, False, 11),
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **{**TOL, **kw})


def _qkv(rng, b, s, h, kvh, d):
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kvh, d)).astype(np.float32),
            rng.normal(size=(b, s, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_matches_jax_and_pallas(rng, case):
    b, s, h, kvh, d, causal, window = case
    q, k, v = _qkv(rng, b, s, h, kvh, d)
    got = tref.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window, block_k=16)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jref.flash_attention(jq, jk, jv, causal=causal, window=window))
    _close(got, jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    block_q=16, block_k=16, interpret=True))
    # the CPU path of ops is the plain version, exactly
    _close(ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window), tref.flash_attention(
        _t(q), _t(k), _t(v), causal=causal, window=window), rtol=0, atol=0)


@pytest.mark.parametrize("case", CASES[:3])
def test_flash_attention_lse(rng, case):
    """The lse variant returns the same output and logsumexp of the masked
    scaled scores per (batch, head, row)."""
    b, s, h, kvh, d, causal, window = case
    q, k, v = _qkv(rng, b, s, h, kvh, d)
    o, lse = tref.flash_attention_lse(_t(q), _t(k), _t(v), causal=causal,
                                      window=window, block_k=16)
    _close(o, tref.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                   window=window, block_k=16), rtol=0, atol=0)
    kh = np.repeat(k, h // kvh, axis=2)
    sc = np.einsum("bqhd,bkhd->bhqk", q, kh) / np.sqrt(d)
    qp, kp = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = (kp <= qp) if causal else np.ones((s, s), bool)
    if window is not None:
        mask &= kp > qp - window
    sc = np.where(mask, sc, -np.inf)
    want = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) + sc.max(-1)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    _close(lse, want)


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_bwd_matches_jax_vjp(rng, case):
    b, s, h, kvh, d, causal, window = case
    q, k, v = _qkv(rng, b, s, h, kvh, d)
    do = rng.normal(size=(b, s, h, d)).astype(np.float32)
    o, lse = tref.flash_attention_lse(_t(q), _t(k), _t(v), causal=causal,
                                      window=window, block_k=16)
    got = tref.flash_attention_bwd(_t(q), _t(k), _t(v), o, lse, _t(do),
                                   causal=causal, window=window, block_k=16)
    _, vjp = jax.vjp(lambda a, bb, c: jref.flash_attention(
        a, bb, c, causal=causal, window=window), *map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        _close(g, w)
    # and autograd of the port's own plain forward
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    out = tref.flash_attention(*xs, causal=causal, window=window, block_k=16)
    for g, w in zip(got, torch.autograd.grad(out, xs, _t(do))):
        _close(g, w.detach())


def test_rmsnorm_bwd_matches_jax_vjp(rng):
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    dy = rng.normal(size=(3, 5, 64)).astype(np.float32)
    dx, dw = tref.rmsnorm_bwd(_t(x), _t(w), _t(dy), 1e-5)
    _, vjp = jax.vjp(lambda a, bb: jref.rmsnorm(a, bb, 1e-5), jnp.asarray(x),
                     jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    _close(dx, jdx)
    _close(dw, jdw)
    xs = [_t(x).requires_grad_(), _t(w).requires_grad_()]
    tdx, tdw = torch.autograd.grad(tref.rmsnorm(*xs, 1e-5), xs, _t(dy))
    _close(dx, tdx)
    _close(dw, tdw)


def test_silu_mul_bwd_matches_jax_vjp(rng):
    g = (3 * rng.normal(size=(7, 96))).astype(np.float32)
    u = rng.normal(size=(7, 96)).astype(np.float32)
    dy = rng.normal(size=(7, 96)).astype(np.float32)
    dg, du = tref.silu_mul_bwd(_t(g), _t(u), _t(dy))
    _, vjp = jax.vjp(jref.silu_mul, jnp.asarray(g), jnp.asarray(u))
    jdg, jdu = vjp(jnp.asarray(dy))
    _close(dg, jdg)
    _close(du, jdu)
    xs = [_t(g).requires_grad_(), _t(u).requires_grad_()]
    tdg, tdu = torch.autograd.grad(tref.silu_mul(*xs), xs, _t(dy))
    _close(dg, tdg)
    _close(du, tdu)


def test_silu_mul_bwd_rounds_like_the_forward(rng):
    """In bf16 the backward equals autograd of the plain forward, whose
    rounding point (silu rounded to up's dtype) it follows."""
    g = torch.from_numpy((3 * rng.normal(size=(4, 64))).astype(np.float32)).bfloat16()
    u = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32)).bfloat16()
    dg, du = tref.silu_mul_bwd(g, u, dy)
    xs = [g.clone().requires_grad_(), u.clone().requires_grad_()]
    tdg, tdu = torch.autograd.grad(tref.silu_mul(*xs), xs, dy)
    assert torch.equal(du, tdu)
    torch.testing.assert_close(dg, tdg, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("max_pos", [64, 4096])
def test_rope_vjp_is_rope_at_negative_positions(rng, max_pos):
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    dy = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, max_pos, size=(2, 9)).astype(np.int32)
    got = tref.apply_rope(_t(dy), -_t(pos))
    _, vjp = jax.vjp(lambda a: jref.apply_rope(a, jnp.asarray(pos)),
                     jnp.asarray(x))
    _close(got, vjp(jnp.asarray(dy))[0])
    xt = _t(x).requires_grad_()
    (want,) = torch.autograd.grad(tref.apply_rope(xt, _t(pos)), xt, _t(dy))
    _close(got, want)


def test_new_cuda_wrappers_refuse_cpu_tensors(rng):
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, k)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(q, k, k, q, lse, q)
    x, w = torch.zeros(3, 16), torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA"):
        trn.rmsnorm_bwd(x, w, x)
    with pytest.raises(ValueError, match="CUDA"):
        tsw.silu_mul_bwd(x, x, x)


def test_flash_wrapper_shape_checks():
    """What the wrapper refuses before it would hand pointers over."""
    k = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="query heads"):
        tfa.flash_attention_fwd(torch.zeros(1, 8, 4, 16), k, k)
    k = torch.zeros(1, 8, 2, 80)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_fwd(torch.zeros(1, 8, 4, 80), k, k)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd(torch.zeros(1, 8, 4, 16), k, k,
                                torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4),
                                torch.zeros(1, 8, 4, 16))
