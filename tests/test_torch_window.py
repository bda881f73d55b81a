"""Port parity, ``attn_window`` through the paged serve functions.

Reduced stablelm-1.6b at fp32 with the JAX package's parameters carried
over: ``serve_prefill_chunk`` over three chunks of a 21-token prompt
(right-padded, growing ``q_offset``) at windows that cut the prefix (3 and
11 keys, the chunk being 8), then ``serve_decode_step`` with the same
window, each against the JAX package's, logits within 1e-4 and every page
but the null page within 1e-4.  The paged decode accepts the window and
ignores it on both sides (the reference's paged decode never reads it), so
a windowed step equals an unwindowed one; the windowed prefill differs from
the unwindowed one (the window is not a no-op).  A windowed prefill over a
sequence-sharded pool raises, as in the reference.

The kernel API on the CPU: ``ops.paged_prefill_attention(window=)`` against
the JAX package's (both the plain flash attention over the gathered pages)
and against ``ref.paged_prefill_attention(window=)``, the plain version the
card's kernel is held to, over a float and an int8 pool, at windows that
leave a chunk's late rows no key of its first pages.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import prefill_attention as tpf  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
BS, NB, MB, CHUNK = 8, 12, 4, 8
TABLE = np.array([[3, 7, 1, 9], [2, 5, 0, 0]], np.int32)
# the JAX references' programs are tiny and their compiles take most of
# their time: XLA's cheapest compile
JIT = dict(compiler_options={"xla_backend_optimization_level": 0,
                             "xla_llvm_disable_expensive_passes": True})


@pytest.fixture(scope="module")
def pair():
    cfg = reduced(get_config("stablelm-1.6b"))
    jparams = jax.jit(lambda key: JM.init_params(cfg, key, dtype=jnp.float32),
                      **JIT)(jax.random.key(0))
    return cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


@functools.lru_cache(maxsize=None)
def _jax_fns(window):
    """JAX's serve functions at one window, jitted once a module."""
    cfg = reduced(get_config("stablelm-1.6b"))
    pre = jax.jit(functools.partial(JM.serve_prefill_chunk, cfg,
                                    attn_window=window), **JIT)
    dec = jax.jit(functools.partial(JM.serve_decode_step, cfg,
                                    attn_window=window), **JIT)
    return pre, dec


def _serve(pair, window, side):
    """Three prefill chunks of slot 0's prompt, then one decode step of
    both slots (slot 1 holds 5 tokens), through one package's serve
    functions; returns (prefill logits, decode logits, pages) as numpy."""
    cfg, jparams, tparams = pair
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, size=21).astype(np.int32)
    side_j = side == "jax"
    state = (JM.init_serve_state(cfg, 2, NB, BS, dtype=jnp.float32) if side_j
             else TM.init_serve_state(cfg, 2, NB, BS, dtype=torch.float32,
                                      device="cpu"))
    pre = []
    for off in range(0, len(prompt), CHUNK):
        n = min(CHUNK, len(prompt) - off)
        tok = np.zeros((1, CHUNK), np.int32)
        tok[0, :n] = prompt[off:off + n]
        tbl = TABLE[0]
        if side_j:
            lg, state = _jax_fns(window)[0](
                jparams, state, tokens=jnp.asarray(tok), length=jnp.int32(n),
                q_offset=jnp.int32(off), block_table=jnp.asarray(tbl),
                slot=jnp.int32(0))
        else:
            lg, state = TM.serve_prefill_chunk(
                cfg, tparams, state, tokens=torch.from_numpy(tok), length=n,
                q_offset=off, block_table=torch.from_numpy(tbl),
                attn_window=window)
        pre.append(np.asarray(lg))
    nxt = np.array([5, 9], np.int32)
    lens = np.array([len(prompt), 4], np.int32)
    if side_j:
        dl, state = _jax_fns(window)[1](jparams, state, jnp.asarray(nxt),
                                        jnp.asarray(lens), jnp.asarray(TABLE))
        pages = [np.asarray(state["attn"][k]) for k in ("k_pages", "v_pages")]
    else:
        dl, state = TM.serve_decode_step(cfg, tparams, state, torch.from_numpy(nxt),
                                         torch.from_numpy(lens),
                                         torch.from_numpy(TABLE),
                                         attn_window=window)
        pages = [state["attn"][k].numpy() for k in ("k_pages", "v_pages")]
    return np.stack(pre), np.asarray(dl), pages


@pytest.fixture(scope="module")
def unwindowed(pair):
    return _serve(pair, None, "torch")


@pytest.mark.parametrize("window", [3, 11])
def test_windowed_serve_matches_jax(pair, unwindowed, window):
    tpre, tdec, tpages = _serve(pair, window, "torch")
    jpre, jdec, jpages = _serve(pair, window, "jax")
    np.testing.assert_allclose(tpre, jpre, **TOL)
    np.testing.assert_allclose(tdec, jdec, **TOL)
    for t, j in zip(tpages, jpages):       # the null page 0 takes padding rows
        np.testing.assert_allclose(t[:, :, 1:], j[:, :, 1:], **TOL)
    # the window cuts the prefix: the chunks past the first see fewer keys
    assert np.abs(tpre[1:] - unwindowed[0][1:]).max() > 1e-3


def test_paged_decode_ignores_the_window(pair):
    """The same pages and tokens decode to the same bits with and without a
    window, as in the reference (its paged decode never reads it)."""
    cfg, _, tparams = pair
    state = TM.init_serve_state(cfg, 2, NB, BS, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(2)
    for key in ("k_pages", "v_pages"):
        state["attn"][key].copy_(torch.randn(state["attn"][key].shape, generator=gen))
    tok, lens = torch.tensor([3, 4]), torch.tensor([20, 9], dtype=torch.int32)
    table = torch.from_numpy(TABLE)
    outs = []
    for window in (None, 2):
        st = {"attn": {k: v.clone() for k, v in state["attn"].items()}}
        outs.append(TM.decode_step_paged(cfg, tparams, st, tok, lens, table,
                                         attn_window=window)[0])
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())


def test_windowed_sharded_prefill_raises(pair):
    cfg, _, tparams = pair
    state = TM.init_serve_state(cfg, 1, NB, BS, dtype=torch.float32, device="cpu")
    local = torch.from_numpy(np.stack([TABLE[0], np.zeros(MB, np.int32)]))
    with pytest.raises(NotImplementedError, match="sequence-sharded"):
        TM.serve_prefill_chunk(cfg, tparams, state,
                               tokens=torch.zeros((1, CHUNK), dtype=torch.int64),
                               length=CHUNK, q_offset=0,
                               block_table=torch.from_numpy(TABLE[0]),
                               local_tables=local, attn_window=4)


def _pool(int8: bool, seed: int = 3):
    rng = np.random.default_rng(seed)
    kvh, nb, bs, d, h, c, qoff = 2, 11, 8, 16, 4, 24, 40
    q = rng.normal(size=(1, c, h, d)).astype(np.float32)
    if int8:
        kp = rng.integers(-127, 128, size=(kvh, nb, bs, d)).astype(np.int8)
        vp = rng.integers(-127, 128, size=(kvh, nb, bs, d)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, size=(kvh, nb)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, size=(kvh, nb)).astype(np.float32)
    else:
        kp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
        vp = rng.normal(size=(kvh, nb, bs, d)).astype(np.float32)
        ks = vs = None
    table = rng.permutation(np.arange(1, nb))[:8].astype(np.int32)
    return q, kp, vp, ks, vs, table, qoff, c


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("window", [1, 16, 200])
def test_ops_windowed_prefill_matches_jax_and_plain(window, int8):
    """Window 16 leaves the chunk's last rows no key of its first pages
    (its last valid row, at 58, sees keys 43-58 of 59); 200 covers all;
    five padding rows end the chunk."""
    q, kp, vp, ks, vs, table, qoff, c = _pool(int8)
    for length in (c - 5,):
        t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
        j = lambda a: None if a is None else jnp.asarray(a)        # noqa: E731
        got = tops.paged_prefill_attention(
            t(q), t(kp), t(vp), t(table), q_offset=qoff, length=length,
            window=window, k_scales=t(ks), v_scales=t(vs))
        want = jops.paged_prefill_attention(
            j(q), j(kp), j(vp), j(table), q_offset=qoff, length=length,
            window=window, k_scales=j(ks), v_scales=j(vs))
        plain = tref.paged_prefill_attention(
            t(q), t(kp), t(vp), t(table), q_offset=qoff, length=length,
            window=window, k_scales=t(ks), v_scales=t(vs))
        rows = slice(0, length)              # padding rows are not compared
        np.testing.assert_allclose(got.numpy()[:, rows], np.asarray(want)[:, rows],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(plain.numpy()[:, rows], got.numpy()[:, rows],
                                   rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_refuses_a_window_of_zero():
    q, kp, vp, _, _, table, qoff, c = _pool(False)
    with pytest.raises(ValueError, match="positive"):
        tpf.paged_prefill_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                    torch.from_numpy(vp), torch.from_numpy(table),
                                    q_offset=qoff, length=c, window=0)
