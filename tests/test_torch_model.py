"""Port parity, model: with the JAX package's parameters carried over
through ``repro_torch.models.convert``, the port's paged prefill chunks and
decode steps give the JAX logits within 1e-4 (fp32, reduced configs) and
scatter the same K/V into the same pages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(arch):
    cfg = reduced(get_config(arch))
    jparams = JM.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, jparams, tparams


def _pages_equal(jstate, tstate):
    """Every page but the null page 0 (padding rows of a chunk all land
    there, in an order neither framework fixes)."""
    for key in ("k_pages", "v_pages"):
        j = np.asarray(jstate["attn"][key])[:, :, 1:]
        t = tstate["attn"][key].numpy()[:, :, 1:]
        np.testing.assert_allclose(t, j, **TOL)


def test_configs_are_copies():
    """Same names and values as the JAX registry (the port keeps its own
    copy of the config files)."""
    from repro.configs import _REGISTRY as jreg
    from repro_torch.configs import _REGISTRY as treg
    assert sorted(jreg) == sorted(treg)
    for name in jreg:
        assert jreg[name].__dict__ == treg[name].__dict__, name
    assert reduced(get_config("granite-3-2b")).__dict__ == \
        t_reduced(t_get_config("granite-3-2b")).__dict__


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-3-2b"])
def test_prefill_and_decode_logits_match_jax(arch):
    """Chunked prefill (right-padded chunks, a table prefix slice, growing
    q_offset) then batched decode over two sequences, one retired slot."""
    cfg, jparams, tparams = _pair(arch)
    bs, nb, mb = 8, 12, 4
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, size=19).astype(np.int32)
    jstate = JM.init_serve_state(cfg, 3, nb, bs, dtype=jnp.float32)
    tstate = TM.init_serve_state(cfg, 3, nb, bs, dtype=torch.float32,
                                 device="cpu")
    table = np.array([[3, 7, 1, 9], [2, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    # slot 0: 19 prompt tokens in chunks of 8 (bucket 8, last one padded)
    off = 0
    while off < len(prompt):
        n = min(8, len(prompt) - off)
        tok = np.zeros((1, 8), np.int32)
        tok[0, :n] = prompt[off:off + n]
        n_live = -(-(off + n) // bs)
        tbl = table[0, :min(1 << max(n_live - 1, 0).bit_length(), mb)]
        jl, jstate = JM.prefill_paged(cfg, jparams, jstate,
                                      tokens=jnp.asarray(tok),
                                      length=jnp.int32(n),
                                      q_offset=jnp.int32(off),
                                      block_table=jnp.asarray(tbl))
        tl, tstate = TM.prefill_paged(cfg, tparams, tstate,
                                      tokens=torch.from_numpy(tok), length=n,
                                      q_offset=off,
                                      block_table=torch.from_numpy(tbl))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        off += n
    _pages_equal(jstate, tstate)
    # batched decode: slot 0 at 19, slot 1 mid-prefill at 5, slot 2 retired
    lens = np.array([19, 5, 0], np.int32)
    toks = np.array([int(np.argmax(np.asarray(jl))), 11, 0], np.int32)
    for _ in range(3):
        jl, jstate = JM.decode_step_paged(cfg, jparams, jstate,
                                          jnp.asarray(toks), jnp.asarray(lens),
                                          jnp.asarray(table))
        tl, tstate = TM.decode_step_paged(cfg, tparams, tstate,
                                          torch.from_numpy(toks),
                                          torch.from_numpy(lens),
                                          torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        toks = np.array(jnp.argmax(jl, axis=-1), np.int32)
        lens = lens + np.array([1, 1, 0], np.int32)
    _pages_equal(jstate, tstate)


def test_copy_kv_page_matches_jax():
    cfg, _, _ = _pair("granite-3-2b")
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, cfg.n_kv_heads, 6, 8, cfg.hd)
    kv = {k: rng.normal(size=shape).astype(np.float32)
          for k in ("k_pages", "v_pages")}
    jout = JM.copy_kv_page({"attn": {k: jnp.asarray(v) for k, v in kv.items()}},
                           jnp.int32(2), jnp.int32(5))
    tout = TM.copy_kv_page({"attn": {k: torch.from_numpy(v.copy())
                                     for k, v in kv.items()}}, 2, 5)
    for k in kv:
        np.testing.assert_array_equal(tout["attn"][k].numpy(),
                                      np.asarray(jout["attn"][k]))


def test_other_families_name_their_slice():
    cfg = t_reduced(t_get_config("olmoe-1b-7b"))
    # zamba2-7b, its Mamba2 family="ssm" variant, rwkv6-3b and MoE all
    # train and serve: no family names a later slice any more
    zamba = t_reduced(t_get_config("zamba2-7b"))
    for c in (zamba, zamba.replace(family="ssm"),
              t_reduced(t_get_config("rwkv6-3b")), cfg):
        params = TM.init_params(c, device="cpu")
        TM.init_serve_state(c, 2, 9, 8, dtype=torch.float32, device="cpu")
        logits, aux = TM.forward(c, params, torch.zeros(1, 4, dtype=torch.int32))
        assert logits.shape == (1, 4, c.vocab_size)
        assert bool(torch.all(aux > 0)) == (c.family == "moe")
