"""Port parity, the modality frontends (``repro_torch.models.frontends``)
against the JAX package's ``repro.models.frontends``.

``embedding_seed`` is the reference's for every registered arch.  The
port's table is drawn by ``torch.Generator`` (the reference's comes from
``jax.random``, whose bits the port cannot make), so its values differ; it
is held to the same shape, dtype and ``d_model ** -0.5`` scale, to repeat
itself, and to give every position of one token id the same row.
``embedding_spec`` is a ``meta`` tensor of the reference's shape and dtype.
The model parity feeds the reference's own embeddings to both packages:
reduced internvl2-2b (``vlm``, grouped kv heads) and musicgen-large
(``audio``) at fp32, a batched ``prefill(embeds=)`` of two right-padded
sequences and two ``decode_step(embeds=)``s over the slabs, logits within
1e-4.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, get_config, reduced  # noqa: E402
from repro.configs.paper_models import PAPER_MODELS  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import frontends as tfront  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
JIT = dict(compiler_options={"xla_backend_optimization_level": 0,
                             "xla_llvm_disable_expensive_passes": True})


def test_embedding_seed_and_kind_match_reference():
    for name in list(ARCHS) + sorted(PAPER_MODELS):
        assert tfront.embedding_seed(t_get_config(name)) == \
            jfront.embedding_seed(get_config(name)), name
        assert tfront.frontend_kind(t_get_config(name)) == \
            jfront.frontend_kind(get_config(name)), name


@pytest.mark.parametrize("arch", ["internvl2-2b", "musicgen-large"])
def test_synthetic_embeddings_shape_scale_and_determinism(arch):
    cfg, jcfg = t_reduced(t_get_config(arch)), reduced(get_config(arch))
    tokens = torch.arange(cfg.vocab_size).reshape(2, -1)
    emb = tfront.synthetic_embeddings(cfg, tokens)
    want = jfront.synthetic_embeddings(jcfg, jnp.asarray(tokens.numpy()))
    assert tuple(emb.shape) == tuple(want.shape)
    assert emb.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    tfront._table.cache_clear()          # a fresh draw repeats itself
    again = tfront.synthetic_embeddings(cfg, tokens)
    np.testing.assert_array_equal(emb.float().numpy(), again.float().numpy())
    f32 = tfront.synthetic_embeddings(cfg, tokens, dtype=torch.float32)
    std = float(f32.std()) * cfg.d_model ** 0.5          # the table's own std
    assert abs(std - 1.0) < 0.1, std
    assert abs(std - float(np.asarray(want, np.float32).std())
               * cfg.d_model ** 0.5) < 0.15
    same = tfront.synthetic_embeddings(cfg, torch.tensor([[5, 5, 7]]))
    np.testing.assert_array_equal(same[0, 0].float().numpy(), same[0, 1].float().numpy())
    spec = tfront.embedding_spec(cfg, 3, 11)
    jspec = jfront.embedding_spec(jcfg, 3, 11)
    assert spec.device.type == "meta" and tuple(spec.shape) == jspec.shape
    assert spec.dtype == torch.bfloat16 and jspec.dtype == jnp.bfloat16


@pytest.mark.parametrize("arch", ["internvl2-2b", "musicgen-large"])
def test_prefill_and_decode_from_embeddings_match_jax(arch):
    jcfg, cfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key, dtype=jnp.float32),
                      **JIT)(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(4)
    b, s, smax = 2, 8, 16
    tok = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    lens = np.array([8, 5], np.int32)
    emb = np.asarray(jfront.synthetic_embeddings(jcfg, jnp.asarray(tok),
                                                 dtype=jnp.float32))
    pre = jax.jit(functools.partial(JM.prefill, jcfg), **JIT)
    dec = jax.jit(functools.partial(JM.decode_step, jcfg), **JIT)
    jstate = JM.init_decode_state(jcfg, b, smax, dtype=jnp.float32)
    tstate = TM.init_decode_state(cfg, b, smax, dtype=torch.float32, device="cpu")
    jl, jstate = pre(jparams, jstate, embeds=jnp.asarray(emb),
                     lengths=jnp.asarray(lens))
    tl, tstate = TM.prefill(cfg, tparams, tstate, embeds=torch.from_numpy(emb),
                            lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    cur = lens.copy()
    for step in range(2):
        nxt = rng.integers(0, jcfg.vocab_size, size=(b,)).astype(np.int32)
        e = np.asarray(jfront.synthetic_embeddings(jcfg, jnp.asarray(nxt),
                                                   dtype=jnp.float32))
        jl, jstate = dec(jparams, jstate, jnp.asarray(nxt), jnp.asarray(cur),
                         embeds=jnp.asarray(e))
        tl, tstate = TM.decode_step(cfg, tparams, tstate, torch.from_numpy(nxt),
                                    torch.from_numpy(cur),
                                    embeds=torch.from_numpy(e))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")
        cur = cur + 1
