"""The port's NoC collectives over a list of shards
(``repro_torch.core.noc``): the butterfly, the binary reduce and broadcast
trees and their all-reduce against numpy's sum and max over the shards;
the sharded softmax and logsumexp, and the centralized-NLU baselines,
against ``jax.nn.softmax`` / ``jax.nn.logsumexp`` over the concatenated
vector; the centralized combine of attention partials against the tree
combine and against attention over every key.  Shard counts 1, 2, 4 and 8,
and 3, where the butterfly takes the reference's ``psum`` / ``pmax`` form
and the trees raise as the reference's assert does.

Sums are held to 1e-6 relative (plus 1e-6 of the largest entry): the tree
and the butterfly add in another order than numpy.  Maxima and copies are
held bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import noc  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

COUNTS = [1, 2, 4, 8]


def _shards(n, shape=(3, 5), seed=0):
    rng = np.random.default_rng(seed + n)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _split(n, width=24, seed=2):
    """One [4, width] vector cut into n shards along its last axis (one
    shape for every n, so JAX compiles its softmax once)."""
    full = np.random.default_rng(seed + n).normal(size=(4, width)).astype(np.float32)
    return full, np.split(full, n, axis=-1)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("n", COUNTS + [3])
def test_butterfly_sum_and_max(n):
    vals = _shards(n)
    ts = [torch.from_numpy(v) for v in vals]
    for out in noc.butterfly_all_reduce(ts, "add"):
        _close(out, np.sum(vals, axis=0))
    for out in noc.butterfly_all_reduce(ts, "max"):
        np.testing.assert_array_equal(out.numpy(), np.max(vals, axis=0))
    pairs = [(t, 2 * t) for t in ts]          # a tuple tree, as the reference's
    for a, b in noc.butterfly_all_reduce(pairs, "add"):
        _close(a, np.sum(vals, axis=0))
        _close(b, 2 * np.sum(vals, axis=0))
    if n == 3:
        with pytest.raises(ValueError, match="builtin combiner"):
            noc.butterfly_all_reduce(ts, lambda a, b: a + b)


@pytest.mark.parametrize("n", COUNTS)
def test_trees(n):
    vals = _shards(n, seed=1)
    ts = [torch.from_numpy(v) for v in vals]
    _close(noc.tree_reduce(ts, "add")[0], np.sum(vals, axis=0))
    np.testing.assert_array_equal(noc.tree_reduce(ts, "max")[0].numpy(),
                                  np.max(vals, axis=0))
    for out in noc.tree_broadcast(ts):
        np.testing.assert_array_equal(out.numpy(), vals[0])
    for out in noc.tree_all_reduce(ts, "add"):
        _close(out, np.sum(vals, axis=0))
    for out in noc.tree_all_reduce(ts, "max"):
        np.testing.assert_array_equal(out.numpy(), np.max(vals, axis=0))
    # the binary tree adds pairwise as the butterfly does: the same bits
    np.testing.assert_array_equal(noc.tree_reduce(ts, "add")[0].numpy(),
                                  noc.butterfly_all_reduce(ts, "add")[0].numpy())


def test_trees_refuse_what_the_reference_asserts():
    ts = [torch.zeros(2)] * 3
    with pytest.raises(ValueError, match="power-of-two"):
        noc.tree_reduce(ts)
    with pytest.raises(ValueError, match="power-of-two"):
        noc.tree_broadcast(ts)
    with pytest.raises(ValueError, match="non-zero roots"):
        noc.tree_reduce(ts[:2], root=1)


@pytest.mark.parametrize("n", COUNTS + [3])
def test_sharded_softmax_and_baselines(n):
    full, vals = _split(n)
    ts = [torch.from_numpy(np.ascontiguousarray(v)) for v in vals]
    want = np.asarray(jax.nn.softmax(jnp.asarray(full), axis=-1))
    want_lse = np.asarray(jax.nn.logsumexp(jnp.asarray(full), axis=-1))
    _close(torch.cat(noc.distributed_softmax(ts), dim=-1), want)
    for lse in noc.distributed_logsumexp(ts):
        _close(lse, want_lse)
    _close(torch.cat(noc.centralized_softmax(ts), dim=-1), want)
    bf = [t.to(torch.bfloat16) for t in ts]
    got = noc.centralized_softmax(bf)
    assert all(g.dtype == torch.bfloat16 for g in got)
    np.testing.assert_array_equal(
        torch.cat(got, -1).float().numpy(),
        torch.softmax(torch.cat(bf, -1).float(), -1).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("n", COUNTS)
def test_centralized_combine(n):
    """The NLU baseline combines the shards' attention partials in shard
    order: the tree combine's result, and attention over all the keys."""
    rng = np.random.default_rng(3)
    b, h, d, keys = 2, 3, 8, 5
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, n * keys, h, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, n * keys, h, d)).astype(np.float32))
    parts = [tref.decode_attention_partial(q, k[:, i * keys:(i + 1) * keys],
                                           v[:, i * keys:(i + 1) * keys])
             for i in range(n)]
    got = noc.centralized_softmax_combine(parts)
    _close(got, noc.tree_softmax_combine(parts).numpy())
    _close(got, tref.decode_attention(q, k, v).numpy())
