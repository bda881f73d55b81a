"""CompAir-NoC's in-transit softmax combine, on one controller.

A torch copy of the parts of the JAX package's ``core/noc.py`` that
sequence-sharded serving runs: the butterfly all-reduce's combine order
(``butterfly_all_reduce``, :52-71), ``tree_softmax_combine`` (:122-132) and
the hop/energy cost model the engine charges per combine
(``softmax_combine_cost``, :147-166, and ``E_HOP_PJ_PER_BIT``).

The paper embeds a Curry ALU in every NoC router so that the softmax
combine of attention partials happens while they move (Fig. 10).  The JAX
package runs it inside ``shard_map`` with one ``ppermute`` per hop.  The
port holds every shard of the page pool on one card under one controller,
so the S shard partials are a list and a hop is a call of the combiner.
The hop and energy totals stay the model's: what the combine would cost on
the NoC, not what the card spends.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.kernels import ref

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def butterfly_all_reduce(values: Sequence, combiner: Callable) -> List:
    """The hypercube (recursive-doubling) all-reduce over a list of S
    per-shard values: at hop ``k`` (1, 2, 4, ...) shard ``i`` combines its
    value with shard ``i ^ k``'s, its own first, as the JAX package's
    ``ppermute`` schedule does.  Returns every shard's result (S log2 S
    combines); S must be a power of two."""
    n = len(values)
    if not _is_pow2(n):
        raise ValueError(f"the butterfly needs a power-of-two shard count, "
                         f"got {n}")
    values, k = list(values), 1
    while k < n:
        values = [combiner(values[i], values[i ^ k]) for i in range(n)]
        k *= 2
    return values


def tree_combine(values: Sequence, combiner: Callable):
    """Shard 0's butterfly result in S - 1 combines: the pairwise tree
    ``((v0.v1).(v2.v3))...``.  At hop ``k`` shard 0 combines its value with
    shard ``k``'s, which is the tree of shards ``[k, 2k)``; so for a
    combiner that is commutative bit for bit this is every shard's result
    (``ref.combine_partials`` is: a max, and sums of two products)."""
    n = len(values)
    if not _is_pow2(n):
        raise ValueError(f"the butterfly needs a power-of-two shard count, "
                         f"got {n}")
    values = list(values)
    while len(values) > 1:
        values = [combiner(values[i], values[i + 1])
                  for i in range(0, len(values), 2)]
    return values[0]


def tree_softmax_combine(parts: Sequence[Partials]) -> torch.Tensor:
    """Combine the S per-shard attention partials ``(acc [..., D] f32, m
    [...], l [...])`` of a sequence-sharded pool into the normalized output
    ``[..., D]`` f32: paper Fig. 10's in-transit softmax, the exp
    renormalization at every tree hop.  The S - 1 combines of
    :func:`tree_combine` give the bits of the JAX package's butterfly."""
    acc, _, l = tree_combine(parts, ref.combine_partials)
    return acc / torch.clamp(l, min=1e-30)[..., None]


# hop/energy accounting for the serve path: the engine charges one call per
# dispatched combine (0.1 pJ/bit for an on-chip link and router traversal,
# the JAX package's NoC constant)

E_HOP_PJ_PER_BIT = 0.1


def softmax_combine_cost(rows: int, heads: int, head_dim: int,
                         n_shards: int, itemsize: int = 4) -> dict:
    """Traffic and energy of ONE tree_softmax_combine over ``n_shards``:
    the butterfly moves the (acc [rows, heads, head_dim], m, l [rows,
    heads]) payload at every one of its log2(n) hops, every node active, so
    a device sends hops x payload bytes.  ``itemsize`` is the partials'
    width (f32 whatever the pool stores).  Returns ``{"hops", "bytes",
    "energy_pj"}`` (bytes and energy per device)."""
    if not _is_pow2(n_shards):
        raise ValueError(f"n_shards must be a power of two, got {n_shards}")
    hops = max(n_shards - 1, 0).bit_length()         # log2 for pow2 n
    payload = rows * heads * (head_dim + 2) * itemsize   # acc + m + l
    total = hops * payload
    return {"hops": hops, "bytes": total,
            "energy_pj": total * 8 * E_HOP_PJ_PER_BIT}
