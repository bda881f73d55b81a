"""CompAir-NoC's in-transit softmax combine, on one controller.

A torch copy of the parts of the JAX package's ``core/noc.py`` that
sequence-sharded serving runs: the butterfly all-reduce's combine order
(``butterfly_all_reduce``, :52-71), ``tree_softmax_combine`` (:122-132) and
the hop/energy cost model the engine charges per combine
(``softmax_combine_cost``, :147-166, and ``E_HOP_PJ_PER_BIT``), and the
swap-versus-recompute preemption cost model (``swap_cost``,
``recompute_cost``, ``preempt_decision``, ``restore_cost_seconds`` and
their four rates, :179-259).

The paper embeds a Curry ALU in every NoC router so that the softmax
combine of attention partials happens while they move (Fig. 10).  The JAX
package runs it inside ``shard_map`` with one ``ppermute`` per hop.  The
port holds every shard of the page pool on one card under one controller,
so the S shard partials are a list and a hop is a call of the combiner.
The hop and energy totals stay the model's: what the combine would cost on
the NoC, not what the card spends.  Likewise the preemption cost model
prices a swap over the paper's CXL link and a recompute on its SRAM-PIM
banks (``pimsim.params``): the engine's ``preempt_policy="auto"`` and its
victim ranking follow the paper's model, not the H100's copy engines or
tensor cores.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.pimsim import params as _pimparams

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


# swap-versus-recompute preemption cost model ------------------------------
#
# Under page-pool pressure the engine evicts a victim's KV progress: park it
# in a slower tier (bytes over a link, paid twice: out now, back at restore)
# or drop it and re-run its prefill (FLOPs).  The rates are the paper's
# model (``pimsim.params``): the swap link is the CXL point-to-point hop of
# a CXL-attached pool, the recompute rate the SRAM-PIM lanes of every DRAM
# bank.  They are not the H100's: module-level, so a caller can re-point
# them at measured rates.

_CXL = _pimparams.Cxl()
_SRAM = _pimparams.SramPim()
_DRAM = _pimparams.DramPim()

SWAP_LINK_BYTES_PER_S = _CXL.p2p_bw
SWAP_E_PJ_PER_BIT = _CXL.e_pj_per_bit
RECOMPUTE_FLOPS_PER_S = _SRAM.bank_flops() * _DRAM.banks
RECOMPUTE_E_PJ_PER_FLOP = _SRAM.e_mac_pj / 2.0   # one MAC = two FLOPs


def swap_cost(n_pages: int, page_bytes: int, state_bytes: int = 0) -> dict:
    """Round-trip cost of parking ``n_pages`` KV pages off the device.

    ``page_bytes`` counts K and V of one page at the pool's storage width
    (an int8 pool: 1-byte values plus its per-page scales); ``state_bytes``
    a slot-state blob that rides the same link.  The factor 2 is the two
    traversals (out now, back at restore).  Returns ``{"bytes", "seconds",
    "energy_pj"}``."""
    b = 2 * (n_pages * page_bytes + state_bytes)
    return {"bytes": b, "seconds": b / SWAP_LINK_BYTES_PER_S,
            "energy_pj": b * 8 * SWAP_E_PJ_PER_BIT}


def recompute_cost(tokens: int, flops_per_token: float) -> dict:
    """Cost of re-running prefill over ``tokens`` dropped KV tokens (an
    upper bound: prefix-cache hits at re-admission skip part of it).
    Returns ``{"flops", "seconds", "energy_pj"}``."""
    f = tokens * flops_per_token
    return {"flops": f, "seconds": f / RECOMPUTE_FLOPS_PER_S,
            "energy_pj": f * RECOMPUTE_E_PJ_PER_FLOP}


def preempt_decision(n_pages: int, page_bytes: int, tokens: int,
                     flops_per_token: float, state_bytes: int = 0) -> str:
    """The cheaper eviction arm for one victim: ``"swap"`` when moving its
    bytes over the link takes no longer than re-running its prefill FLOPs,
    else ``"recompute"``."""
    s = swap_cost(n_pages, page_bytes, state_bytes)["seconds"]
    r = recompute_cost(tokens, flops_per_token)["seconds"]
    return "swap" if s <= r else "recompute"


def restore_cost_seconds(n_pages: int, page_bytes: int, tokens: int,
                         flops_per_token: float, state_bytes: int = 0,
                         policy: str = "auto") -> float:
    """Seconds to bring one victim back under ``policy``: the swap arm's
    round trip, the recompute arm's replay, or (``"auto"``) the cheaper of
    the two, which is always the arm :func:`preempt_decision` takes."""
    s = swap_cost(n_pages, page_bytes, state_bytes)["seconds"]
    r = recompute_cost(tokens, flops_per_token)["seconds"]
    if policy == "swap":
        return s
    if policy == "recompute":
        return r
    return min(s, r)
