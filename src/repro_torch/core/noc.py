"""CompAir-NoC's in-transit collectives, on one controller.

A torch copy of the JAX package's ``core/noc.py``: the combiners
(``COMBINERS``), the butterfly all-reduce's combine order
(``butterfly_all_reduce``, :52-71, with its ``psum`` / ``pmax`` fallback for
a shard count that is not a power of two), the binary reduce and broadcast
trees (``tree_reduce``, ``tree_broadcast``, ``tree_all_reduce``, :74-115),
``tree_softmax_combine`` (:122-132), the softmax and logsumexp of a
sharded feature axis (``distributed_softmax``, ``distributed_logsumexp``,
:366-380) and the centralized-NLU baselines they replace
(``centralized_softmax``, ``centralized_softmax_combine``, :387-410); the
hop/energy cost model the engine charges per combine
(``softmax_combine_cost``, :147-166, and ``E_HOP_PJ_PER_BIT``), the
swap-versus-recompute preemption cost model (``swap_cost``,
``recompute_cost``, ``preempt_decision``, ``restore_cost_seconds`` and
their four rates, :179-259), the prefill -> decode handoff's
(``handoff_cost``, ``handoff_admission_cost``, :260-298), and the hot/cold
expert placement cost model the expert cache prices its promotions with
(``expert_placement_cost``, ``expert_promotion_worthwhile`` and the
``EXPERT_*`` rates, :301-365).

The paper embeds a Curry ALU in every NoC router so that the softmax
combine of attention partials happens while they move (Fig. 10).  The JAX
package runs its collectives inside ``shard_map`` with one ``ppermute`` per
hop.  The port holds every shard on one card under one controller, so the
S shard values are a list and a hop is a call of the combiner: a collective
takes the list and returns every shard's value (a tree reduction's
non-root shards keep what the reference leaves there).
The hop and energy totals stay the model's: what the combine would cost on
the NoC, not what the card spends.  Likewise the preemption cost model
prices a swap over the paper's CXL link and a recompute on its SRAM-PIM
banks (``pimsim.params``): the engine's ``preempt_policy="auto"`` and its
victim ranking follow the paper's model, not the H100's copy engines or
tensor cores, and the expert cache's tiers are the paper's SRAM-PIM and
DRAM-PIM banks, not the card's memory.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.pimsim import params as _pimparams

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _tree_map(fn, *trees):
    """``fn`` over matching leaves of tensors, or tuples / lists of them."""
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _add(a, b):
    return _tree_map(torch.add, a, b)


def _max(a, b):
    return _tree_map(torch.maximum, a, b)


COMBINERS = {"add": _add, "max": _max}


def _combiner(combiner) -> Callable:
    return COMBINERS.get(combiner, combiner)


def butterfly_all_reduce(values: Sequence, combiner="add") -> List:
    """The hypercube (recursive-doubling) all-reduce over a list of S
    per-shard values: at hop ``k`` (1, 2, 4, ...) shard ``i`` combines its
    value with shard ``i ^ k``'s, its own first, as the JAX package's
    ``ppermute`` schedule does.  Returns every shard's result (S log2 S
    combines).  ``combiner`` is ``"add"``, ``"max"`` or a callable.  For S
    not a power of two the reference falls back to ``psum`` / ``pmax``; so
    does this, as a sum or max of the values in shard order, and another
    combiner raises."""
    comb = _combiner(combiner)
    n = len(values)
    if not _is_pow2(n):
        if combiner not in ("add", "max"):
            raise ValueError("non-pow2 axis needs builtin combiner")
        total = values[0]
        for v in values[1:]:
            total = comb(total, v)
        return [total] * n
    values, k = list(values), 1
    while k < n:
        values = [comb(values[i], values[i ^ k]) for i in range(n)]
        k *= 2
    return values


def tree_reduce(values: Sequence, combiner="add", root: int = 0) -> List:
    """Binary-tree reduction to ``root`` (paper Fig. 14A), log2(S) hops: at
    hop ``k`` each shard at an odd multiple of ``k`` forwards its partial to
    the shard ``k`` below, which combines it (its own first).  Only the
    root's value is meaningful afterwards; the others keep what the
    reference leaves them.  S must be a power of two and the root 0."""
    comb = _combiner(combiner)
    n = len(values)
    if not _is_pow2(n):
        raise ValueError(f"tree_reduce needs a power-of-two shard count, got {n}")
    if root != 0:
        raise ValueError("rotate indices for non-zero roots")
    values, k = list(values), 1
    while k < n:
        values = [comb(values[i], values[i + k]) if i % (2 * k) == 0 else values[i]
                  for i in range(n)]
        k *= 2
    return values


def tree_broadcast(values: Sequence, root: int = 0) -> List:
    """Binary-tree broadcast from ``root``: the reduce tree run backwards,
    hop ``k`` = S/2, S/4, ..., 1 copying shard ``i``'s value to ``i + k``."""
    n = len(values)
    if not _is_pow2(n) or root != 0:
        raise ValueError(f"tree_broadcast needs a power-of-two shard count and "
                         f"root 0, got {n} and {root}")
    values, k = list(values), n // 2
    while k >= 1:
        values = [values[i - k] if i % (2 * k) == k else values[i]
                  for i in range(n)]
        k //= 2
    return values


def tree_all_reduce(values: Sequence, combiner="add") -> List:
    """Reduce-to-root + broadcast: the literal paper schedule (two trees).
    :func:`butterfly_all_reduce` has the same depth and no idle nodes."""
    return tree_broadcast(tree_reduce(values, combiner))


def tree_combine(values: Sequence, combiner: Callable):
    """Shard 0's butterfly result in S - 1 combines: the root of
    :func:`tree_reduce`, the pairwise tree ``((v0.v1).(v2.v3))...``.  At hop
    ``k`` shard 0 combines its value with shard ``k``'s, which is the tree
    of shards ``[k, 2k)``; so for a combiner that is commutative bit for bit
    this is every shard's result (``ref.combine_partials`` is: a max, and
    sums of two products)."""
    return tree_reduce(values, combiner)[0]


def tree_softmax_combine(parts: Sequence[Partials]) -> torch.Tensor:
    """Combine the S per-shard attention partials ``(acc [..., D] f32, m
    [...], l [...])`` of a sequence-sharded pool into the normalized output
    ``[..., D]`` f32: paper Fig. 10's in-transit softmax, the exp
    renormalization at every tree hop.  The S - 1 combines of
    :func:`tree_combine` give the bits of the JAX package's butterfly."""
    acc, _, l = tree_combine(parts, ref.combine_partials)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def distributed_softmax(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Softmax over a feature axis cut into S shards (the last axis of each,
    e.g. a vocab-sharded LM head): the max and the sum statistics ride the
    butterfly; returns every shard's slice of the result."""
    ms = butterfly_all_reduce([x.amax(dim=-1) for x in shards], "max")
    es = [torch.exp(x - m[..., None]) for x, m in zip(shards, ms)]
    ss = butterfly_all_reduce([e.sum(dim=-1) for e in es], "add")
    return [e / s[..., None] for e, s in zip(es, ss)]


def distributed_logsumexp(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """logsumexp over a feature axis cut into S shards; every shard's value."""
    ms = butterfly_all_reduce([x.amax(dim=-1) for x in shards], "max")
    ss = butterfly_all_reduce([torch.exp(x - m[..., None]).sum(dim=-1)
                               for x, m in zip(shards, ms)], "add")
    return [m + torch.log(s) for m, s in zip(ms, ss)]


# centralized-NLU baselines (what CompAir-NoC replaces) --------------------

def centralized_softmax(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Baseline: gather the full vector (the NLU round trip), compute the
    softmax in f32 in one place, hand each shard its slice back in its
    dtype: the all-gather + broadcast traffic of Fig. 5A."""
    full = torch.cat(list(shards), dim=-1)
    y = torch.softmax(full.float(), dim=-1).to(shards[0].dtype)
    return list(torch.split(y, [x.shape[-1] for x in shards], dim=-1))


def centralized_softmax_combine(parts: Sequence[Partials]) -> torch.Tensor:
    """Baseline for the decode-attention combine: gather every shard's
    partials and reduce them in shard order in one place."""
    part = parts[0]
    for nxt in parts[1:]:
        part = ref.combine_partials(part, nxt)
    acc, _, l = part
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


# prefill -> decode handoff (disaggregated serving, serve/disagg.py): a
# finished prefill's page chain and slot state cross the swap tier's link
# one way.  int8 pages move at storage width (``page_bytes`` is priced by
# the caller at the pool's width), and pages the decode pool already holds
# registered (prefix-cached chains) move nothing.

def handoff_cost(n_pages: int, page_bytes: int, state_bytes: int = 0,
                 cached_pages: int = 0, n_hops: int = 1) -> dict:
    """One-way cost of streaming one finished prefill to the decode role.

    ``n_pages`` is the whole KV chain, of which ``cached_pages`` leading
    pages are already registered in the decode pool and transfer nothing;
    ``page_bytes`` is one page's K and V at the pool's storage width;
    ``state_bytes`` the slot-state blob, which always transfers; ``n_hops``
    the link traversals between the two workers (each hop past the first
    adds router energy, not time).  Returns ``{"bytes", "hops", "seconds",
    "energy_pj"}``."""
    moved = max(n_pages - cached_pages, 0)
    b = moved * page_bytes + state_bytes
    return {"bytes": b, "hops": n_hops,
            "seconds": b / SWAP_LINK_BYTES_PER_S,
            "energy_pj": b * 8 * (SWAP_E_PJ_PER_BIT
                                  + max(n_hops - 1, 0) * E_HOP_PJ_PER_BIT)}


def handoff_admission_cost(n_pages: int, page_bytes: int, free_pages: int,
                           state_bytes: int = 0,
                           cached_pages: int = 0) -> dict:
    """The decode pool's admission arm for one staged handoff with
    ``free_pages`` grantable pages now: :func:`handoff_cost`'s transfer plus
    ``need_pages`` (the uncached remainder) and ``deferred`` (the pool
    cannot grant it yet: the handoff stays in the arena and is retried)."""
    c = handoff_cost(n_pages, page_bytes, state_bytes, cached_pages)
    need = max(n_pages - cached_pages, 0)
    c["need_pages"] = need
    c["deferred"] = free_pages < need
    return c


# hot/cold expert placement cost model ------------------------------------
#
# CompAir's hybrid premise for MoE: hot experts live in the sub-10 ns
# SRAM-PIM tier, cold ones in the high-capacity DRAM-PIM tier, and every
# promotion moves the expert's weights over the CXL/NoC link.  The serving
# engine's expert cache (``serve/expert_cache.py``) prices its promotions
# with this arm.  Per-bank stream rates: the SRAM tier feeds weights over
# hybrid bonds (6.4x the GDDR6 bank read-out), so a hot expert's dispatch is
# proportionally cheaper, worth a migration once its predicted traffic
# amortizes the link transfer.  Module-level, as the preemption model's.

EXPERT_SRAM_BYTES_PER_S = _SRAM.hb_bw_per_bank
EXPERT_SRAM_E_PJ_PER_BIT = _SRAM.e_access_pj_per_bit
EXPERT_DRAM_BYTES_PER_S = _DRAM.bank_bw
EXPERT_DRAM_E_PJ_PER_BIT = _DRAM.e_access_pj_per_bit
EXPERT_LINK_BYTES_PER_S = _CXL.p2p_bw
EXPERT_LINK_E_PJ_PER_BIT = _CXL.e_pj_per_bit + E_HOP_PJ_PER_BIT


def expert_placement_cost(expert_bytes: int, accesses: float = 1.0) -> dict:
    """Price serving ``accesses`` routed-token dispatches of ONE expert from
    each placement arm.

    ``expert_bytes`` is the routed expert's weights (gate, up and down);
    ``accesses`` the token dispatches that stream it (each re-reads the
    weights from its tier: the un-batched bound the placement decision
    prices).  Returns ``{"sram": {"seconds", "energy_pj"}, "dram":
    {"seconds", "energy_pj"}, "migrate": {"seconds", "bytes",
    "energy_pj"}}``: a resident hit, a cold access in DRAM-PIM, and one
    DRAM -> SRAM move over the link.  With the default rates the sram-dram
    gap grows with ``accesses`` and the migration does not, so the
    crossover is an access count, whatever ``expert_bytes``."""
    bits = 8.0 * expert_bytes
    return {
        "sram": {"seconds": accesses * expert_bytes / EXPERT_SRAM_BYTES_PER_S,
                 "energy_pj": accesses * bits * EXPERT_SRAM_E_PJ_PER_BIT},
        "dram": {"seconds": accesses * expert_bytes / EXPERT_DRAM_BYTES_PER_S,
                 "energy_pj": accesses * bits * EXPERT_DRAM_E_PJ_PER_BIT},
        "migrate": {"seconds": expert_bytes / EXPERT_LINK_BYTES_PER_S,
                    "bytes": expert_bytes,
                    "energy_pj": bits * EXPERT_LINK_E_PJ_PER_BIT},
    }


def expert_promotion_worthwhile(expert_bytes: int,
                                predicted_accesses: float) -> bool:
    """Should a cold expert move to the SRAM-PIM tier?  True when the link
    transfer plus its predicted SRAM-resident serving time beats leaving it
    in DRAM-PIM: the expert cache's promotion gate (experts whose predicted
    traffic cannot amortize the move stay cold)."""
    c = expert_placement_cost(expert_bytes, predicted_accesses)
    return (c["migrate"]["seconds"] + c["sram"]["seconds"]
            < c["dram"]["seconds"])
