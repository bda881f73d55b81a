"""Paged-KV / slot-state continuous-batching serving engine (single device).

Port of the JAX package's ``serve/engine.py`` core for every family: the
dense and MoE families, RWKV6, Mamba2 and the hybrid (Zamba2).  What a
family's cache holds comes from the runner's ``CacheSpec``
(``models/runner.py``); the engine never reads the family past its
constructor.  An MoE model routes every row of a dispatch, the padded rows
of a prefill chunk and the idle rows of the batched decode included, so
its GShard drops are the JAX engine's at any ``capacity_factor``:

* **Paged KV cache** — physical pages ``[L, KvH, NB, BS, hd]`` shared by all
  slots through per-slot block tables; page 0 is the null sink.
* **Continuous batching** — requests are admitted into free slots every
  tick; one batched decode serves all slots.
* **Chunked prefill** — prompts run in bucket-sized chunks under a per-tick
  token budget (decode tokens are reserved first); each chunk gets a
  power-of-two prefix slice of its block table, so its attention work is
  bounded by the live prefix, not the pool.
* **Prefix caching** — full prompt pages are published under a chained
  blake2b digest (the same chain and seed as the JAX engine, so hit
  statistics match); a new prompt's longest cached page prefix is attached
  by reference (refcounted, copy-on-write when the match ends mid-page) and
  cold cached pages are evicted LRU under pool pressure.
* **Sampling** — one pass over the batch per tick with a per-row
  temperature and a single device-to-host copy: a row at ``T = 0`` takes the
  argmax of its raw logits (first index on ties, as ``jnp.argmax``), a row
  at ``T > 0`` the Gumbel-max draw ``argmax(logits / T + Gumbel)`` in f32,
  the form of ``jax.random.categorical``, its noise drawn from one
  ``torch.Generator`` on the engine's device seeded by ``seed``.  A tick
  whose rows are all greedy draws no noise, so a greedy stream runs as it
  did before sampling came.  The bits cannot match JAX's threefry stream;
  the distributions do.
* **Latency classes** (``LATENCY_CLASSES``, ``class_weights``) — one queue
  per class; restores re-admit first, class by class, a blocked restore
  holding back its own and every lighter class; fresh work is admitted by
  deficit-weighted round-robin over the classes (credit reset when a
  class's queue is empty).  A victim's eviction score carries its own
  class's weight.  ``class_stats`` counts submissions, finishes, tokens,
  preemptions and SLO violations per class; a finish later than the
  request's ``deadline_ms`` (or its class's ``class_deadlines_ms``) on the
  wall clock is a violation.
* **Dense-slab baseline** (``paged=False``) — the JAX engine's A/B
  baseline: ``[L, slots, max_seq]`` K/V slabs (RWKV6, Mamba2: the
  recurrent state of ``slots`` rows; the hybrid: ``[G, slots, max_seq]``
  slabs beside it), one monolithic bucketed prefill per tick written
  straight into the slot's rows (the JAX engine prefills a batch-of-one
  state and scatters it into the slot; outputs and stats are the same),
  and one batched decode over all slots through ``model.decode_step``.  No
  pages, no prefix caching.
* **Slot-state continuous batching** (a family with slot state, RWKV6 and
  Mamba2 alone, the hybrid beside its page pool, on the runner path) — the
  recurrent state (the slot on axis 1, or 2 for the hybrid's grouped keys)
  is zeroed for a slot at admission, every prefill chunk reads and
  advances its slot's rows, and the batched decode writes the state back
  at the runnable slots only (a slot mid-prefill or empty keeps its state
  bit for bit).  Without a paged component there is no
  ``BlockAllocator``, no page pressure and no prefix caching.  With one
  (the hybrid) pages are published under their digests but a cached
  prefix is never attached (``prefix_attach`` is off): cached pages cannot
  rebuild the recurrent state, so every prompt is prefilled whole.

* **int8 page pool** (``kv_dtype="int8"``) — pages stored as int8 with one
  f32 scale per (layer, kv head, page); a decode row or a prefill chunk is
  quantized into its pages as it is written (the scale of a page grows
  monotonically within its life), and the paged kernels dequantize inside
  the kernel.  The digest chain's seed folds in ``kv_dtype``, as in the
  JAX engine, so the two pools' pages never alias in the registry.
* **Sequence-sharded page pool** (``seq_shards=S``, a power of two) — the
  ``BlockAllocator`` splits the pool into S shards of ``nbl = NB / S``
  pages, each with its own null page at local 0, and places a slot's
  logical block ``j`` on shard ``j % S`` (round-robin, fill-local when that
  shard is full), with the JAX engine's free-list order, so block tables
  match JAX's.  Each decode step and prefill chunk gets the shard-local
  tables (``BlockAllocator.shard_local``; foreign pages -> local 0), every
  attention layer runs the skip_null partial kernel once per shard over its
  view of the pool, and ``core.noc.tree_softmax_combine`` merges the
  ``(acc, m, l)`` partials — the paper's in-transit NoC softmax, its hop and
  energy totals in ``stats["noc_*"]``.  Greedy outputs are token-identical
  to one shard.  Where the JAX engine puts shard s on device s of a ``seq``
  mesh (and checks the device count), the port keeps the one pool on the
  one card and shard s is the view of its page axis that device s would
  hold: NCCL refuses two ranks on one device, so a mesh on one card has
  nothing to shard, and no device count is checked.  Shards on several
  cards over ``torch.distributed`` come with the distributed slice.

* **Progress-preserving preemption** (a pool below full capacity,
  ``num_blocks``) — an allocation deadlock under page pressure (every live
  slot waiting on pages, nothing moved) is broken by evicting the cheapest
  victim (pages held x restore seconds x the class weight), and with
  ``proactive_horizon > 0`` a victim is evicted before the stall, when the
  active slots' page demand over the next ticks exceeds the grantable pool.
  The victim keeps its progress: its pages are **swapped** to a host arena
  (``serve/swap.py``, pinned host tensors on the card; pages registered
  under the victim's own digest chain are pinned in the pool instead and
  re-attached by reference; a slot-state family's blob rides along) and
  copied back at restore, or **dropped and recomputed**: full pages,
  decoded ones included, are published under the chained digest first, and
  the rest is re-prefilled from ``prompt + out_tokens``.
  ``preempt_policy`` "swap", "recompute" or "auto" (``core.noc``'s cost
  model, the paper's CXL link against its PIM banks); a full arena turns a
  swap into a recompute.  Preempted requests re-admit ahead of new ones,
  and no decoded token is replayed, so greedy outputs are token-identical
  to an unpressured run.  The JAX engine's machinery, order for order.

* **Expert telemetry and the placement-aware expert cache** (an MoE
  family on the runner path, ``expert_cache_size``) — every prefill chunk
  and decode step also returns its per-layer expert load [L, E_pad] and
  drop fraction (one device-to-host read per dispatch, only with the cache
  on), folded into the ``expert_*`` stats (load, routed and dropped tokens,
  skew, Gini) and into ``serve/expert_cache.py``'s ``ExpertCache``: LRU
  residency in the paper's SRAM-PIM tier with EMA promotion through the
  NoC cost gate, double-buffered prefetch (``expert_prefetch``), or the
  static placement (``expert_placement="static"``).  The cache is a
  host-side model: it never changes what the card computes, only the
  ``expert_*`` counters; ``reset_stats`` keeps its placement.

* **Expert parallelism** (an MoE family on the runner path,
  ``expert_parallel=N``) — every MoE layer's routed experts split N ways
  (``models/moe.py``'s expert-parallel dispatch): shard e is the view of
  the banks that device e of JAX's ``expert`` mesh axis would hold, the
  routing is replicated, and the shards' outputs are summed in shard order
  where JAX ``psum``s them.  It turns the expert telemetry on (the
  ``expert_*`` load stats), composes with the expert cache and with
  ``seq_shards`` (attention per sequence shard, the MoE layer per expert
  shard, as on JAX's ``(seq, expert)`` mesh).  As for ``seq_shards``, the
  shards stay on the one card, and no device count is checked.

* **Prefill/decode roles** (``role="prefill"`` or ``"decode"``, paired by
  ``serve/disagg.py:DisaggServer``) — a prefill-role engine admits and
  prefills, samples the first token and parks the request
  (``poll_handoffs``) until ``stage_handoff`` moves its page chain's
  uncached remainder (and a slot-state blob) into the pinned arena the
  server owns; a decode-role engine admits only staged
  ``swap.HandoffHandle``s (``submit_handoff``, the rid adopted):
  cached pages re-attached by reference, the rest copied in from the arena,
  the slot state inserted, all or nothing (a full pool defers it,
  ``stats["handoff_stalls"]``), and decode resumes at the staged position
  from the prefill side's token.  The JAX engine's machinery, order for
  order.

The JAX engine's ``q_tile`` and its prefill-bucket VMEM guard have no
counterpart (construction refuses a ``q_tile``): the CUDA prefill kernel's
query tile is fixed, so no chunk size can overflow its shared memory.
"""
from __future__ import annotations

import hashlib
import itertools
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import noc
from repro_torch.models import model as M
from repro_torch.models.runner import ModelRunner
from repro_torch.serve import swap
from repro_torch.serve.expert_cache import ExpertCache

# Latency classes and their default weights (the JAX engine's): a victim's
# eviction score is pages x restore seconds x its class's weight, and
# admission serves heavier classes first, by deficit-weighted round-robin
# among fresh work.  The engine's ``class_weights`` overrides or extends them.
LATENCY_CLASSES = ("interactive", "batch")
CLASS_WEIGHTS = {"interactive": 8.0, "batch": 1.0}
PREEMPT_POLICIES = ("swap", "recompute", "auto")


def _gini(x: np.ndarray) -> float:
    """Gini coefficient of a nonnegative load vector (0: balanced, towards
    1: all the load on one expert), as the JAX engine's."""
    x = np.sort(np.asarray(x, np.float64))
    n, tot = x.size, float(x.sum())
    if n < 2 or tot <= 0.0:
        return 0.0
    i = np.arange(1, n + 1)
    return float(2.0 * (i * x).sum() / (n * tot) - (n + 1.0) / n)


@dataclass
class Request:
    """One in-flight generation request (engine-internal mutable record)."""
    rid: int
    prompt: np.ndarray                  # [len] int32
    max_new_tokens: int = 32
    temperature: float = 0.0            # 0: greedy
    eos_id: Optional[int] = None
    priority: str = "interactive"       # latency class
    deadline_ms: Optional[float] = None  # SLO deadline, submit -> finish
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    prefill_pos: int = 0                # tokens already prefilled (chunked)
    cached_len: int = 0                 # prefix tokens served from cache
    ttft: Optional[float] = None        # submit -> first token (seconds)
    tpot: Optional[float] = None        # seconds per decode token (mean)
    submit_tick: int = 0
    first_tick: Optional[int] = None
    finish_tick: Optional[int] = None
    _t_submit: float = 0.0
    _t_first: float = 0.0
    resume_len: int = 0                 # preempted: KV tokens to restore
    _preempted_live: int = 0            # KV tokens live at last eviction
    _digests: List[bytes] = field(default_factory=list)  # per-full-page chain
    _published: int = 0                 # this slot's pages already registered
    _resume_tokens: Optional[np.ndarray] = None  # prompt + decoded, [resume_len]
    _swap: Optional[swap.SwapHandle] = None      # parked progress (swap arm)
    _await_handoff: bool = False        # prefill role: parked after prefill
    _handoff: Optional[swap.HandoffHandle] = None  # decode role: staged


class RequestFuture(int):
    """Handle returned by ``submit()``: an ``int`` (the request id) that can
    also poll (``done``/``tokens``) or drive the engine (``result``/
    ``stream``) until its request finishes."""

    def __new__(cls, rid: int, driver):
        self = super().__new__(cls, rid)
        self._driver = driver
        return self

    @property
    def rid(self) -> int:
        return int(self)

    def done(self) -> bool:
        return self._driver._future_done(int(self))

    def tokens(self) -> List[int]:
        return list(self._driver._future_tokens(int(self)))

    def result(self, max_ticks: int = 10_000) -> List[int]:
        for _ in range(max_ticks):
            if self.done():
                return self.tokens()
            self._driver._future_step()
        raise RuntimeError(
            f"request {int(self)} unfinished after {max_ticks} ticks")

    def stream(self, max_ticks: int = 10_000):
        sent = 0
        for _ in range(max_ticks):
            toks = self._driver._future_tokens(int(self))
            while sent < len(toks):
                yield toks[sent]
                sent += 1
            if self.done():
                return
            self._driver._future_step()
        raise RuntimeError(
            f"request {int(self)} unfinished after {max_ticks} ticks")


def sample_tokens(logits: torch.Tensor, temperature,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One token per row of ``logits`` [B, V] (a device tensor of int64):
    where the row's ``temperature`` (B host floats) is 0, the argmax of its
    raw logits; where it is above 0, the Gumbel-max draw ``argmax(logits / T
    + G)`` in f32, ``G = -log(-log(U))`` with U uniform from ``generator``
    (the form of ``jax.random.categorical``).  A batch of greedy rows draws
    nothing from the generator."""
    greedy = torch.argmax(logits, dim=-1)
    temps = np.asarray(temperature, np.float32).reshape(-1)
    hot = temps > 0
    if not hot.any():
        return greedy
    lf = logits.float()
    t = torch.from_numpy(np.where(hot, temps, np.float32(1))).to(lf.device)
    u = torch.rand(lf.shape, generator=generator, device=lf.device,
                   dtype=torch.float32)
    drawn = torch.argmax(lf / t[:, None] - torch.log(-torch.log(u)), dim=-1)
    return torch.where(torch.from_numpy(hot).to(lf.device), drawn, greedy)


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _page_digests(prompt: np.ndarray, block_size: int, n_pages: int,
                  seed: bytes = b"\x00" * 16) -> List[bytes]:
    """Chained content hash per full prompt page: page i's digest commits to
    every token in [0, (i+1)*BS), so equal digests <=> equal page prefix."""
    digests, parent = [], seed
    for i in range(n_pages):
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(np.ascontiguousarray(
            prompt[i * block_size:(i + 1) * block_size], np.int32).tobytes())
        parent = h.digest()
        digests.append(parent)
    return digests


class BlockAllocator:
    """Host-side refcounted physical-page pool, per-slot block tables and the
    prefix-cache registry.  Page 0 is the null sink (never handed out).  A
    registered page whose refcount drops to zero parks in an LRU, still
    matchable, and is reclaimed (oldest first) only when the free lists run
    dry.

    With ``num_shards > 1`` the pool is sequence-sharded: shard ``s`` owns
    global pages ``[s*nb_local, (s+1)*nb_local)`` and keeps its local page 0
    (global ``s*nb_local``) as its null sink.  A slot's logical block ``j``
    prefers shard ``j % num_shards`` and falls back to the next shard with a
    free page.  The prefix-cache registry keys on content digests, so a
    cached chain attaches by reference whichever shards hold its pages.
    The JAX engine's allocator, order for order."""

    def __init__(self, num_blocks: int, block_size: int, slots: int,
                 max_blocks_per_slot: int, num_shards: int = 1):
        if num_blocks % num_shards:
            raise ValueError(f"num_blocks={num_blocks} not divisible by "
                             f"num_shards={num_shards}")
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.num_shards = num_shards
        self.nb_local = num_blocks // num_shards
        if self.nb_local < 2:
            raise ValueError("each shard needs >= 1 usable page beyond its "
                             f"null page (nb_local={self.nb_local})")
        # per-shard free lists, popped lowest id first (one shard: 1, 2, ...)
        self._free_by_shard = [
            list(range(s * self.nb_local + self.nb_local - 1,
                       s * self.nb_local, -1))
            for s in range(num_shards)]
        self.refcount = np.zeros((num_blocks,), np.int32)
        self.table = np.zeros((slots, max_blocks_per_slot), np.int32)
        self.used = np.zeros((slots,), np.int32)
        self._hash_to_page: Dict[bytes, int] = {}
        self._page_hash: Dict[int, bytes] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.pages_allocated = 0
        self.pages_freed = 0
        self.pages_shared = 0
        self.pages_evicted = 0

    @property
    def free_blocks(self) -> int:
        """Pages grantable right now: truly free + reclaimable cached."""
        return sum(len(fl) for fl in self._free_by_shard) + len(self._lru)

    @property
    def usable_blocks(self) -> int:
        """Pool capacity minus the per-shard null pages."""
        return self.num_blocks - self.num_shards

    @property
    def cached_blocks(self) -> int:
        return len(self._lru)

    def owner(self, page: int) -> int:
        return page // self.nb_local

    def shard_local(self, table: np.ndarray) -> np.ndarray:
        """Global-id block table [..., MB] -> per-shard local tables
        [S, ..., MB]: an entry shard ``s`` owns keeps its local index in
        row ``s``, every other entry maps to that shard's null page 0 (the
        kernels' skip_null contract).  One shard returns the table under a
        leading unit axis."""
        t = np.asarray(table, np.int64)
        owner = t // self.nb_local
        local = (t % self.nb_local).astype(np.int32)
        out = np.zeros((self.num_shards,) + t.shape, np.int32)
        for s in range(self.num_shards):
            np.copyto(out[s], local, where=owner == s)
        return out

    def reset_counters(self) -> None:
        self.pages_allocated = self.pages_freed = 0
        self.pages_shared = self.pages_evicted = 0

    def _reclaim(self, preferred: int = 0) -> Optional[int]:
        for i in range(self.num_shards):
            fl = self._free_by_shard[(preferred + i) % self.num_shards]
            if fl:
                return fl.pop()
        if self._lru:                      # evict the coldest cached page
            page, _ = self._lru.popitem(last=False)
            del self._hash_to_page[self._page_hash.pop(page)]
            self.pages_evicted += 1
            return page
        return None

    def alloc_page(self, slot: int) -> Optional[int]:
        """Grant one exclusive page to ``slot``, on the round-robin shard of
        its next logical block when that shard has one; None if none is
        grantable."""
        if self.used[slot] >= self.table.shape[1]:
            return None
        page = self._reclaim(int(self.used[slot]) % self.num_shards)
        if page is None:
            return None
        self.refcount[page] = 1
        self.table[slot, self.used[slot]] = page
        self.used[slot] += 1
        self.pages_allocated += 1
        return page

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s table to cover ``n_tokens``; False if it cannot."""
        need = -(-n_tokens // self.block_size)
        if need > self.table.shape[1]:
            return False
        while self.used[slot] < need:
            if self.alloc_page(slot) is None:
                return False
        return True

    def share(self, slot: int, page: int) -> bool:
        """Append a cache-hit page to ``slot``'s table (refcount bump; a
        parked page is resurrected out of the LRU)."""
        if self.used[slot] >= self.table.shape[1]:
            return False
        if self.refcount[page] == 0:
            self._lru.pop(page, None)
        self.refcount[page] += 1
        self.table[slot, self.used[slot]] = page
        self.used[slot] += 1
        self.pages_shared += 1
        return True

    def release(self, slot: int) -> None:
        """Drop every page reference the slot holds, tail block first, so a
        cached chain parks suffix-first and LRU eviction eats suffixes
        before heads."""
        for i in reversed(range(int(self.used[slot]))):
            self._unref(int(self.table[slot, i]))
        self.table[slot] = 0
        self.used[slot] = 0

    def _unref(self, page: int) -> None:
        if self.refcount[page] <= 0:
            raise RuntimeError(f"double free of physical page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self.pages_freed += 1
            if page in self._page_hash:
                self._lru[page] = None     # park: matchable until evicted
            else:
                self._free_by_shard[self.owner(page)].append(page)

    # -- prefix-cache registry -----------------------------------------
    def register(self, page: int, digest: bytes) -> bool:
        """Publish a completed full prompt page; first writer wins."""
        if digest in self._hash_to_page or page in self._page_hash:
            return False
        self._hash_to_page[digest] = page
        self._page_hash[page] = digest
        return True

    def lookup(self, digest: bytes) -> Optional[int]:
        return self._hash_to_page.get(digest)

    def page_digest(self, page: int) -> Optional[bytes]:
        return self._page_hash.get(page)

    # -- out-of-table references ---------------------------------------
    def pin(self, page: int) -> None:
        """Hold a reference to ``page`` without a table slot."""
        if self.refcount[page] <= 0:
            raise RuntimeError(f"pin of unreferenced physical page {page}")
        self.refcount[page] += 1

    def acquire(self, page: int) -> None:
        """As :meth:`pin`, but may take back a parked (refcount 0,
        registered) page out of the LRU: handoff staging acquires the
        decode pool's cached chain prefix, so eviction cannot invalidate
        the match before admission.  Only a registered page may be
        acquired from refcount 0 (an unregistered one is on a free list)."""
        if self.refcount[page] == 0:
            if page not in self._page_hash:
                raise RuntimeError(
                    f"acquire of free unregistered physical page {page}")
            self._lru.pop(page, None)
        self.refcount[page] += 1

    def unpin(self, page: int) -> None:
        self._unref(page)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_seq: int = 512,
                 slots: int = 8, seed: int = 0,
                 prefill_buckets=(32, 128, 512, 2048),
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 max_tokens_per_tick: Optional[int] = None,
                 paged: Optional[bool] = None,
                 prefix_caching: Optional[bool] = None,
                 kv_dtype: str = "fp16", seq_shards: int = 1,
                 preempt_policy: str = "auto",
                 swap_pages: Optional[int] = None,
                 class_weights: Optional[Dict[str, float]] = None,
                 class_deadlines_ms: Optional[Dict[str, float]] = None,
                 proactive_horizon: int = 0,
                 expert_parallel: Optional[int] = None,
                 expert_cache_size: Optional[int] = None,
                 expert_prefetch: bool = True,
                 expert_placement: str = "adaptive",
                 role: Optional[str] = None,
                 q_tile: Optional[int] = None):
        """Stand up a serving engine over ``params``.

        The engine runs where the parameters live (``init_params`` puts them
        on the card unless asked for the CPU); their dtype is the pool's.
        ``seed``: the sampling generator's seed (rows at ``temperature``
        0 draw nothing from it).  ``prefill_buckets``: chunk sizes for
        chunked prefill (``max_seq`` is always added).  ``num_blocks``:
        page-pool size (default full capacity, ``slots * ceil(max_seq /
        block_size)`` plus a null page per shard); a smaller pool
        oversubscribes, and the engine then stalls, preempts and restores
        under pressure.
        ``max_tokens_per_tick``: padded-token budget per tick shared by
        decode (reserved first) and prefill; default ``slots`` + the largest
        bucket.  ``paged``: None serves through the runner (the page pool for a
        family with a paged component, slot state for one without), True
        demands a paged component, False serves from the dense slabs
        (``block_size`` and ``num_blocks`` then unused).
        ``prefix_caching``: share full prompt pages across requests
        (default: on when paged; it needs the pool).  ``kv_dtype``: page
        storage, "fp16" (the engine dtype) or "int8" (int8 pages with
        per-page scales; paged only).  ``seq_shards``: sequence-shard the
        page pool S ways (a power of two; paged only), each shard's
        partials merged by the NoC tree combine.  ``preempt_policy``: how
        a preemption victim keeps its progress, "swap" (pages to the host
        arena), "recompute" (re-prefilled at restore; prefix-cache hits skip
        most of it) or "auto" (per victim, ``core.noc.preempt_decision``).
        ``swap_pages``: the host arena's capacity in pages (default one full
        pool's); a full arena turns a swap into a recompute.
        ``class_weights``: latency class -> weight (positive), over
        ``CLASS_WEIGHTS``; admission and the victim score follow it.
        ``class_deadlines_ms``: a class's default SLO deadline (submit ->
        finish, wall ms), counted in ``stats["slo_violations"]`` and
        ``class_stats``.  ``proactive_horizon``: ticks of look-ahead for
        proactive preemption (0: only a deadlock preempts).
        ``expert_cache_size``: SRAM-PIM-resident experts per layer of the
        placement-aware expert cache (an MoE family on the runner path;
        None, the default, turns the cache and its telemetry off);
        ``expert_prefetch``: stage promotions a tick ahead (False commits
        them at once); ``expert_placement``: "adaptive" (hot experts
        migrate, ``core.noc.expert_placement_cost``) or "static" (the
        initial placement, the A/B baseline).
        ``expert_parallel``: split an MoE family's routed experts N ways
        (N >= 1 dividing the padded expert count; the runner path), each
        shard a view of the card's banks, the shards' outputs summed; it
        turns the expert telemetry on.  JAX checks that ``seq_shards`` x N
        devices are visible; the port's shards stay on its one card, so
        nothing is checked.  ``role``: None (both phases), "prefill" (admit
        and prefill, then park each request for ``stage_handoff``) or
        "decode" (admit only ``submit_handoff``'s staged prefills and
        decode them); a role needs the runner path.  ``q_tile``: the JAX
        engine's Pallas query tile, which has no counterpart here."""
        if q_tile is not None:
            raise NotImplementedError(
                "engine option q_tile has no counterpart in repro_torch: the "
                "CUDA paged prefill's query tile is fixed, so no chunk size "
                "can overflow its shared memory")
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.slots = slots
        table = params["embed"]["table"]
        self.device, self.dtype = table.device, table.dtype
        self.runner = ModelRunner(cfg, slots, max_seq, kv_dtype=kv_dtype)
        self.kv_dtype = kv_dtype
        spec = self.runner.spec
        if paged and not spec.has_paged:
            raise ValueError(
                f"family {cfg.family!r} has no paged cache components "
                f"(CacheSpec: slot state only) — serve it with paged=None "
                f"(slot-state continuous batching) or paged=False (the "
                f"dense-slab A/B baseline)")
        # paged=None/True: the runner path (paged components through block
        # tables, slot state batched over the slots); paged=False: the
        # dense-slab baseline (monolithic prefill)
        self.dense_baseline = paged is False
        self.paged = not self.dense_baseline and spec.has_paged
        self.has_slot_state = not self.dense_baseline and spec.has_slot_state
        if kv_dtype == "int8" and not self.paged:
            raise ValueError(
                "kv_dtype='int8' quantizes the paged page pool — serve with "
                "a paged KV component (or keep kv_dtype='fp16')")
        if prefix_caching and not self.paged:
            raise ValueError("prefix_caching requires a paged KV component")
        self.prefix_caching = (self.paged if prefix_caching is None
                               else bool(prefix_caching))
        # a slot-state family publishes page digests but never skips prefill
        # at admission: cached pages cannot rebuild the recurrent state that
        # must advance through those tokens
        self.prefix_attach = self.prefix_caching and not self.has_slot_state
        # attention applications per token over the pool (L layers, or the
        # hybrid shared block's G): the NoC combines of a sharded dispatch
        self._n_apps = self.runner.attn_applications if self.paged else 0
        # kv_dtype-salted seed of the digest chain, as in the JAX engine:
        # int8 and fp16 pages never alias in the prefix registry
        self._digest_seed = hashlib.blake2b(
            b"kv_dtype:" + kv_dtype.encode(), digest_size=16).digest()
        self.seq_shards = int(seq_shards)
        if self.seq_shards < 1 or (self.seq_shards & (self.seq_shards - 1)):
            raise ValueError(
                f"seq_shards must be a power of two, got {seq_shards} "
                "(the NoC butterfly combine is a recursive-doubling tree)")
        if self.seq_shards > 1 and not self.paged:
            raise ValueError("seq_shards > 1 requires the paged KV cache")
        if expert_placement not in ("adaptive", "static"):
            raise ValueError(
                f"expert_placement must be 'adaptive' or 'static', got "
                f"{expert_placement!r}")
        self.expert_parallel = (None if expert_parallel is None
                                else int(expert_parallel))
        if self.expert_parallel is not None:
            if self.expert_parallel < 1:
                raise ValueError(
                    f"expert_parallel must be >= 1, got {expert_parallel}")
            if cfg.n_experts <= 0:
                raise ValueError(
                    f"expert_parallel requires a MoE family "
                    f"(cfg.n_experts > 0); {cfg.family!r} has none")
            if self.dense_baseline:
                raise ValueError(
                    "expert_parallel shards the runner dispatch — it is "
                    "incompatible with the dense-slab baseline "
                    "(paged=False)")
            e_pad = self.runner.padded_experts()
            if e_pad % self.expert_parallel:
                raise ValueError(
                    f"expert_parallel={self.expert_parallel} must divide "
                    f"the padded expert count ({e_pad})")
        self.expert_cache: Optional[ExpertCache] = None
        if expert_cache_size is not None:
            if cfg.n_experts <= 0:
                raise ValueError(
                    f"expert_cache_size requires a MoE family "
                    f"(cfg.n_experts > 0); {cfg.family!r} has none")
            if self.dense_baseline:
                raise ValueError(
                    "expert_cache_size needs the runner path's expert "
                    "telemetry — incompatible with paged=False")
            self.expert_cache = ExpertCache(
                cfg.n_layers, self.runner.padded_experts(),
                int(expert_cache_size),
                self.runner.expert_weight_bytes(self.dtype.itemsize),
                prefetch=expert_prefetch,
                adaptive=(expert_placement == "adaptive"))
        # the telemetry is asked of the runner only with expert parallelism
        # or the cache (the keywords passed only then): an engine without
        # either reads nothing more from the card
        self._moe_stats = (not self.dense_baseline and cfg.n_experts > 0
                           and (self.expert_parallel is not None
                                or self.expert_cache is not None))
        self._moe_kw = {"expert_stats": True} if self._moe_stats else {}
        if self.expert_parallel is not None:
            self._moe_kw["expert_parallel"] = self.expert_parallel

        bks = sorted({min(b, max_seq) for b in prefill_buckets} | {max_seq})
        self.prefill_buckets = tuple(bks)
        self.max_tokens_per_tick = (max_tokens_per_tick if max_tokens_per_tick
                                    else slots + self.prefill_buckets[-1])
        if self.max_tokens_per_tick < self.prefill_buckets[0]:
            # a decode-role engine under swap-only preemption never runs a
            # prefill chunk (handoff admission and swap restores insert
            # pages directly), so its budget only has to cover decodes
            if not (role == "decode" and preempt_policy == "swap"):
                raise ValueError(
                    f"max_tokens_per_tick={self.max_tokens_per_tick} can "
                    f"never afford the smallest prefill bucket "
                    f"({self.prefill_buckets[0]}); no request could ever "
                    f"start (role='decode' with preempt_policy='swap' is "
                    f"exempt: it admits handoffs, never prefill chunks)")
        if preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(
                f"preempt_policy must be 'swap', 'recompute' or 'auto', "
                f"got {preempt_policy!r}")
        self.preempt_policy = preempt_policy
        if role not in (None, "prefill", "decode"):
            raise ValueError(
                f"role must be None, 'prefill' or 'decode', got {role!r}")
        if role is not None and self.dense_baseline:
            raise ValueError(
                "role-restricted engines hand KV progress across workers "
                "— the dense-slab baseline (paged=False) has no "
                "extract/insert page path; serve it monolithic")
        self.role = role
        self.proactive_horizon = int(proactive_horizon)
        if self.proactive_horizon < 0:
            raise ValueError(
                f"proactive_horizon must be >= 0, got {proactive_horizon}")
        self.class_weights = dict(CLASS_WEIGHTS)
        if class_weights:
            self.class_weights.update(class_weights)
        if any(w <= 0 for w in self.class_weights.values()):
            raise ValueError(f"class weights must be positive: "
                             f"{self.class_weights}")
        # admission order: heaviest class first, by name on ties
        self.class_order = tuple(sorted(
            self.class_weights, key=lambda c: (-self.class_weights[c], c)))
        self.class_deadlines_ms = dict(class_deadlines_ms or {})
        unknown = set(self.class_deadlines_ms) - set(self.class_weights)
        if unknown:
            raise ValueError(
                f"class_deadlines_ms names unknown classes {sorted(unknown)}"
                f"; this engine serves {sorted(self.class_weights)}")
        # deficit round-robin credit per class (fresh admissions only)
        self._deficit = {cls: 0.0 for cls in self.class_order}
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.block_size = block_size
        self.blocks_per_slot = -(-max_seq // block_size)
        self.alloc: Optional[BlockAllocator] = None
        if self.paged:
            S = self.seq_shards
            if num_blocks is None:                 # a null page per shard
                num_blocks = S + slots * self.blocks_per_slot
            num_blocks = S * -(-num_blocks // S)   # whole shards, as in JAX
            self.alloc = BlockAllocator(num_blocks, block_size, slots,
                                        self.blocks_per_slot, num_shards=S)
            self.state = self.runner.init_state(num_blocks, block_size,
                                                self.dtype, self.device)
        elif not self.dense_baseline:
            # slot-state-only runner path: no page pool at all
            self.state = self.runner.init_state(0, block_size, self.dtype,
                                                self.device)
        else:
            self.state = self.runner.init_dense_state(self.dtype, self.device)

        self._slot_state_bytes = (self.runner.slot_state_bytes(self.state)
                                  if self.has_slot_state else 0)

        self.lengths = np.zeros((slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        # one FIFO per latency class, admitted in class_order by _admit
        self._queues: Dict[str, Deque[Request]] = {
            cls: deque() for cls in self.class_order}
        # preempted requests re-admit from here ahead of new submissions
        self.restore_queue: Deque[Request] = deque()
        self.swap_pages = (swap_pages if swap_pages is not None
                           else (slots * self.blocks_per_slot
                                 if self.paged else 0))
        self._arena: Optional[swap.SwapArena] = None   # built at first swap
        self._stalled_this_tick = False
        self._rid = itertools.count()
        self._reqs: Dict[int, Request] = {}
        self._tick = 0
        self.stats: Dict[str, float] = {}
        self.reset_stats()

    @staticmethod
    def _zero_class_stats() -> Dict[str, float]:
        return {"submitted": 0, "finished": 0, "finished_tokens": 0,
                "preemptions": 0, "slo_violations": 0}

    @property
    def queue(self) -> List[Request]:
        """Queued requests, class by class in ``class_order`` and by age
        within a class: a snapshot, not the admission order (``_admit``
        interleaves classes by deficit round-robin)."""
        return [r for cls in self.class_order for r in self._queues[cls]]

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # -- submission ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_id: Optional[int] = None, temperature: float = 0.0,
               priority: str = "interactive",
               deadline_ms: Optional[float] = None) -> RequestFuture:
        """Queue one generation request; returns a :class:`RequestFuture`.
        ``temperature`` 0 is greedy; ``priority`` is the latency class (a
        key of ``class_weights``); ``deadline_ms`` overrides the class's
        SLO deadline.  Empty or out-of-vocab prompts raise (an out-of-vocab
        id would poison recycled pages), as do an unknown class and a
        request that could never fit the pool.  With prefix caching the
        chained page digests are computed here so admission can attach the
        longest cached prefix.  A decode-role engine refuses: it admits
        only through :meth:`submit_handoff`."""
        if self.role == "decode":
            raise RuntimeError(
                "decode-role engine admits handoffs only; submit prompts "
                "to the prefill role (or the DisaggServer front door)")
        prompt = np.array(prompt, np.int32, copy=True)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(
                f"token ids must be in [0, {self.cfg.vocab_size}); got "
                f"range [{prompt.min()}, {prompt.max()}]")
        req = Request(next(self._rid), prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, eos_id=eos_id,
                      priority=priority, deadline_ms=deadline_ms)
        if req.priority not in self.class_weights:
            raise ValueError(
                f"unknown latency class {req.priority!r}; this engine "
                f"serves {sorted(self.class_weights)}")
        req._t_submit = time.perf_counter()
        req.submit_tick = self._tick
        pages = -(-min(self._plen(req) + req.max_new_tokens, self.max_seq)
                  // self.block_size)
        if self.paged and pages > self.alloc.usable_blocks:
            raise ValueError(
                f"request needs up to {pages} KV pages but the pool has only "
                f"{self.alloc.usable_blocks}; raise num_blocks or shrink the "
                f"request")
        if self.prefix_caching:
            req._digests = _page_digests(prompt, self.block_size,
                                         self._plen(req) // self.block_size,
                                         seed=self._digest_seed)
        return self._enqueue(req)

    def _enqueue(self, req: Request) -> RequestFuture:
        self.class_stats[req.priority]["submitted"] += 1
        self._reqs[req.rid] = req
        self._queues[req.priority].append(req)
        return RequestFuture(req.rid, self)

    def submit_handoff(self, handle: swap.HandoffHandle) -> RequestFuture:
        """Queue one staged prefill (a ``swap.HandoffHandle``) for admission
        on the decode side.  A prefill-role engine refuses; a monolithic one
        accepts (the round trip alone, as the tests run it).  The handle's
        rid is adopted, so this engine's own rid counter is never consumed
        and the future is the one the server's front door returned.  No
        token is sampled here: decode resumes by feeding the last of the
        handle's ``out_tokens``."""
        if self.role == "prefill":
            raise RuntimeError("prefill-role engine cannot admit handoffs")
        req = Request(int(handle.rid), np.array(handle.prompt, np.int32),
                      max_new_tokens=handle.max_new_tokens,
                      temperature=handle.temperature,
                      eos_id=handle.eos_id, priority=handle.priority,
                      deadline_ms=handle.deadline_ms)
        if req.priority not in self.class_weights:
            raise ValueError(
                f"unknown latency class {req.priority!r}; this engine "
                f"serves {sorted(self.class_weights)}")
        req.out_tokens = list(handle.out_tokens)
        req._digests = list(handle.digests)
        req._handoff = handle
        req._t_submit = handle.t_submit or time.perf_counter()
        req.ttft = handle.ttft
        req.submit_tick = self._tick
        return self._enqueue(req)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def _plen(self, req: Request) -> int:
        return max(1, min(len(req.prompt),
                          self.max_seq - req.max_new_tokens - 1))

    def _prefill_target(self, req: Request) -> int:
        """Tokens that must be in the KV cache before ``req`` can decode: the
        clamped prompt, or for a decode-phase preemption victim
        ``resume_len`` (prompt and decoded tokens)."""
        if req.out_tokens and req.resume_len:
            return req.resume_len
        return self._plen(req)

    def _prefill_source(self, req: Request) -> np.ndarray:
        """What chunked prefill reads: the prompt, or for a decode-phase
        restore the preserved ``prompt + out_tokens[:-1]``."""
        if req.out_tokens and req.resume_len:
            return req._resume_tokens
        return req.prompt

    # -- scheduling ----------------------------------------------------
    def _admit(self) -> None:
        """Move requests into free slots, in the JAX engine's two phases.
        **Restores first**, class by class in ``class_order``, FIFO within
        a class: a restore that cannot be placed yet (a swap-in short of
        free pages) holds back everything of its own and every lighter
        class, so equal or lighter new work never takes the pages its
        victim was evicted to free, while a strictly heavier class may
        still pass it.  **Fresh submissions** then go by deficit-weighted
        round-robin over the classes above that barrier: when no candidate
        class has a credit, each gains its weight; the class with the most
        credit (the heavier on ties) admits its oldest request and spends
        one.  A class's credit resets while its queue is empty, so an idle
        engine admits a burst in class-then-age order.  Each admission
        attaches the prompt's longest cached page prefix.  A queue head
        that carries a ``HandoffHandle`` is admitted by
        :meth:`_admit_handoff`; when the pool cannot take it yet it stays
        at the head, ``stats["handoff_stalls"]`` counts the deferral and its
        class is held back like a blocked restore."""
        barrier = 0.0          # classes of weight <= barrier are held back
        for cls in self.class_order:
            w = self.class_weights[cls]
            if w <= barrier:
                continue
            for req in [r for r in self.restore_queue if r.priority == cls]:
                slot = self._free_slot()
                if slot is None:
                    return
                if not self._restore(slot, req):
                    barrier = max(barrier, w)   # it waits for pages
                    break
                self.restore_queue.remove(req)
        for cls in self.class_order:
            if not self._queues[cls]:
                self._deficit[cls] = 0.0       # no credit accrues idle
        while True:
            cand = [c for c in self.class_order
                    if self._queues[c] and self.class_weights[c] > barrier]
            if not cand:
                return
            slot = self._free_slot()
            if slot is None:
                return
            if all(self._deficit[c] < 1.0 for c in cand):
                for c in cand:
                    self._deficit[c] += self.class_weights[c]
            cls = max(cand, key=lambda c: (self._deficit[c],
                                           self.class_weights[c]))
            q = self._queues[cls]
            req = q[0]
            if req._handoff is not None:
                if not self._admit_handoff(slot, req):
                    # the pool cannot take it yet: it waits at the head,
                    # and nothing of its class or lighter takes its pages
                    self.stats["handoff_stalls"] += 1
                    barrier = max(barrier, self.class_weights[cls])
                    continue
                q.popleft()
            else:
                q.popleft()
                req.prefill_pos = 0
                req.cached_len = 0
                req._published = 0
                self.active[slot] = req
                self.lengths[slot] = 0
                if self.has_slot_state:
                    # the previous occupant's state must not leak
                    self.state = self.runner.reset_slot(self.state, slot)
                if self.prefix_attach:
                    self._attach_prefix(slot, req)
            self._deficit[cls] -= 1.0

    def _admit_handoff(self, slot: int, req: Request) -> bool:
        """Adopt one staged prefill into ``slot``: share its cached pages by
        reference, allocate pages for the transferred rest and copy it in
        from the arena (one call per shard), insert the slot-state blob (or
        reset the slot), and resume decode at exactly the staged position.
        All or nothing: False, and nothing held, when the pool cannot grant
        the rest and one decode step's headroom yet.  The transferred full
        pages are registered under their digests, so a later handoff of the
        same prefix moves only its uncached rest."""
        handle = req._handoff
        n_pub = 0
        if self.paged:
            need = handle.n_pages
            grow = -(-(handle.tokens + 1) // self.block_size)
            if self.alloc.free_blocks < max(need, grow - len(handle.cached)):
                return False
            self.active[slot] = req
            for page in handle.cached:
                self.alloc.share(slot, page)
            fresh: List[int] = []
            for _ in range(need):
                page = self.alloc.alloc_page(slot)
                if page is None:        # shard rounding stranded pages
                    self.alloc.release(slot)
                    self.active[slot] = None
                    return False
                fresh.append(page)
            if fresh:
                self._pages_in(handle.arena, handle.slots, fresh)
            # register the transferred full pages, so the next handoff (or
            # a local prefix hit) of this prompt skips their transfer
            n_pub = len(handle.cached)
            if self.prefix_caching:
                full = handle.tokens // self.block_size
                chain = self.alloc.table[slot]
                for i in range(n_pub, min(full, len(handle.digests))):
                    self.alloc.register(int(chain[i]), handle.digests[i])
                    n_pub = i + 1
            # drop the staging references taken when the match was made
            for page in handle.cached:
                self.alloc.unpin(page)
            handle.arena.free(handle)
        if handle.state is not None:
            # the blob covers every slot-state key: no reset needed
            self.state = self.runner.insert_slot_state(self.state, slot,
                                                       handle.state)
        elif self.has_slot_state:
            self.state = self.runner.reset_slot(self.state, slot)
        self.active[slot] = req
        plen = self._plen(req)
        req.prefill_pos = handle.tokens
        req.cached_len = handle.tokens
        req.resume_len = handle.tokens
        req._resume_tokens = req.prompt[:plen].astype(np.int32)
        req._published = n_pub if self.paged else 0
        req._handoff = None
        self.lengths[slot] = handle.tokens
        req.first_tick = self._tick
        req._t_first = time.perf_counter()
        self.stats["handoffs"] += 1
        return True

    def _attach_prefix(self, slot: int, req: Request) -> None:
        """Share the longest registered page chain matching the prompt.  The
        match is capped at ``plen - 1`` (the final logits must come from a
        prefill chunk); when that cap lands mid-page the trailing shared page
        is duplicated copy-on-write."""
        plen = self._plen(req)
        pages: List[int] = []
        for dg in req._digests:
            page = self.alloc.lookup(dg)
            if page is None:
                break
            pages.append(page)
        match = min(len(pages) * self.block_size, plen - 1)
        if match <= 0:
            return
        n_full = match // self.block_size
        for page in pages[:n_full]:
            self.alloc.share(slot, page)
        if match > n_full * self.block_size:
            dst = self.alloc.alloc_page(slot)
            if dst is None:
                match = n_full * self.block_size     # no room: aligned match
            else:
                self.state = self.runner.copy_page(self.state, pages[n_full], dst)
                self.stats["cow_copies"] += 1
        if match <= 0:
            return
        req.prefill_pos = match
        req.cached_len = match
        req._published = match // self.block_size
        self.lengths[slot] = match
        self.stats["prefix_hits"] += 1
        self.stats["prefix_hit_tokens"] += match

    def _restore(self, slot: int, req: Request) -> bool:
        """Re-admit a preempted request into ``slot`` with its progress;
        False if it cannot be placed yet (a swap-in short of pages).  A swap
        victim gets its pages back from the arena; a recompute victim
        re-enters like a new admission, except that the cached chain it
        re-attaches may run over decoded pages (published at preemption)
        and the rest is re-prefilled from ``prompt + out_tokens``: decode
        resumes where it stopped, no sampled token replayed."""
        if req._swap is not None:
            return self._restore_swapped(slot, req)
        self.active[slot] = req
        self.lengths[slot] = 0
        req.prefill_pos = 0
        req.cached_len = 0
        req._published = 0
        if self.has_slot_state:
            # the replay runs the family's prefill from token 0
            self.state = self.runner.reset_slot(self.state, slot)
        if self.prefix_attach:
            hit0 = self.stats["prefix_hit_tokens"]
            if req.out_tokens:
                self._attach_resume(slot, req)
            else:
                self._attach_prefix(slot, req)
            # restored = preserved progress that skipped the replay, capped
            # at what this victim held (an attach may reach further through
            # pages others published), so restored <= preempted
            self.stats["restored_tokens"] += min(
                self.stats["prefix_hit_tokens"] - hit0, req._preempted_live)
        return True

    def _attach_resume(self, slot: int, req: Request) -> None:
        """Share the cached page chain of a decode-phase victim: it may run
        over decoded pages and has no ``plen - 1`` cap (the next logits come
        from decoding ``out_tokens[-1]``); only full pages were published,
        so the match is page-aligned (no copy-on-write)."""
        attached = 0
        for dg in req._digests[:req.resume_len // self.block_size]:
            page = self.alloc.lookup(dg)
            if page is None or not self.alloc.share(slot, page):
                break
            attached += 1
        match = attached * self.block_size
        req.prefill_pos = match
        req.cached_len = match
        req._published = attached
        self.lengths[slot] = match
        if match:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += match

    def _restore_swapped(self, slot: int, req: Request) -> bool:
        """Swap-in: share the handle's pinned prefix-chain pages, allocate
        fresh pages for the parked rest and copy it back (one call per
        shard), then the slot-state blob.  All or nothing: False, and
        nothing held, when the pool cannot grant the rest and the next
        token's page yet."""
        handle = req._swap
        need = handle.n_pages
        n_pin = len(handle.pinned)
        if self.alloc.free_blocks < max(
                need, -(-(handle.tokens + 1) // self.block_size) - n_pin):
            return False
        self.active[slot] = req
        for page in handle.pinned:
            self.alloc.share(slot, page)
        pages: List[int] = []
        for _ in range(need):
            page = self.alloc.alloc_page(slot)
            if page is None:            # shard rounding stranded pages
                self.alloc.release(slot)
                self.active[slot] = None
                return False
            pages.append(page)
        if pages:
            self._pages_in(self._arena, handle.slots, pages)
        if handle.state is not None:
            self.state = self.runner.insert_slot_state(self.state, slot,
                                                       handle.state)
        self.stats["swap_bytes"] += (need * self._page_kv_bytes()
                                     + handle.state_bytes)
        self.stats["restored_tokens"] += handle.tokens
        # the restored coverage is [0, tokens); a gap up to the resume
        # target (a victim preempted again mid-restore) is re-prefilled
        req.prefill_pos = handle.tokens
        req.cached_len = handle.tokens
        for page in handle.pinned:
            self.alloc.unpin(page)      # the slot's own reference remains
        handle.pinned = []
        if handle.slots:
            self._arena.free(handle)
        req._swap = None
        req._published = min(req._published, n_pin + need)
        self.lengths[slot] = req.prefill_pos
        return True

    def _pages_out(self, arena: swap.SwapArena, slots: List[int],
                   pages: List[int]) -> None:
        """Copy device ``pages`` into ``arena``'s ``slots`` (one extract a
        shard); the copies are complete on return, so the caller may free
        the pages."""
        for _, idx in self._by_shard(pages):
            ids = self._pad_pow2([pages[i] for i in idx])
            got = self.runner.extract_pages(self.state, self._to_device(ids))
            k, v, ks, vs = (None if t is None
                            else t.movedim(2, 0)[:len(idx)].contiguous()
                            for t in got)
            arena.write([slots[i] for i in idx], k, v, ks, vs)

    def _pages_in(self, arena: swap.SwapArena, slots: List[int],
                  pages: List[int]) -> None:
        """Copy ``arena``'s ``slots`` into the device ``pages`` (one insert
        a shard)."""
        parked = arena.read(slots)                 # [n, A, KvH, ...]
        for _, idx in self._by_shard(pages):
            ids = self._pad_pow2([pages[i] for i in idx])
            sel = torch.as_tensor(idx, device=self.device)
            args = [self._pad_pages(t.index_select(0, sel).movedim(0, 2))
                    for t in parked]
            self.state = self.runner.insert_pages(
                self.state, self._to_device(ids), *args)

    def _by_shard(self, pages: List[int]):
        """Positions of ``pages`` grouped by owning shard (a swap copy
        touches one shard's slice of the pool per call)."""
        groups: Dict[int, List[int]] = {}
        for i, p in enumerate(pages):
            groups.setdefault(self.alloc.owner(p), []).append(i)
        return sorted(groups.items())

    @staticmethod
    def _pad_pow2(ids: List[int]) -> np.ndarray:
        """A page-id list padded to a power of two with the null page 0."""
        out = np.zeros((_next_pow2(len(ids)),), np.int32)
        out[:len(ids)] = ids
        return out

    @staticmethod
    def _pad_pages(t: torch.Tensor) -> torch.Tensor:
        """Zero-pad the page axis (2) of pages ``[A, KvH, P, BS, hd]`` or
        scales ``[A, KvH, P]`` to :meth:`_pad_pow2`'s length."""
        p = t.shape[2]
        b = _next_pow2(p)
        if b == p:
            return t
        pad = torch.zeros(t.shape[:2] + (b - p,) + t.shape[3:], dtype=t.dtype,
                          device=t.device)
        return torch.cat([t, pad], dim=2)

    def _publish_pages(self, slot: int, req: Request) -> None:
        """Register the slot's freshly completed full pages (after a
        recompute preemption the digest chain runs over decoded pages too,
        so replayed pages republish)."""
        n_done = min(req.prefill_pos // self.block_size, len(req._digests))
        while req._published < n_done:
            i = req._published
            self.alloc.register(int(self.alloc.table[slot, i]), req._digests[i])
            req._published += 1

    def _page_bucket(self, n_pages: int) -> int:
        """Live page count rounded up to a power of two (capped at the
        per-slot maximum)."""
        return min(_next_pow2(n_pages), self.blocks_per_slot)

    def _prefill_tick(self, budget: int, finished: List[Request]) -> int:
        """Advance pending prefills chunk by chunk under ``budget`` padded
        tokens; returns the unspent budget.  Runner slots (paged or slot
        state) move chunk by chunk.  Dense slabs cannot chunk: that mode
        runs one monolithic prefill per tick, outside the budget (the JAX
        engine's A/B baseline)."""
        pending = [(slot, req) for slot, req in enumerate(self.active)
                   if req is not None
                   and req.prefill_pos < self._prefill_target(req)]
        if self.dense_baseline:
            for slot, req in pending[:1]:
                plen = self._plen(req)
                bucket = self._bucket(plen)
                logits = self._run_prefill_chunk(slot, req, bucket, plen)
                self.stats["prefill_tokens"] += plen
                self.stats["padded_tokens"] += bucket
                req.prefill_pos = plen
                self.lengths[slot] = plen
                self._finish_prefill(slot, req, logits, finished)
            return budget
        for slot, req in pending:
            plen = self._prefill_target(req)
            while req.prefill_pos < plen:
                remaining = plen - req.prefill_pos
                bucket = self._bucket(min(remaining, max(budget, 1)))
                if bucket > budget:
                    if bucket <= self.max_tokens_per_tick:
                        break                  # affordable on a richer tick
                    # the round-up bucket can never fit the budget: chunk at
                    # the largest affordable bucket instead of stalling
                    afford = [b for b in self.prefill_buckets if b <= budget]
                    if not afford:
                        break
                    bucket = afford[-1]
                n = min(remaining, bucket)
                if self.paged and not self.alloc.ensure(
                        slot, req.prefill_pos + n):
                    self.stats["stall_events"] += 1
                    self._stalled_this_tick = True
                    break                      # pool exhausted: wait
                logits = self._run_prefill_chunk(slot, req, bucket, n)
                budget -= bucket
                self.stats["padded_tokens"] += bucket
                self.stats["prefill_tokens"] += n
                req.prefill_pos += n
                self.lengths[slot] = req.prefill_pos
                if self.prefix_caching:
                    self._publish_pages(slot, req)
                # a decode-phase restore discards its last chunk's logits:
                # the next decode feeds out_tokens[-1] (never re-sampled)
                if req.prefill_pos >= plen and not req.out_tokens:
                    self._finish_prefill(slot, req, logits, finished)
        return budget

    def _run_prefill_chunk(self, slot: int, req: Request, bucket: int, n: int):
        self.stats["prefill_dispatches"] += 1
        padded = np.zeros((1, bucket), np.int32)
        src = self._prefill_source(req)
        padded[0, :n] = src[req.prefill_pos:req.prefill_pos + n]
        if self.dense_baseline:
            return self.runner.prefill_slot(self.params, self.state, slot,
                                            self._to_device(padded), n)
        table = local = None                # slot state only: no tables
        if self.paged:
            # only the live prefix of the block table, rounded up to a power
            # of two: per-chunk attention work follows the cached length
            n_live = -(-(req.prefill_pos + n) // self.block_size)
            mb = self._page_bucket(n_live)
            bt = np.zeros((mb,), np.int32)
            u = min(int(self.alloc.used[slot]), mb)
            bt[:u] = self.alloc.table[slot, :u]
            table, S = self._to_device(bt), self.seq_shards
            if S > 1:
                local = self._to_device(self.alloc.shard_local(bt))  # [S, mb]
                self._account_noc_combine(rows=bucket)
            if self.device.type == "cpu":
                # the CPU path gathers k and v per layer per chunk and shard
                # (the kernel reads pages through the table, gathers nothing)
                self.stats["gather_pages_calls"] += 2 * self._n_apps * S
                self.stats["gather_page_volume"] += 2 * self._n_apps * mb * S
        out = self.runner.prefill_chunk(
            self.params, self.state, self._to_device(padded), n,
            req.prefill_pos, table, slot, local, **self._moe_kw)
        logits, self.state = out[:2]
        if self._moe_stats:
            self._account_expert(out[2], rows=bucket)
        return logits

    def _account_noc_combine(self, rows: int) -> None:
        """Charge the in-transit combine traffic of one sharded dispatch:
        one tree_softmax_combine per attention application (L layers, or
        the hybrid shared block's G) over ``rows`` query rows (the slots
        for a decode step, the bucket for a prefill chunk)."""
        cfg, n = self.cfg, self._n_apps
        c = noc.softmax_combine_cost(rows, cfg.n_heads, cfg.hd, self.seq_shards)
        self.stats["noc_combines"] += n
        self.stats["noc_hops"] += n * c["hops"]
        self.stats["noc_bytes"] += n * c["bytes"]
        self.stats["noc_energy_pj"] += n * c["energy_pj"]

    def _account_expert(self, est, rows: int) -> None:
        """Fold one dispatch's expert telemetry (``est``: the per-layer
        routed counts [L, E_pad] and the drop fraction, read back in one
        copy) into the stats and, when there is one, the placement cache.  ``rows`` is the
        dispatch's rows (the slots for a decode step, the bucket for a
        prefill chunk): padded and idle rows route too, so they count."""
        vals = torch.cat([est["expert_load"].reshape(-1),
                          est["frac_dropped"].reshape(1)]).cpu().numpy()
        cfg = self.cfg
        load = vals[:-1].astype(np.float64).reshape(cfg.n_layers, -1)
        self.stats["expert_load"] = self.stats["expert_load"] + load.sum(0)
        self.stats["expert_routed_tokens"] += rows
        self.stats["expert_dropped_tokens"] += (float(vals[-1]) * rows
                                                * cfg.top_k)
        cum = self.stats["expert_load"][:cfg.n_experts]
        tot = float(cum.sum())
        if tot > 0.0:
            self.stats["expert_skew"] = float(cum.max() * cum.size / tot)
            self.stats["expert_gini"] = _gini(cum)
        if self.expert_cache is None:
            return
        tick = self.expert_cache.observe(load)
        self.stats["expert_hits"] += tick["hits"]
        self.stats["expert_misses"] += tick["misses"]
        self.stats["expert_migrations"] += tick["migrations"]
        self.stats["expert_migration_bytes"] += tick["migration_bytes"]
        self.stats["expert_prefetches"] += tick["prefetches"]
        self.stats["expert_sram_hit_rate"] = self.expert_cache.sram_hit_rate

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _finish_prefill(self, slot: int, req: Request, logits,
                        finished: List[Request]) -> None:
        """Prompt fully cached: sample the first token.  A prefill-role
        engine then parks the request for :meth:`stage_handoff` instead of
        decoding it."""
        first = int(sample_tokens(logits[0].reshape(1, -1), [req.temperature],
                                  self.generator)[0])
        req.out_tokens.append(first)
        req._t_first = time.perf_counter()
        req.ttft = req._t_first - req._t_submit
        req.first_tick = self._tick
        hit_eos = req.eos_id is not None and first == req.eos_id
        if hit_eos or req.max_new_tokens <= 1:
            self._finish(slot, req, finished)
        elif self.role == "prefill":
            req._await_handoff = True

    def _finish(self, slot: int, req: Request, finished: List[Request]) -> None:
        """Retire a completed request: its clocks, its class's counts, and
        an SLO violation when it finished past its deadline (its own
        ``deadline_ms``, else its class's) on the wall clock."""
        req.done = True
        req.finish_tick = self._tick
        now = time.perf_counter()
        if len(req.out_tokens) > 1 and req._t_first:
            req.tpot = (now - req._t_first) / (len(req.out_tokens) - 1)
        cs = self.class_stats[req.priority]
        cs["finished"] += 1
        cs["finished_tokens"] += len(req.out_tokens)
        dl = (req.deadline_ms if req.deadline_ms is not None
              else self.class_deadlines_ms.get(req.priority))
        if dl is not None and req._t_submit and (now - req._t_submit) * 1e3 > dl:
            self.stats["slo_violations"] += 1
            cs["slo_violations"] += 1
        finished.append(req)
        self._retire(slot)

    def _retire(self, slot: int) -> None:
        self.active[slot] = None
        self.lengths[slot] = 0
        if self.paged:
            self.alloc.release(slot)

    # -- engine tick ---------------------------------------------------
    def _decode_ready(self, slot: int) -> bool:
        """Decode runs once the whole prefill target is cached: for a
        restore victim that is ``resume_len``, not the prompt.  A request
        parked for its handoff never decodes here."""
        req = self.active[slot]
        return bool(req is not None and req.out_tokens
                    and not req._await_handoff
                    and req.prefill_pos >= self._prefill_target(req))

    def step(self) -> List[Request]:
        """One engine tick; returns the requests completed this tick.

        (0) with ``proactive_horizon`` a victim is preempted ahead of a
        predicted stall; (1) decode-ready slots reserve their next page
        before any restore or admission can take it; (2) admit restores,
        then queued requests; (3) advance chunked prefills under the budget
        left after one token per decode-ready slot; (4) one batched decode
        over the runnable slots (those whose next page was granted),
        sampled by one argmax over the batch; (5) retire finished requests.
        A tick that moved nothing while a slot waited on pages breaks the
        deadlock by preempting the cheapest victim."""
        self._tick += 1
        self.stats["ticks"] += 1
        self._stalled_this_tick = False
        progress0 = self.stats["prefill_tokens"] + self.stats["decode_tokens"]
        if self.paged and self.proactive_horizon > 0:
            self._preempt_proactive()
        if self.paged:
            for i in range(self.slots):
                if self._decode_ready(i):
                    self.alloc.ensure(i, self.lengths[i] + 1)
        self._admit()
        finished: List[Request] = []
        decode_slots = [i for i in range(self.slots) if self._decode_ready(i)]
        if self.paged:
            for i in decode_slots:
                self.alloc.ensure(i, self.lengths[i] + 1)
        spare = self._prefill_tick(self.max_tokens_per_tick - len(decode_slots),
                                   finished)
        # a prefill that completed inside this tick rides along only if the
        # prefill loop left budget for its decode token
        reserved = set(decode_slots)
        live = []
        for i in range(self.slots):
            if not self._decode_ready(i):
                continue
            if i in reserved:
                live.append(i)
            elif spare >= 1:
                spare -= 1
                live.append(i)
        n_active = sum(r is not None for r in self.active)
        self.stats["occupancy_sum"] += n_active / self.slots
        self.stats["peak_active"] = max(self.stats["peak_active"], n_active)
        runnable = []
        for i in live:
            if self.paged and not self.alloc.ensure(i, self.lengths[i] + 1):
                self.stats["stall_events"] += 1
                self._stalled_this_tick = True
                continue                       # stalled: decoded later
            runnable.append(i)
        if runnable:
            self._decode(runnable, finished)
        if self.paged:
            for k in ("pages_allocated", "pages_freed", "pages_shared",
                      "pages_evicted"):
                self.stats[k] = getattr(self.alloc, k)
        if self._stalled_this_tick:
            self.stats["stalled_ticks"] += 1
        made_progress = (self.stats["prefill_tokens"]
                         + self.stats["decode_tokens"] > progress0)
        if (self.paged and not made_progress and not finished
                and self._stalled_this_tick):
            self._preempt_for_deadlock()
        return finished

    def _decode(self, runnable: List[int], finished: List[Request]) -> None:
        """One batched decode over every slot; the runnable ones feed their
        last token and take the next."""
        self.stats["decode_dispatches"] += 1
        toks = np.zeros((self.slots,), np.int32)
        for i in runnable:
            toks[i] = self.active[i].out_tokens[-1]
        lens = self._to_device(self.lengths.copy())
        if not self.dense_baseline:
            tables = local = None
            if self.paged:
                tables = self._to_device(self.alloc.table.copy())
                if self.seq_shards > 1:
                    local = self._to_device(
                        self.alloc.shard_local(self.alloc.table))
                    self._account_noc_combine(rows=self.slots)
            # the mask gates the slot state: the batched decode must not
            # advance a mid-prefill, stalled or empty neighbour's state
            mask = np.zeros((self.slots,), bool)
            mask[runnable] = True
            out = self.runner.decode(
                self.params, self.state, self._to_device(toks), lens, tables,
                mask, local, **self._moe_kw)
            logits, self.state = out[:2]
            if self._moe_stats:
                # the batched decode routes every slot's row, idle ones too
                self._account_expert(out[2], rows=self.slots)
        else:
            logits, self.state = M.decode_step(
                self.cfg, self.params, self.state, self._to_device(toks), lens)
        temps = np.zeros((self.slots,), np.float32)
        for i in runnable:
            temps[i] = self.active[i].temperature
        nxt_all = sample_tokens(logits, temps, self.generator).tolist()
        for i in runnable:
            req = self.active[i]
            self.lengths[i] += 1
            self.stats["decode_tokens"] += 1
            self.stats["padded_tokens"] += 1
            nxt = int(nxt_all[i])
            req.out_tokens.append(nxt)
            hit_eos = req.eos_id is not None and nxt == req.eos_id
            if (len(req.out_tokens) >= req.max_new_tokens or hit_eos
                    or self.lengths[i] >= self.max_seq - 1):
                self._finish(i, req, finished)

    # -- preemption ----------------------------------------------------
    def _victims(self) -> List[int]:
        return [i for i, r in enumerate(self.active)
                if r is not None and self.alloc.used[i] > 0
                and not r._await_handoff]

    def _preempt_for_deadlock(self) -> None:
        """Two or more partly allocated slots wait on each other's pages:
        preempt the cheapest victim (:meth:`_victim_score`), its progress
        preserved.  With fewer than two, a parked swap restore may hold
        pages hostage through its pins: demote the first such handle to the
        recompute arm rather than livelock."""
        victims = self._victims()
        if len(victims) < 2:
            for parked in self.restore_queue:
                if parked._swap is not None:
                    self._demote_swap(parked)
                    break
            return
        self._preempt(min(victims, key=self._victim_score))

    def _flops_per_token(self) -> float:
        return 2.0 * self.cfg.param_count(active_only=True)

    def _restore_seconds(self, req: Request, live_tokens: int) -> float:
        """What bringing this victim back would cost under the engine's
        policy (``core.noc.restore_cost_seconds``, the paper's rates)."""
        n_pages = -(-live_tokens // self.block_size)
        return noc.restore_cost_seconds(
            n_pages, self._page_kv_bytes(), live_tokens,
            flops_per_token=self._flops_per_token(),
            state_bytes=self._slot_state_bytes, policy=self.preempt_policy)

    def _victim_score(self, slot: int):
        """Evict the slot whose loss costs least: pages held x restore
        seconds x the victim's class weight (JAX's score), so an
        interactive request falls only when no equal-cost batch victim
        exists; ties by decoded tokens, prefill progress, then the slot
        index."""
        req = self.active[slot]
        live = int(self.lengths[slot])
        pages = int(self.alloc.used[slot])
        score = (pages * self._restore_seconds(req, live)
                 * self.class_weights[req.priority])
        return (score, len(req.out_tokens), req.prefill_pos, slot)

    def _page_demand(self, horizon: int) -> int:
        """Pages the active slots will ask for over the next ``horizon``
        ticks beyond what they hold: a whole budget a tick mid-prefill, one
        token a tick decoding, capped at the request's total length."""
        need = 0
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            cur = int(self.lengths[slot])
            total = self._prefill_target(req) + req.max_new_tokens
            if req.prefill_pos < self._prefill_target(req):
                grow = horizon * self.max_tokens_per_tick
            else:
                grow = horizon
            future = min(total, cur + grow)
            need += max(0, -(-future // self.block_size)
                        - int(self.alloc.used[slot]))
        return need

    def _preempt_proactive(self) -> None:
        """Preempt before the pool stalls: when the predicted demand over
        ``proactive_horizon`` ticks exceeds the grantable pool (parked
        cached pages count), evict the cheapest victim now.  Held while a
        restore is parked (evicting to re-admit would ping-pong)."""
        if self.restore_queue:
            return
        victims = self._victims()
        if len(victims) < 2:
            return
        if self._page_demand(self.proactive_horizon) <= self.alloc.free_blocks:
            return
        self.stats["preempt_proactive"] += 1
        self._preempt(min(victims, key=self._victim_score))

    def _demote_swap(self, req: Request) -> None:
        """Turn a parked swap handle into a recompute restore: its pins and
        arena slots go back, and the restore replays from
        ``_resume_tokens``."""
        handle = req._swap
        for page in handle.pinned:
            self.alloc.unpin(page)
        handle.pinned = []
        if handle.slots:
            self._arena.free(handle)
        req._swap = None
        self.stats["swap_demotions"] += 1

    def _preempt(self, slot: int) -> None:
        """Evict ``slot``, preserving its progress: its live KV rows
        (``lengths[slot]``) are swapped to the arena or dropped for a
        recompute (full pages published first, so the prefix cache can
        hand them back), as ``preempt_policy`` decides; the request goes to
        ``restore_queue``."""
        req = self.active[slot]
        live = int(self.lengths[slot])
        self.stats["preemptions"] += 1
        self.class_stats[req.priority]["preemptions"] += 1
        self.stats["preempted_tokens"] += live
        req._preempted_live = live
        if live == 0:                   # nothing cached yet: plain requeue
            req.prefill_pos = 0
            self._retire(slot)
            self.restore_queue.append(req)
            return
        plen = self._plen(req)
        if req.out_tokens:
            # every decoded token but the unfed last sample must be back in
            # the cache before decode continues
            target = plen + len(req.out_tokens) - 1
            kv_seq = np.concatenate([
                req.prompt[:plen].astype(np.int32),
                np.asarray(req.out_tokens[:-1], np.int32)])
        else:
            target = 0                  # the prompt prefill resumes it
            kv_seq = req.prompt[:plen].astype(np.int32)
        policy = self._preempt_choice(live)
        if policy == "swap" and not self._swap_out(slot, live):
            policy = "recompute"        # arena full: recompute, never fail
        if policy == "swap":
            self.stats["preempt_swaps"] += 1
        else:
            self.stats["preempt_recomputes"] += 1
            if self.prefix_caching:
                self._extend_digests(req, kv_seq)
                self._publish_resume_pages(slot, req, live)
        req.resume_len = target
        req._resume_tokens = kv_seq
        req.prefill_pos = 0
        self._retire(slot)
        self.restore_queue.append(req)

    def _preempt_choice(self, live_tokens: int) -> str:
        if self.preempt_policy != "auto":
            return self.preempt_policy
        return noc.preempt_decision(
            -(-live_tokens // self.block_size), self._page_kv_bytes(),
            live_tokens, flops_per_token=self._flops_per_token(),
            state_bytes=self._slot_state_bytes)

    def _page_kv_bytes(self) -> int:
        """Bytes of one physical page over every application, K and V, at
        the pool's storage width (int8: 1-byte values and the scales)."""
        return self.runner.page_kv_bytes(self.block_size, self.dtype.itemsize)

    def _swap_out(self, slot: int, live_tokens: int) -> bool:
        """Park the victim's progress: pages registered under its own digest
        chain are pinned (restore shares them back), the rest is copied
        into the arena (one call per shard), and a slot-state family's blob
        rides along.  False when the arena cannot hold the rest."""
        req = self.active[slot]
        n_pages = -(-live_tokens // self.block_size)
        pages = [int(p) for p in self.alloc.table[slot, :n_pages]]
        n_pin = 0
        if self.prefix_caching:
            for i, p in enumerate(pages):
                if (i < len(req._digests)
                        and self.alloc.page_digest(p) == req._digests[i]):
                    n_pin += 1
                else:
                    break
        rest = pages[n_pin:]
        if rest:
            if self._arena is None:
                if self.swap_pages < 1:
                    return False
                quant = self.kv_dtype == "int8"
                self._arena = swap.SwapArena(
                    self.swap_pages, self.runner.page_shape(self.block_size),
                    torch.int8 if quant else self.dtype, quantized=quant,
                    device=self.device)
            handle = self._arena.alloc(len(rest))
            if handle is None:
                return False
        else:
            handle = swap.SwapHandle([])   # every page pinned
        handle.tokens = live_tokens
        handle.pinned = pages[:n_pin]
        for p in handle.pinned:
            self.alloc.pin(p)           # survives release(); LRU cannot take it
        if self.has_slot_state:
            handle.state = self.runner.extract_slot_state(self.state, slot)
            handle.state_bytes = self._slot_state_bytes
        self._pages_out(self._arena, handle.slots, rest)
        self.stats["swap_bytes"] += (len(rest) * self._page_kv_bytes()
                                     + handle.state_bytes)
        req._swap = handle
        return True

    def _extend_digests(self, req: Request, kv_seq: np.ndarray) -> None:
        """Grow the chained digest list over decoded pages, so the decode
        suffix can be published and matched again (page i commits to every
        token of [0, (i + 1) BS), through the one chain of submit)."""
        bs = self.block_size
        n_full = len(kv_seq) // bs
        if n_full > len(req._digests):
            req._digests = _page_digests(kv_seq, bs, n_full,
                                         seed=self._digest_seed)

    def _publish_resume_pages(self, slot: int, req: Request,
                              live_tokens: int) -> None:
        """Register every full live page (prompt and decoded) before the
        drop, so a restore can share them back while they survive in the
        LRU."""
        for i in range(live_tokens // self.block_size):
            self.alloc.register(int(self.alloc.table[slot, i]),
                                req._digests[i])

    # -- disaggregated handoff (prefill side) --------------------------
    def poll_handoffs(self) -> List[int]:
        """Slots parked for their handoff (a prefill-role engine parks each
        request after :meth:`_finish_prefill`; empty on other roles)."""
        return [i for i, r in enumerate(self.active)
                if r is not None and r._await_handoff]

    def stage_handoff(self, slot: int, arena: Optional[swap.SwapArena],
                      cached=()) -> Optional[swap.HandoffHandle]:
        """Move one parked prefill out of ``slot`` into ``arena`` and retire
        the slot -> the ``HandoffHandle``, or None when the arena cannot
        hold the chain's rest (the slot stays parked; the caller retries,
        and the arena's backpressure becomes this pool's).  ``cached``: the
        decode pool's page ids of the leading full pages it already holds
        registered (matched and acquired by the server): they never cross,
        only the rest is extracted (one call per shard), as
        ``core.noc.handoff_cost`` prices.  This pool keeps its own
        registered copies parked in the LRU for later local hits."""
        req = self.active[slot]
        if req is None or not req._await_handoff:
            raise RuntimeError(f"slot {slot} holds no handoff-ready request")
        tokens = int(self.lengths[slot])
        handle = swap.HandoffHandle(
            rid=req.rid, prompt=req.prompt,
            max_new_tokens=req.max_new_tokens,
            temperature=req.temperature, eos_id=req.eos_id,
            priority=req.priority, deadline_ms=req.deadline_ms,
            out_tokens=list(req.out_tokens), tokens=tokens,
            digests=list(req._digests), cached=list(cached), arena=arena,
            t_submit=req._t_submit, ttft=req.ttft)
        if self.paged:
            n_pages = -(-tokens // self.block_size)
            pages = [int(p) for p in self.alloc.table[slot, :n_pages]]
            rest = pages[len(handle.cached):]
            if rest:
                got = arena.alloc(len(rest))
                if got is None:
                    return None         # arena full: stays parked
                handle.slots = got.slots
                self._pages_out(arena, handle.slots, rest)
        if self.has_slot_state:
            handle.state = self.runner.extract_slot_state(self.state, slot)
            handle.state_bytes = self._slot_state_bytes
        req._await_handoff = False
        self._retire(slot)
        return handle

    # -- async future driver protocol ----------------------------------
    def _future_done(self, rid: int) -> bool:
        return self._reqs[rid].done

    def _future_tokens(self, rid: int) -> List[int]:
        return self._reqs[rid].out_tokens

    def _future_step(self) -> None:
        self.step()

    def run_until_drained(self, max_ticks: int = 10_000,
                          strict: bool = True) -> List[Request]:
        """Step until the queue, the restore queue and the slots are empty;
        returns every
        finished request.  With ``strict`` an engine that cannot drain
        within ``max_ticks`` raises instead of returning a partial set."""
        done: List[Request] = []
        for _ in range(max_ticks):
            done.extend(self.step())
            if (not self.queued and not self.restore_queue
                    and all(r is None for r in self.active)):
                return done
        if strict:
            live = [r.rid for r in self.active if r is not None]
            st = self.stats
            raise RuntimeError(
                f"engine not drained after {max_ticks} ticks "
                f"(queued={self.queued}, "
                f"awaiting_restore={len(self.restore_queue)}, "
                f"active rids={live}, "
                f"stalled_ticks={st['stalled_ticks']:.0f}, "
                f"preemptions={st['preemptions']:.0f}, "
                f"preempt_swaps={st['preempt_swaps']:.0f}, "
                f"preempt_recomputes={st['preempt_recomputes']:.0f}, "
                f"restored_tokens={st['restored_tokens']:.0f})")
        return done

    # -- introspection -------------------------------------------------
    def reset_stats(self) -> None:
        """Zero the counters and the class stats (the prefix-cache registry
        and the expert cache's placement, staging and EMA are kept)."""
        self.stats = {
            "ticks": 0, "prefill_tokens": 0, "decode_tokens": 0,
            "occupancy_sum": 0.0, "padded_tokens": 0, "prefill_dispatches": 0,
            "decode_dispatches": 0,
            # stall_events counts per-slot waits on pages, stalled_ticks the
            # ticks with one or more; every preemption is a swap or a
            # recompute; preempted_tokens counts the KV rows live at
            # eviction, restored_tokens those brought back without a replay
            # (swap-in or a prefix-cache hit)
            "stalled_ticks": 0, "stall_events": 0,
            "preemptions": 0, "preempt_proactive": 0, "preempt_swaps": 0,
            "preempt_recomputes": 0, "swap_bytes": 0, "swap_demotions": 0,
            "preempted_tokens": 0, "restored_tokens": 0,
            "prefix_hits": 0, "prefix_hit_tokens": 0, "cow_copies": 0,
            "pages_allocated": 0, "pages_freed": 0, "pages_shared": 0,
            "pages_evicted": 0, "gather_pages_calls": 0,
            "gather_page_volume": 0, "peak_active": 0,
            # the in-transit combine of a sequence-sharded pool: one per
            # layer per decode step and prefill chunk, costed by
            # core.noc.softmax_combine_cost
            "noc_combines": 0, "noc_hops": 0, "noc_bytes": 0,
            "noc_energy_pj": 0.0,
            "kv_bytes_per_page": self._page_kv_bytes() if self.paged else 0,
            # finished requests past their deadline (per request, else
            # their class's), also counted per class in class_stats
            "slo_violations": 0,
            # expert telemetry (MoE, with the expert cache): expert_load is
            # the routed-token count per padded expert summed over layers
            # and dispatches; skew = max / mean load and the Gini index over
            # the real experts; the cache counters are
            # serve/expert_cache.py's
            "expert_load": (np.zeros(self.runner.padded_experts())
                            if self._moe_stats else 0.0),
            "expert_routed_tokens": 0, "expert_dropped_tokens": 0.0,
            "expert_skew": 0.0, "expert_gini": 0.0,
            "expert_hits": 0.0, "expert_misses": 0.0,
            "expert_sram_hit_rate": 0.0,
            "expert_migrations": 0, "expert_migration_bytes": 0,
            "expert_prefetches": 0,
            # disaggregated serving: handoffs admitted from a HandoffHandle,
            # and admissions deferred by a pool that could not take one yet
            # (the deferred arm of core.noc.handoff_admission_cost)
            "handoffs": 0, "handoff_stalls": 0,
        }
        self.class_stats: Dict[str, Dict[str, float]] = {
            cls: self._zero_class_stats() for cls in self.class_order}
        if self.paged:
            self.alloc.reset_counters()
        if self.expert_cache is not None:
            self.expert_cache.reset_counters()

    @property
    def prefix_hit_rate(self) -> float:
        tot = self.stats["prefix_hit_tokens"] + self.stats["prefill_tokens"]
        return self.stats["prefix_hit_tokens"] / tot if tot else 0.0

    @property
    def mean_occupancy(self) -> float:
        t = self.stats["ticks"]
        return self.stats["occupancy_sum"] / t if t else 0.0

    def kv_cache_bytes(self) -> int:
        """Bytes of the serving state: pages or slabs and any slot state."""
        def nbytes(tree):
            if isinstance(tree, dict):
                return sum(nbytes(t) for t in tree.values())
            return tree.numel() * tree.element_size()
        return nbytes(self.state)
