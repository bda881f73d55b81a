"""CacheSpec and ModelRunner: the model-side contract the serving engine
drives.

Port of the JAX package's ``models/runner.py`` (``cache_spec`` :89 and
``ModelRunner`` :118) for every family.  The dense and MoE families'
serving cache is one paged component (attention KV for all L layers,
addressed through one block table per sequence) and no slot state;
RWKV6's and Mamba2's are fixed-size slot state only (``tm_shift``, ``wkv``
and ``cm_shift``, or ``conv`` and ``ssm``, the engine slot on axis 1) and
no paged component; the hybrid's is both: one paged component ``attn``
for the shared block's G applications, and ``conv_g`` / ``ssm_g`` (the
slot on axis 2, after the group and layer axes) and ``conv_t`` /
``ssm_t`` (axis 1).  The engine reads the spec (``has_paged``: run a
``BlockAllocator``; ``has_slot_state``: reset a slot at admission, gate
its state in the batched decode, never attach a cached prefix) and never
the family.  The runner also holds the dense-slab baseline's state
(``[L, slots, max_seq]`` slabs, the recurrent state of ``slots`` rows, or
the hybrid's both) and its monolithic prefill into one slot, and the
device halves of a swap preemption: the pages (``extract_pages`` /
``insert_pages``) and one slot's recurrent state as a host blob
(``extract_slot_state`` / ``insert_slot_state``), so the engine sees one
interface for every family.

A sequence-sharded pool (``ServeEngine(seq_shards=S)``) stays one state on
the card: shard ``s`` is the slice ``[s*nbl, (s+1)*nbl)`` of every paged
tensor's page axis (axis 2 of pages ``[L, KvH, NB, BS, hd]`` and scales
``[L, KvH, NB]``), the slice the JAX package's ``state_partition_specs``
puts on device ``s``.  The attention layers cut those views per layer
(``layers.pool_shards``, no copy), the port's counterpart of the partition
specs, beside the shard-local tables that ``decode`` / ``prefill_chunk``
pass on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import moe


@dataclass(frozen=True)
class PagedComponentSpec:
    """One paged KV component: pages ``[n_apps, kv_heads, NB, BS,
    head_dim]``, ``n_apps`` attention applications sharing a block table."""
    name: str
    n_apps: int
    kv_heads: int
    head_dim: int

    def page_shape(self, block_size: int) -> Tuple[int, ...]:
        return (self.n_apps, self.kv_heads, block_size, self.head_dim)

    def page_kv_bytes(self, block_size: int, itemsize: int) -> int:
        """Bytes of ONE physical page, K and V."""
        n = 1
        for d in self.page_shape(block_size):
            n *= d
        return 2 * n * itemsize


@dataclass(frozen=True)
class SlotStateSpec:
    """One fixed-size per-slot state entry (a top-level serve-state key),
    indexed by the engine slot on axis ``batch_axis``."""
    key: str
    batch_axis: int


@dataclass(frozen=True)
class CacheSpec:
    """What a family's serving cache is made of."""
    paged: Tuple[PagedComponentSpec, ...]
    slot_state: Tuple[SlotStateSpec, ...] = ()

    @property
    def has_paged(self) -> bool:
        return bool(self.paged)

    @property
    def has_slot_state(self) -> bool:
        return bool(self.slot_state)


def cache_spec(cfg: ModelConfig) -> CacheSpec:
    M.require_servable(cfg)
    if cfg.family == "ssm":
        keys = M.RWKV_STATE if cfg.rwkv else M.MAMBA_STATE
        return CacheSpec(paged=(), slot_state=tuple(
            SlotStateSpec(key, 1) for key in keys))
    if cfg.family == "hybrid":
        g, _, _ = M.hybrid_layout(cfg)
        return CacheSpec(
            paged=(PagedComponentSpec("attn", g, cfg.n_kv_heads, cfg.hd),),
            slot_state=(SlotStateSpec("conv_g", 2), SlotStateSpec("ssm_g", 2),
                        SlotStateSpec("conv_t", 1), SlotStateSpec("ssm_t", 1)))
    return CacheSpec(paged=(PagedComponentSpec("attn", cfg.n_layers,
                                               cfg.n_kv_heads, cfg.hd),))


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, complete on return: pinned for a card tensor
    (one DMA copy, then the stream synchronized)."""
    if t.device.type != "cuda":
        return t.detach().clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return out


def _slot_index(spec: SlotStateSpec, slot: int):
    return (slice(None),) * spec.batch_axis + (slice(slot, slot + 1),)


class ModelRunner:
    """The engine's compute façade over ``models.model``.  ``kv_dtype`` is
    the pages' storage: "fp16" (the engine dtype) or "int8" (plus
    per-(layer, kv head, page) scales).  Slot state is updated in place."""

    def __init__(self, cfg: ModelConfig, slots: int, max_seq: int,
                 kv_dtype: str = "fp16"):
        if kv_dtype not in ("fp16", "int8"):
            raise ValueError(
                f"kv_dtype must be 'fp16' or 'int8', got {kv_dtype!r}")
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.kv_dtype = kv_dtype
        self.spec = cache_spec(cfg)

    def init_state(self, num_blocks: int, block_size: int, dtype, device):
        return M.init_serve_state(self.cfg, self.slots, num_blocks, block_size,
                                  dtype=dtype, device=device,
                                  kv_dtype=self.kv_dtype)

    def init_dense_state(self, dtype, device):
        """The dense ``[slots, max_seq]``-slab baseline state."""
        return M.init_decode_state(self.cfg, self.slots, self.max_seq,
                                   dtype=dtype, device=device)

    def prefill_slot(self, params, state, slot: int, tokens: torch.Tensor,
                     length: int):
        """Monolithic prefill of one right-padded prompt (tokens [1, S])
        straight into slot ``slot``'s rows of the slabs -> logits [1, V].
        Rows past S keep what an earlier occupant left: decode never
        reads a row before writing it.  A recurrent prefill starts from a
        zero state and writes the slot's state rows whole, as the JAX engine
        scatters its batch-of-one state into the slot; the hybrid's view
        holds both its state rows and its slabs' slot."""
        view = {s.key: state[s.key][_slot_index(s, slot)]
                for s in self.spec.slot_state}
        if "attn" in state:
            view["attn"] = {key: t[:, slot:slot + 1]
                            for key, t in state["attn"].items()}
        lens = torch.full((1,), length, dtype=torch.int32, device=tokens.device)
        logits, _ = M.prefill(self.cfg, params, view, tokens=tokens,
                              lengths=lens)
        return logits[:, 0]

    def decode(self, params, state, tokens: torch.Tensor, lengths: torch.Tensor,
               block_tables: Optional[torch.Tensor], mask,
               local_tables: Optional[torch.Tensor] = None,
               expert_stats: bool = False,
               expert_parallel: Optional[int] = None):
        """Batched one-token decode over every slot.  ``mask`` [slots] bool
        (a CPU tensor or array) gates the slot state: a slot that is not
        runnable (mid-prefill or empty) keeps its recurrent state bit for
        bit, written back only at the runnable rows (an index copy in
        place, not a select over the whole state).  Paged components need
        no gating: retired and mid-prefill rows scatter into the null page
        or into a position the next prefill chunk overwrites; their logits
        are ignored.  ``local_tables`` [S, slots, MB]: a sequence-sharded
        pool's shard-local tables (``block_tables`` stays global, for the
        scatter).  ``expert_stats`` (MoE): the per-layer expert load and
        the drop fraction of the step's rows, returned third.
        ``expert_parallel`` (MoE): each MoE layer over that many expert
        shards, views of the one card's banks (``models/moe.py``)."""
        rows = None
        if self.spec.has_slot_state:
            mask = torch.as_tensor(mask, dtype=torch.bool).cpu()
            if not bool(mask.all()):
                rows = torch.nonzero(mask).flatten().to(tokens.device)
        return M.serve_decode_step(self.cfg, params, state, tokens, lengths,
                                   block_tables, local_tables, rows=rows,
                                   expert_stats=expert_stats,
                                   expert_parallel=expert_parallel)

    def prefill_chunk(self, params, state, tokens: torch.Tensor, length: int,
                      q_offset: int, block_table: Optional[torch.Tensor],
                      slot: int, local_tables: Optional[torch.Tensor] = None,
                      expert_stats: bool = False,
                      expert_parallel: Optional[int] = None):
        """One right-padded chunk of a single-sequence prefill: attention
        K/V land in the pages of ``block_table`` (``local_tables`` [S, MB]:
        a sequence-sharded pool's), recurrent state reads and advances
        ``slot``'s rows (padding rows are state-neutral).  ``expert_stats``
        and ``expert_parallel`` as in :meth:`decode`."""
        return M.serve_prefill_chunk(self.cfg, params, state, tokens=tokens,
                                     length=length, q_offset=q_offset,
                                     block_table=block_table, slot=slot,
                                     local_tables=local_tables,
                                     expert_stats=expert_stats,
                                     expert_parallel=expert_parallel)

    def reset_slot(self, state, slot: int):
        """Zero one slot's recurrent state in place (a fresh admission must
        not inherit the previous occupant's)."""
        for s in self.spec.slot_state:
            state[s.key][_slot_index(s, slot)] = 0
        return state

    def extract_slot_state(self, state, slot: int):
        """One slot's recurrent state as a host blob (key -> tensor, the
        slot axis dropped; pinned on the card, the copy complete on
        return): the fixed-size half of a swap (pages are the other)."""
        return {s.key: to_host(state[s.key].select(s.batch_axis, slot))
                for s in self.spec.slot_state}

    def insert_slot_state(self, state, slot: int, blob):
        """Write a blob from :meth:`extract_slot_state` back into slot
        ``slot``'s rows, in place."""
        for s in self.spec.slot_state:
            dst = state[s.key].select(s.batch_axis, slot)
            dst.copy_(blob[s.key].to(dst.dtype), non_blocking=True)
        return state

    def slot_state_bytes(self, state) -> int:
        """Bytes of ONE slot's recurrent state."""
        return sum(state[s.key].numel() // state[s.key].shape[s.batch_axis]
                   * state[s.key].element_size() for s in self.spec.slot_state)

    def handoff_payload_bytes(self, block_size: int, itemsize: int,
                              n_pages: int, cached_pages: int = 0,
                              state=None) -> int:
        """Bytes ONE prefill -> decode handoff moves over the link: the
        uncached remainder of the page chain at the pool's storage width
        plus the slot-state blob (sized from ``state`` when the family has
        one).  Prefix-cached pages re-attach by reference on the decode side
        and move nothing: the payload ``core.noc.handoff_cost`` prices."""
        pages = 0
        if self.spec.paged:
            pages = (max(0, n_pages - cached_pages)
                     * self.page_kv_bytes(block_size, itemsize))
        blob = (self.slot_state_bytes(state)
                if state is not None and self.spec.slot_state else 0)
        return pages + blob

    def copy_page(self, state, src: int, dst: int):
        """Physical-page copy across every paged component (copy-on-write
        for mid-page prefix-cache matches); the slot state is untouched."""
        return M.copy_kv_page(state, src, dst)

    def extract_pages(self, state, pages: torch.Tensor):
        """Gather physical pages by id: the device half of a swap-out.
        Returns (k, v, k_scales, v_scales): pages ``[A, KvH, P, BS, hd]``,
        scales ``[A, KvH, P]`` (None for a float pool)."""
        return M.extract_kv_pages(state, pages)

    def insert_pages(self, state, pages: torch.Tensor, k, v, k_scales=None,
                     v_scales=None):
        """Scatter swapped-out pages back in place: the device half of a
        swap-in (slot state untouched)."""
        return M.insert_kv_pages(state, pages, k, v, k_scales, v_scales)

    def page_shape(self, block_size: int) -> Tuple[int, ...]:
        """One physical page's shape ``(A, KvH, BS, hd)``: the swap
        arena's slot."""
        (comp,) = self.spec.paged
        return comp.page_shape(block_size)

    @property
    def attn_applications(self) -> int:
        """Attention applications per token over the pool (the NoC combines
        of one sharded dispatch): L layers, or the hybrid's G."""
        return sum(c.n_apps for c in self.spec.paged)

    def padded_experts(self) -> int:
        """Routed expert count as the MoE dispatch pads it (the unit an
        expert-parallel split must divide)."""
        return moe.moe_padded_experts(self.cfg)

    def expert_param_specs(self, params):
        """The expert-sharded leaves of ``params`` (``moe.expert_param_specs``:
        0 at each layer's routed banks, None elsewhere)."""
        return moe.expert_param_specs(params)

    def expert_weight_bytes(self, itemsize: int) -> int:
        """One routed expert's weights (gate, up and down) at ``itemsize``
        bytes an element: the unit an expert placement cache prices a
        migration in."""
        return 3 * self.cfg.d_model * self.cfg.moe_d_ff * itemsize

    def page_kv_bytes(self, block_size: int, itemsize: int) -> int:
        """Bytes of ONE physical page across paged components, K and V.
        ``itemsize`` is the engine dtype's width; an int8 pool stores 1-byte
        values plus one f32 scale per (application, kv head) for each of K
        and V."""
        if self.kv_dtype == "int8":
            return sum(c.page_kv_bytes(block_size, 1)
                       + 2 * c.n_apps * c.kv_heads * 4 for c in self.spec.paged)
        return sum(c.page_kv_bytes(block_size, itemsize) for c in self.spec.paged)
