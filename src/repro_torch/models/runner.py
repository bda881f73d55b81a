"""CacheSpec and ModelRunner: the model-side contract the serving engine
drives.

Port of the JAX package's ``models/runner.py`` (``cache_spec`` :89 and
``ModelRunner`` :118) for the paged-only dense family: the serving cache is
one paged component (attention KV for all L layers, addressed through one
block table per sequence) and no fixed-size slot state.  Families with slot
state (hybrid, ssm) come with a later slice.  The runner also holds the
dense-slab baseline's state (``[L, slots, max_seq]`` slabs) and its
monolithic prefill into one slot.

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
class CacheSpec:
    paged: Tuple[PagedComponentSpec, ...]


def cache_spec(cfg: ModelConfig) -> CacheSpec:
    M.require_servable(cfg)
    return CacheSpec(paged=(PagedComponentSpec("attn", cfg.n_layers,
                                               cfg.n_kv_heads, cfg.hd),))


class ModelRunner:
    """The engine's compute façade over ``models.model`` (paged dense).
    ``kv_dtype`` is the pages' storage: "fp16" (the engine dtype) or "int8"
    (plus per-(layer, kv head, page) scales)."""

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
        reads a row before writing it."""
        view = {"attn": {key: t[:, slot:slot + 1]
                         for key, t in state["attn"].items()}}
        lens = torch.full((1,), length, dtype=torch.int32, device=tokens.device)
        logits, _ = M.prefill(self.cfg, params, view, tokens=tokens,
                              lengths=lens)
        return logits[:, 0]

    def decode(self, params, state, tokens: torch.Tensor, lengths: torch.Tensor,
               block_tables: torch.Tensor,
               local_tables: Optional[torch.Tensor] = None):
        """Batched one-token decode over every slot.  Retired and
        mid-prefill rows scatter into the null page or into a position the
        next prefill chunk overwrites; their logits are ignored.
        ``local_tables`` [S, slots, MB]: a sequence-sharded pool's
        shard-local tables (``block_tables`` stays global, for the
        scatter)."""
        return M.serve_decode_step(self.cfg, params, state, tokens, lengths,
                                   block_tables, local_tables)

    def prefill_chunk(self, params, state, tokens: torch.Tensor, length: int,
                      q_offset: int, block_table: torch.Tensor,
                      local_tables: Optional[torch.Tensor] = None):
        """One right-padded chunk of a single-sequence prefill
        (``local_tables`` [S, MB]: a sequence-sharded pool's)."""
        return M.serve_prefill_chunk(self.cfg, params, state, tokens=tokens,
                                     length=length, q_offset=q_offset,
                                     block_table=block_table,
                                     local_tables=local_tables)

    def copy_page(self, state, src: int, dst: int):
        """Physical-page copy across every paged component (copy-on-write
        for mid-page prefix-cache matches)."""
        return M.copy_kv_page(state, src, dst)

    def page_kv_bytes(self, block_size: int, itemsize: int) -> int:
        """Bytes of ONE physical page across paged components, K and V.
        ``itemsize`` is the engine dtype's width; an int8 pool stores 1-byte
        values plus one f32 scale per (application, kv head) for each of K
        and V."""
        if self.kv_dtype == "int8":
            return sum(c.page_kv_bytes(block_size, 1)
                       + 2 * c.n_apps * c.kv_heads * 4 for c in self.spec.paged)
        return sum(c.page_kv_bytes(block_size, itemsize) for c in self.spec.paged)
