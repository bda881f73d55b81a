"""Paged prefill attention — hand-written CUDA kernel for Hopper
(``csrc/paged_attention.cu``, host side in ``_paged.py``).

Replaces the TPU kernel ``src/repro/kernels/prefill_attention.py``
(``_paged_prefill``, ``pallas_call`` at :273, behind
``paged_prefill_attention`` :292 and ``paged_prefill_attention_partial``
:310).  One chunk's queries ``[1, C, H, D]`` attend to the paged KV (the
chunk's own K/V already scattered into its pages), causal on global
positions ``kpos <= q_offset + row // G`` and valid on ``kpos < q_offset +
length``.  Each block takes a fixed tile of query rows of one kv head,
row-major ``(position, group)``, and walks keys only up to its tile's causal
end (the TPU kernel's per-q-tile live-page clamp, ``prefill_attention.py``
:141-142).  ``C`` need not be a multiple of the tile, and ``block_table`` may
be a prefix slice of the slot's table.

bf16 queries run the tensor-core form: 64-row tiles (``_paged.TC_ROWS``),
the tiles with the most keys first; the tile's pages listed once in shared
memory; 64-key stages through a ``cp.async`` ring; S = Q K^T and P V on
``mma.sync`` with the online softmax in f32 and P as a bf16 hi + lo pair.
f32 queries (the fp32 parity runs) keep the CUDA-core form, 16-row tiles
(``_paged.ROWS``) in f32.  Because the query tile is fixed, no chunk size
can overflow shared memory, so the TPU kernel's VMEM sizing
(``resolve_q_tile``, ``q_tile_vmem_bytes``) has no counterpart.  An int8
pool (pages int8 with ``k_scales`` / ``v_scales`` [KvH, NB] f32) runs each
form's int8-page variant (the TPU kernel's quantized branch, :165-170): the
bf16 form widens the int8 pages to bf16 and scales its score and P columns,
the f32 form dequantizes each value as it stages it.  ``skip_null``
(:142-146, a sequence-sharded pool): the pages are a shard's view of the
pool, read through their kv-head stride; the bf16 form walks only the pages
the shard-local table owns (its nonzero entries), the f32 form masks the
keys of zero entries and never loads their bytes; a row that sees no owned
key returns ``(0, -1e30, 0)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _paged

launches = 0      # kernel launches over a float pool
q8_launches = 0   # kernel launches over an int8 pool (its variant)
shard_launches = 0      # skip_null launches over a shard of a float pool
shard_q8_launches = 0   # skip_null launches over a shard of an int8 pool
tc_launches = 0   # launches (of every mode above) with bf16 queries: the tensor-core form
window_launches = 0     # launches (of every mode above) with a window


def _prefill(q, k_pages, v_pages, block_table, q_offset, length, partials,
             k_scales, v_scales, skip_null=False, window=None):
    global launches, q8_launches, shard_launches, shard_q8_launches, tc_launches
    global window_launches
    if q.dim() != 4 or q.shape[0] != 1 or block_table.dim() != 1:
        raise ValueError(f"paged prefill: q must be [1, C, H, D] and the "
                         f"table [MB]; got {tuple(q.shape)}, "
                         f"{tuple(block_table.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"paged prefill: window must be None or positive, "
                         f"got {window}")
    mb, bs = block_table.shape[0], k_pages.shape[2]
    total = min(int(q_offset) + int(length), mb * bs)
    res = _paged.launch(q, k_pages, v_pages, block_table[None],
                        int(q_offset), total, partials=partials,
                        k_scales=k_scales, v_scales=v_scales,
                        skip_null=skip_null, window=int(window or 0))
    if skip_null and k_scales is None:
        shard_launches += 1
    elif skip_null:
        shard_q8_launches += 1
    elif k_scales is None:
        launches += 1
    else:
        q8_launches += 1
    if q.dtype == torch.bfloat16:
        tc_launches += 1
    if window:
        window_launches += 1
    return res


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_table: torch.Tensor,
                            *, q_offset: int, length: int,
                            window: Optional[int] = None,
                            k_scales: Optional[torch.Tensor] = None,
                            v_scales: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """q [1,C,H,D]; k_pages, v_pages [KvH,NB,BS,D] in q's dtype, or int8
    with ``k_scales`` / ``v_scales`` [KvH,NB] f32; block_table [MB] int32;
    ``window`` None or positive -> [1,C,H,D]."""
    return _prefill(q, k_pages, v_pages, block_table, q_offset, length, False,
                    k_scales, v_scales, window=window)


def paged_prefill_attention_partial(q, k_pages, v_pages, block_table, *,
                                    q_offset: int, length: int,
                                    skip_null: bool = False,
                                    k_scales=None, v_scales=None):
    """(acc f32 [1,C,H,D], m [1,C,H], l [1,C,H]) for the softmax combine;
    with ``skip_null`` over a shard's view of the pool and its local
    table."""
    return _prefill(q, k_pages, v_pages, block_table, q_offset, length, True,
                    k_scales, v_scales, skip_null)
