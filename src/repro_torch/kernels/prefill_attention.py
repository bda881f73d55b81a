"""Paged prefill attention — hand-written CUDA kernel for Hopper
(``csrc/paged_attention.cu``, host side in ``_paged.py``).

Replaces the TPU kernel ``src/repro/kernels/prefill_attention.py``
(``_paged_prefill``, ``pallas_call`` at :273, behind
``paged_prefill_attention`` :292 and ``paged_prefill_attention_partial``
:310).  One chunk's queries ``[1, C, H, D]`` attend to the paged KV (the
chunk's own K/V already scattered into its pages), causal on global
positions ``kpos <= q_offset + row // G`` and valid on ``kpos < q_offset +
length``.  Each block takes a fixed tile of 16 query rows of one kv head,
row-major ``(position, group)``, and walks keys only up to its tile's causal
end (the TPU kernel's per-q-tile live-page clamp, ``prefill_attention.py``
:141-142).  ``C`` need not be a multiple of the tile, and ``block_table`` may
be a prefix slice of the slot's table.  Bound on the H100: bytes at serving
shapes; the products run on the CUDA cores in f32 in this first version.

Because the query tile is fixed, no chunk size can overflow shared memory
(41 KB at head dim 128), so the TPU kernel's VMEM sizing (``resolve_q_tile``,
``q_tile_vmem_bytes``) has no counterpart.  ``skip_null`` and the int8
pool's scales come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _paged

launches = 0   # kernel launches through this module's wrappers


def _prefill(q, k_pages, v_pages, block_table, q_offset, length, partials):
    global launches
    if q.dim() != 4 or q.shape[0] != 1 or block_table.dim() != 1:
        raise ValueError(f"paged prefill: q must be [1, C, H, D] and the "
                         f"table [MB]; got {tuple(q.shape)}, "
                         f"{tuple(block_table.shape)}")
    mb, bs = block_table.shape[0], k_pages.shape[2]
    total = min(int(q_offset) + int(length), mb * bs)
    res = _paged.launch(q, k_pages, v_pages, block_table[None], None,
                        int(q_offset), total, partials=partials)
    launches += 1
    return res


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_table: torch.Tensor,
                            *, q_offset: int, length: int) -> torch.Tensor:
    """q [1,C,H,D]; k_pages, v_pages [KvH,NB,BS,D]; block_table [MB] int32
    -> [1,C,H,D]."""
    return _prefill(q, k_pages, v_pages, block_table, q_offset, length, False)


def paged_prefill_attention_partial(q, k_pages, v_pages, block_table, *,
                                    q_offset: int, length: int):
    """(acc f32 [1,C,H,D], m [1,C,H], l [1,C,H]) for the softmax combine."""
    return _prefill(q, k_pages, v_pages, block_table, q_offset, length, True)
