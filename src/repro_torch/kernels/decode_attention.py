"""Paged flash-decoding — hand-written CUDA kernel for Hopper
(``csrc/paged_attention.cu``, host side in ``_paged.py``).

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py``
(``_paged_decode``, ``pallas_call`` at :300, behind
``paged_decode_attention`` :313 and ``paged_decode_attention_partial``
:327).  A decode step is run as a one-row chunk per sequence: block
(tile, kv head, sequence) reads its own block-table row, walks only the
sequence's live keys ``[0, min(len, MB*BS))`` 32 at a time through shared
memory, and keeps the online softmax in f32 registers.  Bound on the H100:
bytes (each live K/V byte is read once).  The TPU kernel's 64-row
K-subtiling for ``BS > 64`` has no counterpart to port: this kernel's step
is 32 keys whatever the page size.  Retired slots (all-zero table row,
length 0 -> attention over the null page's first row) launch validly and
their rows are discarded by the engine.

Ported here: the fp pool, normalized output and ``(acc, m, l)`` partials
(an empty row is ``(0, -1e30, 0)``).  The int8 pool's per-(head, page)
scales, ``skip_null`` and ``kv_offset`` (sequence-sharded pools) come with
later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _paged

launches = 0   # kernel launches through this module's wrappers


def _decode(q, k_pages, v_pages, block_tables, lengths, partials: bool):
    global launches
    if q.dim() != 3:
        raise ValueError(f"paged decode: q must be [B, H, D], got {tuple(q.shape)}")
    res = _paged.launch(q[:, None], k_pages, v_pages, block_tables, lengths,
                        0, 0, partials=partials)
    launches += 1
    if partials:
        acc, m, l = res
        return acc[:, 0], m[:, 0], l[:, 0]
    return res[:, 0]


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q [B,H,D]; k_pages, v_pages [KvH,NB,BS,D]; block_tables [B,MB] int32;
    lengths [B] int32 (keys ``[0, len)`` attended) -> [B,H,D]."""
    return _decode(q, k_pages, v_pages, block_tables, lengths, partials=False)


def paged_decode_attention_partial(q, k_pages, v_pages, block_tables, lengths):
    """(acc f32 [B,H,D], m [B,H], l [B,H]) for the softmax combine."""
    return _decode(q, k_pages, v_pages, block_tables, lengths, partials=True)
