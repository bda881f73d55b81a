"""Modality-frontend stubs for the ``audio`` / ``vlm`` architectures
(musicgen-large, internvl2-2b), a copy of the JAX package's
``models/frontends.py``.

The transformer backbone is what is modeled; the frontend only provides
precomputed frame / patch embeddings of the right shape, which the model's
``prefill`` / ``decode_step`` take as ``embeds=``.  ``embedding_spec``
describes them without data; ``synthetic_embeddings`` makes them (a fixed
random table indexed by token ids, deterministic).

The reference draws its table with ``jax.random``, whose bits the port
cannot reproduce without JAX: here the table comes from a ``torch.Generator``
seeded with the same :func:`embedding_seed`, with the same shape, dtype and
``d_model ** -0.5`` scale, so the values differ from the reference's.  A
parity test feeds the reference's embeddings in.
"""
from __future__ import annotations

import functools
import zlib

import torch

from repro_torch.configs.base import ModelConfig


def embedding_seed(cfg: ModelConfig) -> int:
    """Stable per-arch seed of the synthetic frontend table:
    ``zlib.crc32`` of the arch name, the same in every process (Python's
    ``hash`` is salted per process)."""
    return zlib.crc32(cfg.name.encode("utf-8")) % (2 ** 31)


def frontend_kind(cfg: ModelConfig) -> str:
    return cfg.frontend  # 'none' | 'audio' | 'vlm'


def embedding_spec(cfg: ModelConfig, batch: int, seq: int,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """The precomputed frontend embeddings ``[batch, seq, d_model]`` as a
    ``meta``-device tensor: shape and dtype, no storage (PyTorch's form of
    the reference's ``ShapeDtypeStruct``)."""
    return torch.empty((batch, seq, cfg.d_model), dtype=dtype, device="meta")


@functools.lru_cache(maxsize=2)
def _table(seed: int, vocab: int, d_model: int, device: str) -> torch.Tensor:
    """The N(0, 1) table ``[vocab, d_model]`` f32, drawn on the CPU (so every
    device gets the same values) and kept on ``device``: a full-width
    vocab's draw takes seconds, and a decode loop asks for it every step."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((vocab, d_model), generator=gen,
                       dtype=torch.float32).to(device)


def synthetic_embeddings(cfg: ModelConfig, tokens: torch.Tensor,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """Deterministic stand-in for EnCodec frames / ViT patches: token ids
    ``[...]`` through the fixed table of :func:`embedding_seed`, cast to
    ``dtype`` and scaled by ``d_model ** -0.5`` -> ``[..., d_model]`` on
    ``tokens``' device."""
    table = _table(embedding_seed(cfg), cfg.vocab_size, cfg.d_model,
                   str(tokens.device))
    return table[tokens.long()].to(dtype) * cfg.d_model ** -0.5
