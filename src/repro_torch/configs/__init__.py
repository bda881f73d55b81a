"""Architecture registry.

``get_config(name)`` resolves any assigned architecture id (and the paper's
own models).  ``ARCHS`` lists the ten assigned ids in assignment order.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    ModelConfig, ShapeSpec, SHAPES, SHAPES_BY_NAME,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
    reduced, shape_applicable,
)

from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.internvl2_2b import CONFIG as _internvl2
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2moe
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.stablelm_1_6b import CONFIG as _stablelm
from repro_torch.configs.qwen2_72b import CONFIG as _qwen72
from repro_torch.configs.minitron_4b import CONFIG as _minitron
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.zamba2_7b import CONFIG as _zamba
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv
from repro_torch.configs.paper_models import PAPER_MODELS

ARCHS = (
    "musicgen-large",
    "internvl2-2b",
    "qwen2-moe-a2.7b",
    "olmoe-1b-7b",
    "stablelm-1.6b",
    "qwen2-72b",
    "minitron-4b",
    "granite-3-2b",
    "zamba2-7b",
    "rwkv6-3b",
)

_REGISTRY = {c.name: c for c in (
    _musicgen, _internvl2, _qwen2moe, _olmoe, _stablelm,
    _qwen72, _minitron, _granite, _zamba, _rwkv,
)}
_REGISTRY.update(PAPER_MODELS)


def get_config(name: str) -> ModelConfig:
    key = name.strip()
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def all_cells():
    """Yield every runnable (config, shape) cell plus skip records.

    Returns (cfg, shape, runnable, reason) for all 40 nominal cells.
    """
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, reason = shape_applicable(cfg, shape)
            yield cfg, shape, ok, reason


__all__ = [
    "ModelConfig", "ShapeSpec", "SHAPES", "SHAPES_BY_NAME", "ARCHS",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "get_config", "reduced", "shape_applicable", "all_cells", "PAPER_MODELS",
]
