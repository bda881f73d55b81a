"""zamba2-7b — Zamba2: Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; unverified]  81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64.  A *shared-weight* attention+FFN block is applied
every 6 Mamba2 layers (per-application KV caches, shared parameters; the
per-instance LoRA specialization of the real model is not modeled — see
DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    source="arXiv:2411.15242; unverified",
)
