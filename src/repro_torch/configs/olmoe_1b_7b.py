"""olmoe-1b-7b — OLMoE.

[arXiv:2409.02060; hf]  16L d_model=2048 16H (GQA kv=16) vocab=50304,
MoE: 64 routed experts top-8, per-expert d_ff=1024, no shared experts.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    n_experts=64,
    n_shared_experts=0,
    top_k=8,
    moe_d_ff=1024,
    source="arXiv:2409.02060; hf",
)
