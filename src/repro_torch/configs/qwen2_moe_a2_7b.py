"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (GQA kv=16) vocab=151936,
MoE: 60 routed experts top-4 + 4 shared experts, per-expert d_ff=1408.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,            # dense-equivalent (4 shared x 1408); unused by MoE FFN math
    vocab_size=151936,
    head_dim=128,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
