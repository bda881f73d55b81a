"""rwkv6-3b — RWKV-6 "Finch" with data-dependent decay.

[arXiv:2404.05892; hf]  32L d_model=2560 (attention-free) d_ff=8960
vocab=65536.  Linear-attention recurrence with a per-channel data-dependent
decay produced by a low-rank (LoRA) projection — the defining v6 feature.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    rwkv=True,
    rwkv_head_dim=64,
    rwkv_lora=64,
    source="arXiv:2404.05892; hf",
)
