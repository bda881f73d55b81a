"""stablelm-1.6b — StableLM-2-1.6B.

[hf:stabilityai/stablelm-2-1_6b; unverified]  24L d_model=2048 32H (kv=32, MHA)
d_ff=5632 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    head_dim=64,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
