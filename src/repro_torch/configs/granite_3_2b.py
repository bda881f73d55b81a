"""granite-3-2b — IBM Granite 3.0 2B base.

[hf:ibm-granite/granite-3.0-2b-base; hf]  40L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    head_dim=64,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)
