"""musicgen-large — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284; hf]  48L d_model=2048 32H (GQA kv=32 => MHA) d_ff=8192
vocab=2048.  The EnCodec frontend is a STUB: ``input_specs`` provides
precomputed frame embeddings (see ``repro.models.frontends``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="dense",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    frontend="audio",
    source="arXiv:2306.05284; hf",
)
