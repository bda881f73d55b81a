"""minitron-4b — pruned Nemotron.

[arXiv:2407.14679; hf]  32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
    source="arXiv:2407.14679; hf",
)
