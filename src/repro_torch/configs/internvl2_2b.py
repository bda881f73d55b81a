"""internvl2-2b — InternViT + InternLM2 VLM.

[arXiv:2404.16821; hf]  LM backbone: 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553.  The InternViT frontend is a STUB: ``input_specs``
provides precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    head_dim=128,
    frontend="vlm",
    source="arXiv:2404.16821; hf",
)
