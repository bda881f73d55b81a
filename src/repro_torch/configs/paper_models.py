"""The paper's own evaluation models (used by pimsim + examples).

Llama2 series [arXiv:2307.09288], Qwen-72B [arXiv:2407.10671 lineage],
GPT3-175B [github.com/openai/gpt-3].
"""
from repro_torch.configs.base import ModelConfig

LLAMA2_7B = ModelConfig(
    name="llama2-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab_size=32000, head_dim=128,
    source="arXiv:2307.09288",
)

LLAMA2_13B = ModelConfig(
    name="llama2-13b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=13824, vocab_size=32000, head_dim=128,
    source="arXiv:2307.09288",
)

LLAMA2_70B = ModelConfig(
    name="llama2-70b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab_size=32000, head_dim=128,
    source="arXiv:2307.09288",
)

QWEN_72B = ModelConfig(
    name="qwen-72b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=29568, vocab_size=152064, head_dim=128,
    qkv_bias=True, source="arXiv:2407.10671",
)

GPT3_175B = ModelConfig(
    name="gpt3-175b", family="dense", n_layers=96, d_model=12288,
    n_heads=96, n_kv_heads=96, d_ff=49152, vocab_size=50257, head_dim=128,
    source="github.com/openai/gpt-3",
)

PAPER_MODELS = {m.name: m for m in
                (LLAMA2_7B, LLAMA2_13B, LLAMA2_70B, QWEN_72B, GPT3_175B)}
