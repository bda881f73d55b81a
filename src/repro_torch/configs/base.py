"""Model / shape configuration dataclasses (the PyTorch port's own copy).

Every assigned architecture is expressed as a :class:`ModelConfig` with the
same names and values as the JAX package's ``repro/configs/base.py``; the
port keeps a copy so that it never imports the JAX package.  In the port the
dataclass drives model construction (``repro_torch.models``) and the serving
engine (``repro_torch.serve``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-style LM backbone configuration.

    ``family`` selects the block pattern:
      * ``dense``  — pre-norm GQA attention + SwiGLU FFN
      * ``moe``    — attention + top-k routed MoE FFN (optionally shared experts)
      * ``ssm``    — attention-free (RWKV6 when ``rwkv`` else Mamba2)
      * ``hybrid`` — Mamba2 backbone with a *shared-weight* attention block
                     applied every ``attn_every`` layers (Zamba2 style)
    """

    name: str
    family: str                     # 'dense' | 'moe' | 'ssm' | 'hybrid'
    n_layers: int
    d_model: int
    n_heads: int                    # query heads (0 for attention-free)
    n_kv_heads: int                 # KV heads (GQA); == n_heads for MHA
    d_ff: int                       # dense FFN hidden (or shared-attn-block FFN)
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    frontend: str = "none"          # 'none' | 'audio' | 'vlm' (stub embeddings)
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0              # routed experts
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden size
    capacity_factor: float = 1.25

    # --- SSM (Mamba2) -------------------------------------------------------
    ssm_state: int = 0              # N, per-head state size
    ssm_expand: int = 2             # d_inner = expand * d_model
    ssm_head_dim: int = 64
    conv_width: int = 4

    # --- hybrid (Zamba2) ----------------------------------------------------
    attn_every: int = 0             # shared attention block every k Mamba layers

    # --- RWKV6 ---------------------------------------------------------------
    rwkv: bool = False
    rwkv_head_dim: int = 64
    rwkv_lora: int = 64             # rank of the data-dependent decay LoRA

    # --- provenance -----------------------------------------------------------
    source: str = ""                # citation tag from the assignment table

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim if self.rwkv else 0

    @property
    def has_attention(self) -> bool:
        return self.family in ("dense", "moe", "hybrid")

    @property
    def is_pure_full_attention(self) -> bool:
        """True when *every* token-mixing layer is full (quadratic) attention."""
        return self.family in ("dense", "moe")

    # --- parameter counting (used by roofline MODEL_FLOPS and pimsim) --------
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.hd
        n_attn = self.n_heads * hd * d + 2 * self.n_kv_heads * hd * d + self.n_heads * hd * d
        n_dense_ffn = 3 * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "dense":
            per_layer = n_attn + n_dense_ffn + 2 * d
            return self.n_layers * per_layer + emb + d
        if self.family == "moe":
            n_router = d * self.n_experts
            experts = self.top_k if active_only else self.n_experts
            n_moe = (experts + self.n_shared_experts) * 3 * d * self.moe_d_ff
            per_layer = n_attn + n_moe + n_router + 2 * d
            return self.n_layers * per_layer + emb + d
        if self.family == "ssm" and self.rwkv:
            # time-mix (r,k,v,g,o ~ 5 d^2 at head granularity) + decay lora + channel-mix
            per_layer = 5 * d * d + 2 * d * self.rwkv_lora + d * self.d_ff * 2 + 4 * d
            return self.n_layers * per_layer + emb + d
        if self.family in ("ssm", "hybrid"):
            di, ns = self.d_inner, self.ssm_state
            heads = di // self.ssm_head_dim
            per_mamba = d * (2 * di + 2 * ns * 0 + 0)  # placeholder, refined below
            # in_proj: d -> (2*di + 2*n_groups*ns + heads); use n_groups=1
            per_mamba = d * (2 * di + 2 * ns + heads) + di * self.conv_width + di * d + 2 * d
            if self.family == "ssm":
                return self.n_layers * per_mamba + emb + d
            # hybrid: shared attention+FFN block counted once (weights shared)
            shared = n_attn + n_dense_ffn + 2 * d
            return self.n_layers * per_mamba + shared + emb + d
        raise ValueError(self.family)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (one fwd/train step)."""
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=min(cfg.n_layers, 4) if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=96,
        vocab_size=128,
        head_dim=16 if cfg.n_heads else 0,
    )
    if cfg.family == "moe":
        kw.update(n_experts=8, n_shared_experts=min(cfg.n_shared_experts, 1), top_k=2, moe_d_ff=32)
    if cfg.family in ("ssm", "hybrid") and not cfg.rwkv:
        kw.update(ssm_state=8, ssm_head_dim=16, ssm_expand=2)
    if cfg.family == "hybrid":
        kw.update(attn_every=2, n_layers=5)  # 2 groups of 2 + 1 tail layer
    if cfg.rwkv:
        kw.update(rwkv_head_dim=16, rwkv_lora=8)
    return cfg.replace(**kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell is runnable, with a reason when skipped.

    ``long_500k`` requires sub-quadratic token mixing: run for SSM/hybrid,
    skip for pure full-attention archs (per assignment instructions; the skip
    is recorded in DESIGN.md / EXPERIMENTS.md).
    """
    if shape.name == "long_500k" and cfg.is_pure_full_attention:
        return False, "long_500k skipped: pure full-attention arch (quadratic prefill, no sub-quadratic mixer)"
    return True, ""
