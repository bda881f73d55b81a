"""Hybrid execution planner: the paper's substrate-selection logic on the
card.

A torch-free copy of the JAX package's ``core/planner.py`` with the same
functions and field names.  CompAir routes each operator to the substrate
whose constraint it does not violate: weight-reusing batched GeMM ->
SRAM-PIM (§2.2, Fig. 4B), GeMV / input-dependent-matrix ops -> DRAM-PIM
(Fig. 4C).  On the H100 the two substrates become two *execution lanes*:

    tensor lane  -- the tensor-core GEMM (the SRAM-PIM analogue): a
                    weight-stationary tiled product on ``wgmma``, tiles
                    aligned to its M of 64, a weight panel kept in shared
                    memory across input tiles
    stream lane  -- bandwidth-bound streaming (decode attention, scans,
                    embedding lookups; the DRAM-PIM analogue): latency =
                    bytes / HBM bandwidth

The classification rule is the roofline ridge: arithmetic intensity
(FLOPs per HBM byte) above the ridge point -> tensor lane, below -> stream
lane.  For an [m,k]@[k,n] GEMM with m << k,n the intensity is ~m, so the
ridge reproduces the paper's batch-size crossover of Fig. 4B.

The planner emits, per operator: lane, the roofline terms, and tensor-lane
block shapes (the card's counterpart of the paper's §3.3 SRAM macro-shape
DSE, Fig. 20).  The default hardware is the card's datasheet (:data:`H100`);
any other is a :class:`HWParams` the caller builds.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional

from repro_torch.configs.base import ModelConfig, ShapeSpec


@dataclass(frozen=True)
class HWParams:
    """One accelerator as the planner sees it.  The defaults are an NVIDIA
    H100 SXM5 80 GB at its 700 W limit, from NVIDIA's H100 Tensor Core GPU
    datasheet (the same figures ``PERF.md``'s bounds use):

    - ``peak_flops``: dense bf16 tensor-core FLOP/s (989 TFLOP/s);
    - ``hbm_bw``: HBM3 bytes/s (3.35 TB/s);
    - ``ici_bw``: one NVLink 4 link's bytes/s in one direction (25 GB/s;
      18 links give the datasheet's 900 GB/s both ways together);
    - ``ici_links``: NVLink 4 links of one card (18);
    - ``ici_hop_latency``: seconds of a small transfer over one link; no
      datasheet gives it, 1 us is an assumed order of magnitude, not a
      measurement;
    - ``vmem_bytes``: the shared memory one thread block may hold on
      ``sm_90`` (227 KiB), where the tensor lane keeps its weight panel;
    - ``dtype_bytes``: bytes of an operand element (bf16);
    - ``mxu_align``: the tile alignment of the tensor lane, a ``wgmma``
      tile's M of 64.
    """
    name: str = "h100-sxm5-80gb"
    peak_flops: float = 989e12          # bf16 dense FLOP/s
    hbm_bw: float = 3.35e12             # B/s
    ici_bw: float = 25e9                # B/s per NVLink 4 link, one direction
    ici_links: int = 18
    ici_hop_latency: float = 1e-6       # s, assumed (no datasheet value)
    vmem_bytes: int = 227 * 1024        # shared memory of one block, sm_90
    dtype_bytes: int = 2
    mxu_align: int = 64                 # wgmma tile M

    @property
    def ridge(self) -> float:
        """FLOPs per HBM byte at the compute/memory roofline knee."""
        return self.peak_flops / self.hbm_bw


H100 = HWParams()


class Lane(str, Enum):
    TENSOR = "tensor"   # SRAM-PIM analogue: weight-stationary tensor-core GEMM
    STREAM = "stream"   # DRAM-PIM analogue: bandwidth-bound streaming


@dataclass(frozen=True)
class OpProfile:
    """One operator instance: [m, k] @ [k, n] with ``count`` repetitions.

    ``weight_static``: the k×n operand is a parameter (reusable across
    batches) rather than input-dependent (attention K/V, scan states)."""
    name: str
    m: int
    k: int
    n: int
    count: int = 1
    weight_static: bool = True
    dtype_bytes: int = 2

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n * self.count

    @property
    def bytes_hbm(self) -> float:
        mk = self.m * self.k
        kn = self.k * self.n
        mn = self.m * self.n
        return float(self.dtype_bytes) * (mk + kn + mn) * self.count

    @property
    def intensity(self) -> float:
        return self.flops / max(self.bytes_hbm, 1.0)


@dataclass(frozen=True)
class OpPlan:
    op: OpProfile
    lane: Lane
    # tensor-lane tiling (None on the stream lane)
    bm: Optional[int] = None
    bn: Optional[int] = None
    compute_s: float = 0.0
    memory_s: float = 0.0

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"


def classify(op: OpProfile, hw: HWParams = H100) -> Lane:
    return Lane.TENSOR if op.intensity >= hw.ridge else Lane.STREAM


def plan_blocks(op: OpProfile, hw: HWParams = H100):
    """Pick (bm, bn) so the weight panel k*bn and both tiles fit the
    block's shared memory with double buffering: the §3.3 'balanced shapes
    minimize bandwidth given a MAC budget' argument (mean-value
    inequality), aligned to the tensor lane's tile."""
    a = hw.mxu_align
    budget = hw.vmem_bytes // 3        # panel + in-tile + acc
    bn = a
    while op.k * (bn * 2) * hw.dtype_bytes <= budget and bn * 2 <= max(op.n, a):
        bn *= 2
    bm = a
    while (bm * 2) * op.k * hw.dtype_bytes <= budget and bm * 2 <= max(op.m, a):
        bm *= 2
    return bm, bn


def plan_op(op: OpProfile, hw: HWParams = H100, chips: int = 1) -> OpPlan:
    lane = classify(op, hw)
    compute_s = op.flops / (chips * hw.peak_flops)
    memory_s = op.bytes_hbm / (chips * hw.hbm_bw)
    if lane == Lane.TENSOR:
        bm, bn = plan_blocks(op, hw)
        return OpPlan(op, lane, bm, bn, compute_s, memory_s)
    return OpPlan(op, lane, None, None, compute_s, memory_s)


# ---------------------------------------------------------------------------
# per-model operator inventory
# ---------------------------------------------------------------------------

def model_op_profiles(cfg: ModelConfig, shape: ShapeSpec) -> List[OpProfile]:
    """Enumerate the model's GEMM-shaped operators at an assigned shape.

    Decode shapes profile ONE serve step (m = global_batch tokens) against
    a cache of shape.seq_len; train/prefill profile the full sequence."""
    L, d = cfg.n_layers, cfg.d_model
    hd = cfg.hd
    decode = shape.is_decode
    tokens = shape.global_batch * (1 if decode else shape.seq_len)
    s_ctx = shape.seq_len
    ops: List[OpProfile] = []

    def fc(name, k, n, count=1, m=tokens):
        ops.append(OpProfile(name, m, k, n, count))

    if cfg.has_attention:
        n_attn_layers = cfg.n_layers
        if cfg.family == "hybrid":
            n_attn_layers = cfg.n_layers // cfg.attn_every
        h, kvh = cfg.n_heads, cfg.n_kv_heads
        fc("attn_qkv", d, (h + 2 * kvh) * hd, n_attn_layers)
        fc("attn_out", h * hd, d, n_attn_layers)
        # attention score/value matmuls: per (batch*head), input-dependent
        bh = shape.global_batch * h
        if decode:
            ops.append(OpProfile("attn_qk", 1, hd, s_ctx, bh * n_attn_layers,
                                 weight_static=False))
            ops.append(OpProfile("attn_sv", 1, s_ctx, hd, bh * n_attn_layers,
                                 weight_static=False))
        else:
            # causal: ~S^2/2 effective
            ops.append(OpProfile("attn_qk", s_ctx, hd, s_ctx // 2,
                                 bh * n_attn_layers, weight_static=False))
            ops.append(OpProfile("attn_sv", s_ctx, s_ctx // 2, hd,
                                 bh * n_attn_layers, weight_static=False))

    if cfg.family == "dense":
        fc("ffn_gate_up", d, 2 * cfg.d_ff, L)
        fc("ffn_down", cfg.d_ff, d, L)
    elif cfg.family == "moe":
        fc("moe_router", d, cfg.n_experts, L)
        # routed experts: each token hits top_k experts
        m_exp = tokens * cfg.top_k
        fc("moe_gate_up", d, 2 * cfg.moe_d_ff, L, m=m_exp)
        fc("moe_down", cfg.moe_d_ff, d, L, m=m_exp)
        if cfg.n_shared_experts:
            fc("moe_shared", d, 3 * cfg.n_shared_experts * cfg.moe_d_ff, L)
    elif cfg.rwkv:
        fc("rwkv_tm_proj", d, 4 * d, L)          # r,k,v,g
        fc("rwkv_tm_out", d, d, L)
        fc("rwkv_decay_lora", d, cfg.rwkv_lora + cfg.rwkv_lora, L)
        # wkv state update: per token per head, S [hd, hd] read-modify-write
        ops.append(OpProfile("rwkv_wkv", 1, cfg.rwkv_head_dim, cfg.rwkv_head_dim,
                             tokens * cfg.rwkv_heads * L, weight_static=False))
        fc("rwkv_cm", d, 2 * cfg.d_ff, L)        # up + down ~ 2*d*ff
    if cfg.family in ("ssm", "hybrid") and not cfg.rwkv:
        n_mamba = cfg.n_layers      # hybrid: every layer is a mamba layer
        di, ns = cfg.d_inner, cfg.ssm_state
        fc("mamba_in_proj", d, 2 * di + 2 * ns + cfg.ssm_heads, n_mamba)
        fc("mamba_out_proj", di, d, n_mamba)
        ops.append(OpProfile("mamba_ssd", 1, ns, cfg.ssm_head_dim,
                             tokens * cfg.ssm_heads * n_mamba * 2,
                             weight_static=False))
        if cfg.family == "hybrid":
            fc("shared_ffn", d, 3 * cfg.d_ff, cfg.n_layers // cfg.attn_every)

    fc("lm_head", d, cfg.vocab_size, 1)
    return ops


def plan_model(cfg: ModelConfig, shape: ShapeSpec, hw: HWParams = H100,
               chips: int = 1) -> List[OpPlan]:
    return [plan_op(op, hw, chips) for op in model_op_profiles(cfg, shape)]


def lane_table(cfg: ModelConfig, shape: ShapeSpec, hw: HWParams = H100
               ) -> str:
    """Human-readable lane assignment, one row an operator."""
    rows = [f"{'op':18s} {'m':>9s} {'k':>7s} {'n':>7s} {'AI':>8s} lane    blocks"]
    for p in plan_model(cfg, shape, hw):
        blocks = f"({p.bm},{p.bn})" if p.lane == Lane.TENSOR else "stream"
        rows.append(f"{p.op.name:18s} {p.op.m:9d} {p.op.k:7d} {p.op.n:7d} "
                    f"{p.op.intensity:8.1f} {p.lane.value:6s}  {blocks}")
    return "\n".join(rows)
