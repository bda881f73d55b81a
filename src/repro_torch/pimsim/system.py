"""System-level analytical models: CENT, CompAir variants, AttAcc proxy.

A copy of the JAX package's ``pimsim/system.py`` (:28-185), bit-equal:
the paper's modeled systems, not the card the port runs on.

simulate(model_cfg, batch, s_ctx, phase, system=...) returns a per-token
(decode) or per-batch (prefill) latency/energy breakdown over one full
forward pass: FC lanes, attention, non-linear ops, collectives.

Systems (the paper's ablation, Fig. 16):
  cent            — fully DRAM-PIM, centralized NLU, GB reductions [11]
  cent_curry      — CENT + CompAir-NoC (Curry ALU) for non-linear/reduce
  compair_base    — + SRAM-PIM lanes for weight-reusing FCs (32 GB/s feed)
  compair_opt     — + decoupled column decoder (128 GB/s feed, §3.4)
  attacc          — A100 + HBM-PIM proxy [53]
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.pimsim import ops as O
from repro_torch.pimsim.params import DEFAULT, CompairHW, Gpu, HbmPim

BYTES = 2


@dataclass
class Breakdown:
    fc: O.Cost = field(default_factory=O.Cost)
    attn: O.Cost = field(default_factory=O.Cost)
    nonlinear: O.Cost = field(default_factory=O.Cost)
    comm: O.Cost = field(default_factory=O.Cost)

    @property
    def total(self) -> O.Cost:
        return self.fc + self.attn + self.nonlinear + self.comm

    def as_dict(self) -> Dict[str, float]:
        return {
            "fc_s": self.fc.t, "attn_s": self.attn.t,
            "nonlinear_s": self.nonlinear.t, "comm_s": self.comm.t,
            "total_s": self.total.t, "energy_j": self.total.e,
        }


def _fc_layers(cfg: ModelConfig):
    """[(k, n, reusable)] per transformer layer (dense archs; the paper
    evaluates Llama/Qwen/GPT3 — all dense)."""
    d, hd = cfg.d_model, cfg.hd
    return [
        ("qkv", d, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd, True),
        ("attn_out", cfg.n_heads * hd, d, True),
        ("ffn_up_gate", d, 2 * cfg.d_ff, True),
        ("ffn_down", cfg.d_ff, d, True),
    ]


def simulate(cfg: ModelConfig, *, batch: int, s_ctx: int, phase: str,
             system: str = "compair_opt", hw: CompairHW = DEFAULT,
             tp: int = 8, sram_min_batch: int = 2,
             mapping: str = "auto") -> Breakdown:
    """One forward pass over all layers.

    phase: 'decode' (m = batch tokens) or 'prefill' (m = batch * s_ctx).
    tp: tensor-parallel device count (weights sliced; activations
        all-reduced over CXL per attention/FFN block).
    mapping: 'auto' | 'output' | 'input' — SRAM-PIM macro organization
        ((512,8) output-split vs (256,16) with a 2-group input split)."""
    assert phase in ("decode", "prefill")
    m = batch if phase == "decode" else batch * s_ctx
    banks = hw.dram.banks  # per device
    bd = Breakdown()
    use_noc = system in ("cent_curry", "compair_base", "compair_opt")
    use_sram = system in ("compair_base", "compair_opt")
    decoupled = system == "compair_opt"

    if system == "attacc":
        return _attacc(cfg, batch=batch, s_ctx=s_ctx, phase=phase, tp=tp)

    for _ in range(cfg.n_layers):
        # ---- FC lanes -----------------------------------------------------
        for name, k, n, reusable in _fc_layers(cfg):
            n_tp = max(n // tp, 1)
            if use_sram and reusable and m >= sram_min_batch:
                if mapping == "input" or (mapping == "auto" and n_tp / banks < 16):
                    c = O.sram_fc(hw, m, k // 2, n_tp, banks, decoupled=decoupled,
                                  in_dim=256, out_dim=16, input_split_groups=2)
                else:
                    c = O.sram_fc(hw, m, k, n_tp, banks, decoupled=decoupled)
            else:
                c = O.dram_fc(hw, m, k, n_tp, banks)
            bd.fc += c
            # input-vector broadcast to banks
            bcast = O.Cost(m * k * BYTES / hw.dram.gb_bw,
                           m * k * BYTES * 8 * 0.5e-12)
            bd.comm += bcast if not use_noc else O.Cost(bcast.t * 0.5, bcast.e)

        # ---- attention (KV input-dependent -> DRAM lane, paper §8) --------
        heads_tp = max(cfg.n_heads // tp, 1)
        if phase == "decode":
            bd.attn += O.dram_attention(hw, batch, heads_tp, s_ctx, cfg.hd, banks)
            probs = batch * heads_tp * s_ctx
        else:
            # prefill: process s_ctx queries; causal ~ s/2 average context
            bd.attn += O.dram_attention(hw, batch * s_ctx, heads_tp,
                                        max(s_ctx // 2, 1), cfg.hd, banks)
            probs = batch * s_ctx * heads_tp * max(s_ctx // 2, 1)

        # softmax: exp on probs + cross-bank reduce + bcast + divide
        if use_noc:
            bd.nonlinear += O.nonlinear_noc(hw, probs)
            bd.nonlinear += O.reduce_tree_noc(hw, batch * heads_tp,
                                              hw.dram.banks_per_channel)
        else:
            bd.nonlinear += O.nonlinear_centralized(hw, probs)
            bd.nonlinear += O.reduce_global_buffer(hw, batch * heads_tp,
                                                   hw.dram.banks_per_channel)
        # RoPE rearrangement (q,k) + RMSNorm (2x) + SiLU on ffn hidden
        rope_elems = 2 * m * heads_tp * cfg.hd
        norm_elems = 2 * m * cfg.d_model
        silu_elems = m * cfg.d_ff // tp
        if use_noc:
            bd.nonlinear += O.nonlinear_noc(hw, rope_elems, ops_per_elem=4)
            bd.nonlinear += O.nonlinear_noc(hw, norm_elems, ops_per_elem=6)
            bd.nonlinear += O.nonlinear_noc(hw, silu_elems)
        else:
            bd.nonlinear += O.nonlinear_centralized(hw, rope_elems, ops_per_elem=4)
            bd.nonlinear += O.nonlinear_centralized(hw, norm_elems, ops_per_elem=6)
            bd.nonlinear += O.nonlinear_centralized(hw, silu_elems)

        # ---- TP collectives over CXL (attention out + FFN down) ----------
        bd.comm += O.cxl_allreduce(hw, m * cfg.d_model * BYTES, tp)
        bd.comm += O.cxl_allreduce(hw, m * cfg.d_model * BYTES, tp)

    return bd


def _attacc(cfg: ModelConfig, *, batch: int, s_ctx: int, phase: str,
            tp: int = 4) -> Breakdown:
    """A100 + HBM-PIM proxy: FCs on the GPU roofline, attention in
    HBM-PIM banks (AttAcc's split)."""
    gpu, hp = Gpu(), HbmPim()
    m = batch if phase == "decode" else batch * s_ctx
    bd = Breakdown()
    for _ in range(cfg.n_layers):
        for name, k, n, _ in _fc_layers(cfg):
            fl = 2.0 * m * k * (n / tp)
            by = (k * n / tp + m * k + m * n / tp) * BYTES
            t = max(fl / gpu.peak_flops, by / gpu.hbm_bw)
            e = fl * gpu.e_pj_per_flop * 1e-12 + by * 8 * gpu.e_hbm_pj_per_bit * 1e-12
            bd.fc += O.Cost(t, e)
        heads_tp = max(cfg.n_heads // tp, 1)
        ctx = s_ctx if phase == "decode" else max(s_ctx // 2, 1)
        mq = batch if phase == "decode" else batch * s_ctx
        kv_bytes = 2 * mq * heads_tp * ctx * cfg.hd * BYTES
        bd.attn += O.Cost(kv_bytes / hp.internal_bw,
                          kv_bytes * 8 * hp.e_pj_per_bit * 1e-12)
        # non-linears ride the GPU (cheap in time, costly in energy)
        elems = mq * heads_tp * ctx + 2 * m * cfg.d_model
        bd.nonlinear += O.Cost(elems / gpu.peak_flops * 8,
                               elems * 8 * gpu.e_pj_per_flop * 1e-12)
        bd.comm += O.Cost(2 * m * cfg.d_model * BYTES / 300e9,
                          2 * m * cfg.d_model * BYTES * 8 * 2e-12)
    # static/board power dominates bandwidth-bound GPU decode: 4x A100 TDP
    # + 4x HBM-PIM stacks (est. 50 W each) for the whole pass duration.
    # (PIM devices are lean by design; the paper's energy edge is exactly
    # this term — GPUs burn TDP while waiting on HBM.)
    static_w = tp * gpu.power_w + 4 * 50.0
    bd.comm += O.Cost(0.0, static_w * bd.total.t)
    return bd


def token_latency(cfg: ModelConfig, **kw) -> float:
    return simulate(cfg, phase="decode", **kw).total.t


def decode_throughput(cfg: ModelConfig, *, batch: int, s_ctx: int,
                      system: str, tp: int = 8, devices: int = 32,
                      hw: CompairHW = DEFAULT) -> float:
    """Tokens/s across the whole fleet: device groups of ``tp`` serve
    independent replicas (the paper's TP<=8 finding, Fig. 18)."""
    lat = simulate(cfg, batch=batch, s_ctx=s_ctx, phase="decode",
                   system=system, tp=tp, hw=hw).total.t
    replicas = max(devices // tp, 1)
    return batch * replicas / lat
