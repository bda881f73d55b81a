"""Analytical latency/energy models for the PIM substrates.

A copy of the JAX package's ``pimsim/ops.py`` (:18-162), every formula in
the reference's order of operations, so each float comes out bit-equal.
These price the paper's modeled hardware (``pimsim.params``), not the card.

Conventions: an FC layer instance is [m, k, n] (m input vectors, k inputs,
n outputs) sharded output-split (or input-split) across ``banks``; times in
seconds, energies in joules.  These are throughput-latency models (not
cycle-accurate): bandwidths and access times from params.py, plus DRAM row
overheads amortized at row granularity.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.pimsim.params import CompairHW


@dataclass
class Cost:
    t: float = 0.0            # seconds
    e: float = 0.0            # joules

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.t + o.t, self.e + o.e)

    def par(self, o: "Cost") -> "Cost":
        """Parallel composition (overlapped): max time, summed energy."""
        return Cost(max(self.t, o.t), self.e + o.e)


BYTES = 2  # BF16


# ---------------------------------------------------------------------------
# DRAM-PIM (bandwidth lane)
# ---------------------------------------------------------------------------

def dram_fc(hw: CompairHW, m: int, k: int, n: int, banks: int,
            reuse_weights: bool = False) -> Cost:
    """Output-split GeMV/GeMM on DRAM-PIM MACs: every weight is re-read
    from the array for every input vector (no reuse inside a bank)."""
    n_bank = max(n / banks, 1.0)
    wbytes = k * n_bank * BYTES
    # each input vector streams the bank's weight slice once
    t_stream = m * wbytes / hw.dram.bank_bw
    rows = math.ceil(wbytes / 1024)
    t_rows = m * rows * hw.dram.row_overhead_s * 0.1  # pipelined activates
    e = (m * wbytes * 8 * hw.dram.e_access_pj_per_bit
         + 2.0 * m * k * n_bank * hw.dram.e_mac_pj / 2) * 1e-12 * banks
    return Cost(t_stream + t_rows, e)


def dram_attention(hw: CompairHW, batch: int, heads: int, s_ctx: int,
                   hd: int, banks: int) -> Cost:
    """QK^T + SV for one decode step: stream the KV cache once."""
    kv_bytes = 2 * batch * heads * s_ctx * hd * BYTES
    t = kv_bytes / (banks * hw.dram.bank_bw)
    e = kv_bytes * 8 * hw.dram.e_access_pj_per_bit * 1e-12
    return Cost(t, e)


# ---------------------------------------------------------------------------
# SRAM-PIM (matrix lane)
# ---------------------------------------------------------------------------

def sram_fc(hw: CompairHW, m: int, k: int, n: int, banks: int, *,
            decoupled: bool = False, in_dim: int | None = None,
            out_dim: int | None = None, input_split_groups: int = 1) -> Cost:
    """Weight-stationary FC on the bonded SRAM-PIM macros.

    Tiles of [K_in x N_out] load once from DRAM (feed bandwidth), then all
    m vectors stream through (SRAM_Write / SRAM_Compute).  (512,8) vs
    (256,16) macro concatenation is modeled by in_dim/out_dim;
    ``input_split_groups`` > 1 adds a NoC reduction per output tile."""
    sram = hw.sram
    K_in = in_dim or sram.in_dim * sram.macros_per_bank   # (512, 8) default
    N_out = out_dim or sram.out_dim
    feed = sram.feed_bw_decoupled if decoupled else sram.feed_bw_base
    n_bank = max(n / banks, 1.0)
    wbytes = k * n_bank * BYTES
    t_load = wbytes / feed                                 # once per batch
    tiles = math.ceil(k / K_in) * math.ceil(n_bank / N_out)
    t_compute = m * tiles * sram.t_access_ns * 1e-9
    # inputs stream from DRAM once per output tile sweep
    in_bytes = m * k * BYTES * math.ceil(n_bank / N_out) / max(input_split_groups, 1)
    t_input = in_bytes / feed
    if input_split_groups > 1:
        t_reduce = (m * n_bank * BYTES / hw.dram.gb_bw
                    + math.log2(input_split_groups) * hw.noc.hop_cycles
                    / hw.noc.clock_hz)
    else:
        t_reduce = 0.0
    # energy: DRAM reads feeding the bond + hybrid-bonding transfer + MACs
    e = ((wbytes + in_bytes) * 8 * (hw.dram.e_access_pj_per_bit
                                    + hw.sram.e_hb_pj_per_bit)
         + m * k * n_bank * hw.sram.e_mac_pj) * 1e-12 * banks
    # loads/input streaming overlap compute (double-buffered); 10% exposed
    t_ovl = max(t_load + t_input, t_compute) \
        + 0.1 * min(t_load + t_input, t_compute)
    return Cost(t_ovl + t_reduce, e)


# ---------------------------------------------------------------------------
# non-linear paths
# ---------------------------------------------------------------------------

def nonlinear_centralized(hw: CompairHW, elements: int, ops_per_elem: int = 8
                          ) -> Cost:
    """CENT-style NLU in the CXL controller: move out + compute + move back
    (the Fig. 5A round trip)."""
    bytes_ = elements * BYTES
    t_move = 2 * bytes_ / hw.nlu.bus_bw
    t_comp = elements * ops_per_elem / (hw.nlu.lanes * hw.nlu.clock_hz)
    e = (2 * bytes_ * 8 * hw.cxl.e_pj_per_bit
         + elements * ops_per_elem * hw.nlu.e_pj_per_op) * 1e-12
    return Cost(t_move + t_comp, e)


def nonlinear_noc(hw: CompairHW, elements: int, ops_per_elem: int | None = None,
                  channels_active: int | None = None) -> Cost:
    """Curry-ALU in-transit non-linear: computed while flits traverse the
    per-channel mesh; all channels work in parallel."""
    chans = channels_active or hw.dram.channels
    ops_pe = ops_per_elem if ops_per_elem is not None else 3 * hw.curry_rounds + 6
    t = elements * ops_pe / (chans * hw.noc.alu_throughput)
    # flit transport overlaps with compute (flit-compute stage, Fig. 11C)
    e = (elements * ops_pe * 0.05e-12 * hw.noc.alus_per_router
         + elements * BYTES * 8 * hw.noc.e_hop_pj_per_bit * 1e-12 * 4)
    return Cost(t, e)


def reduce_tree_noc(hw: CompairHW, vec_elems: int, fan_in: int) -> Cost:
    """Bank-granularity reduce/broadcast tree inside a channel."""
    hops = math.ceil(math.log2(max(fan_in, 2)))
    t = hops * (hw.noc.hop_cycles / hw.noc.clock_hz) \
        + vec_elems * BYTES * 8 / (hw.noc.flit_bits * hw.noc.clock_hz)
    e = vec_elems * BYTES * 8 * hw.noc.e_hop_pj_per_bit * hops * 1e-12
    return Cost(t, e)


def reduce_global_buffer(hw: CompairHW, vec_elems: int, fan_in: int) -> Cost:
    """CENT baseline: serialize partial sums through the global buffer."""
    bytes_ = vec_elems * BYTES * fan_in
    t = bytes_ / hw.dram.gb_bw
    e = bytes_ * 8 * hw.dram.e_access_pj_per_bit * 1e-12
    return Cost(t, e)


def cxl_allreduce(hw: CompairHW, bytes_per_device: float, tp: int) -> Cost:
    if tp <= 1:
        return Cost()
    payload = 2.0 * bytes_per_device * (tp - 1) / tp
    t = payload / hw.cxl.collective_bw
    e = payload * 8 * hw.cxl.e_pj_per_bit * 1e-12 * tp
    return Cost(t, e)


def cxl_broadcast(hw: CompairHW, bytes_: float, tp: int) -> Cost:
    if tp <= 1:
        return Cost()
    t = bytes_ / hw.cxl.collective_bw
    e = bytes_ * 8 * hw.cxl.e_pj_per_bit * 1e-12 * tp
    return Cost(t, e)
