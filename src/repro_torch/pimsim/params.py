"""Hardware constants of the paper's analytical CompAir model.

A copy of the parts of the JAX package's ``pimsim/params.py`` that the
port reads: ``DramPim`` (:16-48), ``SramPim`` (:50-99) and ``Cxl``
(:100-105), with the same fields and defaults.  ``core.noc``'s
swap-versus-recompute cost model prices a preemption with them.

Sources: paper Table 3 and the platforms it cites: AiM GDDR6-PIM [40], the
28nm 64kb digital SRAM-CIM macro [12], the CXL switch [14], hybrid bonding
[18,21,48].  Where the paper gives ranges (SRAM t_access 6.8-14.1 ns across
0.9-0.6 V) the defaults sit at the nominal point of its evaluation; energy
constants are estimates from the cited literature (marked).  These are the
paper's model of PIM banks and of a CXL link, not an H100's rates.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DramPim:
    """AiM-style GDDR6 DRAM-PIM (per device)."""
    channels: int = 32
    banks_per_channel: int = 16
    bank_mb: int = 32
    macs_per_bank: int = 16          # BF16 MACs @ 1 GHz
    clock_hz: float = 1e9
    bank_bw: float = 32e9            # B/s internal read-out per bank
    channel_bw: float = 512e9        # B/s per channel (16 banks aggregate)
    ext_io_bw: float = 32e9          # B/s external I/O per channel
    t_rcdrd_ns: float = 18.0
    t_cl_ns: float = 25.0
    t_rp_ns: float = 16.0
    t_ras_ns: float = 27.0
    t_rcdwr_ns: float = 14.0
    gb_bw: float = 64e9              # global-buffer inter-bank path, B/s
    e_access_pj_per_bit: float = 3.5   # GDDR6 array access (est.)
    e_mac_pj: float = 0.4              # BF16 MAC (est.)

    @property
    def banks(self) -> int:
        return self.channels * self.banks_per_channel

    @property
    def bank_flops(self) -> float:
        return 2.0 * self.macs_per_bank * self.clock_hz

    @property
    def row_overhead_s(self) -> float:
        """Activate + read + precharge amortized per row touched."""
        return (self.t_rcdrd_ns + self.t_rp_ns) * 1e-9


@dataclass(frozen=True)
class SramPim:
    """28nm 64kb digital FP CIM macro [12]; 4 macros bonded per DRAM bank."""
    macros_per_bank: int = 4
    kb_per_macro: int = 8            # 64kb
    in_dim: int = 128                # inputs per access
    out_dim: int = 8                 # outputs per access
    t_access_ns: float = 10.0        # 6.8 (0.9V) .. 14.1 (0.6V)
    tops_per_w: float = 22.0         # 14.4..31.6
    e_mac_pj: float = 0.09           # from TOPS/W (est.)
    feed_bw_base: float = 32e9       # DRAM->SRAM feed (= bank read-out)
    feed_bw_decoupled: float = 128e9  # §3.4 decoupled column decoder (8:1)
    hb_bw_per_bank: float = 204.8e9  # 256 bonds x 6.4 Gb/s
    e_hb_pj_per_bit: float = 0.5     # hybrid bonding 0.05-0.88 pJ/b
    e_access_pj_per_bit: float = 0.15  # SRAM array read (est., ~1/20 GDDR6)

    @property
    def macs_per_access(self) -> int:
        return self.in_dim * self.out_dim

    def bank_flops(self) -> float:
        return (2.0 * self.macs_per_access * self.macros_per_bank
                / (self.t_access_ns * 1e-9))


@dataclass(frozen=True)
class Cxl:
    collective_bw: float = 29.44e9   # B/s broadcast/reduce across devices
    p2p_bw: float = 53.5e9           # B/s point-to-point
    e_pj_per_bit: float = 5.0
