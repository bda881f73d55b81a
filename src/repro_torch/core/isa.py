"""Hierarchical ISA (paper §5): Row-Level programs -> Packet-Level plans.

A torch copy of the JAX package's ``core/isa.py``: the same instruction
set, the same lowering and the same packet semantics, run on ``torch``
buffers on whatever device they live on.

Row-Level (user-facing, SIMD across banks, Table 1):
    NoC_Scalar   op in {+=,-=,*=,/=,max=}; one Curry-ALU application
    NoC_Access   Rd/Wr of Curry-ALU ArgRegs
    NoC_BCast    bank-granular broadcast from SrcBank
    NoC_Reduce   bank-granular reduction to DstBank
    NoC_Exchange T±/R± data exchange (the RoPE neighbour swap, Fig. 12)
    SRAM_Write / SRAM_Compute   weight load / matrix multiply
plus the DRAM-PIM-native ops the paper inherits from AiM [40]:
    DRAM_EWMUL   element-wise multiply inside the bank
    DRAM_MAC     row reduction through the bank's 16-input MAC

Packet-Level (what routers execute, Table 2): packets carry a fused op
*path* (<= 4 ops per loop, IterNum loops) plus tree hop schedules for
Reduce/BCast.  :func:`lower` performs the paper's **path generation**
(§5.2): consecutive NoC_Scalar ops in a producer->consumer chain
(prev.DST == next.SRC) are fused into one packet, eliminating the per-op
DRAM round trip ("Base" in Fig. 23).

:class:`Machine` executes plans on a bank-major memory model (buffers:
name -> ``[banks, width]`` tensors), op by op, every Curry-ALU op taken
from ``core.curry.OPS``: a division by a constant is a true division on
every device, as in the reference.  There is no kernel: each packet is a
few PyTorch ops on the buffers' device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.curry import OPS, ChainStep

Num = Union[int, float, str, None]

ROW_KINDS = ("NoC_Scalar", "NoC_Access", "NoC_BCast", "NoC_Reduce",
             "NoC_Exchange", "SRAM_Write", "SRAM_Compute",
             "DRAM_EWMUL", "DRAM_MAC")


@dataclass(frozen=True)
class RowInstr:
    """One Table-1 row-level instruction (SIMD across all masked banks)."""
    kind: str
    op: Num         # OP field
    src: str        # SRC buffer
    dst: str        # DST buffer
    num1: Num = None  # Mask / Length / Offset
    num2: Num = None  # Config / Const / Src-/DstBank / Group

    def __post_init__(self):
        assert self.kind in ROW_KINDS, self.kind


# ----------------------------- packet level --------------------------------

MAX_PATH = 4  # Table 2: Path[0..3]


@dataclass
class ScalarPacket:
    """Fused Curry-ALU path: ops applied in sequence, one DRAM read at
    entry + one write at exit (vs. a round trip *per op* unfused)."""
    src: str
    dst: str
    steps: List[ChainStep]

    @property
    def iter_num(self) -> int:  # Table 2 IterNum
        return max(1, math.ceil(len(self.steps) / MAX_PATH))


@dataclass
class TreePacket:
    kind: str       # 'reduce' | 'bcast'
    op: Num
    src: str
    dst: str
    root: int

    def hops(self, n_banks: int) -> int:
        return int(math.log2(max(n_banks, 2)))


@dataclass
class ExchangePacket:
    mode: str       # 'T+'|'T-'|'R+'|'R-'
    src: str
    dst: str
    offset: int
    group: int


@dataclass
class SramPacket:
    kind: str       # 'write' | 'compute'
    src: str
    dst: Optional[str]


@dataclass
class DramPacket:
    kind: str       # 'ewmul' | 'mac'
    op: Num
    src: str
    src2: Optional[str]
    dst: str


Packet = Union[ScalarPacket, TreePacket, ExchangePacket, SramPacket, DramPacket]


@dataclass
class PacketPlan:
    packets: List[Packet] = field(default_factory=list)

    def n_packets(self) -> int:
        return len(self.packets)

    def dram_roundtrips(self) -> int:
        """DRAM read+write round trips (the quantity path generation cuts):
        one for every packet."""
        return len(self.packets)

    def alu_ops(self) -> int:
        return sum(len(p.steps) for p in self.packets
                   if isinstance(p, ScalarPacket))


# ----------------------------- lowering ------------------------------------

def lower(program: Sequence[RowInstr], *, fuse: bool = True) -> PacketPlan:
    """Row-level -> packet-level translation with path generation.

    With ``fuse=False`` every NoC_Scalar becomes its own packet (the
    conservative write-back-to-DRAM semantics of the row-level ISA); with
    ``fuse=True`` producer->consumer chains merge (Fig. 23).  Buffers
    referenced *by name* as a later instruction's ArgReg must be
    materialized, so fusion breaks after any instruction whose DST is
    consumed as an argument downstream (the paper's address-dependency
    analysis across row-level instructions)."""
    consumed_as_arg = {ins.num2 for ins in program
                       if ins.kind == "NoC_Scalar" and isinstance(ins.num2, str)
                       and ins.num2 != "self"}
    plan = PacketPlan()
    pending: Optional[ScalarPacket] = None

    def flush():
        nonlocal pending
        if pending is not None:
            plan.packets.append(pending)
            pending = None

    for ins in program:
        if ins.kind == "NoC_Scalar":
            step = ChainStep(ins.op, ins.num2)
            if fuse and pending is not None and pending.dst == ins.src:
                pending.steps.append(step)
                pending.dst = ins.dst
            else:
                flush()
                pending = ScalarPacket(src=ins.src, dst=ins.dst, steps=[step])
            if not fuse or ins.dst in consumed_as_arg:
                flush()
            continue
        flush()
        if ins.kind == "NoC_Reduce":
            plan.packets.append(TreePacket("reduce", ins.op, ins.src, ins.dst,
                                           int(ins.num2 or 0)))
        elif ins.kind == "NoC_BCast":
            plan.packets.append(TreePacket("bcast", None, ins.src, ins.dst,
                                           int(ins.num2 or 0)))
        elif ins.kind == "NoC_Exchange":
            plan.packets.append(ExchangePacket(str(ins.op), ins.src, ins.dst,
                                               int(ins.num1), int(ins.num2)))
        elif ins.kind == "SRAM_Write":
            plan.packets.append(SramPacket("write", ins.src, None))
        elif ins.kind == "SRAM_Compute":
            plan.packets.append(SramPacket("compute", ins.src, ins.dst))
        elif ins.kind == "DRAM_EWMUL":
            plan.packets.append(DramPacket("ewmul", None, ins.src,
                                           str(ins.num2), ins.dst))
        elif ins.kind == "DRAM_MAC":
            plan.packets.append(DramPacket("mac", ins.op, ins.src, None, ins.dst))
        elif ins.kind == "NoC_Access":
            plan.packets.append(DramPacket("ewmul", None, ins.src, None, ins.dst))
        else:
            raise ValueError(ins.kind)
    flush()
    return plan


# ----------------------------- execution -----------------------------------

def _alternating_sign(n: int, like: torch.Tensor) -> torch.Tensor:
    """-1 at even indices, +1 at odd ones, in ``like``'s dtype and device."""
    idx = torch.arange(n, device=like.device)
    return torch.where(idx % 2 == 0, -1.0, 1.0).to(like.dtype)


class Machine:
    """Bank-major interpreter: buffers are ``[banks, width]`` tensors, all on
    one device; every packet runs there.  ``sram_weight`` holds the per-bank
    SRAM-PIM weight ``[banks, in, out]`` after SRAM_Write."""

    def __init__(self, buffers: Dict[str, torch.Tensor]):
        self.buf = dict(buffers)
        self.sram_weight: Optional[torch.Tensor] = None

    def run(self, plan: PacketPlan) -> Dict[str, torch.Tensor]:
        for p in plan.packets:
            self._exec(p)
        return self.buf

    def _exec(self, p: Packet):
        if isinstance(p, ScalarPacket):
            env = dict(self.buf)        # named ArgRegs resolve to buffers
            cur = self.buf[p.src]
            for s in p.steps:
                if s.arg == "self":
                    cur = OPS[s.op](cur, cur)
                    continue
                arg = env[s.arg] if isinstance(s.arg, str) else s.arg
                cur = OPS[s.op](cur, arg)
            self.buf[p.dst] = cur
        elif isinstance(p, TreePacket):
            x = self.buf[p.src]
            if p.kind == "reduce":
                if p.op == "+=":
                    total = x.sum(dim=0)
                else:                   # generic fold over banks
                    comb = OPS[p.op]
                    total = x[0]
                    for i in range(1, x.shape[0]):
                        total = comb(total, x[i])
                out = torch.zeros_like(x)
                out[p.root] = total
                self.buf[p.dst] = out
            else:  # bcast
                self.buf[p.dst] = x[p.root].expand(x.shape).clone()
        elif isinstance(p, ExchangePacket):
            x = self.buf[p.src]
            neg = p.mode.endswith("-")
            if p.mode.startswith("R"):
                banks, width = x.shape
                g, off = p.group, p.offset
                idx = (torch.arange(g, device=x.device) + off) % g
                sw = x.reshape(banks, width // g, g)[:, :, idx]
                if neg:  # negate elements arriving at even (first) slots
                    sw = sw * _alternating_sign(g, sw)
                self.buf[p.dst] = sw.reshape(banks, width)
            else:  # T: across banks
                banks = x.shape[0]
                ar = torch.arange(banks, device=x.device)
                idx = (ar + p.offset) % p.group + (ar // p.group) * p.group
                sw = x[idx]
                if neg:
                    sw = sw * _alternating_sign(banks, sw)[:, None]
                self.buf[p.dst] = sw
        elif isinstance(p, SramPacket):
            if p.kind == "write":
                self.sram_weight = self.buf[p.src]
            else:
                if self.sram_weight is None:
                    raise RuntimeError("SRAM_Compute before SRAM_Write")
                self.buf[p.dst] = torch.einsum("bi,bio->bo", self.buf[p.src],
                                               self.sram_weight)
        elif isinstance(p, DramPacket):
            if p.kind == "ewmul":
                a = self.buf[p.src]
                b = self.buf[p.src2] if p.src2 else a
                self.buf[p.dst] = a * b
            else:  # mac: row reduction inside the bank
                self.buf[p.dst] = self.buf[p.src].sum(dim=-1, keepdim=True)
        else:
            raise TypeError(p)


# ----------------------------- canonical programs --------------------------

def softmax_program(rounds: int = 6) -> List[RowInstr]:
    """Paper Fig. 10: per-bank Curry exp + local MAC sum + NoC reduce tree
    + broadcast + divide.  Operates on buffer 'x' [banks, width]."""
    prog: List[RowInstr] = []
    # exp via the Fig. 13 iteration, expressed as NoC_Scalar ops.  The
    # range-reduced input 'xr' is materialized once (it is a downstream
    # ArgReg), then the Horner chain runs in-place on 'e'.
    prog.append(RowInstr("NoC_Scalar", "*=", "x", "xr", None, 1.0 / 16.0))
    prog.append(RowInstr("NoC_Scalar", "/=", "xr", "e", None, float(rounds)))
    prog.append(RowInstr("NoC_Scalar", "+=", "e", "e", None, 1.0))
    for i in range(rounds - 1, 0, -1):
        prog.append(RowInstr("NoC_Scalar", "*=", "e", "e", None, "xr"))
        prog.append(RowInstr("NoC_Scalar", "/=", "e", "e", None, float(i)))
        prog.append(RowInstr("NoC_Scalar", "+=", "e", "e", None, 1.0))
    for _ in range(4):
        prog.append(RowInstr("NoC_Scalar", "*=", "e", "e", None, "self"))
    prog += [
        RowInstr("DRAM_MAC", "+=", "e", "partial"),
        RowInstr("NoC_Reduce", "+=", "partial", "total", None, 0),
        RowInstr("NoC_BCast", None, "total", "total_b", None, 0),
        RowInstr("NoC_Scalar", "/=", "e", "y", None, "total_b"),
    ]
    return prog


def softmax_execute(x_banks: torch.Tensor, rounds: int = 6, fuse: bool = True
                    ) -> Tuple[torch.Tensor, PacketPlan]:
    """Run the softmax program on [banks, width] data; returns (y, plan)."""
    plan = lower(softmax_program(rounds), fuse=fuse)
    buf = Machine({"x": x_banks}).run(plan)
    return buf["y"], plan


def rope_program() -> List[RowInstr]:
    """Paper Fig. 12: neighbour exchange in routers + EWMUL in DRAM-PIM.
    Buffers: 'x' [banks, width], 'cos'/'sin' interleave-expanded tables."""
    return [
        RowInstr("NoC_Exchange", "R-", "x", "xr", 1, 2),
        RowInstr("DRAM_EWMUL", None, "x", "xc", None, "cos"),
        RowInstr("DRAM_EWMUL", None, "xr", "xs", None, "sin"),
        RowInstr("NoC_Scalar", "+=", "xc", "y", None, "xs"),
    ]


def rope_execute(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> Tuple[torch.Tensor, PacketPlan]:
    plan = lower(rope_program())
    buf = Machine({"x": x, "cos": cos, "sin": sin}).run(plan)
    return buf["y"], plan
