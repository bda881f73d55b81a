"""Mapping: the paper's §3.3 output-split vs input-split analysis, as a
bytes-moved cost model (a copy of the JAX package's ``core/mapping.py``,
:38-83).

Paper findings it reproduces:
  * DRAM-PIM prefers **output-split** (no inter-bank reduction, but the
    input vector must be broadcast and per-bank FC shapes become extremely
    imbalanced: long inputs, short outputs);
  * with an efficient inter-bank reduction (CompAir-NoC), **input-split**
    often wins because balanced shapes minimize data movement for a fixed
    MAC budget (mean-value inequality);
  * the classic Megatron FFN pairing (up/gate output-split + down
    input-split, one reduction per block) is exactly this theorem applied
    twice.

``choose_fc_split`` is the quantitative rule.  The reference's
``sharding_plan`` / ``named_shardings``, which apply it across a model's
parameters as partition specs of a device mesh, come with the port's mesh
(``launch/mesh.py``); the port runs on one card until then.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.planner import H100, HWParams


@dataclass(frozen=True)
class SplitChoice:
    split: str            # 'output' | 'input'
    comm_bytes: float     # per-device collective payload
    alt_bytes: float      # the rejected option's payload
    collective: str       # which collective it implies


def choose_fc_split(m: int, k: int, n: int, tp: int,
                    dtype_bytes: int = 2, input_sharded: bool = False,
                    hw: HWParams = H100) -> SplitChoice:
    """Cost of sharding an [m,k]@[k,n] FC over ``tp`` devices.

    output-split: W columns sharded; requires the activation replicated
        (all-gather m*k if it arrives reduce-scattered), output stays local.
    input-split:  W rows sharded; activation arrives k-sharded for free,
        partial [m,n] outputs need an all-reduce (2x ring payload).
    ``hw`` is unused, as in the reference: the rule compares bytes only.
    """
    frac = (tp - 1) / tp
    ag = m * k * dtype_bytes * frac if input_sharded else 0.0
    out_bytes = ag
    in_bytes = 2.0 * m * n * dtype_bytes * frac
    if in_bytes < out_bytes:
        return SplitChoice("input", in_bytes, out_bytes, "all-reduce")
    return SplitChoice("output", out_bytes, in_bytes, "all-gather")


def megatron_block_bytes(m: int, d: int, ff: int, tp: int,
                         dtype_bytes: int = 2) -> Dict[str, float]:
    """Fig. 8-style comparison: pure output-split vs the mixed mapping for
    a SwiGLU FFN block (per device, bytes moved)."""
    frac = (tp - 1) / tp
    # pure output-split: all three FCs column-sharded; activations must be
    # re-gathered between up/gate and down (down's input is ff-wide)
    pure_output = (m * d * dtype_bytes * frac          # gather x for up/gate
                   + m * ff * dtype_bytes * frac)      # gather h for down
    # mixed (paper/Megatron): up/gate output-split, down input-split:
    # one all-reduce of the [m, d] output
    mixed = 2.0 * m * d * dtype_bytes * frac
    return {"pure_output_split": pure_output, "mixed_input_split": mixed,
            "speedup": pure_output / max(mixed, 1.0)}
