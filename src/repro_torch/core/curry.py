"""Curry ALU: single-operand iterated arithmetic (paper §4.2, Fig. 11/13).

The hardware unit applies a unary op with a register-held right operand
(ArgReg), optionally updating ArgReg each iteration (IterOp/IterArg).
Non-linear functions are built as *chains* of these ops — exp by the
iterated Taylor/Horner scheme of Fig. 13, rsqrt by Newton iteration.

A torch copy of the JAX package's ``core/curry.py``, op for op, so that the
same inputs give the same f32 values.  Its role in the port is fidelity
mode: the plain versions of the Curry-ALU kernel forms (``kernels/ref.py``
``rmsnorm`` and ``silu_mul`` with ``curry_rounds``) are built from it.

Every division here is a true division on every device: PyTorch on the card
divides by a Python scalar as a product with its reciprocal, one rounding
away from the reference (and from the CUDA kernels), so a divisor that is a
constant is made a tensor on the operand's device first (:func:`_const`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Union

import torch

Scalar = Union[float, torch.Tensor, str]


def _const(x: torch.Tensor, c) -> torch.Tensor:
    """``c`` as a tensor on x's device; a Python number takes x's dtype, as
    JAX's weakly typed scalars do."""
    if isinstance(c, torch.Tensor):
        return c
    return torch.tensor(c, dtype=x.dtype, device=x.device)


# the four Curry-ALU binary ops of Table 1 (NoC_Scalar OP field)
OPS = {
    "+=": lambda x, c: x + c,
    "-=": lambda x, c: x - c,
    "*=": lambda x, c: x * c,
    "/=": lambda x, c: x / _const(x, c),
    "max=": lambda x, c: torch.maximum(x, _const(x, c)),
}


@dataclass(frozen=True)
class ChainStep:
    op: str            # one of OPS
    arg: Scalar        # ArgReg value (float const or buffer name)


@dataclass
class Chain:
    """A fused sequence of Curry-ALU ops — one NoC packet path after
    path generation (paper §5.2, Fig. 23)."""
    steps: List[ChainStep] = field(default_factory=list)

    def apply(self, x, env=None):
        env = env or {}
        for s in self.steps:
            arg = env[s.arg] if isinstance(s.arg, str) else s.arg
            x = OPS[s.op](x, arg)
        return x

    def __len__(self):
        return len(self.steps)


def curry_exp(x, rounds: int = 6):
    """exp(x) via the Fig. 13 iteration (range-reduced Taylor + squaring)."""
    xr = x.float() * (1.0 / 16.0)
    p = torch.ones_like(xr)
    for i in range(rounds, 0, -1):
        p = p * (xr / _const(xr, float(i))) + 1.0
    for _ in range(4):
        p = p * p
    return p


def curry_rsqrt(x, rounds: int = 3):
    """1/sqrt(x) by Newton iteration, seeded from a low-precision estimate
    (the Curry-ALU refinement loop of §4.3.2)."""
    xf = x.float()
    y = torch.rsqrt(xf.to(torch.bfloat16).float())
    for _ in range(rounds):
        y = y * (1.5 - 0.5 * xf * y * y)
    return y


def curry_sqrt(x, rounds: int = 3):
    return x * curry_rsqrt(x, rounds)


def curry_softmax(x, axis: int = -1, rounds: int = 8):
    """Softmax whose exp is the Curry iteration — fidelity comparison
    object for benchmarks/fig22."""
    m = x.amax(dim=axis, keepdim=True).detach()
    e = curry_exp(x - m, rounds)
    return e / e.sum(dim=axis, keepdim=True)


def curry_silu(x, rounds: int = 8):
    e = curry_exp(-torch.abs(x.float()), rounds)
    sig = torch.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
    return x * sig


def curry_rmsnorm(x, w, eps: float = 1e-5, rounds: int = 3):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * curry_rsqrt(var + eps, rounds) * w.float()).to(x.dtype)
