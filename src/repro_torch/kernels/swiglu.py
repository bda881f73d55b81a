"""Fused SwiGLU gating and its backward — hand-written CUDA kernels for
Hopper (``csrc/swiglu.cu``).

Replaces the TPU kernel ``src/repro/kernels/swiglu.py`` (``silu_mul``,
``pallas_call`` at :59).  On the H100 it is bound by bytes: two reads and one
write per element; fusing keeps ``silu(gate)`` out of device memory.  The
kernel streams 16-byte vectors (8 bf16 or 4 f32): each thread loads a
vector of gate and one of up a step, both before its math, and stores a
vector; the n mod 8 (or 4) elements past the last vector go one a thread in
the same launch.  :func:`plan` sizes the launch from the element count and
the card: a call that fits one wave of the card's threads (decode) goes one
element a thread (the element route), so its math spreads over all the
threads it can; larger ones take the vector route, the grid at most
``WAVES`` waves of the card's resident threads, walked with a stride of the
whole grid.  A base off a 16-byte boundary takes the scalar route, the
element route's walk (chosen by the plan, counted in
``launches_by_route``).  The kernel rounds ``silu(gate)`` to the element
type before the multiply, as the plain version does; the TPU kernel keeps
it in f32, one bf16 rounding away.  The TPU kernel's ``curry_rounds`` form
(the paper's Curry-ALU sigmoid: exp by a range-reduced Taylor series and
four squarings) is the same kernel with a runtime round count, forward
only; it keeps ``g * sigma(g) * u`` in f32 with one rounding, as the TPU
kernel does.  It has no caller on a model path and its launches are
counted apart (``curry_launches``).

The backward (no TPU kernel: the JAX package differentiates its oracle) is
one elementwise pass, bound by bytes (three reads, two writes); it rounds
where the forward rounds; its grid-stride loop's grid comes from the card
(``_build.stride_grid``).

The plain versions are ``kernels/ref.py:silu_mul`` and ``silu_mul_bwd``;
``kernels/ops.py`` sends CPU tensors there.  These wrappers take CUDA
tensors only.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0       # forward kernel launches through this module
curry_launches = 0  # launches of the curry_rounds form
bwd_launches = 0   # backward kernel launches
launches_by_route = {"vector": 0, "element": 0, "scalar": 0}   # every forward launch

VEC_BYTES = 16          # one access a thread: 8 bf16 or 4 f32
BLOCKS = (256, 128, 64)  # threads of a block, largest first (csrc kMaxThreads 256)
THREADS_PER_SM = 2048   # resident threads an SM holds: one wave
WAVES = 8               # waves of blocks the grid may hold before threads walk on
BWD_THREADS = 256       # threads of a backward block (csrc kBwdThreads)


class Plan(NamedTuple):
    route: str     # "vector" (16-byte accesses), "element" or "scalar" (one element a step)
    threads: int   # threads of a block
    grid: int      # blocks; thread t takes units t, t + T, ... (T = grid threads)


@functools.lru_cache(maxsize=1024)
def plan(n: int, elem_bytes: int, aligned: bool, n_sms: int) -> Plan:
    """The launch shape of :func:`silu_mul` over ``n`` elements of
    ``elem_bytes`` bytes; ``aligned``: gate, up and out start on a 16-byte
    boundary.  A call larger than one wave of the card's resident threads
    takes the vector route: a 16-byte vector of gate and of up a thread a
    step, the n mod 8 or 4 elements past the last vector one a thread after
    them.  A smaller
    one (decode's [8, 5632]) takes the element route, one element a
    thread, so its math spreads over eight times the threads (1.37 against
    1.75 us a launch with the inputs in L2, H100; ``PERF.md``); a base off
    16 bytes the scalar route, the same walk.  A block is the largest of
    ``BLOCKS`` that still leaves a block for every SM; the grid as many
    blocks as the work needs, at most ``WAVES`` waves of
    ``THREADS_PER_SM`` an SM, whose threads then walk the rest."""
    vec = VEC_BYTES // elem_bytes
    route = ("scalar" if not aligned else
             "vector" if n > n_sms * THREADS_PER_SM else "element")
    units = n // vec if route == "vector" else n   # thread-steps of the work
    threads = next((t for t in BLOCKS if -(-units // t) >= n_sms), BLOCKS[-1])
    grid = max(1, min(-(-units // threads), WAVES * n_sms * THREADS_PER_SM // threads))
    return Plan(route, threads, grid)


def silu_mul(gate: torch.Tensor, up: torch.Tensor,
             curry_rounds: int = 0) -> torch.Tensor:
    """silu(gate) * up, elementwise; gate and up of one shape and dtype;
    ``curry_rounds`` Taylor terms replace the native exp when nonzero."""
    global launches, curry_launches
    if gate.shape != up.shape or gate.dtype != up.dtype:
        raise ValueError(f"silu_mul: gate {tuple(gate.shape)} {gate.dtype} and "
                         f"up {tuple(up.shape)} {up.dtype} must match")
    _build.require_cuda("silu_mul", gate=gate, up=up)
    out = torch.empty_like(up)
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (gate, up, out))
    p = plan(up.numel(), up.element_size(), aligned, _build.n_sms(up.device))
    lib = _build.load()
    code = lib.repro_silu_mul(_build.dtype_code(up), gate.data_ptr(),
                              up.data_ptr(), out.data_ptr(), up.numel(),
                              int(curry_rounds), int(p.route == "vector"),
                              p.threads, p.grid,
                              _build.stream_ptr(up))
    if curry_rounds:
        curry_launches += 1
    else:
        launches += 1
    launches_by_route[p.route] += 1
    _build.check("silu_mul", code)
    return out


def silu_mul_bwd(gate: torch.Tensor, up: torch.Tensor, dy: torch.Tensor):
    """Gradients (dgate, dup) of :func:`silu_mul` for the output gradient."""
    global bwd_launches
    if not (gate.shape == up.shape == dy.shape) or \
            not (gate.dtype == up.dtype == dy.dtype):
        raise ValueError(f"silu_mul_bwd: gate {tuple(gate.shape)} {gate.dtype}, "
                         f"up {tuple(up.shape)} {up.dtype}, dy "
                         f"{tuple(dy.shape)} {dy.dtype} must match")
    _build.require_cuda("silu_mul_bwd", gate=gate, up=up, dy=dy)
    dgate = torch.empty_like(gate)
    dup = torch.empty_like(up)
    lib = _build.load()
    code = lib.repro_silu_mul_bwd(_build.dtype_code(up), gate.data_ptr(),
                                  up.data_ptr(), dy.data_ptr(),
                                  dgate.data_ptr(), dup.data_ptr(), up.numel(),
                                  _build.stride_grid(up.numel(), BWD_THREADS,
                                                     _build.n_sms(up.device)),
                                  _build.stream_ptr(up))
    bwd_launches += 1
    _build.check("silu_mul_bwd", code)
    return dgate, dup
