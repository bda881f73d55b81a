"""Mamba2 SSD chunked scan — hand-written CUDA kernels for Hopper
(``csrc/mamba2.cu``): the forward and its deterministic backward.

Replaces the TPU kernel ``src/repro/kernels/mamba_chunk.py``
(``mamba2_chunked``, its body ``_kernel``, ``pallas_call`` at :86).  x
``[B, S, H, P]``, dt ``[B, S, H]`` and B, C ``[B, S, N]`` are read in their
layouts (no host-side transpose or padding: the ragged last chunk is masked
in the kernel), and every decay exponent is <= 0.  For training the forward
also writes the state at each chunk's entry, ``[B, H, ceil(S/64), P, N]``
f32 (235 MB a layer at zamba2-7b's full width and 2 x 4096 tokens), which
the backward reads instead of recomputing.

bf16 runs on the tensor cores (``mma.sync``), bound by bytes: C B^T once
per (batch, chunk) in a pre-pass, shared by the heads; a forward that walks
the chunks per (batch, head) with the state in registers (warp w its rows
16 w..) and the next chunk prefetched by ``cp.async``; a backward that
walks dS in reverse per (batch, head) into scratch, then computes every
gradient of a chunk locally, one block per (batch, chunk, group of heads)
(:func:`bwd_plan`, on the card's resident slots), summing dB and dC over
the group's heads in registers. The f32 operand of each product (the
decays, dt, the state) enters as a bf16 hi + lo pair beside an exact bf16
one. f32 (the fp32 parity runs) keeps the CUDA-core kernels: one block per
(batch, head), C B^T per head. No atomics: every sum runs in a fixed order,
so two runs give the same bits. ``launches`` and ``bwd_launches`` count
calls of the wrappers; a bf16 call launches 2 CUDA kernels forward and 4
backward, an f32 call 1 and 2.

The forward also starts from a state ``h0`` the caller carries in
(recurrent serving: a slot's SSM state between prefill chunks), where the
JAX package runs its plain chunked scan on the TPU too
(``src/repro/kernels/ops.py:259-263``): on the bf16 route each state-owning
warp loads its rows of h0 into registers and the shared hi + lo pair that
chunk 0's C h^T reads; the f32 kernel loads h0 into the block's state.
Every output, every chunk-entry state and h_final follow.  ``h0_launches``
counts the forwards that took one; a forward without ``h0`` is the
zero-state kernel, bit for bit.

The plain versions are ``kernels/ref.py:mamba2_scan`` and ``mamba2_bwd``;
``kernels/ops.py`` sends CPU tensors there.  These wrappers take CUDA
tensors only; bf16 tensors must start on a 16-byte boundary.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0         # forward kernel launches through this module
states_launches = 0  # those of them that also wrote the chunk-entry states
bwd_launches = 0     # backward launches (one per mamba2_bwd call)
h0_launches = 0      # forwards from a carried initial state h0

SHAPES = ((64, 64), (16, 8))   # (head dim P, state N) the kernel is built for
CHUNK = 64                     # rows per chunk (kChunk of csrc/mamba2.cu)
SUM_THREADS = 256              # threads of a block of the backward's last pass (kThreads)
PLAN_SLACK = 0.05              # bwd_plan: a score this far below the best still counts


def n_chunks(s: int) -> int:
    return -(-s // CHUNK)


_bwd_slots = {}   # (device, P, N) -> blocks of the bf16 gradient kernel resident at once


def bwd_slots(device: torch.device, p: int, n: int) -> int:
    """Blocks of the bf16 gradient kernel that ``device`` holds at once:
    its SMs times the blocks an SM holds, which CUDA's occupancy calculator
    reads off the kernel's registers and shared memory."""
    key = (device, p, n)
    if key not in _bwd_slots:
        per_sm = ctypes.c_int(0)
        _build.check("mamba2_bwd", _build.load().repro_mamba2_bwd_occupancy(
            p, n, ctypes.addressof(per_sm)))
        _bwd_slots[key] = _build.n_sms(device) * per_sm.value
    return _bwd_slots[key]


def bwd_plan(b: int, s: int, h: int, slots: int) -> int:
    """Heads a block of the bf16 gradient kernel covers, G.  Its grid is B *
    NC * ceil(H / G) blocks, ``slots`` of them resident at once
    (:func:`bwd_slots`).  A grid's score is the share of its last wave's
    slots that hold a block times the share of its last group's G heads
    that exist.  The plan takes the fewest groups that score within
    PLAN_SLACK of the best: fewer groups mean fewer dB / dC partials ([B,
    S, ceil(H / G), N] f32) and fewer stagings of B, C and C B^T; more
    groups fill a short grid."""
    base = b * n_chunks(s)

    def score(g):
        ng = -(-h // g)
        blocks = base * ng
        return blocks / (-(-blocks // slots) * slots) * h / (ng * g)

    # for each group count the smallest G that makes it (the fullest groups)
    sizes = [-(-h // ng) for ng in range(1, h + 1)]
    best = max(map(score, sizes))
    return next(g for g in sizes if score(g) >= (1 - PLAN_SLACK) * best)


def _check(name: str, x, dt, A, B, C):
    if x.dim() != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be [B, S, H, P]")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n) \
            or C.shape != B.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} must be [B,S,H,P], [B,S,H], [H], "
                         f"[B,S,N] x2")
    if (p, n) not in SHAPES:
        raise ValueError(f"{name}: (head dim, state) ({p}, {n}) not in {SHAPES}")
    if not (x.dtype == B.dtype == C.dtype):
        raise ValueError(f"{name}: x, B, C dtypes {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"{name}: dt and A must be float32, got {dt.dtype}, "
                         f"{A.dtype}")
    return b, s, h, p, n


def _aligned(name: str, **tensors):
    """bf16 tiles are copied 16 bytes at a time (cp.async)."""
    for arg, t in tensors.items():
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte boundary")


def mamba2_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, *, h0=None,
               save_states: bool = False):
    """x [B, S, H, P]; dt [B, S, H] f32; A [H] f32; B, C [B, S, N]; h0 [B, H,
    P, N] f32 (contiguous, 16-byte aligned) or None (zeros) -> (y like x,
    h_final [B, H, P, N] f32, chunk-entry states [B, H, NC, P, N] f32 or
    None)."""
    global launches, states_launches, h0_launches
    b, s, h, p, n = _check("mamba2", x, dt, A, B, C)
    extra = {}
    if h0 is not None:
        if h0.shape != (b, h, p, n) or h0.dtype != torch.float32 \
                or not h0.is_contiguous() or h0.data_ptr() % 16:
            raise ValueError(f"mamba2: h0 must be a contiguous [{b}, {h}, {p}, "
                             f"{n}] float32 on a 16-byte boundary, got "
                             f"{tuple(h0.shape)} {h0.dtype}")
        extra["h0"] = h0
    _build.require_cuda("mamba2", x=x, dt=dt, A=A, B=B, C=C, **extra)
    _aligned("mamba2", x=x, B=B, C=C)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    hf = torch.empty((b, h, p, n), **f32)
    states = (torch.empty((b, h, n_chunks(s), p, n), **f32) if save_states
              else None)
    cb = (torch.empty((b, n_chunks(s), CHUNK, CHUNK), **f32)
          if x.dtype == torch.bfloat16 else None)
    lib = _build.load()
    code = lib.repro_mamba2_fwd(_build.dtype_code(x), x.data_ptr(), dt.data_ptr(),
                                A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                h0.data_ptr() if h0 is not None else None,
                                y.data_ptr(), hf.data_ptr(),
                                states.data_ptr() if save_states else None,
                                cb.data_ptr() if cb is not None else None,
                                b, s, h, p, n, _build.stream_ptr(x))
    launches += 1
    states_launches += save_states
    h0_launches += h0 is not None
    _build.check("mamba2", code)
    return y, hf, states


def mamba2_bwd(x, dt, A, B, C, dy, states):
    """Gradients (dx, ddt, dA, dB, dC) of :func:`mamba2_fwd`'s ``y`` for the
    output gradient ``dy`` (h_final's gradient taken as zero), from the
    chunk-entry ``states`` that the forward wrote."""
    global bwd_launches
    b, s, h, p, n = _check("mamba2_bwd", x, dt, A, B, C)
    nc = n_chunks(s)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"mamba2_bwd: dy {tuple(dy.shape)} {dy.dtype} must be "
                         f"like x")
    if states is None or states.shape != (b, h, nc, p, n) \
            or states.dtype != torch.float32:
        raise ValueError("mamba2_bwd: states must be the forward's chunk-entry "
                         f"states [{b}, {h}, {nc}, {p}, {n}] float32")
    _build.require_cuda("mamba2_bwd", x=x, dt=dt, A=A, B=B, C=C, dy=dy,
                        states=states)
    _aligned("mamba2_bwd", x=x, B=B, C=C, dy=dy)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty((h,), **f32)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    if x.dtype == torch.bfloat16:
        g = bwd_plan(b, s, h, bwd_slots(x.device, p, n))
        ng, n_part = -(-h // g), b * nc
        cb = torch.empty((b, nc, CHUNK, CHUNK), **f32)
        dstates = torch.empty_like(states)
    else:
        g, ng, n_part, cb, dstates = 1, h, b, None, None
    dB_part = torch.empty((b, s, ng, n), **f32)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty((n_part, h), **f32)
    lib = _build.load()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    code = lib.repro_mamba2_bwd(_build.dtype_code(x), x.data_ptr(), dt.data_ptr(),
                                A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                dy.data_ptr(), states.data_ptr(), dx.data_ptr(),
                                ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                                dC.data_ptr(), dB_part.data_ptr(),
                                dC_part.data_ptr(), dA_part.data_ptr(), ptr(cb),
                                ptr(dstates), g, b, s, h, p, n,
                                _build.stride_grid(max(b * s * n, h), SUM_THREADS,
                                                   _build.n_sms(x.device)),
                                _build.stream_ptr(x))
    bwd_launches += 1
    _build.check("mamba2_bwd", code)
    return dx, ddt, dA, dB, dC
