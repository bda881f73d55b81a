"""Flash attention for training — hand-written CUDA kernels for Hopper
(``csrc/flash_attention.cu``): the forward, which also writes the per-row
log-sum-exp, and its deterministic backward.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``, ``pallas_call`` at :109): causal or not, an optional
sliding ``window``, GQA by ``h // (H / KvH)``, and any sequence length (the
ragged last tile is masked in the kernel; q, k and v are read in their
``[B, S, H|KvH, D]`` layout with no host-side transpose or padding).  The
TPU kernel has no backward; the JAX package differentiates its oracle.  On
the H100 both directions are bound by operations once S is a few hundred.
bf16 inputs run on the tensor cores (``mma.sync`` m16n8k16 with f32
accumulation; K/V or Q/dO tiles streamed through ``cp.async`` rings and read
with ``ldmatrix``; softmax statistics, p and ds in f32; the forward's p
rounded to bf16 as an MMA operand, the backward's p and ds carried as bf16
hi + lo pairs, two MMAs each); f32 inputs, the fp32 parity runs, compute in
f32 on the CUDA cores (64 x 64 tiles, a 4 x 4 register tile per thread).
The backward takes no atomics (dK/dV and dQ in separate kernels, each
summing in a fixed order), so it is bitwise repeatable.  bf16 tensors must
start on a 16-byte boundary (any tensor PyTorch allocates does).

The forward also takes a per-sequence key bound ``lengths`` [B] int32, the
ragged prefill of the dense-slab serving path (keys at ``kpos >= lengths[b]``
are masked, and key tiles wholly past the bound are not read).  The JAX
package runs its plain version there even on the TPU; the bound has no
backward, since serving never differentiates it.

The plain versions are ``kernels/ref.py:flash_attention_lse`` and
``flash_attention_bwd`` (``flash_attention`` with ``lengths``);
``kernels/ops.py`` sends CPU tensors there.  These wrappers take CUDA
tensors only.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0       # forward kernel launches through this module (no lengths)
lengths_launches = 0   # forward launches with a per-sequence key bound
bwd_launches = 0   # backward launches (one per flash_attention_bwd call)

HEAD_DIMS = (16, 64, 112, 128)   # the configs' head dims (reduced: 16; zamba2-7b: 112)


def _geometry(name: str, q, k, v):
    b, sq, h, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not [B,Sq,H,D], [B,Sk,KvH,D] x2")
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"{name}: {h} query heads over {kvh} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    return b, sq, k.shape[1], h, kvh, d


def _window(window: Optional[int]) -> int:
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    return 0 if window is None else int(window)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        lengths: Optional[torch.Tensor] = None):
    """q [B, Sq, H, D]; k, v [B, Sk, KvH, D]; lengths [B] int32 or None (keys
    ``[0, lengths[b])`` visible) -> (o [B, Sq, H, D], lse [B, H, Sq] f32)."""
    global launches, lengths_launches
    b, sq, sk, h, kvh, d = _geometry("flash_attention", q, k, v)
    tensors = dict(q=q, k=k, v=v)
    if lengths is not None:
        if lengths.shape != (b,) or lengths.dtype != torch.int32:
            raise ValueError(f"flash_attention: lengths must be [{b}] int32, "
                             f"got {tuple(lengths.shape)} {lengths.dtype}")
        tensors["lengths"] = lengths
    _build.require_cuda("flash_attention", **tensors)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    code = lib.repro_flash_fwd(_build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                               v.data_ptr(),
                               None if lengths is None else lengths.data_ptr(),
                               o.data_ptr(), lse.data_ptr(), b, sq, sk, h, kvh,
                               d, int(causal), _window(window),
                               _build.stream_ptr(q))
    if lengths is None:
        launches += 1
    else:
        lengths_launches += 1
    _build.check("flash_attention", code)
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None):
    """Gradients (dq, dk, dv) of :func:`flash_attention_fwd` for the output
    gradient ``do``, given its output ``o`` and ``lse``."""
    global bwd_launches
    b, sq, sk, h, kvh, d = _geometry("flash_attention_bwd", q, k, v)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} "
                         f"and do {tuple(do.shape)} {do.dtype} must be like q")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be [{b}, {h}, {sq}] "
                         f"float32, got {tuple(lse.shape)} {lse.dtype}")
    _build.require_cuda("flash_attention_bwd", q=q, k=k, v=v, o=o, lse=lse,
                        do=do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    code = lib.repro_flash_bwd(_build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                               v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                               do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kvh,
                               d, int(causal), _window(window),
                               _build.stream_ptr(q))
    bwd_launches += 1
    _build.check("flash_attention_bwd", code)
    return dq, dk, dv
