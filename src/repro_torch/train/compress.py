"""Int8 gradient all-reduce with error feedback, riding the NoC butterfly
(port of the JAX package's ``train/compress.py``).

A distributed-optimization trick for scale (beyond the paper, in the spirit
of CompAir's compute-during-communication): gradients are quantized to
int8 per tensor before each butterfly hop, summed in int32, and
requantized; the quantization residual is fed back into the next step's
gradient (error feedback), which keeps SGD/Adam convergent (Karimireddy et
al., 2019).  Wire bytes per hop drop 4x against f32, 2x against bf16.

The JAX package runs this inside ``shard_map`` over the data axis, one
``ppermute`` per hop and a ``pmax`` for each hop's scale.  The port takes
the S data shards' values as a list, as ``core/noc.py:butterfly_all_reduce``
does: a hop is one partner exchange in the list, and the hop's scale is the
max over every shard.  Each step is the reference's, op for op, so the
results are its bits: round half to even, clip to +-127, an int32 sum, the
mean cast back to the input dtype.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as T


def _f32(x: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d f32 tensor on ``x``'s device: dividing by it divides (a CUDA
    tensor divided by a Python scalar multiplies by its reciprocal, which
    may differ in the last bit)."""
    return torch.full((), value, dtype=torch.float32, device=x.device)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale): the scale
    floored at 1e-12 after the division by 127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax() / _f32(xf, 127.0), min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def butterfly_allreduce_int8(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce-mean of the S shards' ``values`` with int8 payloads on
    every hop: at hop ``k`` (1, 2, 4, ...) the shared scale is the max |x|
    over every shard, floored at 1e-12 before the division by 127; shard
    ``i`` adds its int8 payload to shard ``i ^ k``'s in int32 and rescales.
    Returns every shard's mean, in its input dtype.  S must be a power of
    two."""
    n = len(values)
    if n < 1 or n & (n - 1):
        raise ValueError(f"butterfly needs a power-of-two axis, got {n} shards")
    xs = [v.float() for v in values]
    k = 1
    while k < n:
        peak = torch.stack([x.abs().amax() for x in xs]).amax()
        scale = torch.clamp(peak, min=1e-12) / _f32(peak, 127.0)
        qs = [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
              for x in xs]
        xs = [(qs[i].to(torch.int32) + qs[i ^ k].to(torch.int32)).float() * scale
              for i in range(n)]
        del qs
        k *= 2
    return [(x / _f32(x, n)).to(v.dtype) for x, v in zip(xs, values)]


def compressed_grad_sync(grads: Sequence, error: Optional[Sequence] = None):
    """Error-feedback int8 all-reduce over the S shards' gradient trees.

    ``grads``: one tree per shard; ``error``: the residual trees of the
    previous step (None at step 0: zeros).  Returns (synced, new_error),
    each a list of S trees of f32 leaves.  A leaf's corrected gradient is
    ``g.float() + e``; it rides the butterfly, and its residual is what the
    shard's own per-tensor quantization (``quantize_int8``) loses of it.
    Leaves are taken one at a time, in ``repro_torch.tree`` order."""
    n = len(grads)
    cols = [T.leaves(g) for g in grads]
    errs = [T.leaves(e) for e in error] if error is not None else None
    synced = [[] for _ in range(n)]
    new_err = [[] for _ in range(n)]
    for j in range(len(cols[0])):
        corrected = [cols[s][j].float() + (errs[s][j] if errs is not None else 0.0)
                     for s in range(n)]
        for s, y in enumerate(butterfly_allreduce_int8(corrected)):
            synced[s].append(y)
        for s, c in enumerate(corrected):
            new_err[s].append(c - dequantize(*quantize_int8(c)))
        del corrected
    return ([T.unflatten(g, leaves) for g, leaves in zip(grads, synced)],
            [T.unflatten(g, leaves) for g, leaves in zip(grads, new_err)])
