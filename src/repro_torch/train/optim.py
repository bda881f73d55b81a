"""AdamW + global-norm clipping + cosine schedule, as plain functions over
the parameter tree (port of the JAX package's ``train/optim.py``).

Moments are f32 whatever the parameters' dtype; the update is computed in
f32 and cast back, with ``delta = m^/(sqrt(v^) + eps) + wd * p`` and bias
corrections from ``step + 1`` -- the JAX recipe, operation for operation
(``torch.optim.AdamW`` keeps bf16 moments for bf16 parameters and decays
differently).  Where JAX returns new arrays, :func:`adamw_update` updates
the parameter and moment tensors in place and returns them: at full width
a second copy of the f32 moments would not fit beside the first.  It clips
and updates one leaf at a time, so the only f32 temporaries are one leaf's.
The step count is a CPU int32 scalar tensor; the schedule and the bias
corrections are CPU f32 scalars, which combine with tensors on the card
without a synchronisation.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import tree as T


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor


def adamw_init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(m=T.map(zeros, params), v=T.map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in T.leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return T.map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(params, grads, opt: OptState, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float = 1.0):
    """One AdamW step on clipped gradients -> (params, opt, grad norm).
    ``params``, ``opt.m`` and ``opt.v`` are updated in place."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, clip_norm)
    step = opt.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for p, g, m, v in zip(T.leaves(params), T.leaves(grads), T.leaves(opt.m),
                          T.leaves(opt.v)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, OptState(opt.m, opt.v, step), gnorm


def cosine_schedule(step: torch.Tensor, *, base_lr: float, warmup: int,
                    total: int, min_ratio: float = 0.1) -> torch.Tensor:
    t = step.float()
    warm = base_lr * t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)
