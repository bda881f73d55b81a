"""The training step: loss, microbatch accumulation, state plumbing
(port of the JAX package's ``train/step.py``, single device).

Cross-entropy takes a max-subtracted logsumexp in f32 and picks the gold
logit by comparing a vocabulary index with the label, as the JAX version
does.  The gradient is ``torch.autograd.grad`` of the loss with respect to
detached copies of the parameter leaves (the state's tensors themselves
never require grad); the optimizer then updates them in place.
``cross_entropy_noc`` is the loss over logits split into the shard views of
a mesh (``launch/mesh.py``), the batch over its data axes and the
vocabulary over its model axis, with the logsumexp's statistics on the NoC
butterfly (a ``shard_map`` in JAX).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core import noc
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import model as M
from repro_torch.train import optim


class TrainState(NamedTuple):
    params: dict
    opt: optim.OptState


def init_state(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
               device="cuda") -> TrainState:
    params = M.init_params(cfg, seed=seed, device=device, dtype=dtype)
    return TrainState(params, optim.adamw_init(params))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, S, V] (any dtype), labels [B, S] -> scalar mean nll."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    vocab = torch.arange(lf.shape[-1], device=lf.device, dtype=torch.int32)
    eq = vocab == labels[..., None].to(torch.int32)
    gold = torch.sum(torch.where(eq, lf, 0.0), dim=-1)
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def cross_entropy_noc(logits: torch.Tensor, labels: torch.Tensor, mesh,
                      dp_axes, tp_axis: str, *,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy over vocab-sharded logits with the NoC butterfly
    logsumexp (``core/noc.py:distributed_logsumexp``): the paper's
    distributed softmax applied to the LM loss, equal to ``cross_entropy``.

    logits [B, S, V] split as the reference's ``P(dp, None, tp)``: the batch
    over the ``dp_axes`` the mesh has, V over ``tp_axis``, each shard a view;
    labels (and mask) [B, S] over dp.  Each shard picks its gold logit by
    comparing its vocabulary slice's index plus its offset with the label;
    the gold logits add up over the tp shards and the numerators (and the
    mask's sums) over the dp shards, both on the butterfly.  Unmasked, the
    sum divides by the global B * S.  Autograd runs through the views."""
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in dp_axes if a in sizes)
    n_dp, n_tp = math.prod(sizes[a] for a in dp), sizes[tp_axis]
    b, s, v = logits.shape
    if b % n_dp or v % n_tp:
        raise ValueError(f"logits {tuple(logits.shape)} do not split over dp "
                         f"{dp} ({n_dp}) and tp {tp_axis!r} ({n_tp})")
    b_loc, v_loc = b // n_dp, v // n_tp
    iota = torch.arange(v_loc, device=logits.device, dtype=torch.int32)
    nums, dens = [], []
    for d in range(n_dp):
        rows = slice(d * b_loc, (d + 1) * b_loc)
        lf = [logits[rows, :, t * v_loc:(t + 1) * v_loc].float() for t in range(n_tp)]
        lb = labels[rows].to(torch.int32)[..., None]
        lse = noc.distributed_logsumexp(lf)                    # [B_loc, S] a shard
        gold = noc.butterfly_all_reduce(
            [torch.sum(torch.where(iota + t * v_loc == lb, x, 0.0), dim=-1)
             for t, x in enumerate(lf)], "add")
        nll = lse[0] - gold[0]          # every tp shard holds the same values
        if mask is not None:
            mk = mask[rows]
            nums.append(torch.sum(nll * mk))
            dens.append(torch.sum(mk))
        else:
            nums.append(torch.sum(nll))
    num = noc.butterfly_all_reduce(nums, "add")[0]
    if mask is not None:
        return num / torch.clamp(noc.butterfly_all_reduce(dens, "add")[0], min=1.0)
    return num / max(float(b * s), 1.0)


def make_loss_fn(cfg: ModelConfig, *, lb_coef: float = 0.01,
                 z_coef: float = 1e-3, attn_window: Optional[int] = None,
                 remat: bool = True):
    def loss_fn(params, batch):
        kwargs = {}
        if "embeds" in batch:
            kwargs["embeds"] = batch["embeds"]
        else:
            kwargs["tokens"] = batch["tokens"]
        logits, aux = M.forward(cfg, params, train=True, remat=remat,
                                attn_window=attn_window, **kwargs)
        nll = cross_entropy(logits, batch["labels"],
                            mask=batch.get("loss_mask"))
        loss = nll
        if cfg.family == "moe":
            loss = loss + lb_coef * aux[0] + z_coef * aux[1]
        return loss, {"nll": nll, "lb": aux[0], "z": aux[1]}

    return loss_fn


def value_and_grad(loss_fn):
    """(params, batch) -> ((loss, metrics), grads): the counterpart of
    ``jax.value_and_grad(loss_fn, has_aux=True)``, grads in the params'
    structure and dtype; loss and metrics come back detached."""
    def fn(params, batch):
        live = [p.detach().requires_grad_() for p in T.leaves(params)]
        loss, metrics = loss_fn(T.unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                T.unflatten(params, list(grads)))
    return fn


def make_train_step(cfg: ModelConfig, *, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1, clip_norm: float = 1.0,
                    microbatch: Optional[int] = None,
                    attn_window: Optional[int] = None,
                    remat: bool = True):
    """Returns train_step(state, batch) -> (state, metrics); the state's
    tensors are updated in place.

    ``microbatch``: split the batch into this many sequential chunks with
    gradient accumulation in f32 -- the activation-memory lever for the
    biggest shapes.  Each chunk is its own forward, so an MoE layer routes
    each chunk as one dispatch, its GShard capacity from that chunk's rows,
    as in JAX's scan over microbatches."""
    grad_fn = value_and_grad(make_loss_fn(cfg, attn_window=attn_window,
                                          remat=remat))

    def compute_grads(params, batch):
        if not microbatch or microbatch <= 1:
            return grad_fn(params, batch)
        b = batch["labels"].shape[0]
        assert b % microbatch == 0, (b, microbatch)
        lsum, gsum = 0.0, None
        metr = {"nll": 0.0, "lb": 0.0, "z": 0.0}
        for i in range(microbatch):
            mb = {k: v.reshape((microbatch, b // microbatch) + v.shape[1:])[i]
                  for k, v in batch.items()}
            (l, met), g = grad_fn(params, mb)
            gsum = T.map(lambda bb: bb.float(), g) if gsum is None else \
                T.map(lambda a, bb: a + bb.float(), gsum, g)
            metr = {k: metr[k] + met[k] for k in metr}
            lsum = lsum + l
        inv = 1.0 / microbatch
        return ((lsum * inv, {k: v * inv for k, v in metr.items()}),
                T.map(lambda g: g * inv, gsum))

    def train_step(state: TrainState, batch):
        (loss, metrics), grads = compute_grads(state.params, batch)
        # schedule at step+1: at raw step 0 the warmup gives lr = 0 and a
        # silent no-op first update
        lr = optim.cosine_schedule(state.opt.step + 1, base_lr=base_lr,
                                   warmup=warmup, total=total_steps)
        params, opt, gnorm = optim.adamw_update(
            state.params, grads, state.opt, lr=lr,
            weight_decay=weight_decay, clip_norm=clip_norm)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return TrainState(params, opt), metrics

    return train_step
