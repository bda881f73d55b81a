"""The training step: loss, microbatch accumulation, state plumbing
(port of the JAX package's ``train/step.py``, single device).

Cross-entropy takes a max-subtracted logsumexp in f32 and picks the gold
logit by comparing a vocabulary index with the label, as the JAX version
does.  The gradient is ``torch.autograd.grad`` of the loss with respect to
detached copies of the parameter leaves (the state's tensors themselves
never require grad); the optimizer then updates them in place.  The NoC
butterfly cross-entropy (``cross_entropy_noc``, a shard_map in JAX) comes
with the sharding slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
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
