"""Carry the JAX package's parameters (and optimizer state) over to the port.

The JAX model initialises its layer stack with ``jax.vmap``, so every leaf
under ``"layers"`` is stacked ``[L, ...]``; the port keeps a list of
per-layer dicts.  The input is the JAX parameter tree with numpy leaves
(``jax.tree.map(np.asarray, params)``, done by the caller: the port never
imports JAX).  Layouts are unchanged (``linear`` weights stay ``[d_in,
d_out]``), so the two models compute the same function.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.train.optim import OptState
from repro_torch.train.step import TrainState


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bf16: via f32, exact
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))    # a writable copy
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _split(stacked, n: int, device):
    """Leaves stacked ``[n, ...]`` -> a list of n trees of their slices."""
    return [_map(stacked, lambda a, i=i: _tensor(np.asarray(a)[i], device))
            for i in range(n)]


def _count(stacked) -> int:
    return len(np.asarray(stacked["ln1"]["scale"]))


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX parameter tree (numpy leaves) -> port parameters, each leaf in its
    own dtype (the RWKV6 ``u`` / ``w0`` and the Mamba2 ``A_log`` / ``D`` /
    ``dt_bias`` and the MoE router stay f32 among bf16 leaves), nested dicts
    (``tm`` / ``cm`` / ``mamba`` / ``moe``) kept as they are.  The stacked
    ``[L, ...]`` leaves of ``layers`` are split per layer (an MoE layer's
    router [L, d, E_pad] and expert banks [L, E_pad, ...] into each layer's
    [d, E_pad] and [E_pad, ...], its shared experts' FFN likewise); for the
    hybrid family the ``[G, K, ...]`` leaves of ``groups`` become G lists of
    K layers, the ``[T, ...]`` leaves of ``tail`` (None when the layer count
    divides into groups) a list of T layers, and ``shared`` stays one
    block."""
    stacks = ("layers", "groups", "tail")
    out = {k: _map(v, lambda a: _tensor(a, device))
           for k, v in tree.items() if k not in stacks}
    if "layers" in tree:
        out["layers"] = _split(tree["layers"], _count(tree["layers"]), device)
    if "groups" in tree:
        groups = tree["groups"]
        g, k = np.asarray(groups["ln1"]["scale"]).shape[:2]
        out["groups"] = [_split(_map(groups, lambda a, i=i: np.asarray(a)[i]),
                                k, device) for i in range(g)]
        tail = tree.get("tail")
        out["tail"] = [] if tail is None else _split(tail, _count(tail), device)
    return out


def state_from_jax(state, device="cpu"):
    """A JAX ``TrainState`` (numpy leaves) -> the port's
    ``repro_torch.train.step.TrainState``: parameters as in
    :func:`params_from_jax`, and the AdamW moments ``m`` / ``v``, which have
    the parameters' structure, carried the same way; the step count stays a
    CPU int32 scalar.  A JAX serving or decode state (a dict with numpy
    leaves: RWKV6's ``tm_shift`` / ``wkv`` / ``cm_shift`` and Mamba2's
    ``conv`` / ``ssm`` stacked ``[L, B, ...]``, the hybrid's ``conv_g`` /
    ``ssm_g`` ``[G, K, B, ...]`` and ``conv_t`` / ``ssm_t`` ``[max(tail, 1),
    B, ...]``, the ``attn`` pages (and int8 scales) or slabs of the dense
    family's L layers or the hybrid's G applications) -> the port's, each
    leaf in its dtype and layout (the port keeps the layer stack)."""
    if isinstance(state, dict):
        return _map(state, lambda a: _tensor(a, device))
    opt = state.opt
    return TrainState(
        params=params_from_jax(state.params, device),
        opt=OptState(m=params_from_jax(opt.m, device),
                     v=params_from_jax(opt.v, device),
                     step=torch.tensor(int(np.asarray(opt.step)),
                                       dtype=torch.int32)))
