"""Checkpointing: atomic, async-capable (port of the JAX package's
``checkpoint/ckpt.py``, single device).

Layout:  <dir>/step_<N>/arrays.npz + manifest.json (keys, logical dtypes,
shapes).  Writes go to a ``.tmp`` directory renamed atomically, so a crash
mid-write can never corrupt the latest checkpoint -- the fault-tolerance
contract the runtime driver relies on.  numpy has no bfloat16, so a bf16
leaf is stored as its uint16 bit pattern under its logical dtype name.

JAX arrays are immutable, so the JAX version may serialize them on a
background thread after ``save`` returns.  The port's optimizer updates
tensors in place, so ``save`` copies every leaf to host memory before it
returns (and before the writer thread starts); the caller may then keep
training.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as T


def _to_host(t) -> tuple:
    """A private host copy of a leaf as a storable numpy array, plus its
    logical dtype name."""
    t = torch.as_tensor(t).detach()
    host = t.to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = host.numpy()
    return arr, arr.dtype.name


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True
         ) -> Optional[threading.Thread]:
    """Write the checkpoint for ``step``.  Every leaf is copied to host
    memory before this returns; with ``blocking=False`` the file writes
    happen on a background thread (async checkpointing)."""
    host, logical_dtypes = {}, {}
    for k, v in T.leaves_with_paths(tree):
        host[k], logical_dtypes[k] = _to_host(v)

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(v.shape), "dtype": logical_dtypes[k]}
                     for k, v in host.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target_tree, *, shardings=None):
    """Restore into the structure of ``target_tree`` (keys, shapes and
    dtypes validated; a target may be a tree of meta tensors).  Each leaf
    lands on its target leaf's device, or, where ``shardings`` (a tree of
    ``core.mapping.NamedSharding`` over the target's keys; leaves may be
    missing or None) gives it one, on that sharding's device once its shape
    divides: the elastic / other-mesh path."""
    base = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(base, "arrays.npz")) as z:
        data = {k: _from_storable(z[k], manifest["keys"][k]["dtype"])
                for k in z.files}
    flat_target = T.leaves_with_paths(target_tree)
    keys = {k for k, _ in flat_target}
    missing, extra = keys - set(data), set(data) - keys
    if missing or extra:
        raise ValueError(f"checkpoint/target mismatch: missing={sorted(missing)[:3]} "
                         f"extra={sorted(extra)[:3]}")
    flat_shard = (dict(T.leaves_with_paths(shardings)) if shardings is not None
                  else {})
    out = []
    for key, leaf in flat_target:
        arr = data[key]
        leaf = torch.as_tensor(leaf)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != {tuple(leaf.shape)}")
        if arr.dtype != leaf.dtype:
            raise ValueError(f"{key}: dtype {arr.dtype} != {leaf.dtype}")
        sharding = flat_shard.get(key)
        out.append(arr.to(leaf.device) if sharding is None else sharding.put(arr))
    return T.unflatten(target_tree, out)


class CheckpointManager:
    """save-every / keep-last-k / async -- the driver-facing API."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3, async_save: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, step: int, tree):
        self.wait()
        self._pending = save(self.dir, step, tree,
                             blocking=not self.async_save)
        self._gc(pending_step=step)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def latest(self) -> Optional[int]:
        return latest_step(self.dir)

    def restore(self, target_tree, *, step: Optional[int] = None):
        step = step if step is not None else self.latest()
        if step is None:
            return None, None
        return step, restore(self.dir, step, target_tree)

    def _gc(self, pending_step: Optional[int] = None):
        steps = sorted({int(m.group(1)) for d in os.listdir(self.dir)
                        if (m := re.fullmatch(r"step_(\d+)", d))}
                       | ({pending_step} if pending_step is not None else set()))
        doomed = steps[:-self.keep] if self.keep else []
        for s in doomed:
            if s == pending_step:
                continue
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)
