"""Device meshes of the port (the JAX package's ``launch/mesh.py``).

The JAX package lays its shards over a grid of TPU chips.  The port holds
every shard of a mesh on one device, as a view of one tensor: the expert
shards of ``models/moe.py`` and the sequence shards of the page pool are
such views.  So a ``Mesh`` is its axis names, their sizes and the one torch
device that holds every shard view.  ``devices`` is an object array of the
mesh's shape with that device in every entry: what the reference's callers
read (``mesh.devices.shape``), so the two packages' planning functions
take either package's mesh.

Constructing a mesh touches no device state.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch


class Mesh:
    """Named axes of ``shape``'s sizes over shard views on ``device``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device="cuda"):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} differ "
                             f"in length")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names {names}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axis sizes must be positive, got {shape}")
        self.axis_names = names
        self.axis_sizes = shape
        self.device = torch.device(device)

    @property
    def devices(self) -> np.ndarray:
        grid = np.empty(self.axis_sizes, dtype=object)
        grid.fill(self.device)
        return grid

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names, self.axis_sizes))
        return f"Mesh({axes}; on {self.device})"


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh of either package (or any object with
    ``axis_names`` and ``devices.shape``)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """Single pod: 16x16 = 256 chips (data, model).
    Multi-pod: 2 pods x 256 = 512 chips (pod, data, model); the pod axis
    is the DCN/ICI-superlink dimension (DP across pods by default)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device)


def make_test_mesh(n_data: int = 2, n_model: int = 2, n_pod: int = 0,
                   device="cuda") -> Mesh:
    """A small mesh: (n_pod, n_data, n_model) over ('pod', 'data', 'model'),
    or (n_data, n_model) over ('data', 'model') without pods."""
    if n_pod:
        return Mesh((n_pod, n_data, n_model), ("pod", "data", "model"), device)
    return Mesh((n_data, n_model), ("data", "model"), device)


def chips(mesh) -> int:
    """The devices a mesh spans where each shard has its own chip."""
    return math.prod(mesh.devices.shape)
