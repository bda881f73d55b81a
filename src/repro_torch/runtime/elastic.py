"""Elastic rescale: move a training or serving state between meshes (port
of the JAX package's ``runtime/elastic.py``).

Pattern: checkpoint (or live state) -> rebuild the mesh with the new shape
-> re-derive the sharding plan for it (``core/mapping.py``) -> place every
leaf onto its new sharding.  The data pipeline is deterministic per step,
so training resumes where it stopped at another data-parallel width (the
global batch is re-sharded, not changed).  The port's shards are views of
one device's tensors (``launch/mesh.py``), so placing a leaf checks that
its shape divides over the new mesh and moves it to the mesh's device.
"""
from __future__ import annotations

from typing import Optional

from repro_torch import tree as T
from repro_torch.checkpoint import ckpt as C
from repro_torch.launch.mesh import axis_sizes


def reshard_tree(tree, shardings):
    """Each leaf placed onto its (new-mesh) sharding."""
    return T.map(lambda x, s: s.put(x), tree, shardings)


def rescale_from_checkpoint(ckpt_dir: str, target_tree, new_shardings,
                            *, step: Optional[int] = None):
    """Restore the latest (or given) checkpoint directly onto a new mesh's
    shardings: the restart path after adding or removing pods."""
    step = step if step is not None else C.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    state = C.restore(ckpt_dir, step, target_tree, shardings=new_shardings)
    return step, state


def validate_rescale(old_mesh, new_mesh, global_batch: int) -> list:
    """Pre-flight checks the orchestrator runs before rescaling."""
    problems = []

    def dp(mesh):
        sizes = axis_sizes(mesh)
        return sizes.get("pod", 1) * sizes.get("data", 1)

    if axis_sizes(new_mesh).get("model", 1) != axis_sizes(old_mesh).get("model", 1):
        problems.append("TP degree changed: params reshard is still valid, "
                        "but kernels re-tune (allowed, slower first step)")
    if global_batch % dp(new_mesh) != 0:
        problems.append(f"global_batch={global_batch} not divisible by new "
                        f"DP={dp(new_mesh)}")
    return problems
