"""The port stands alone: importing every repro_torch module pulls in
neither JAX nor any module of the JAX package."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(",".join(names), bad)
"""

# modules that must be among those walked (the training, dense-slab
# serving, fidelity-kernel and architecture-layer slices included)
REQUIRED = ("repro_torch.kernels.flash_attention", "repro_torch.kernels.autograd",
            "repro_torch.kernels.decode_attention", "repro_torch.models.runner",
            "repro_torch.serve.engine", "repro_torch.launch.serve",
            "repro_torch.launch.trace_serve",
            "repro_torch.models.model", "repro_torch.train.optim",
            "repro_torch.train.step", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.ckpt", "repro_torch.runtime.driver",
            "repro_torch.runtime.straggler", "repro_torch.launch.train",
            "repro_torch.kernels.rwkv_chunk", "repro_torch.models.rwkv",
            "repro_torch.kernels.mamba_chunk", "repro_torch.models.ssm",
            "repro_torch.core", "repro_torch.core.curry",
            "repro_torch.kernels.matmul", "repro_torch.core.isa",
            "repro_torch.core.planner", "repro_torch.core.mapping",
            "repro_torch.pimsim.ops", "repro_torch.pimsim.system",
            "repro_torch.models.frontends")


def test_repro_torch_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", _CODE], capture_output=True,
                       text=True, env=env, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    names, bad = r.stdout.strip().split(" ", 1)
    names = names.split(",")
    assert bad == "[]", bad
    assert len(names) >= 30        # every package and module was walked
    assert not set(REQUIRED) - set(names), set(REQUIRED) - set(names)
