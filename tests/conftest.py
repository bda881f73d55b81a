import os
import subprocess
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# hypothesis fallback shim: on a bare interpreter the property tests skip
# *individually* while the plain oracle tests in the same modules still run
# (a module-level importorskip would skip whole files).  Test modules keep
# ``hypothesis = pytest.importorskip("hypothesis")``, which resolves to this
# stub when the real package is absent.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    class _Strategy:
        """Chainable inert stand-in for hypothesis strategies."""

        def __getattr__(self, _name):
            return lambda *a, **k: self

    def _skip_decorator(*_a, **_k):
        return pytest.mark.skip(reason="hypothesis not installed")

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _skip_decorator
    _hyp.settings = _skip_decorator
    _hyp.assume = lambda *a, **k: True
    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda _name: (lambda *a, **k: _Strategy())
    _hyp.strategies = _st
    _hyp.__getattr__ = lambda _name: _Strategy()
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidevice: needs several jax devices (CI runs these with "
        "XLA_FLAGS=--xla_force_host_platform_device_count=8)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips "
        "without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def run_subprocess(code: str, devices: int = 8, timeout: int = 420) -> str:
    """Run a JAX snippet in a fresh process with N fake host devices
    (device count locks at first backend init, so multi-device tests
    need their own process)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=REPO)
    assert r.returncode == 0, f"STDERR:\n{r.stderr[-3000:]}\nSTDOUT:\n{r.stdout[-1000:]}"
    return r.stdout


@pytest.fixture
def subproc():
    return run_subprocess
