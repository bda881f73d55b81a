"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper); the objects are linked into one shared
library with a plain C interface, loaded with :mod:`ctypes`.  No source
includes PyTorch's headers, so a build takes seconds, not minutes.

The build runs at first use (the first kernel launch, or :func:`load`) into
``build/repro_torch_kernels/`` at the repository root, a directory git
ignores.  The library's file name carries a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused.  Nothing here runs
at import: the CPU tests import every module of the port, and this sandbox
has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
GENCODE = "-gencode=arch=compute_90a,code=sm_90a"
BUILD_TIMEOUT_S = 900
NVCC_FLAGS = (GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# element-type codes of csrc/common.cuh (repro::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# argtypes of every C entry point: each pointer and the stream is c_void_p
# (ctypes would otherwise pass a Python int as a 32-bit int and cut it)
_SIGNATURES = {
    "repro_rmsnorm": (_I, _P, _P, _P, _I64, _I, _F, _I, _I, _I, _I, _I, _P),
    "repro_rope": (_I, *(_P,) * 5, _I64, _I, _I, _I, _F, *(_I,) * 7, _P),
    "repro_silu_mul": (_I, _P, _P, _P, _I64, _I, _I, _I, _I, _P),
    "repro_paged_attention": (_I, *(_P,) * 6, _I, _I, _I, _I, *(_P,) * 4, _I, _I,
                              _I, _I, _I64, _I64, _I, _I, _I, _I, _P),
    "repro_paged_decode": (_I, _I, *(_P,) * 7, _I, _I, *(_P,) * 4, _I, _I, _I,
                           _I64, _I64, _I, _I, _I, _I, _I, _I, _P),
    "repro_rmsnorm_bwd": (_I, *(_P,) * 6, _I64, _I, _F, *(_I,) * 5, _P),
    "repro_silu_mul_bwd": (_I, _P, _P, _P, _P, _P, _I64, _I, _P),
    "repro_flash_fwd": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I, _P),
    "repro_decode_attention": (_I, _I, _P, _P, _P, _P, _I, *(_P,) * 4,
                               *(_I,) * 8, _P),
    "repro_flash_bwd": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P),
    "repro_rwkv6_fwd": (_I, *(_P,) * 10, _I, _I, _I, _I, _P),
    "repro_rwkv6_bwd": (_I, *(_P,) * 15, _I, _I, _I, _I, _P),
    "repro_mamba2_fwd": (_I, *(_P,) * 10, _I, _I, _I, _I, _I, _P),
    "repro_mamba2_bwd": (_I, *(_P,) * 17, *(_I,) * 7, _P),
    "repro_mamba2_bwd_occupancy": (_I, _I, _P),
    "repro_matmul": (_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None
# what the last build did: seconds, whether it was reused, the ptxas report
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the repro_torch CUDA kernels are built with the CUDA "
        "toolkit on the machine that has the GPU")


def _source_key(files: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources: List[Path], key: str) -> tuple:
    """Compile every source concurrently; returns (objects, ptxas report)."""
    procs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}-{key}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, logs, failed = [], [], []
    try:
        outs = [proc.communicate(timeout=BUILD_TIMEOUT_S)[0]
                for _, _, proc in procs]
    finally:
        for _, _, proc in procs:      # on a timeout, stop every compiler
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for (src, obj, proc), out in zip(procs, outs):
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
        objs.append(obj)
    report = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{report}")
    return objs, report


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    key = _source_key(sources + sorted(CSRC.glob("*.cuh")))
    lib_path = BUILD_DIR / f"librepro_torch_kernels-{key}.so"
    t0 = time.perf_counter()
    report = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        objs, report = _compile(nvcc, sources, key)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, GENCODE, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=BUILD_TIMEOUT_S)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, reused=not report,
                      path=str(lib_path), ptxas=report)
    _lib = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch)."""
    if code:
        msg = load().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"unsupported dtype {t.dtype}; the kernels take "
                        f"{list(DTYPE_CODES)}")
    return code


def require_cuda(name: str, views=(), **tensors) -> None:
    """The checks every wrapper makes before it hands pointers to a kernel:
    each tensor lies on the same CUDA device and is contiguous.  A tensor
    named in ``views`` (a shard's slice of a page pool, which the kernel
    reads through its leading stride) need only be dense past its leading
    dim."""
    devices = {t.device for t in tensors.values()}
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}; the kernel "
                             f"takes CUDA tensors (CPU tensors go to the plain "
                             f"version through repro_torch.kernels.ops)")
        if arg in views:
            if t.shape[0] and not t[0].is_contiguous():
                raise ValueError(f"{name}: {arg} must be dense past its "
                                 f"leading dim")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")


def stream_ptr(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


_n_sms: Dict[torch.device, int] = {}   # streaming multiprocessors of each card


def n_sms(device: torch.device) -> int:
    """Streaming multiprocessors of a card (the launch plans' input)."""
    if device not in _n_sms:
        _n_sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _n_sms[device]


STRIDE_BLOCKS_PER_SM = 32   # blocks an SM of a grid-stride loop: 4 waves of 256 threads


def stride_grid(n: int, threads: int, sms: int) -> int:
    """Blocks of a grid-stride loop over ``n`` items, ``threads`` a block,
    on a card of ``sms`` SMs: as many as the items need, at most
    ``STRIDE_BLOCKS_PER_SM`` an SM (the silu_mul backward, the Mamba2
    backward's last pass)."""
    return max(1, min(-(-n // threads), sms * STRIDE_BLOCKS_PER_SM))
