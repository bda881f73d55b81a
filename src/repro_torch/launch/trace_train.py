"""Where the device time goes in a full-width training step of the port.

  PYTHONPATH=src python -m repro_torch.launch.trace_train [--arch rwkv6-3b]

Trains ``--arch`` (granite-3-2b by default, rwkv6-3b, or zamba2-7b) at full
width and depth (zamba2-7b at ``ONE_CARD_LAYERS``'s depth; random bf16
weights from ``--seed``) on ``--batch`` x ``--seq-len``
tokens per step through ``train/step.py:make_train_step`` with remat, the
step ``chip_smoke.py``'s train phases drive: one step untimed to warm up,
``--steps`` untraced steps for the wall clock, one step under
``torch.profiler``.  Prints the device kernel time of the traced step by
kernel and by group (the flash-attention, wkv6 and Mamba2-scan forward and
backward kernels each in a group of their own, the port's other CUDA
kernels, GEMMs, other PyTorch ops) and the device busy share: summed kernel time over the
mean untraced step (one stream, so kernels do not overlap).  The summary
also lands in ``chiprun_out/trace_train[_<arch>].json``.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import for_cell
from repro_torch.train import step as TS

# Training depth on one 80 GB card where the full depth does not fit: at 81
# layers zamba2-7b has 6.75 B parameters, ~81 GB of bf16 weights and
# gradients with f32 AdamW moments.  33 layers are 5 groups of 6 Mamba2
# layers, the full config's 3-layer tail and 5 applications of the shared
# block (3.01 B parameters), at full width.
ONE_CARD_LAYERS = {"zamba2-7b": 33}


def one_card_config(arch: str):
    """``arch``'s config at the depth one card trains (only the layer count
    is cut, and only where ``ONE_CARD_LAYERS`` names the arch)."""
    cfg = get_config(arch)
    layers = ONE_CARD_LAYERS.get(cfg.name)
    return cfg.replace(n_layers=layers) if layers else cfg


# kernel-name fragments of the port's CUDA kernels (csrc/*.cu), by group;
# the flash fragments take both forms (flash_fwd_kernel in f32,
# flash_fwd_bf16_kernel on the tensor cores; flash_bwd_delta / dkdv / dq),
# and so do the Mamba2 ones (f32: mamba2_fwd_kernel, mamba2_bwd_kernel; bf16:
# the C B^T pre-pass mamba2_fwd_cb / mamba2_bwd_cb, the walks
# mamba2_fwd_tc and mamba2_bwd_walk, the chunk-parallel mamba2_bwd_tc; both:
# the sums mamba2_bwd_sum), and so do the wkv6 ones (f32: rwkv6_fwd_kernel,
# rwkv6_bwd_kernel; bf16: the increments rwkv6_fwd_inc / rwkv6_bwd_inc, the
# scans rwkv6_fwd_scan / rwkv6_bwd_scan, the chunk-parallel rwkv6_fwd_out
# and rwkv6_bwd_grad; both: the du sum rwkv6_bwd_du)
GROUPS = (("flash attention forward", ("flash_fwd_",)),
          ("flash attention backward", ("flash_bwd_",)),
          ("wkv6 forward", ("rwkv6_fwd_",)),
          ("wkv6 backward", ("rwkv6_bwd_",)),
          ("Mamba2 scan forward", ("mamba2_fwd_",)),
          ("Mamba2 scan backward", ("mamba2_bwd_",)),
          ("port CUDA kernels, other", ("rmsnorm_", "rope_kernel", "silu_mul_",
                                        "paged_attention_kernel",
                                        "paged_prefill_tc_kernel")))
GEMM_MARKS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")
TOP = 15                       # kernels listed by device time


def _group(name: str) -> str:
    for group, marks in GROUPS:
        if any(m in name for m in marks):
            return group
    if any(m in name.lower() for m in GEMM_MARKS):
        return "GEMM (torch.matmul)"
    return "other PyTorch ops"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2,
                    help="untraced steps timed for the wall clock")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="default chiprun_out/trace_train.json for granite-3-2b, "
                         "chiprun_out/trace_train_<arch>.json otherwise")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = one_card_config(args.arch)
    state = TS.init_state(cfg, seed=args.seed, dtype=torch.bfloat16, device="cuda")
    ds = for_cell(cfg, ShapeSpec("trace", args.seq_len, args.batch, "train"))
    n = args.steps + 2
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in ds.batch(i).items()}
               for i in range(n)]
    step = TS.make_train_step(cfg, base_lr=3e-4, warmup=1, total_steps=n)

    state, _ = step(state, batches[0])              # warm-up
    torch.cuda.synchronize()
    walls = []
    for i in range(1, n - 1):
        t0 = time.perf_counter()
        state, _ = step(state, batches[i])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sum(walls) / len(walls)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batches[n - 1])
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0

    per_kernel = defaultdict(lambda: [0.0, 0])      # name -> [us, calls]
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name][0] += ev.time_range.elapsed_us()
            per_kernel[ev.name][1] += 1
    groups = defaultdict(lambda: [0.0, 0])
    for name, (us, calls) in per_kernel.items():
        groups[_group(name)][0] += us
        groups[_group(name)][1] += calls
    device_s = sum(us for us, _ in groups.values()) / 1e6
    card = torch.cuda.get_device_name(0)
    tokens = args.batch * args.seq_len
    print(f"[trace] {card}; {cfg.name} ({cfg.n_layers} layers) {args.batch} x "
          f"{args.seq_len} tokens "
          f"per step, remat; untraced steps {[round(w, 4) for w in walls]} s "
          f"(mean {wall:.4f} s, {tokens / wall:.1f} tokens/s), traced step "
          f"{traced_wall:.4f} s; device kernel time {device_s:.4f} s; busy "
          f"share {device_s / wall:.3f} of the untraced step")
    for g, (us, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[trace] group {g}: {us / 1e3:.1f} ms in {calls} launches "
              f"({us / 1e6 / device_s:.3f} of device time, "
              f"{us / 1e6 / wall:.3f} of the untraced step)")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]
    for name, (us, calls) in top:
        print(f"[trace] {us / 1e3:9.2f} ms {calls:7d} x  {name[:110]}")
    out = Path(args.out or ("chiprun_out/trace_train.json"
                            if args.arch == "granite-3-2b" else
                            f"chiprun_out/trace_train_{args.arch}.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(
        card=card, arch=cfg.name, n_layers=cfg.n_layers, batch=args.batch, seq_len=args.seq_len,
        step_s=walls, mean_step_s=wall, traced_step_s=traced_wall,
        device_s=device_s, busy_share=device_s / wall,
        groups={g: dict(ms=us / 1e3, launches=c) for g, (us, c) in groups.items()},
        top=[dict(name=k, ms=us / 1e3, calls=c) for k, (us, c) in top]), indent=1))


if __name__ == "__main__":
    main()
