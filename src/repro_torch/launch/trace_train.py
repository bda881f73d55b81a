"""Where the device time goes in a full-width training step of the port.

  PYTHONPATH=src python -m repro_torch.launch.trace_train [--arch rwkv6-3b]

Trains ``--arch`` (granite-3-2b by default, rwkv6-3b, zamba2-7b or
olmoe-1b-7b) at full width and depth (zamba2-7b and olmoe-1b-7b at
``ONE_CARD_LAYERS``'s depth; random bf16 weights from ``--seed``) on
``--batch`` x ``--seq-len``
tokens per step through ``train/step.py:make_train_step`` with remat, the
step ``chip_smoke.py``'s train phases drive: one step untimed to warm up,
``--steps`` untraced steps for the wall clock, one step under
``torch.profiler``.  Prints the device kernel time of the traced step by
kernel and by group (the flash-attention, wkv6 and Mamba2-scan forward and
backward kernels each in a group of their own, the port's other CUDA
kernels, GEMMs, other PyTorch ops) and the device busy share: summed kernel time over the
mean untraced step (one stream, so kernels do not overlap).  An MoE
model's dispatch is split out as ``trace_serve`` splits it: the traced
step puts each call of ``models/moe.py``'s ``route``, ``dispatch`` and
``combine`` under a profiler range ("MoE dispatch", its GEMMs included)
and of ``experts`` under another ("expert GEMMs": the routed experts'
batched GEMMs; their silu_mul stays with the port's kernels), in the
forward and in remat's recompute alike.  A backward node takes the range
of the forward op that made it (the profiler's sequence number and
forward thread), so the dispatch's and the expert GEMMs' gradients land
in those groups too.  The recompute runs inside a backward node (the
first that unpacks a saved tensor of its layer), so each checkpointed
function runs under a fence range as well: the recompute's kernels stay
with their own ranges and groups and never join that node's
(``launch/_trace.py``).  The
summary also lands in ``chiprun_out/trace_train[_<arch>].json``.  Needs a
CUDA device.
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
from repro_torch.launch import _trace
from repro_torch.launch._trace import GEMMS, OTHER_OPS
from repro_torch.models import model, moe
from repro_torch.train import step as TS

# Training depth on one 80 GB card where the full depth does not fit, at 12
# bytes a parameter (bf16 weights and gradients, f32 AdamW moments): at 81
# layers zamba2-7b has 6.75 B parameters, ~81 GB; 33 layers are 5 groups of
# 6 Mamba2 layers, the full config's 3-layer tail and 5 applications of the
# shared block (3.01 B parameters), at full width.  olmoe-1b-7b at 16
# layers has 6.92 B parameters, 83.0 GB; 8 layers are 3.563 B, 42.8 GB,
# which leaves room for the activations of 2 x 4096 tokens (the combine's
# f32 gather alone is [8192, 8, 2048], 537 MB a layer, and the f32 logits
# 1.65 GB).
ONE_CARD_LAYERS = {"zamba2-7b": 33, "olmoe-1b-7b": 8}


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
TOP = 15                       # kernels listed by device time
# MoE functions whose calls the traced step ranges: (attribute of
# models/moe.py, group), the groups a range's kernels leave for it, and the
# fence over each checkpointed function (a recompute's range)
RANGED = (("route", "MoE dispatch"), ("dispatch", "MoE dispatch"),
          ("combine", "MoE dispatch"), ("experts", "expert GEMMs"))
MOVED_FROM = {"MoE dispatch": (OTHER_OPS, GEMMS), "expert GEMMs": (GEMMS,)}
FENCE = "trace_train::checkpointed"


def _group(name: str) -> str:
    for group, marks in GROUPS:
        if any(m in name for m in marks):
            return group
    if _trace.is_gemm(name):
        return GEMMS
    return OTHER_OPS


def _fenced(checkpoint):
    """``checkpoint`` with the function it runs under the ``FENCE`` range,
    in the forward and in the backward's recompute."""
    def call(fn, *args, **kwargs):
        return checkpoint(_trace.ranged(fn, FENCE), *args, **kwargs)
    return call


def traced_ranges():
    """The patches that range the traced step (the MoE functions, reached
    by ``models/model.py`` through the moe module, and the checkpoint that
    ``forward`` calls), and {range name: group} (the fence's None)."""
    patches = [(moe, attr, _trace.ranged(getattr(moe, attr), f"trace_train::{attr}"))
               for attr, _ in RANGED]
    patches.append((model, "checkpoint", _fenced(model.checkpoint)))
    ranges = {f"trace_train::{attr}": group for attr, group in RANGED}
    ranges[FENCE] = None
    return patches, ranges


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
    # the untraced steps above ran without the ranges
    patches, ranges = traced_ranges()
    with _trace.patched(patches), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batches[n - 1])
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0

    events = prof.events()
    per_kernel = defaultdict(lambda: [0.0, 0])      # name -> [us, calls]
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                ev.name not in ranges:              # not a range's GPU span
            per_kernel[ev.name][0] += ev.time_range.elapsed_us()
            per_kernel[ev.name][1] += 1
    taken = _trace.attribute(events, ranges, MOVED_FROM, _group)
    groups = _trace.regroup(per_kernel, taken, _group)
    device_s = sum(us for us, _ in groups.values()) / 1e6
    card = torch.cuda.get_device_name(0)
    tokens = args.batch * args.seq_len
    print(f"[trace] {card}; {cfg.name} ({cfg.n_layers} layers) {args.batch} x "
          f"{args.seq_len} tokens "
          f"per step, remat; untraced steps {[round(w, 4) for w in walls]} s "
          f"(mean {wall:.4f} s, {tokens / wall:.1f} tokens/s), traced step "
          f"{traced_wall:.4f} s; device kernel time {device_s:.4f} s; busy "
          f"share {device_s / wall:.3f} of the untraced step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    moe_summary = {}
    if cfg.family == "moe":
        # the recompute's fences that ran inside a backward node, by node
        holders = defaultdict(int)
        for ev in events:
            if ev.name == FENCE and ev.cpu_parent is not None:
                holders[ev.cpu_parent.name] += 1
        # the routed experts' GEMMs: 3 a layer in the forward, 3 in the
        # recompute, 6 in the backward, each 2 E_pad cap d ff operations
        e_pad = moe.moe_padded_experts(cfg)
        cap = moe.capacity(tokens, cfg.top_k, cfg.capacity_factor, e_pad)
        flop = 12 * cfg.n_layers * 2 * e_pad * cap * cfg.d_model * cfg.moe_d_ff
        us, launches = groups["expert GEMMs"]
        moe_summary = dict(moved_kernels=len(taken), recompute_holders=dict(holders),
                           expert_gemm_tflop=flop / 1e12,
                           expert_gemm_launches=launches,
                           expert_gemm_launches_expected=12 * cfg.n_layers,
                           expert_gemm_tflops=flop / (us / 1e6) / 1e12)
        print(f"[trace] MoE ranges: {len(taken)} kernels moved; the recompute "
              f"ran inside {dict(holders)}; expert GEMMs {launches} launches "
              f"(12 L = {12 * cfg.n_layers}), {flop / 1e12:.2f} TFLOP a step "
              f"(E_pad {e_pad}, cap {cap}) in {us / 1e3:.1f} ms: "
              f"{moe_summary['expert_gemm_tflops']:.1f} TFLOP/s")
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
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        moe=moe_summary,
        groups={g: dict(ms=us / 1e3, launches=c) for g, (us, c) in groups.items()},
        top=[dict(name=k, ms=us / 1e3, calls=c) for k, (us, c) in top]), indent=1))


if __name__ == "__main__":
    main()
