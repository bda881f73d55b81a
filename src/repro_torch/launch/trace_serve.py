"""Where the device time goes when the port serves at full width.

  PYTHONPATH=src python -m repro_torch.launch.trace_serve \
      [--dense | --kv-dtype int8 | --seq-shards 4]

Serves stablelm-1.6b (random bf16 weights from ``--seed``) on the card
through the engine, paged (default; ``--kv-dtype int8`` for the int8 page
pool, ``--seq-shards S`` for a sequence-sharded pool) or from the dense
slabs (``--dense``, ``ServeEngine(paged=False)``),
on the mix that ``chip_smoke.py`` drives
(``launch/serve.py:shared_prefix_mix``): once untimed to warm up, once
untraced for the wall clock, once under ``torch.profiler``.  Prints the
device kernel time by kernel and by group (the port's CUDA kernels,
GEMMs, other PyTorch ops) and the device busy share: summed kernel time
over the untraced wall time (one stream, so kernels do not overlap).  The
summary also lands in ``chiprun_out/trace_serve.json``.  Needs a CUDA
device.  With ``--dense`` the default summary file is
``trace_serve_dense.json`` beside it, with ``--kv-dtype int8``
``trace_serve_int8.json``, with ``--seq-shards S`` ``trace_serve_seqS.json``.
The port's kernels are split into decode attention (the flash-decoding
kernel, over pages or slabs), the paged prefill and the rest; a sharded
run's traced pass also puts each ``core.noc.tree_softmax_combine`` call
under a profiler range, so the combine's elementwise kernels (max, exp,
products, sums, the division) are counted apart from the other PyTorch
ops.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.core import noc
from repro_torch.launch.serve import (MIX_ENGINE, MIX_NEW_TOKENS,
                                      shared_prefix_mix)
from repro_torch.models import model
from repro_torch.serve import ServeEngine

# kernel-name fragments of the port's CUDA kernels (csrc/*.cu); the paged
# prefill's: paged_attention_kernel (f32 queries), paged_prefill_tc_kernel
# (bf16)
PREFILL_KERNELS = ("paged_attention_kernel", "paged_prefill_tc_kernel")
PORT_KERNELS = ("rmsnorm_kernel", "rope_kernel", "silu_mul_kernel",
                "flash_decode_kernel", "flash_fwd_kernel", *PREFILL_KERNELS)
GEMM_MARKS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")
TOP = 15                       # kernels listed by device time
COMBINE = "noc_tree_softmax_combine"   # the profiler range of one combine


def _group(name: str) -> str:
    low = name.lower()
    if "flash_decode_kernel" in name:
        return "port CUDA kernels: decode attention"
    if any(k in name for k in PREFILL_KERNELS):
        return "port CUDA kernels: paged prefill"
    if any(k in name for k in PORT_KERNELS):
        return "port CUDA kernels: other"
    if any(m in low for m in GEMM_MARKS):
        return "GEMM (torch.matmul)"
    return "other PyTorch ops"


def _serve(cfg, params, prompts, dense: bool, kv_dtype: str,
           seq_shards: int) -> float:
    eng = ServeEngine(cfg, params, **MIX_ENGINE,
                      paged=False if dense else None, kv_dtype=kv_dtype,
                      seq_shards=seq_shards)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new_tokens=MIX_NEW_TOKENS)
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng
    torch.cuda.empty_cache()
    return wall


def _kernels(ev) -> list:
    """The device kernels launched by a profiler CPU event and its
    descendants."""
    out = list(ev.kernels)
    for child in ev.cpu_children:
        out += _kernels(child)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dense", action="store_true",
                    help="serve from the dense KV slabs (paged=False)")
    ap.add_argument("--kv-dtype", default="fp16", choices=["fp16", "int8"],
                    help="paged-pool storage (int8: quantized pages)")
    ap.add_argument("--seq-shards", type=int, default=1,
                    help="sequence-shard the page pool S ways")
    ap.add_argument("--out", default="chiprun_out/trace_serve.json")
    args = ap.parse_args(argv)
    out = Path(args.out)
    if args.out == ap.get_default("out"):
        if args.dense:
            out = out.with_name("trace_serve_dense.json")
        elif args.kv_dtype != "fp16":
            out = out.with_name(f"trace_serve_{args.kv_dtype}.json")
        elif args.seq_shards > 1:
            out = out.with_name(f"trace_serve_seq{args.seq_shards}.json")
    if not torch.cuda.is_available():
        raise SystemExit("trace_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("stablelm-1.6b")
    params = model.init_params(cfg, seed=args.seed, device="cuda")
    prompts = shared_prefix_mix(cfg.vocab_size, args.seed)
    run = (args.dense, args.kv_dtype, args.seq_shards)
    _serve(cfg, params, prompts[:2], *run)          # warm-up
    wall = _serve(cfg, params, prompts, *run)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    combine = noc.tree_softmax_combine

    def ranged_combine(parts):
        with torch.profiler.record_function(COMBINE):
            return combine(parts)
    # the layers call the combine through the module, so the range covers
    # every call of the traced pass; the untimed and untraced passes above
    # ran without it
    noc.tree_softmax_combine = ranged_combine
    try:
        with torch.profiler.profile(activities=acts) as prof:
            traced_wall = _serve(cfg, params, prompts, *run)
    finally:
        noc.tree_softmax_combine = combine

    per_kernel = defaultdict(lambda: [0.0, 0])      # name -> [us, calls]
    combine_us, combine_n = 0.0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.name != COMBINE:                  # not the range's GPU span
                per_kernel[ev.name][0] += ev.time_range.elapsed_us()
                per_kernel[ev.name][1] += 1
        elif ev.name == COMBINE:
            kernels = _kernels(ev)
            combine_us += sum(k.duration for k in kernels)
            combine_n += len(kernels)
    groups = defaultdict(float)
    group_n = defaultdict(int)
    for name, (us, n) in per_kernel.items():
        groups[_group(name)] += us
        group_n[_group(name)] += n
    if combine_n:                 # elementwise kernels, out of "other ops"
        groups["other PyTorch ops"] -= combine_us
        group_n["other PyTorch ops"] -= combine_n
        groups["NoC tree combine ops"] = combine_us
        group_n["NoC tree combine ops"] = combine_n
    device_s = sum(groups.values()) / 1e6
    card = torch.cuda.get_device_name(0)
    mode = "dense slabs" if args.dense else f"paged, {args.kv_dtype} pool"
    if args.seq_shards > 1:
        mode += f", {args.seq_shards} sequence shards"
    n_launch = sum(n for _, n in per_kernel.values())
    print(f"[trace] {card}; {mode}; {n_launch} kernel launches; "
          f"wall {wall:.3f} s untraced, {traced_wall:.3f} s "
          f"traced; device kernel time {device_s:.3f} s; busy share "
          f"{device_s / wall:.3f} of the untraced wall")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[trace] group {g}: {us / 1e3:.1f} ms in {group_n[g]} launches "
              f"({us / 1e6 / device_s:.3f} of device time)")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]
    for name, (us, n) in top:
        print(f"[trace] {us / 1e3:9.2f} ms {n:7d} x  {name[:110]}")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(
        card=card, dense=args.dense, kv_dtype=args.kv_dtype,
        seq_shards=args.seq_shards, wall_s=wall,
        traced_wall_s=traced_wall, launches=n_launch,
        group_launches=dict(group_n),
        device_s=device_s,
        busy_share=device_s / wall, groups_ms={g: us / 1e3 for g, us in groups.items()},
        top=[dict(name=n, ms=us / 1e3, calls=c) for n, (us, c) in top]), indent=1))


if __name__ == "__main__":
    main()
