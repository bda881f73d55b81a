"""Where the device time goes when the port serves at full width.

  PYTHONPATH=src python -m repro_torch.launch.trace_serve \
      [--arch rwkv6-3b | zamba2-7b | olmoe-1b-7b | minitron-4b] \
      [--dense | --kv-dtype int8 | --seq-shards 4] \
      [--num-blocks 129 --preempt-policy swap|recompute|auto] \
      [--disagg] [--expert-parallel 4]

Serves ``--arch`` (default stablelm-1.6b; random bf16 weights from
``--seed``) at full width and depth on the card through the engine: the
runner path (default: the page pool, ``--kv-dtype int8`` for the int8 page
pool, ``--seq-shards S`` for a sequence-sharded pool; rwkv6-3b's slot
state; zamba2-7b's pool beside its Mamba2 slot state; olmoe-1b-7b's pool;
minitron-4b's pool of 8 kv heads under 24 query heads) or the dense-slab
baseline (``--dense``, ``ServeEngine(paged=False)``), on the mix that
``chip_smoke.py`` drives (``launch/serve.py:shared_prefix_mix``): once
untimed to warm up, once untraced for the wall clock, once under
``torch.profiler``.  Prints the
device kernel time by kernel and by group (the port's CUDA kernels,
GEMMs, other PyTorch ops) and the device busy share: summed kernel time
over the untraced wall time (one stream, so kernels do not overlap).  The
summary also lands in ``chiprun_out/trace_serve.json``.  Needs a CUDA
device.  With ``--dense`` the default summary file is
``trace_serve_dense.json`` beside it, with ``--kv-dtype int8``
``trace_serve_int8.json``, with ``--seq-shards S`` ``trace_serve_seqS.json``
(another arch: its name before ``.json``).  The port's kernels are split
into decode attention (the flash-decoding kernel, over pages or slabs),
the paged prefill, the slab prefill (the flash forward with a key bound),
the wkv6 forward (from a carried state on rwkv6-3b's runner path), the
Mamba2 forward (from a carried state on zamba2-7b's runner path), rmsnorm
and the rest.  The traced pass also puts each call of a few plain
functions under a profiler range, and the non-GEMM kernels they launch are
counted apart from the other PyTorch ops: the NoC tree combine
(``core.noc.tree_softmax_combine``, a sharded run: max, exp, products,
sums, the division), RWKV6's plain one-token step (``ops.rwkv6_step``),
decay (``models/rwkv.py:_decay``, its LoRA GEMMs left with the GEMMs) and
token shift (``_shift``), and Mamba2's plain one-token step
(``ops.mamba2_step``) and its causal conv over a chunk
(``models/ssm.py:_causal_conv``) or a token (``_conv_step``).  An MoE
model's dispatch (``models/moe.py``: ``route``, the router GEMM, top-k
and the positions; ``dispatch``, the scatter; ``combine``, the gather and
the gated sum) is its own group, "MoE dispatch", GEMMs included, and the
routed experts' batched GEMMs (``experts``) are counted apart from the
other GEMMs, as "expert GEMMs" (their silu_mul stays with the port's
kernels).  The LM head (``models/model.py:_logits``: the final norm and
the vocabulary-wide GEMM) is its own group, "LM head", its rmsnorm left
with the port's kernels.  ``--num-blocks`` below the pool's full capacity serves the mix
under page pressure (``--preempt-policy``): the engine's swap-out
(``ServeEngine._swap_out``: the page gathers and the device-to-host
copies), swap-in (``_restore_swapped``: the host-to-device copies and the
page scatters) and the replayed prefill chunks of a recompute restore (a
chunk of a request that has decoded already, or below the tokens it held
when it was preempted) are ranged
as "swap out", "swap in" and "recompute", every kernel under them (a
replayed chunk's GEMMs and attention included) moved to that group, so the
device time of a pressured run splits by arm; the summary file then ends
in ``_nbN`` and records the preemption statistics.  ``--disagg`` serves
the mix through a prefill/decode pair (``serve/disagg.py``: the 8 slots
split 4 and 4, the decode role under swap, the default arena), as
``launch/serve.py --disagg`` builds it; the prefill side's staging
(``ServeEngine.stage_handoff``: the page gathers and the device-to-host
copies into the arena) and the decode side's admission
(``_admit_handoff``: the host-to-device copies and the page scatters) are
ranged as "handoff out" and "handoff in", fenced as the swap arms are, and
the summary file ends in ``_disagg`` with the handoff ledger.
``--expert-parallel N`` (an MoE arch) runs every MoE layer over N expert
shards; each shard's batched GEMMs count as "expert GEMMs" (the ranges sit
on ``models/moe.py``'s functions, which every shard calls), and the file
ends in ``_epN``.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import noc
from repro_torch.kernels import ops
from repro_torch.launch import _trace
from repro_torch.launch._trace import GEMMS, OTHER_OPS
from repro_torch.launch.serve import (MIX_ENGINE, MIX_NEW_TOKENS,
                                      shared_prefix_mix)
from repro_torch.models import model, moe, rwkv, ssm
from repro_torch.serve import DisaggServer, ServeEngine

# kernel-name fragments of the port's CUDA kernels (csrc/*.cu); the paged
# prefill's: paged_attention_kernel (f32 queries), paged_prefill_tc_kernel
# (bf16)
PREFILL_KERNELS = ("paged_attention_kernel", "paged_prefill_tc_kernel")
PORT_KERNELS = ("rmsnorm_kernel", "rope_kernel", "silu_mul_kernel",
                "flash_decode_kernel", "flash_", *PREFILL_KERNELS)
TOP = 15                       # kernels listed by device time
# plain functions whose calls the traced pass puts under a profiler range:
# (module, attribute, group of the non-GEMM kernels they launch)
RANGED = ((noc, "tree_softmax_combine", "NoC tree combine ops"),
          (ops, "rwkv6_step", "rwkv plain ops: rwkv6_step"),
          (rwkv, "_decay", "rwkv plain ops: decay"),
          (rwkv, "_shift", "rwkv plain ops: token shift"),
          (ops, "mamba2_step", "mamba plain ops: mamba2_step"),
          (ssm, "_causal_conv", "mamba plain ops: conv"),
          (ssm, "_conv_step", "mamba plain ops: conv"),
          (moe, "route", "MoE dispatch"),
          (moe, "dispatch", "MoE dispatch"),
          (moe, "combine", "MoE dispatch"),
          (moe, "experts", "expert GEMMs"),
          (model, "_logits", "LM head"))
# the groups a range's kernels leave for its own (default: the non-GEMM
# kernels, so a range's GEMMs stay GEMMs; None: every group)
MOVED_FROM = {"MoE dispatch": (OTHER_OPS, GEMMS), "expert GEMMs": (GEMMS,),
              "LM head": (OTHER_OPS, GEMMS),
              "swap out": None, "swap in": None, "recompute": None,
              "handoff out": None, "handoff in": None}
# the engine's preemption arms and the two halves of a handoff: (method,
# group); the replay chunks of a recompute restore are ranged by
# _replay_ranged
ARMS = (("_swap_out", "swap out"), ("_restore_swapped", "swap in"),
        ("stage_handoff", "handoff out"), ("_admit_handoff", "handoff in"))


def _group(name: str) -> str:
    if "flash_decode_kernel" in name:
        return "port CUDA kernels: decode attention"
    if any(k in name for k in PREFILL_KERNELS):
        return "port CUDA kernels: paged prefill"
    if "flash_fwd_" in name:
        return "port CUDA kernels: slab prefill (flash)"
    if "rwkv6_fwd_" in name:
        return "port CUDA kernels: wkv6"
    if "mamba2_fwd_" in name:
        return "port CUDA kernels: Mamba2"
    if "rmsnorm_kernel" in name:
        return "port CUDA kernels: rmsnorm"
    if any(k in name for k in PORT_KERNELS):
        return "port CUDA kernels: other"
    if _trace.is_gemm(name):
        return GEMMS
    return OTHER_OPS


PREEMPT_STATS = ("preemptions", "preempt_proactive", "preempt_swaps",
                 "preempt_recomputes", "swap_bytes", "preempted_tokens",
                 "restored_tokens", "stalled_ticks", "prefill_tokens",
                 "decode_tokens", "ticks")
HANDOFF_STATS = ("handoffs", "handoff_pages", "handoff_cached_pages",
                 "handoff_bytes", "handoff_seconds", "arena_stalls",
                 "decode_step_seconds", "prefill_step_seconds")


def _serve(cfg, params, prompts, dense: bool, kv_dtype: str,
           seq_shards: int, num_blocks=None, preempt_policy="auto",
           disagg=False, expert_parallel=None):
    """Wall seconds of one drained run of ``prompts``, and the engine's
    preemption statistics (the decode side's, with the server's handoff
    ledger, under ``disagg``)."""
    kw = dict(MIX_ENGINE, paged=False if dense else None, kv_dtype=kv_dtype,
              seq_shards=seq_shards, num_blocks=num_blocks,
              expert_parallel=expert_parallel)
    if disagg:
        slots = kw.pop("slots")
        srv = DisaggServer(cfg, params, prefill=dict(slots=slots // 2),
                           decode=dict(slots=slots - slots // 2,
                                       preempt_policy="swap"), **kw)
        eng = srv.decode
    else:
        srv = eng = ServeEngine(cfg, params, preempt_policy=preempt_policy,
                                **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        srv.submit(p, max_new_tokens=MIX_NEW_TOKENS)
    srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {k: eng.stats[k] for k in PREEMPT_STATS}
    if disagg:
        stats.update({k: srv.stats[k] for k in HANDOFF_STATS},
                     handoff_stalls=eng.stats["handoff_stalls"])
    del eng, srv
    torch.cuda.empty_cache()
    return wall, stats


def _replay_ranged(fn):
    """``ServeEngine._run_prefill_chunk`` with a recompute replay's chunks
    (any chunk of a request that has decoded already, or below the tokens
    it held at its last preemption) under the "recompute" range."""
    def call(self, slot, req, bucket, n):
        if req.out_tokens or req.prefill_pos < req._preempted_live:
            with torch.profiler.record_function("trace_serve::recompute"):
                return fn(self, slot, req, bucket, n)
        return fn(self, slot, req, bucket, n)
    return call


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list(ARCHS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dense", action="store_true",
                    help="serve from the dense KV slabs (paged=False)")
    ap.add_argument("--kv-dtype", default="fp16", choices=["fp16", "int8"],
                    help="paged-pool storage (int8: quantized pages)")
    ap.add_argument("--seq-shards", type=int, default=1,
                    help="sequence-shard the page pool S ways")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="page pool size (default: full capacity); below "
                         "it the mix runs under page pressure")
    ap.add_argument("--preempt-policy", default="auto",
                    choices=["swap", "recompute", "auto"])
    ap.add_argument("--disagg", action="store_true",
                    help="serve through a prefill/decode pair, the handoff "
                         "halves ranged")
    ap.add_argument("--expert-parallel", type=int, default=None,
                    help="an MoE arch's experts over N shards")
    ap.add_argument("--out", default="chiprun_out/trace_serve.json")
    args = ap.parse_args(argv)
    out = Path(args.out)
    if args.out == ap.get_default("out"):
        stem = "trace_serve"
        if args.arch != ap.get_default("arch"):
            stem += f"_{args.arch}"
        if args.dense:
            stem += "_dense"
        elif args.kv_dtype != "fp16":
            stem += f"_{args.kv_dtype}"
        elif args.seq_shards > 1:
            stem += f"_seq{args.seq_shards}"
        if args.num_blocks is not None:
            stem += f"_nb{args.num_blocks}_{args.preempt_policy}"
        if args.disagg:
            stem += "_disagg"
        if args.expert_parallel is not None:
            stem += f"_ep{args.expert_parallel}"
        out = out.with_name(f"{stem}.json")
    if not torch.cuda.is_available():
        raise SystemExit("trace_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    params = model.init_params(cfg, seed=args.seed, device="cuda")
    prompts = shared_prefix_mix(cfg.vocab_size, args.seed)
    run = (args.dense, args.kv_dtype, args.seq_shards, args.num_blocks,
           args.preempt_policy, args.disagg, args.expert_parallel)
    _serve(cfg, params, prompts[:2], *run)          # warm-up
    wall, stats = _serve(cfg, params, prompts, *run)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the callers reach these functions through their modules, so a range
    # covers every call of the traced pass; the untimed and untraced passes
    # above ran without them
    ranged = RANGED + tuple((ServeEngine, a, g) for a, g in ARMS)
    ranges = {f"trace_serve::{attr}": group for _, attr, group in ranged}
    ranges["trace_serve::recompute"] = "recompute"
    patches = [(mod, attr, _trace.ranged(getattr(mod, attr), f"trace_serve::{attr}"))
               for mod, attr, _ in ranged]
    patches.append((ServeEngine, "_run_prefill_chunk",
                    _replay_ranged(ServeEngine._run_prefill_chunk)))
    with _trace.patched(patches), torch.profiler.profile(activities=acts) as prof:
        traced_wall, _ = _serve(cfg, params, prompts, *run)

    events = prof.events()
    per_kernel = defaultdict(lambda: [0.0, 0])      # name -> [us, calls]
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                ev.name not in ranges:              # not a range's GPU span
            per_kernel[ev.name][0] += ev.time_range.elapsed_us()
            per_kernel[ev.name][1] += 1
    groups = _trace.regroup(per_kernel,
                            _trace.attribute(events, ranges, MOVED_FROM, _group),
                            _group)
    device_s = sum(us for us, _ in groups.values()) / 1e6
    card = torch.cuda.get_device_name(0)
    if args.dense:
        mode = "dense slabs"
    elif cfg.family == "ssm":
        mode = "slot state"
    else:
        mode = f"paged, {args.kv_dtype} pool"
        if cfg.family == "hybrid":
            mode += ", slot state"
    if args.seq_shards > 1:
        mode += f", {args.seq_shards} sequence shards"
    if args.expert_parallel is not None:
        mode += f", {args.expert_parallel} expert shards"
    if args.num_blocks is not None:
        mode += (f", {args.num_blocks} pages ({args.preempt_policy}): "
                 + ", ".join(f"{k} {stats[k]:.0f}" for k in PREEMPT_STATS))
    if args.disagg:
        mode += (", prefill/decode pair (4 + 4 slots): "
                 + ", ".join(f"{k} {stats[k]:.4g}" for k in HANDOFF_STATS)
                 + f", handoff_stalls {stats['handoff_stalls']:.0f}")
    n_launch = sum(n for _, n in per_kernel.values())
    print(f"[trace] {card}; {args.arch}, {mode}; {n_launch} kernel launches; "
          f"wall {wall:.3f} s untraced, {traced_wall:.3f} s "
          f"traced; device kernel time {device_s:.3f} s; busy share "
          f"{device_s / wall:.3f} of the untraced wall")
    for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[trace] group {g}: {us / 1e3:.1f} ms in {n} launches "
              f"({us / 1e6 / device_s:.3f} of device time)")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]
    for name, (us, n) in top:
        print(f"[trace] {us / 1e3:9.2f} ms {n:7d} x  {name[:110]}")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(
        card=card, arch=args.arch, dense=args.dense, kv_dtype=args.kv_dtype,
        seq_shards=args.seq_shards, num_blocks=args.num_blocks,
        preempt_policy=args.preempt_policy, disagg=args.disagg,
        expert_parallel=args.expert_parallel, preempt_stats=stats, wall_s=wall,
        traced_wall_s=traced_wall, launches=n_launch,
        group_launches={g: n for g, (_, n) in groups.items()},
        device_s=device_s,
        busy_share=device_s / wall,
        groups_ms={g: us / 1e3 for g, (us, _) in groups.items()},
        top=[dict(name=n, ms=us / 1e3, calls=c) for n, (us, c) in top]), indent=1))


if __name__ == "__main__":
    main()
