"""Serving entry point of the port: stand up the engine for an arch (the
runner path by default, ``--dense`` for the dense-slab baseline) and run a
synthetic request stream.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --reduced --device cpu --requests 8 [--dense | --kv-dtype int8] \
      [--seq-shards 4]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --reduced --device cpu [--dense]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --reduced --device cpu [--dense | --kv-dtype int8 | --seq-shards 4]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --reduced --device cpu [--dense | --kv-dtype int8 | --seq-shards 4]
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --num-blocks 12 --preempt-policy swap [--proactive-horizon 2]
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --batch-frac 0.5 --deadline-ms 1e6 [--temperature 0.8]
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --ckpt-dir /tmp/ckpt        # what launch/train.py --ckpt-dir wrote
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --disagg [--handoff-pages 8]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --reduced --device cpu --expert-parallel 4 [--seq-shards 2]

The engine runs on the card (``--device cuda``, the default) through the
hand-written CUDA kernels; ``--device cpu`` runs the plain PyTorch versions.
Parameters are random, made from ``--seed``, unless ``--ckpt-dir`` names a
checkpoint of ``launch/train.py``: its latest step's parameters are served
(an empty directory keeps the random ones).  ``--temperature`` samples
(0: greedy; the draw is seeded by ``--seed``).  ``--batch-frac`` submits
that share of the stream in the ``batch`` latency class with twice the new
tokens, the rest ``interactive``; ``--deadline-ms`` gives the interactive
class an SLO deadline and the batch class ten times it; a line per class
reports its finishes, preemptions, SLO violations and TTFT p50.  The port
serves the dense family (grouped kv heads too: ``--arch minitron-4b``),
from a page pool in the engine dtype or in int8
(``--kv-dtype int8``), whole or sequence-sharded (``--seq-shards S``: S
shards of the one pool on the one device, their attention partials merged
by the NoC tree combine, whose hop and energy totals are printed), RWKV6
(``--arch rwkv6-3b``) from its recurrent slot state, which has no page
pool: the engine refuses ``--kv-dtype int8`` and ``--seq-shards`` for it,
the hybrid (``--arch zamba2-7b``): its shared attention block's KV in
the page pool (int8 and sequence shards too) beside its Mamba2 layers'
slot state, or in dense slabs with ``--dense``, and the MoE family
(``--arch olmoe-1b-7b``, ``qwen2-moe-a2.7b``) as the dense one, its
routed experts at the config's GShard ``capacity_factor``.  A paged pool
may be smaller than full capacity (``--num-blocks``): the engine then
stalls, preempts and restores under pressure, each victim swapped to the
host arena or recomputed (``--preempt-policy``, ``--swap-pages``,
``--proactive-horizon``), and the summary line counts the preemptions by
arm.  An MoE family takes the placement-aware expert cache on the runner
path (``--expert-cache N`` experts per layer in the paper's SRAM-PIM
tier, ``--no-expert-prefetch``, ``--expert-placement static``), and the
expert telemetry and cache lines are printed; ``--expert-parallel N``
splits its routed experts N ways (views of the one card's banks, the
shards' outputs summed; it composes with ``--seq-shards`` and
``--expert-cache``) and prints the telemetry line.  ``--disagg`` serves
through a prefill/decode pair (``serve/disagg.py:DisaggServer``):
``--slots`` split between the roles, the decode role under swap
preemption, finished prefills handed over through a pinned arena of
``--handoff-pages`` pages (default: the prefill pool's full coverage); two
lines report the handoff ledger (pages moved and re-attached, the modeled
link bytes and energy, the stalls) and each role's worker seconds, and the
per-class counts take the prefill front door as the arrival count.
``--disagg --dense`` is refused.  The JAX launcher's ``--q-tile`` sizes
the Pallas prefill's VMEM tile and has no counterpart.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import ARCHS, get_config, reduced as reduce_cfg
from repro_torch.models import model
from repro_torch.serve import DisaggServer, ServeEngine
from repro_torch.train import step as train_step

# The full-width serving mix that chip_smoke.py and trace_serve.py drive:
# stablelm-1.6b's engine at 8 slots, and 16 requests of 64 new tokens (the
# same engine and requests serve rwkv6-3b, which ignores block_size,
# zamba2-7b, whose pool holds the shared block's 13 applications, and
# olmoe-1b-7b).
MIX_ENGINE = dict(slots=8, max_seq=1024, block_size=16,
                  prefill_buckets=(32, 128, 512, 1024))
MIX_NEW_TOKENS = 64


def shared_prefix_mix(vocab: int, seed: int = 0):
    """8 prompts on one shared 256-token prefix plus 32-384 own tokens and 8
    unique prompts of 64-768 tokens, interleaved (int32 arrays)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 256)
    prompts = []
    for _ in range(8):
        prompts.append(np.concatenate(
            [shared, rng.integers(0, vocab, int(rng.integers(32, 385)))]))
        prompts.append(rng.integers(0, vocab, int(rng.integers(64, 769))))
    return [p.astype(np.int32) for p in prompts]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature of every request (0: greedy)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged-KV page size (tokens)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="physical page pool size (default: full capacity); "
                         "a smaller pool oversubscribes and preempts")
    ap.add_argument("--kv-dtype", default="fp16", choices=["fp16", "int8"],
                    help="paged-pool storage: fp16 keeps the engine dtype, "
                         "int8 stores quantized pages with per-page-per-head "
                         "scales (paged only)")
    ap.add_argument("--seq-shards", type=int, default=1,
                    help="sequence-shard the page pool S ways (a power of "
                         "two; paged only): S shards of the one pool on the "
                         "one device, merged by the NoC tree combine")
    ap.add_argument("--preempt-policy", default="auto",
                    choices=["swap", "recompute", "auto"],
                    help="how preemption victims keep their progress: swap "
                         "pages to the host arena, drop + recompute via the "
                         "prefix cache, or pick per victim from the "
                         "link-bytes-vs-prefill-FLOPs cost model (the "
                         "paper's CXL and PIM rates)")
    ap.add_argument("--swap-pages", type=int, default=None,
                    help="host swap-arena capacity in pages (default: one "
                         "full pool's worth)")
    ap.add_argument("--proactive-horizon", type=int, default=0,
                    help="preempt on predicted page-pool exhaustion this "
                         "many ticks ahead (0 = deadlock-only)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="max padded tokens (prefill+decode) per tick")
    ap.add_argument("--prefill-buckets", default=None,
                    help="comma-separated chunk sizes for chunked prefill "
                         "(default 32,128,512,2048; each clamps to "
                         "--max-seq, which is always included)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prompt-page prefix caching")
    ap.add_argument("--dense", action="store_true",
                    help="serve from the dense [slots, max_seq] KV slabs "
                         "(the A/B baseline; turns prefix caching off)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="interactive-class SLO deadline in wall ms (the "
                         "batch class gets 10x); finishes past the "
                         "effective deadline count as slo_violations")
    ap.add_argument("--batch-frac", type=float, default=0.0,
                    help="fraction of the synthetic stream submitted as "
                         "the 'batch' latency class (twice the new tokens, "
                         "weight 1) instead of 'interactive' (weight 8)")
    ap.add_argument("--disagg", action="store_true",
                    help="serve through a prefill/decode-disaggregated "
                         "pair (DisaggServer): --slots split between the "
                         "roles, finished prefills handed over (pages and "
                         "slot state) through a pinned arena, priced on "
                         "the paper's link")
    ap.add_argument("--handoff-pages", type=int, default=None,
                    help="handoff-arena capacity in pages (the prefill -> "
                         "decode handoffs in flight; default: the prefill "
                         "pool's full slot coverage)")
    ap.add_argument("--expert-parallel", type=int, default=None,
                    help="shard a MoE family's routed experts N ways: N "
                         "expert shards, views of the one device's banks, "
                         "their outputs summed (composes with "
                         "--seq-shards and --expert-cache)")
    ap.add_argument("--expert-cache", type=int, default=None,
                    help="SRAM-PIM-resident experts per layer for the "
                         "placement-aware hot/cold expert cache (MoE "
                         "families, the runner path; default off)")
    ap.add_argument("--no-expert-prefetch", action="store_true",
                    help="commit expert promotions at once instead of "
                         "double-buffered staging")
    ap.add_argument("--expert-placement", default="adaptive",
                    choices=["adaptive", "static"],
                    help="adaptive migrates hot experts into SRAM residency "
                         "per the NoC cost model; static keeps the initial "
                         "placement (the A/B baseline)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the latest step's parameters of a "
                         "checkpoint that launch/train.py wrote")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (the CUDA kernels) or "
                         "cpu (their plain PyTorch versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random parameters and the prompts")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible; pass --device cpu to run "
                         "the plain PyTorch path")
    params = model.init_params(cfg, seed=args.seed, device=device)
    if args.ckpt_dir:
        from repro_torch.checkpoint import CheckpointManager
        step_no, state = CheckpointManager(args.ckpt_dir).restore(
            train_step.init_state(cfg, args.seed, device=device))
        if state is not None:
            # each leaf in the dtype init_params gives it
            params = T.map(lambda p, r: p.to(r.dtype), state.params, params)
            del state
            print(f"[serve] restored step {step_no} from {args.ckpt_dir}")
    ekw = {}
    if args.deadline_ms is not None:
        ekw["class_deadlines_ms"] = {"interactive": args.deadline_ms,
                                     "batch": 10.0 * args.deadline_ms}
    if args.prefill_buckets:
        ekw["prefill_buckets"] = tuple(
            int(b) for b in args.prefill_buckets.split(","))
    ekw.update(max_seq=args.max_seq, block_size=args.block_size,
               max_tokens_per_tick=args.token_budget,
               paged=False if args.dense else None,
               prefix_caching=(False if args.dense or args.no_prefix_cache
                               else None),
               kv_dtype=args.kv_dtype, seq_shards=args.seq_shards,
               swap_pages=args.swap_pages,
               proactive_horizon=args.proactive_horizon,
               expert_parallel=args.expert_parallel,
               expert_cache_size=args.expert_cache,
               expert_prefetch=not args.no_expert_prefetch,
               expert_placement=args.expert_placement, seed=args.seed)
    if args.disagg:
        if args.dense:
            ap.error("--disagg serves through the paged/slot-state "
                     "engines; drop --dense")
        p_slots = max(1, args.slots // 2)
        # the decode role never prefills, so swap is the one preemption
        # policy that can restore its victims
        srv = DisaggServer(
            cfg, params,
            prefill=dict(slots=p_slots, num_blocks=args.num_blocks),
            decode=dict(slots=max(1, args.slots - p_slots),
                        num_blocks=args.num_blocks, preempt_policy="swap"),
            handoff_pages=args.handoff_pages, **ekw)
        eng = srv.decode                # decode owns the finished stream
        engines = (srv.prefill, srv.decode)
    else:
        srv = eng = ServeEngine(cfg, params, slots=args.slots,
                                num_blocks=args.num_blocks,
                                preempt_policy=args.preempt_policy, **ekw)
        engines = (eng,)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        plen = int(rng.integers(2, max(3, min(24, args.max_seq // 4))))
        # drawn only with --batch-frac, so a one-class stream keeps its prompts
        batch = args.batch_frac > 0 and rng.random() < args.batch_frac
        srv.submit(rng.integers(0, cfg.vocab_size, plen).tolist(),
                   max_new_tokens=(2 * args.max_new_tokens if batch
                                   else args.max_new_tokens),
                   temperature=args.temperature,
                   priority="batch" if batch else "interactive")
    done = srv.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in done)
    for r in sorted(done, key=lambda r: r.rid)[:5]:
        print(f"[serve] req {r.rid}: {len(r.prompt)} prompt -> "
              f"{r.out_tokens[:8]}{'...' if len(r.out_tokens) > 8 else ''}")
    ttfts = sorted(r.ttft for r in done if r.ttft is not None)
    p50 = ttfts[len(ttfts) // 2] * 1e3 if ttfts else 0.0
    mode = ("dense" if args.dense else
            " + ".join(name for name, on in (("paged", eng.paged),
                                             ("slot state", eng.has_slot_state))
                       if on))
    if eng.kv_dtype != "fp16":
        mode += f"/{eng.kv_dtype}"
    if eng.seq_shards > 1:
        mode += f"/seq{eng.seq_shards}"
    if eng.expert_parallel:
        mode += f"/ep{eng.expert_parallel}"
    if args.disagg:
        mode += "/disagg"
    print(f"[serve] {len(done)} requests, {total} tokens, {dt:.2f}s "
          f"({total / dt:.1f} tok/s) on {device}  kv={mode} "
          f"({eng.kv_cache_bytes() / 1e6:.1f} MB), "
          f"occupancy={eng.mean_occupancy:.2f}, "
          f"prefill_dispatches={eng.stats['prefill_dispatches']:.0f}, "
          f"prefix_hit_tokens={eng.stats['prefix_hit_tokens']:.0f}, "
          f"cow_copies={eng.stats['cow_copies']:.0f}, "
          f"preemptions={eng.stats['preemptions']:.0f} "
          f"(swap={eng.stats['preempt_swaps']:.0f}/"
          f"recompute={eng.stats['preempt_recomputes']:.0f}, "
          f"restored={eng.stats['restored_tokens']:.0f} of "
          f"{eng.stats['preempted_tokens']:.0f} preempted tokens, "
          f"swap_bytes={eng.stats['swap_bytes']:.0f}), "
          f"gather_volume={eng.stats['gather_page_volume']:.0f}, "
          f"ttft_p50={p50:.1f}ms")
    if args.disagg:
        hs = srv.stats
        pre = srv.prefill
        payload = pre.runner.handoff_payload_bytes(
            pre.block_size, 1 if pre.kv_dtype == "int8" else pre.dtype.itemsize,
            int(hs["handoff_pages"]) + int(hs["handoff_cached_pages"]),
            int(hs["handoff_cached_pages"]))
        print(f"[serve] disagg: prefill={pre.slots} slots / "
              f"decode={srv.decode.slots} slots, "
              f"arena={srv.handoff_pages} pages; "
              f"handoffs={hs['handoffs']:.0f} "
              f"({hs['handoff_pages']:.0f} pages moved + "
              f"{hs['handoff_cached_pages']:.0f} decode-cached), "
              f"link={hs['handoff_bytes'] / 1e6:.2f}MB "
              f"(paged payload {payload / 1e6:.2f}MB), "
              f"energy={hs['handoff_energy_pj'] / 1e6:.2f}uJ, "
              f"arena_stalls={hs['arena_stalls']:.0f}, "
              f"handoff_stalls={srv.decode.stats['handoff_stalls']:.0f}")
        print(f"[serve] disagg prefill side: "
              f"prefill_dispatches={pre.stats['prefill_dispatches']:.0f}, "
              f"occupancy={pre.mean_occupancy:.2f}, "
              f"worker_s={hs['prefill_step_seconds']:.2f} vs "
              f"decode worker_s={hs['decode_step_seconds']:.2f}")
    for cls in eng.class_order:
        cs = {k: sum(e.class_stats[cls][k] for e in engines)
              for k in eng.class_stats[cls]}
        if args.disagg:
            # a handed-off rid counts as submitted on both engines: the
            # prefill front door alone is the arrival count
            cs["submitted"] = srv.prefill.class_stats[cls]["submitted"]
        if not cs["submitted"]:
            continue
        ttfts = sorted(r.ttft for r in done
                       if r.priority == cls and r.ttft is not None)
        p50 = ttfts[len(ttfts) // 2] * 1e3 if ttfts else 0.0
        print(f"[serve] class {cls} (w={eng.class_weights[cls]:g}): "
              f"finished={cs['finished']:.0f}/{cs['submitted']:.0f}, "
              f"tokens={cs['finished_tokens']:.0f}, "
              f"preemptions={cs['preemptions']:.0f}, "
              f"slo_violations={cs['slo_violations']:.0f}, "
              f"ttft_p50={p50:.1f}ms")
    if args.deadline_ms is not None:
        print(f"[serve] slo: interactive deadline {args.deadline_ms:g}ms "
              f"(batch {10 * args.deadline_ms:g}ms): "
              f"{sum(e.stats['slo_violations'] for e in engines):.0f} of "
              f"{len(done)} finished requests violated")
    if eng.stats["preempt_proactive"]:
        print(f"[serve] proactive preemptions (horizon="
              f"{eng.proactive_horizon}): "
              f"{eng.stats['preempt_proactive']:.0f}, "
              f"stalled_ticks={eng.stats['stalled_ticks']:.0f} "
              f"of {eng.stats['ticks']:.0f} ticks")
    if eng.seq_shards > 1:
        print(f"[serve] noc: combines={eng.stats['noc_combines']:.0f}, "
              f"hops={eng.stats['noc_hops']:.0f}, "
              f"bytes={eng.stats['noc_bytes'] / 1e6:.2f}MB, "
              f"energy={eng.stats['noc_energy_pj'] / 1e6:.2f}uJ")
    if eng._moe_stats:
        print(f"[serve] experts: "
              f"routed_tokens={eng.stats['expert_routed_tokens']:.0f}, "
              f"dropped={eng.stats['expert_dropped_tokens']:.1f}, "
              f"skew={eng.stats['expert_skew']:.2f}, "
              f"gini={eng.stats['expert_gini']:.3f}, "
              f"ep={eng.expert_parallel or 1}")
    if eng.expert_cache is not None:
        print(f"[serve] expert cache "
              f"(capacity={eng.expert_cache.capacity}/layer, "
              f"{'adaptive' if eng.expert_cache.adaptive else 'static'}"
              f"{'' if eng.expert_cache.prefetch else ', no prefetch'}): "
              f"sram_hit_rate={eng.stats['expert_sram_hit_rate']:.3f}, "
              f"migrations={eng.stats['expert_migrations']:.0f}, "
              f"migration_bytes="
              f"{eng.stats['expert_migration_bytes'] / 1e6:.2f}MB, "
              f"prefetches={eng.stats['expert_prefetches']:.0f}")


if __name__ == "__main__":
    main()
