#!/usr/bin/env python3
"""The serving schedule of one source tree on the card, for comparing trees.

    python3 tools/serve_schedule.py [--src SRC] [--tag NAME]
    python3 tools/serve_schedule.py --compare A.json B.json

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``), so
that one call can read a checkout and its parent (unpacked with ``git
archive``) in turns.  stablelm-1.6b at full width and depth, random bf16
weights from seed 0, serves the mix of ``chip_smoke.py`` phase 5 (one
latency class, greedy) through the engines of phases 5 (the runner,
prefix caching on), 17 (an int8 pool), 18 (4 sequence shards) and 22 (129
pages under swap and under recompute), each through ``chip_smoke.py``'s
``serve_mix`` with the kernels' launch counters zeroed just before and read
just after.  For each engine it records the sha256 of the tokens, the
dispatch, tick and preemption counts, every kernel's launches and the
sha256 of every request's (submit, first, finish) ticks, and the tok/s
(host clock; not compared).  Prints one JSON line and writes it to
``chiprun_out/schedule/<tag>.json``.  ``--compare`` prints the fields two
such files disagree on and exits 1 if any but tok/s and wall time do.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NOT_COMPARED = ("tok_s", "wall_s")


def compare(a_path: str, b_path: str) -> int:
    a, b = (json.loads(Path(p).read_text()) for p in (a_path, b_path))
    bad = 0
    for eng in sorted(set(a["engines"]) | set(b["engines"])):
        ea, eb = a["engines"].get(eng, {}), b["engines"].get(eng, {})
        for k in sorted(set(ea) | set(eb)):
            if ea.get(k) != eb.get(k):
                hard = k not in NOT_COMPARED
                bad += hard
                print(f"[schedule] {eng}.{k}: {a['tag']} {ea.get(k)} / {b['tag']} "
                      f"{eb.get(k)}{'' if hard else ' (not compared)'}")
    print(f"[schedule] {a['tag']} vs {b['tag']}: "
          f"{'equal' if not bad else f'{bad} fields differ'} over "
          f"{sorted(a['engines'])}")
    return 1 if bad else 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--compare", nargs=2, metavar="JSON")
    args = ap.parse_args()
    if args.compare:
        raise SystemExit(compare(*args.compare))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("serve_schedule: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import prefill_attention as kpf
    from repro_torch.kernels import rmsnorm, rope, swiglu
    from repro_torch.serve import ServeEngine

    C = cs.Counter
    counters = {"rmsnorm": C(rmsnorm), "apply_rope_qk": C(rope, "qk_launches"),
                "silu_mul": C(swiglu), "paged_decode_attention": C(kda),
                "paged_prefill_attention": C(kpf),
                "paged_prefill_attention_tc": C(kpf, "tc_launches"),
                "paged_decode_attention_int8": C(kda, "q8_launches"),
                "paged_prefill_attention_int8": C(kpf, "q8_launches"),
                "paged_decode_attention_skip_null": C(kda, "shard_launches"),
                "paged_prefill_attention_skip_null": C(kpf, "shard_launches")}
    cfg = get_config("stablelm-1.6b")
    params = cs.serve_params(torch, cfg)
    warm = ServeEngine(cfg, params, slots=8, max_seq=160, block_size=16,
                       prefill_buckets=(32, 128))
    warm.submit(list(range(40)), max_new_tokens=3)
    warm.run_until_drained()
    del warm
    ticks = {}

    def keep_ticks(eng):
        ticks["eng"] = eng

    out = dict(tag=args.tag, src=args.src, card=cs.nvidia_smi_line(), engines={})
    for name, kw in (("runner", dict(prefix_caching=True)),
                     ("int8", dict(kv_dtype="int8")),
                     ("seq4", dict(seq_shards=cs.SEQ_SHARDS)),
                     ("pressure_swap", dict(num_blocks=cs.PRESSURE_BLOCKS,
                                            preempt_policy="swap")),
                     ("pressure_recompute", dict(num_blocks=cs.PRESSURE_BLOCKS,
                                                 preempt_policy="recompute"))):
        toks, stats, launches, summary = cs.serve_mix(torch, cfg, params, counters,
                                                      hook=keep_ticks, **kw)
        reqs = sorted(ticks.pop("eng")._reqs.values(), key=lambda r: r.rid)
        clock = [(r.submit_tick, r.first_tick, r.finish_tick) for r in reqs]
        out["engines"][name] = dict(
            tokens_sha256=hashlib.sha256(json.dumps(toks, sort_keys=True).encode())
            .hexdigest(),
            ticks_sha256=hashlib.sha256(json.dumps(clock).encode()).hexdigest(),
            **{k: stats[k] for k in ("prefill_dispatches", "decode_dispatches", "ticks",
                                     "preemptions", "preempt_swaps",
                                     "preempt_recomputes", "prefix_hit_tokens")},
            launches=launches, tok_s=summary["tok_s"], wall_s=summary["wall_s"])
        print(f"[schedule {args.tag}] {name}: {out['engines'][name]}", flush=True)
    dest = ROOT / "chiprun_out" / "schedule"
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"{args.tag}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
