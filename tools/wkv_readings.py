#!/usr/bin/env python3
"""Readings of the wkv6 kernels of one source tree on the card.

    python3 tools/wkv_readings.py [--src SRC] [--tag NAME]

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``), so
that one call can take readings of a checkout and of its parent (unpacked
with ``git archive``) in turns; the inputs come from this checkout's
``chip_smoke.py`` (``rwkv_inputs``, ``carried_state``), the same in every
tree.  In bf16 at rwkv6-3b's full width: the training forward with the
chunk-entry states (row 9, r, k, v [2, 4096, 40, 64]) and its backward
(9b); the zero-state forward at the serving prefill chunk [1, 512, 40, 64]
(``9-chunk``, what the dense-slab prefill launches) and, on a tree whose
forward takes a carried state, the forward from S0 at that chunk (row
9s).  Each is timed with ``chip_smoke.py``'s Timer and its outputs hashed
(sha256 of the bytes), so two trees' bits can be compared; 9s is also held
against its plain version (max |err|, logged, not gated).  Prints one JSON
line and writes it to ``chiprun_out/wkv/<tag>.json``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("wkv_readings: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_chunk as kwkv

    cfg = get_config("rwkv6-3b")
    timer = cs.Timer(torch)
    out = dict(tag=args.tag, src=args.src, card=cs.nvidia_smi_line(), rows={})

    def row(name, fn, iters=20):
        got = fn()
        torch.cuda.synchronize()
        r = dict(hash=cs.digest(torch, got), rerun_equal=cs.digest(torch, fn()) == cs.digest(
            torch, got), ms=timer(fn, iters=iters))
        out["rows"][name] = r
        print(f"[wkv {args.tag}] row {name}: {r}", flush=True)
        return got

    r, k, v, w, u, do = cs.rwkv_inputs(torch, cfg, seed=4)
    _, _, states = row("9", lambda: kwkv.rwkv6_fwd(r, k, v, w, u, save_states=True),
                       iters=10)
    row("9b", lambda: kwkv.rwkv6_bwd(r, k, v, w, u, do, states), iters=10)
    del r, k, v, w, u, do, states
    r, k, v, w, u, s0 = cs.carried_state(torch, cfg, seed=21)
    row("9-chunk", lambda: kwkv.rwkv6_fwd(r, k, v, w, u)[:2])
    if "s0" in inspect.signature(kwkv.rwkv6_fwd).parameters:
        got = row("9s", lambda: kwkv.rwkv6_fwd(r, k, v, w, u, s0=s0)[:2])
        want = ref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0, chunk=kwkv.TC_CHUNK)
        out["rows"]["9s"]["max_abs_err"] = [float((g.float() - x.float()).abs().max())
                                            for g, x in zip(got, want)]
    out_dir = ROOT / "chiprun_out" / "wkv"
    out_dir.mkdir(parents=True, exist_ok=True)
    line = json.dumps(out)
    (out_dir / f"{args.tag}.json").write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
