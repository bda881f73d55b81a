#!/usr/bin/env python3
"""Readings of the Mamba2 scan kernels of one source tree on the card.

    python3 tools/mamba_readings.py [--src SRC] [--tag NAME]

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``), so
that one call can take readings of a checkout and of its parent (unpacked
with ``git archive``) in turns; the inputs come from this checkout's
``chip_smoke.py`` (``mamba_inputs``, ``mamba_carried_state``), the same in
every tree.  In bf16 at zamba2-7b's full width: the training forward with
the chunk-entry states (row 8, x [2, 4096, 112, 64]) and its backward
(8b); the zero-state forward at the serving prefill chunk [1, 512, 112, 64]
(``8-chunk``, what the dense-slab prefill launches) and, on a tree whose
forward takes a carried state, the forward from h0 at that chunk (row 8s).
Each is timed with ``chip_smoke.py``'s Timer and its outputs hashed (sha256
of the bytes), so two trees' bits can be compared; 8s is also held against
its plain version (max |err|, logged, not gated).  Prints one JSON line and
writes it to ``chiprun_out/mamba/<tag>.json``.
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
        raise SystemExit("mamba_readings: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_chunk as kmamba
    from repro_torch.kernels import ref

    cfg = get_config("zamba2-7b")
    timer = cs.Timer(torch)
    out = dict(tag=args.tag, src=args.src, card=cs.nvidia_smi_line(), rows={})

    def row(name, fn, iters=20):
        got = fn()
        torch.cuda.synchronize()
        r = dict(hash=cs.digest(torch, got), rerun_equal=cs.digest(torch, fn()) == cs.digest(
            torch, got), ms=timer(fn, iters=iters))
        out["rows"][name] = r
        print(f"[mamba {args.tag}] row {name}: {r}", flush=True)
        return got

    x, dt, A, B, C, dy = cs.mamba_inputs(torch, cfg, seed=6)
    _, _, states = row("8", lambda: kmamba.mamba2_fwd(x, dt, A, B, C, save_states=True),
                       iters=10)
    row("8b", lambda: kmamba.mamba2_bwd(x, dt, A, B, C, dy, states), iters=10)
    del x, dt, A, B, C, dy, states
    x, dt, A, B, C, h0 = cs.mamba_carried_state(torch, cfg, seed=25)
    row("8-chunk", lambda: kmamba.mamba2_fwd(x, dt, A, B, C)[:2])
    if "h0" in inspect.signature(kmamba.mamba2_fwd).parameters:
        got = row("8s", lambda: kmamba.mamba2_fwd(x, dt, A, B, C, h0=h0)[:2])
        want = ref.mamba2_scan(x, dt, A, B, C, h0=h0, chunk=kmamba.CHUNK)
        out["rows"]["8s"]["max_abs_err"] = [float((g.float() - w.float()).abs().max())
                                            for g, w in zip(got, want)]
    out_dir = ROOT / "chiprun_out" / "mamba"
    out_dir.mkdir(parents=True, exist_ok=True)
    line = json.dumps(out)
    (out_dir / f"{args.tag}.json").write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
