#!/usr/bin/env python3
"""Readings of the paged prefill kernel of one source tree on the card.

    python3 tools/prefill_readings.py [--src SRC] [--tag NAME] [--repeats N]

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``), so
that one call can take readings of a checkout and of its parent (unpacked
with ``git archive``) in turns: parent, change, change, parent.  At
``chip_smoke.py``'s shapes in bf16: row 2, stablelm-1.6b's 512-row chunk q
[1, 512, 32, 64] at offset 256 over a [32, 513, 16, 64] pool; 2q, the same
over the pool quantized to int8; 2h, zamba2-7b's head dim 112 (32 heads);
2o, olmoe-1b-7b's 16 heads of 128; and, on a tree whose kernel takes a
window, 2w at windows 64, 256 and 700.  Each is held against its plain
version (max |err| logged, not gated) and timed ``N`` times with
``chip_smoke.py``'s Timer (L2 flushed before each launch, the device kept
behind the host); the row keeps every reading.  Prints one JSON line and
writes it to ``chiprun_out/prefill/<tag>.json``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = {"2": (32, 64), "2q": (32, 64), "2h": (32, 112), "2o": (16, 128)}
WINDOWS = (64, 256, 700)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("prefill_readings: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _build
    from repro_torch.kernels import prefill_attention as kpf
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    _build.load()
    timer = cs.Timer(torch)
    has_window = "window" in inspect.signature(kpf.paged_prefill_attention).parameters
    c, qoff, bs, mb = 512, 256, 16, 64
    nb = 1 + 8 * mb
    out = dict(card=smi, tag=args.tag, src=args.src, rows={})
    for name, (h, hd) in ROWS.items():
        gen = torch.Generator(device="cuda").manual_seed(7)
        kp = torch.randn((h, nb, bs, hd), generator=gen, device="cuda").to(torch.bfloat16)
        vp = torch.randn((h, nb, bs, hd), generator=gen, device="cuda").to(torch.bfloat16)
        table = (torch.randperm(nb - 1, generator=gen, device="cuda")[:mb] + 1).to(torch.int32)
        q = torch.randn((1, c, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
        kw = dict(q_offset=qoff, length=c)
        if name == "2q":
            kp, ks = cs.quantize_pages(torch, kp)
            vp, vs = cs.quantize_pages(torch, vp)
            kw.update(k_scales=ks, v_scales=vs)
        cases = [(name, {})]
        if has_window and name == "2":
            cases += [(f"2w_{w}", dict(window=w)) for w in WINDOWS]
        for tag, extra in cases:
            def fn(extra=extra):
                return kpf.paged_prefill_attention(q, kp, vp, table, **kw, **extra)
            err = float((fn().float() - ref.paged_prefill_attention(
                q, kp, vp, table, **kw, **extra).float()).abs().max())
            ms = [timer(fn) for _ in range(args.repeats)]
            out["rows"][tag] = dict(ms=ms, max_abs_err=err)
            cs.log(f"{args.tag} row {tag}: " + ", ".join(f"{m:.4f}" for m in ms)
                   + f" ms, max|err| {err:.3g}")
    dest = ROOT / "chiprun_out" / "prefill"
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"{args.tag}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
