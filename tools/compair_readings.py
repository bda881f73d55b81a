#!/usr/bin/env python3
"""Phase 29 of ``chip_smoke.py`` alone on the card.

    python3 tools/compair_readings.py

Builds the kernels from this checkout's sources, then runs ``chip_smoke.py``'s
phase 29 (``compair_phase``): the ISA's Machine in f32 against the CPU and
``torch.softmax`` / the rope kernel, the planner's rooflines against
``torch.matmul``, row 2w (the paged prefill's window) in bf16, f32 and int8
beside row 2, the windowed model path, and internvl2-2b from synthetic
embeddings.  Every hold and control of the phase applies; a failure exits
non-zero.  Prints the card line and one JSON line (row 2w and the phase's
results), and writes them to ``chiprun_out/compair/readings.json``.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("compair_readings: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    _build.load()
    cs.log(f"build: {_build.build_info['seconds']:.1f} s")
    row, res = cs.compair_phase(torch, cs.Timer(torch))
    out = dict(card=smi, row_2w=row, **res)
    dest = ROOT / "chiprun_out" / "compair"
    dest.mkdir(parents=True, exist_ok=True)
    (dest / "readings.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
