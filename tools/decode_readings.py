#!/usr/bin/env python3
"""Readings of the flash-decoding kernel of one source tree on the card.

    python3 tools/decode_readings.py [--src SRC] [--tag NAME] [--repeats N] [--sweep]

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``), so
that one call can take readings of a checkout and of its parent (unpacked
with ``git archive``) in turns: parent, change, change, parent.  At
``chip_smoke.py``'s shapes in bf16, 8 sequences of the same random lengths
in [1, 1024]: row 1, stablelm-1.6b's q [8, 32, 64] over a [32, 513, 16, 64]
pool through tables [8, 64]; 1q, the same pool quantized to int8; 1h,
zamba2-7b's 32 heads of 112; 1o, olmoe-1b-7b's 16 heads of 128; 1g,
minitron-4b's 24 heads over 8 kv heads of 128; and the dense slab [8, 1024,
KvH, D] at rows 7 (stablelm), 7o, 7h, and 7g (granite-3-2b's 32 heads over
8 kv heads of 64).  Each is held to its plain version (``chip_smoke.py``'s
DECODE_TOL and DECODE_REL; int8: Q8_BF16_TOL and Q8_REL), timed ``N`` times
with the L2 flushed before each launch (``chip_smoke.py``'s Timer) and ``N``
times with the inputs left in L2, beside an empty launch's time under both
timers, and once at length 1 and once at length 0 for every sequence
(``len1_ms``, ``len0_ms``: the fixed cost without the walk, and without
its one copy); the row keeps every reading, which form took it
(from the tree's launch counters), and a hash of its output bits.  Rows
1h, 1o and 1g are also read at shapes off the serve mixes: one sequence
with all 1024 keys live (``-b1``), one sequence of 32768 keys (``-b1l``,
DECODE_32K's cache length) and 8 sequences of random lengths up to 32768
(``-32k``).  The paged rows also time SDPA over the K/V gathered
beforehand into a slab under the same key mask (``sdpa_slab_ms``;
``enable_gqa`` at G > 1).  ``--sweep`` (a tree with the tensor-core form)
times each of its rows again at splits 1 / 2 / 3 / 4 / 6 / 8.  Prints one
JSON line and writes it to ``chiprun_out/decode/<tag>.json``; exits
non-zero if a row misses its hold.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# row -> (source, H, KvH, D, sequences, keys a sequence); one sequence has
# every key live, several random lengths in [1, keys]
ROWS = {"1": ("pool", 32, 32, 64, 8, 1024), "1q": ("int8", 32, 32, 64, 8, 1024),
        "1h": ("pool", 32, 32, 112, 8, 1024), "1o": ("pool", 16, 16, 128, 8, 1024),
        "1g": ("pool", 24, 8, 128, 8, 1024), "7": ("slab", 32, 32, 64, 8, 1024),
        "7o": ("slab", 16, 16, 128, 8, 1024), "7h": ("slab", 32, 32, 112, 8, 1024),
        "7g": ("slab", 32, 8, 64, 8, 1024)}
for _r, _h, _kvh, _d in (("1h", 32, 32, 112), ("1o", 16, 16, 128), ("1g", 24, 8, 128)):
    ROWS.update({f"{_r}-b1": ("pool", _h, _kvh, _d, 1, 1024),
                 f"{_r}-b1l": ("pool", _h, _kvh, _d, 1, 32768),
                 f"{_r}-32k": ("pool", _h, _kvh, _d, 8, 32768)})
BS = 16


class WarmTimer:
    """``chip_smoke.Timer`` without the flush: the inputs stay in L2."""

    def __init__(self, torch, timer):
        self.timer = timer
        self.timer.flush = torch.empty(0, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20):
        return self.timer(fn, iters=iters)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("decode_readings: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _build, _paged
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    _build.load()
    timer = cs.Timer(torch)
    warm = WarmTimer(torch, cs.Timer(torch))
    bf = torch.bfloat16
    has_tc = hasattr(kda, "tc_launches")
    out = dict(card=smi, tag=args.tag, src=args.src, rows={},
               empty_launch_ms=timer(lambda: torch.cuda._sleep(1)),
               empty_launch_warm_ms=warm(lambda: torch.cuda._sleep(1)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    failed = []
    for name, (source, h, kvh, hd, nseq, keys) in ROWS.items():
        mb = keys // BS
        if nseq == 1:
            lens = torch.full((1,), keys, device="cuda", dtype=torch.int32)
        else:
            lens = torch.randint(1, keys + 1, (nseq,), device="cuda", dtype=torch.int32,
                                 generator=torch.Generator(device="cuda").manual_seed(5))
        live = int(lens.sum())
        valid = torch.arange(keys, device="cuda")[None, :] < lens[:, None]
        gen = torch.Generator(device="cuda").manual_seed(7)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(bf)

        q = randn(nseq, h, hd)
        tol, rel = cs.DECODE_TOL, cs.DECODE_REL
        gathered = None
        if source == "slab":
            k, v = randn(nseq, mb * BS, kvh, hd), randn(nseq, mb * BS, kvh, hd)

            def fn(q=q, k=k, v=v, ln=lens):
                return kda.decode_attention(q, k, v, ln)

            def plain(q=q, k=k, v=v):
                return ref.decode_attention(q, k, v, lengths=lens)
        else:
            nb = 1 + nseq * mb
            kp, vp = randn(kvh, nb, BS, hd), randn(kvh, nb, BS, hd)
            tables = (torch.randperm(nb - 1, generator=gen, device="cuda")[:nseq * mb]
                      + 1).to(torch.int32).reshape(nseq, mb).contiguous()
            kw = {}
            if source == "int8":
                kp, ks = cs.quantize_pages(torch, kp)
                vp, vs = cs.quantize_pages(torch, vp)
                kw = dict(k_scales=ks, v_scales=vs)
                tol, rel = cs.Q8_BF16_TOL, cs.Q8_REL
            else:
                gathered = (ref.gather_pages(kp, tables), ref.gather_pages(vp, tables))

            def fn(q=q, kp=kp, vp=vp, tables=tables, kw=kw, ln=lens):
                return kda.paged_decode_attention(q, kp, vp, tables, ln, **kw)

            def plain(q=q, kp=kp, vp=vp, tables=tables, kw=kw):
                return ref.paged_decode_attention(q, kp, vp, tables, lengths=lens, **kw)
        n_tc = kda.tc_launches if has_tc else 0
        got = fn()
        form = "tc" if has_tc and kda.tc_launches > n_tc else "cuda"
        want = plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = (bool(torch.isfinite(got.float()).all())
              and torch.allclose(got.float(), want.float(), **tol)
              and cs.rel_err(torch, got, want) <= rel)
        if not ok:
            failed.append(name)
        kv_bytes = (1 if source == "int8" else 2) * kvh * hd * 2
        nbytes = 2 * q.numel() * 2 + live * kv_bytes + (
            nseq * mb * 4 if source != "slab" else nseq * 4)
        bound_ms, _ = cs.bound(nbytes, 4 * h * hd * live)
        row = dict(form=form, max_abs_err=err, held=ok, bound_ms=bound_ms,
                   bits=hashlib.sha256(got.view(torch.int16).cpu().numpy().tobytes())
                   .hexdigest()[:16],
                   ms=[timer(fn) for _ in range(args.repeats)],
                   warm_ms=[warm(fn) for _ in range(args.repeats)])
        # every sequence one key long, then none: the kernel's fixed cost
        # (the launch, the table, one copy, the merge) without its walk, and
        # without the copy
        ones = torch.ones_like(lens)
        row["len1_ms"] = timer(lambda: fn(ln=ones))
        row["len0_ms"] = timer(lambda: fn(ln=ones * 0))
        if gathered is not None:
            ks_, vs_ = (t.transpose(1, 2).contiguous() for t in gathered)
            qs, mask = q[:, :, None], valid[:, None, None, :]
            gqa = dict(enable_gqa=True) if h != kvh else {}
            row["sdpa_slab_ms"] = timer(lambda: sdpa(qs, ks_, vs_, attn_mask=mask, **gqa))
        if args.sweep and form == "tc":
            row["sweep"] = sweep(kda, _paged, fn, timer)

        out["rows"][name] = row
        del q, fn, plain, got, want, gathered
        torch.cuda.empty_cache()
        cs.log(f"{args.tag} row {name} ({form}): "
               + ", ".join(f"{m:.4f}" for m in row["ms"]) + " ms; in L2 "
               + ", ".join(f"{m:.4f}" for m in row["warm_ms"])
               + f" ms; bound {bound_ms:.4f}; max|err| {err:.3g}"
               + (f"; sdpa over a slab {row['sdpa_slab_ms']:.4f}" if "sdpa_slab_ms" in row
                  else "") + ("" if ok else " MISSED ITS HOLD"))
    dest = ROOT / "chiprun_out" / "decode"
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"{args.tag}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    if failed:
        sys.exit(f"decode_readings: rows {failed} missed their holds")


def sweep(kda, _paged, fn, timer):
    """The tensor-core form's time at forced splits (ms by n_split), its own
    plan restored after."""
    planned = kda._tc_plan
    res = {}
    try:
        for n in (1, 2, 3, 4, 6, 8):
            def forced(q_, kvh_, keys_, grain_, n=n):
                p = planned(q_, kvh_, keys_, grain_)
                split = -(-(-(-keys_ // n)) // grain_) * grain_
                n_split = -(-keys_ // split)
                return _paged.DecodePlan(keys_, n_split, split, p.row_tiles,
                                         (n_split, *p.grid[1:]), (n_split, 1, 1))
            kda._tc_plan = forced
            res[str(n)] = timer(fn)
    finally:
        kda._tc_plan = planned
    return res


if __name__ == "__main__":
    main()
