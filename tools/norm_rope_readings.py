#!/usr/bin/env python3
"""Readings of the rmsnorm and rope kernels of one source tree on the card.

    python3 tools/norm_rope_readings.py [--src SRC] [--tag NAME]

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``), so
that one call can take readings of a checkout and of its parent (unpacked
with ``git archive``) in turns.  At the serving path's full-width
stablelm-1.6b shapes in bf16 (the rows of PERF.md): rmsnorm [512, 2048]
(row 3), its Curry-ALU form with 3 rounds (3c), rmsnorm [8, 2048] (3d);
rope on q [1, 512, 32, 64] (4), on q and k of that shape (4qk) and on q and
k [8, 1, 32, 64] (4d); and at granite-3-2b's training shapes, rmsnorm
[8192, 2048] (3t) and rope on q [2, 4096, 32, 64] and k [2, 4096, 8, 64]
(4t).  q and k go through ``rope.apply_rope_qk`` where the
tree has it, else through two ``apply_rope`` launches, as that tree's model
launches them.  Each is held against its plain version (max |err|, the
largest excess of |err| over one bf16 ulp relative, the relative norm
error; logged, not gated) and timed with ``chip_smoke.py``'s Timer beside
the plain version and an empty launch (``torch.cuda._sleep(1)``); on a
tree with the launch plans, the kernels are also timed with their plans
forced (``plan_sweep``).  Prints one JSON line and writes it to
``chiprun_out/norm_rope/<tag>.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ULP = 2 ** -7                   # one bf16 ulp, relative


def plan_sweep(torch, timer, krn, krope, randn, eps, theta):
    """Times of the redesigned kernels with their plans forced (logged, not
    gated; what the plans' constants are chosen from): rmsnorm [512, 2048]
    and [8192, 2048] at each row width and block size, rope's q and k at a
    prefill chunk by tile and at decode by head split."""
    from repro_torch.kernels import _build

    n_sms = _build.n_sms(torch.device("cuda"))
    planned_rms, planned_rope = krn.plan, krope.plan
    sweep = {}
    try:
        w = randn(2048)
        for rows in (512, 8192):
            x = randn(rows, 2048)
            for t in (64, 128, 256):
                for threads in (128, 256, 512):
                    if threads < t:
                        continue
                    per = next(p for p in krn.PER_THREAD if p * t >= 256)
                    grid = min(-(-rows // (threads // t)), n_sms * krn.BLOCKS_PER_SM)
                    forced = krn.Plan("vector", per, t, threads, grid)
                    krn.plan = lambda *a, forced=forced: forced
                    sweep[f"rmsnorm {rows} rows, {t} threads a row, blocks of "
                          f"{threads}"] = timer(lambda: krn.rmsnorm(x, w, eps))
        krn.plan = planned_rms
        x = randn(512, 2048)
        sweep["rmsnorm 512 rows, planned"] = timer(lambda: krn.rmsnorm(x, w, eps))
        q, k = randn(1, 512, 32, 64), randn(1, 512, 32, 64)
        pos = torch.arange(512, dtype=torch.int32, device="cuda")[None]
        for tile in (1, 2, 4, 8):
            forced = krope.Plan("vector", 4, tile, 64, 256,
                                (min(-(-512 // tile), n_sms * krope.BLOCKS_PER_SM), 1))
            krope.plan = lambda *a, forced=forced, **kw: forced
            sweep[f"rope q+k 512 tokens, tile {tile}"] = timer(
                lambda: krope.apply_rope_qk(q, k, pos, theta))
        qd, kd = randn(8, 1, 32, 64), randn(8, 1, 32, 64)
        posd = torch.arange(8, dtype=torch.int32, device="cuda")[:, None].contiguous()
        for hpb in (64, 16, 4):
            forced = krope.Plan("vector", 4, 1, hpb, min(256, hpb * 8 // 32 * 32 or 32),
                                (8, 64 // hpb))
            krope.plan = lambda *a, forced=forced, **kw: forced
            sweep[f"rope q+k decode, {hpb} heads a block"] = timer(
                lambda: krope.apply_rope_qk(qd, kd, posd, theta))
    finally:
        krn.plan, krope.plan = planned_rms, planned_rope
    for name, ms in sweep.items():
        print(f"[norm_rope sweep] {name}: {ms:.4f} ms", flush=True)
    return sweep


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("norm_rope_readings: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.kernels import rope as krope

    cfg = get_config("stablelm-1.6b")
    d, h, kvh, hd, eps, theta = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.hd, cfg.norm_eps, cfg.rope_theta)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    if hasattr(krope, "apply_rope_qk"):
        qk_kernel, qk_launches = krope.apply_rope_qk, 1
    else:
        def qk_kernel(q, k, pos, theta):
            return krope.apply_rope(q, pos, theta), krope.apply_rope(k, pos, theta)
        qk_launches = 2

    def qk_plain(q, k, pos):
        return ref.apply_rope(q, pos, theta), ref.apply_rope(k, pos, theta)

    c, qoff, slots = 512, 256, 8
    x3, x3d, w = randn(1, c, d), randn(slots, d), randn(d)
    q, k = randn(1, c, h, hd), randn(1, c, kvh, hd)
    qd, kd = randn(slots, 1, h, hd), randn(slots, 1, kvh, hd)
    pos = (qoff + torch.arange(c, dtype=torch.int32, device="cuda"))[None]
    posd = torch.randint(1, 1024, (slots, 1), generator=gen, device="cuda",
                         dtype=torch.int32)
    # granite-3-2b's training shapes: rmsnorm [8192, 2048], q [2, 4096, 32,
    # 64] and k [2, 4096, 8, 64]
    xt = randn(8192, d)
    qt, kt = randn(2, 4096, 32, hd), randn(2, 4096, 8, hd)
    post = torch.arange(4096, dtype=torch.int32, device="cuda")[None].expand(2, 4096)
    cases = {
        "3": (lambda: krn.rmsnorm(x3, w, eps), lambda: ref.rmsnorm(x3, w, eps), 1),
        "3c": (lambda: krn.rmsnorm(x3, w, eps, curry_rounds=3),
               lambda: ref.rmsnorm(x3, w, eps, curry_rounds=3), 1),
        "3d": (lambda: krn.rmsnorm(x3d, w, eps), lambda: ref.rmsnorm(x3d, w, eps), 1),
        "4": (lambda: krope.apply_rope(q, pos, theta),
              lambda: ref.apply_rope(q, pos, theta), 1),
        "4qk": (lambda: qk_kernel(q, k, pos, theta), lambda: qk_plain(q, k, pos),
                qk_launches),
        "4d": (lambda: qk_kernel(qd, kd, posd, theta), lambda: qk_plain(qd, kd, posd),
               qk_launches),
        "3t": (lambda: krn.rmsnorm(xt, w, eps), lambda: ref.rmsnorm(xt, w, eps), 1),
        "4t": (lambda: qk_kernel(qt, kt, post, theta), lambda: qk_plain(qt, kt, post),
               qk_launches),
    }
    timer = cs.Timer(torch)
    one = torch.zeros(1, device="cuda")
    out = dict(tag=args.tag, src=args.src, card=cs.nvidia_smi_line(),
               floor_ms=timer(lambda: torch.cuda._sleep(1)),
               one_element_ms=timer(lambda: one.add_(1.0)), rows={})
    for name, (kernel, plain, launches) in cases.items():
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        errs = [(g.float() - w_.float()).abs() for g, w_ in zip(got, want)]
        out["rows"][name] = dict(
            launches=launches,
            max_abs_err=max(float(e.max()) for e in errs),
            excess_over_ulp=max(float((e - ULP * w_.float().abs()).max())
                                for e, w_ in zip(errs, want)),
            rel_err=max(cs.rel_err(torch, g, w_) for g, w_ in zip(got, want)),
            ms=timer(kernel), plain_ms=timer(plain))
        del got, want, errs
    if hasattr(krn, "plan"):
        out["sweep"] = plan_sweep(torch, timer, krn, krope, randn, eps, theta)
    out_dir = ROOT / "chiprun_out" / "norm_rope"
    out_dir.mkdir(parents=True, exist_ok=True)
    line = json.dumps(out)
    (out_dir / f"{args.tag}.json").write_text(line + "\n")
    for name, r in out["rows"].items():
        print(f"[norm_rope {args.tag}] row {name}: {r['ms']:.4f} ms ({r['launches']} "
              f"launch(es)), plain {r['plain_ms']:.4f}, max|err| {r['max_abs_err']:.3g}, "
              f"excess over 1 ulp {r['excess_over_ulp']:.3g}, rel {r['rel_err']:.3g}",
              flush=True)
    print(f"[norm_rope {args.tag}] empty launch {out['floor_ms']:.4f} ms, a one-element "
          f"add_ {out['one_element_ms']:.4f} ms; {out['card']}", flush=True)
    print(line, flush=True)


if __name__ == "__main__":
    main()
