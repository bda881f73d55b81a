#!/usr/bin/env python3
"""Readings of the silu_mul and rmsnorm-backward kernels of one source tree
on the card.

    python3 tools/swiglu_norm_bwd_readings.py [--src SRC] [--tag NAME]

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``), so
that one call can take readings of a checkout and of its parent (unpacked
with ``git archive``) in turns.  In bf16 (the rows of PERF.md): silu_mul on
stablelm-1.6b's prefill chunk [512, 5632] (row 5), its Curry-ALU form with
6 rounds (5c), decode's [8, 5632] (5d) and granite-3-2b's training hidden
[8192, 8192] (5t); the silu_mul backward at [8192, 8192] (5b); the Mamba2
backward at zamba2-7b's x [2, 4096, 112, 64] (8b); the rmsnorm backward on
8192 rows at widths 2048 (row 3b), 2560, 3584 and 7168.  Each is held
against its plain version (max |err|, the largest excess of |err| over one
bf16 ulp relative, the relative norm error; for the backward dx and dw
apart; logged, not gated), timed with ``chip_smoke.py``'s Timer beside the
plain version, an empty launch (``torch.cuda._sleep(1)``) and a one-element
``add_``, and its outputs hashed (sha256 of the bytes) on inputs made from
one seed, so two trees' bits can be compared.  The rmsnorm backward's two
launches (rows pass, column pass) are also timed apart with
``torch.profiler`` under the Timer's flush, and silu_mul's rows carry their
device time with the inputs left in L2 (``warm_ms``, back to back, as a
model's previous kernel leaves them).  On a tree with the launch
plans the kernels are also timed with their plans forced (``sweep``).
Prints one JSON line and writes it to
``chiprun_out/swiglu_norm_bwd/<tag>.json``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ULP = 2 ** -7                   # one bf16 ulp, relative
BWD_WIDTHS = (2048, 2560, 3584, 7168)
BWD_ROWS = 8192
SPLIT_ITERS = 20


def digest(torch, outs) -> str:
    """sha256 of the bytes of a tensor or a tuple of tensors, in order."""
    h = hashlib.sha256()
    for t in outs if isinstance(outs, tuple) else (outs,):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def errors(cs, torch, got, want) -> dict:
    err = (got.float() - want.float()).abs()
    return dict(max_abs_err=float(err.max()),
                excess_over_ulp=float((err - ULP * want.float().abs()).max()),
                rel_err=cs.rel_err(torch, got, want))


def launch_split(torch, timer, fn, fragments, flush=True) -> dict:
    """Mean device ms a call of the kernels whose names hold each fragment,
    from ``torch.profiler`` over SPLIT_ITERS calls, each after the Timer's
    L2 flush (``flush``) or back to back, the inputs left in L2 as a
    model's previous kernel leaves them."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(SPLIT_ITERS):
            if flush:
                timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(fragments, 0.0)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            for f in fragments:
                if f in ev.name:
                    out[f] += ev.time_range.elapsed_us() / 1e3 / SPLIT_ITERS
    return out


def sweep(torch, timer, ksw, krn, randn, eps):
    """Times of the redesigned kernels with their plans forced (logged, not
    gated; what the plans' constants are chosen from): silu_mul on its
    element and vector routes from decode's 8 rows to a chunk's 512 (timed
    and, with the inputs in L2, its device time), the vector route's waves
    at a training batch's hidden, the planned launches with the curry form
    beside them; the rmsnorm backward at two widths by block and threads an
    SM, each with its launches apart."""
    from repro_torch.kernels import _build

    n_sms = _build.n_sms(torch.device("cuda"))
    planned_silu, planned_bwd = ksw.plan, krn.bwd_plan
    out = {}
    try:
        # the element route against the vector route across the wave
        for rows in (8, 16, 32, 48, 64, 128, 512):
            g, u = randn(rows, 5632, scale=3.0), randn(rows, 5632)
            n = g.numel()
            for forced in (ksw.Plan("element", 256, -(-n // 256)),
                           ksw.Plan("vector", 256, -(-(n // 8) // 256))):
                ksw.plan = lambda *a, forced=forced: forced
                fn = lambda: ksw.silu_mul(g, u)  # noqa: E731
                out[f"silu_mul [{rows}, 5632] {forced.route}, grid {forced.grid}"] = dict(
                    ms=timer(fn), warm_ms=launch_split(torch, timer, fn, ("silu_mul",),
                                                       flush=False)["silu_mul"])
            ksw.plan = planned_silu
            del g, u
        # the vector route's waves at a training batch's hidden
        g, u = randn(8192, 8192, scale=3.0), randn(8192, 8192)
        wave = n_sms * 2048 // 256
        for waves in (1, 2, 4, 8, 16):
            forced = ksw.Plan("vector", 256, waves * wave)
            ksw.plan = lambda *a, forced=forced: forced
            out[f"silu_mul [8192, 8192] vector, grid {forced.grid}"] = timer(
                lambda: ksw.silu_mul(g, u))
        ksw.plan = planned_silu
        for rows, ff in ((8, 5632), (512, 5632), (8192, 8192)):
            gg, uu = g[:rows, :ff].contiguous(), u[:rows, :ff].contiguous()
            p = tuple(ksw.plan(gg.numel(), 2, True, n_sms))
            out[f"silu_mul [{rows}, {ff}] planned {p}"] = timer(lambda: ksw.silu_mul(gg, uu))
            out[f"silu_mul [{rows}, {ff}] planned {p}, 6 curry rounds"] = timer(
                lambda: ksw.silu_mul(gg, uu, curry_rounds=6))
            del gg, uu
        del g, u
        for d in (2048, 7168):
            x, w, dy = randn(BWD_ROWS, d), randn(d), randn(BWD_ROWS, d)
            base = planned_bwd(BWD_ROWS, d, 2, True, n_sms)
            for threads in (256, 512):
                if threads < base.row_threads:
                    continue
                for sm_threads in (1024, 2048):
                    groups = threads // base.row_threads
                    cap = n_sms * sm_threads // threads
                    rpb = -(-BWD_ROWS // min(-(-BWD_ROWS // groups), cap))
                    forced = krn.BwdPlan("vector", base.per, base.row_threads, threads,
                                         -(-BWD_ROWS // rpb), rpb)
                    krn.bwd_plan = lambda *a, forced=forced: forced
                    fn = lambda: krn.rmsnorm_bwd(x, w, dy, eps)  # noqa: E731
                    split = launch_split(torch, timer, fn, ("rmsnorm_bwd_rows",
                                                            "rmsnorm_bwd_cols"))
                    out[f"rmsnorm_bwd [{BWD_ROWS}, {d}] {threads} threads, "
                        f"{sm_threads} an SM, grid {forced.grid}"] = dict(ms=timer(fn), **split)
            krn.bwd_plan = planned_bwd
            del x, w, dy
    finally:
        ksw.plan, krn.bwd_plan = planned_silu, planned_bwd
    for name, r in out.items():
        print(f"[swiglu_norm_bwd sweep] {name}: {r}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("swiglu_norm_bwd_readings: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_chunk as kmamba
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.kernels import swiglu as ksw
    from repro_torch.launch.trace_train import one_card_config

    eps = get_config("granite-3-2b").norm_eps
    gen = torch.Generator(device="cuda").manual_seed(9)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    timer = cs.Timer(torch)
    one = torch.zeros(1, device="cuda")
    out = dict(tag=args.tag, src=args.src, card=cs.nvidia_smi_line(),
               floor_ms=timer(lambda: torch.cuda._sleep(1)),
               one_element_ms=timer(lambda: one.add_(1.0)), rows={})

    def row(name, kernel, plain, nbytes, outputs=("out",)):
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        r = dict(hash=digest(torch, got), rerun_equal=digest(torch, kernel()) == digest(torch, got),
                 **{o: errors(cs, torch, g, w) for o, g, w in zip(outputs, got, want)})
        del got, want
        r.update(ms=timer(kernel), plain_ms=timer(plain, iters=5),
                 bound_ms=nbytes / cs.PEAK_BYTES_S * 1e3)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        out["rows"][name] = r
        print(f"[swiglu_norm_bwd {args.tag}] row {name}: {r}", flush=True)

    for name, rows, ff, rounds in (("5", 512, 5632, 0), ("5c", 512, 5632, 6),
                                   ("5d", 8, 5632, 0), ("5t", 8192, 8192, 0)):
        g, u = randn(rows, ff, scale=3.0), randn(rows, ff)
        fn = lambda: ksw.silu_mul(g, u, curry_rounds=rounds)  # noqa: E731
        row(name, fn, lambda: ref.silu_mul(g, u, curry_rounds=rounds), 3 * g.numel() * 2)
        out["rows"][name]["warm_ms"] = launch_split(torch, timer, fn, ("silu_mul",),
                                                    flush=False)["silu_mul"]
        del g, u
    g, u, dy = randn(8192, 8192, scale=3.0), randn(8192, 8192), randn(8192, 8192)
    row("5b", lambda: ksw.silu_mul_bwd(g, u, dy), lambda: ref.silu_mul_bwd(g, u, dy),
        5 * g.numel() * 2, outputs=("dgate", "dup"))
    del g, u, dy
    x, dt, A, B, C, dy = cs.mamba_inputs(torch, one_card_config("zamba2-7b"), seed=6)
    _, _, states = kmamba.mamba2_fwd(x, dt, A, B, C, save_states=True)
    got = kmamba.mamba2_bwd(x, dt, A, B, C, dy, states)
    torch.cuda.synchronize()
    out["rows"]["8b"] = dict(hash=digest(torch, got), rerun_equal=digest(
        torch, kmamba.mamba2_bwd(x, dt, A, B, C, dy, states)) == digest(torch, got),
        ms=timer(lambda: kmamba.mamba2_bwd(x, dt, A, B, C, dy, states), iters=10))
    print(f"[swiglu_norm_bwd {args.tag}] row 8b: {out['rows']['8b']}", flush=True)
    del x, dt, A, B, C, dy, states, got
    for d in BWD_WIDTHS:
        x, w, dy = randn(BWD_ROWS, d), randn(d), randn(BWD_ROWS, d)
        name = "3b" if d == 2048 else f"3b-{d}"
        fn = lambda: krn.rmsnorm_bwd(x, w, dy, eps)  # noqa: E731
        row(name, fn, lambda: ref.rmsnorm_bwd(x, w, dy, eps),
            3 * x.numel() * 2 + 2 * d * 2, outputs=("dx", "dw"))
        out["rows"][name]["launches_apart"] = launch_split(
            torch, timer, fn, ("rmsnorm_bwd_rows", "rmsnorm_bwd_cols"))
        print(f"[swiglu_norm_bwd {args.tag}] row {name} launches apart: "
              f"{out['rows'][name]['launches_apart']}", flush=True)
        del x, w, dy
    torch.cuda.empty_cache()
    if hasattr(ksw, "plan") and not args.no_sweep:
        out["sweep"] = sweep(torch, timer, ksw, krn, randn, eps)
    out_dir = ROOT / "chiprun_out" / "swiglu_norm_bwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    line = json.dumps(out)
    (out_dir / f"{args.tag}.json").write_text(line + "\n")
    print(f"[swiglu_norm_bwd {args.tag}] empty launch {out['floor_ms']:.4f} ms, a "
          f"one-element add_ {out['one_element_ms']:.4f} ms; {out['card']}", flush=True)
    print(line, flush=True)


if __name__ == "__main__":
    main()
