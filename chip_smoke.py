#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100.  Phases:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every kernel of the serving path from ``src/repro_torch/kernels/
   csrc`` with nvcc for sm_90a, with the ptxas register/shared-memory report;
3. kernels: each of the five kernels at the full-width stablelm-1.6b shapes
   of the serving path, in bf16, held against its plain PyTorch version on
   the card (stated tolerance) and timed with CUDA events beside the plain
   version, the least time the card could take, and a library call where one
   computes the same function;
4. parity: the reduced stablelm-1.6b model on the card (CUDA kernels)
   against the CPU (plain versions) at fp32;
5. serve: stablelm-1.6b at full width and depth (random bf16 weights from a
   seed) serving 16 requests through ``repro_torch.serve.ServeEngine``; the
   kernels' launch counters are zeroed just before and read just after,
   and every kernel must have run; a rerun with prefix caching off must give
   token-identical greedy outputs.

Prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero without the last line; so does a run
with no CUDA device or outside a checkout.  Long output (the full ptxas
report, the results) goes to ``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out" / "chip_smoke"

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and dense
# bf16 tensor-core FLOP/s; a card below its 700 W limit runs slower
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
BF16_TOL = dict(rtol=2 ** -6, atol=1e-2)      # two bf16 ulps, plus 1e-2
ATTN_TOL = dict(rtol=2e-2, atol=2e-2)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

class Timer:
    """Mean device time of ``fn`` with CUDA events around each call and the
    50 MB L2 flushed before each one (the serving path finds a layer's pages
    and weights cold).  A sleep kernel first puts the device ~50 ms behind
    the host, so every timed call is queued before the device reaches it and
    the events see device time, not the host's time to enqueue the call."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)         # ~50 ms of device clock cycles
        events = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(nbytes: float, flops: float):
    """Least time (ms) for the work and the resource that sets it."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def kernel_phase(torch, timer, cfg):
    """Each kernel at the serving path's full-width shapes, bf16."""
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import prefill_attention as kpf
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.kernels import rope as krope
    from repro_torch.kernels import swiglu as ksw

    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    d, h, kvh, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    c, qoff = 512, 256                 # a 512-row prefill chunk at offset 256
    slots, bs, mb = 8, 16, 64          # decode: 8 slots, max_seq 1024
    nb = 1 + slots * mb
    rows = []

    def record(name, source, replaces, kernel, plain, tol, nbytes, flops,
               library=None, note=""):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got.float()).all()):
            fail(f"{name}: non-finite kernel output")
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), **tol):
            fail(f"{name}: kernel and plain version disagree, max |err| {err} "
                 f"(tolerance {tol})")
        ms, plain_ms = timer(kernel), timer(plain)
        lib_ms = timer(library) if library is not None else None
        bms, by = bound(nbytes, flops)
        log(f"kernel {name}: max|err| {err:.3g} (tol {tol}{note}), "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by})" + (f", library {lib_ms:.4f} ms" if lib_ms else ""))
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=0, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=lib_ms))

    csrc = "src/repro_torch/kernels/csrc/"
    # rmsnorm on a prefill chunk's activations [1, 512, 2048]
    x, w = randn(1, c, d), randn(d)
    record("rmsnorm", csrc + "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:51",
           lambda: krn.rmsnorm(x, w, cfg.norm_eps),
           lambda: ref.rmsnorm(x, w, cfg.norm_eps), BF16_TOL,
           nbytes=2 * x.numel() * 2 + d * 2, flops=4 * x.numel(),
           library=lambda: torch.nn.functional.rms_norm(x, (d,), w, cfg.norm_eps))
    # rope on the chunk's queries [1, 512, 32, 64] at positions 256..767
    q = randn(1, c, h, hd)
    pos = (qoff + torch.arange(c, dtype=torch.int32, device=dev))[None]
    record("apply_rope", csrc + "rope.cu", "src/repro/kernels/rope.py:52",
           lambda: krope.apply_rope(q, pos, cfg.rope_theta),
           lambda: ref.apply_rope(q, pos, cfg.rope_theta), BF16_TOL,
           nbytes=2 * q.numel() * 2 + c * 4, flops=3 * q.numel(),
           note="; the TPU kernel forms 1/theta^(j/half) as exp(-ln theta "
                "j/half), the port follows the plain version")
    # silu_mul on the chunk's FFN hidden [1, 512, 5632]
    g, u = randn(1, c, ff, scale=3.0), randn(1, c, ff)
    record("silu_mul", csrc + "swiglu.cu", "src/repro/kernels/swiglu.py:59",
           lambda: ksw.silu_mul(g, u), lambda: ref.silu_mul(g, u), BF16_TOL,
           nbytes=3 * g.numel() * 2, flops=5 * g.numel(),
           note="; rounds silu(gate) to bf16 before the product as the plain "
                "version does (the TPU kernel keeps it in f32)")
    # decode attention: 8 slots, pages [32, 513, 16, 64], tables [8, 64]
    kp, vp = randn(kvh, nb, bs, hd), randn(kvh, nb, bs, hd)
    perm = torch.randperm(nb - 1, generator=gen, device=dev)[:slots * mb] + 1
    tables = perm.to(torch.int32).reshape(slots, mb).contiguous()
    lens = torch.randint(1, mb * bs + 1, (slots,), generator=gen, device=dev,
                         dtype=torch.int32)
    qd = randn(slots, h, hd)
    live = int(lens.clamp(max=mb * bs).sum())
    kv_row = kvh * hd * 2 * 2                     # K and V bytes of one token
    record("paged_decode_attention", csrc + "paged_attention.cu",
           "src/repro/kernels/decode_attention.py:300",
           lambda: kda.paged_decode_attention(qd, kp, vp, tables, lens),
           lambda: ref.paged_decode_attention(qd, kp, vp, tables, lengths=lens),
           ATTN_TOL, nbytes=2 * qd.numel() * 2 + live * kv_row + tables.numel() * 4,
           flops=4 * h * hd * live,
           note="; the plain version rounds p to bf16 before the PV product")
    # prefill attention: a 512-row chunk at q_offset 256, table [64]
    qp = randn(1, c, h, hd)
    table = tables[0].contiguous()
    total = qoff + c
    attended = sum(min(qoff + i + 1, total) for i in range(c))
    record("paged_prefill_attention", csrc + "paged_attention.cu",
           "src/repro/kernels/prefill_attention.py:273",
           lambda: kpf.paged_prefill_attention(qp, kp, vp, table, q_offset=qoff,
                                               length=c),
           lambda: ref.paged_prefill_attention(qp, kp, vp, table, q_offset=qoff,
                                               length=c),
           ATTN_TOL, nbytes=2 * qp.numel() * 2 + total * kv_row + mb * 4,
           flops=4 * h * hd * attended)
    return rows


def parity_phase(torch, cfg_small):
    """Reduced stablelm at fp32: a prefill chunk and two decode steps on the
    card against the CPU, same parameters (the repo's own reference)."""
    from repro_torch.models import model as M

    params = M.init_params(cfg_small, seed=0, device="cpu", dtype=torch.float32)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    out = {}
    for dev, p in (("cpu", params), ("cuda", to(params, "cuda"))):
        state = M.init_serve_state(cfg_small, 2, 9, 8, dtype=torch.float32,
                                   device=dev)
        tok = torch.tensor([[5, 9, 2, 77, 3, 3, 41, 0]], dtype=torch.int32)
        bt = torch.tensor([[2, 4, 6, 8], [1, 3, 0, 0]], dtype=torch.int32)
        lg, state = M.prefill_paged(cfg_small, p, state, tokens=tok.to(dev),
                                    length=7, q_offset=0,
                                    block_table=bt[0].to(dev))
        logits = [lg.cpu()]
        lens = torch.tensor([7, 0], dtype=torch.int32)
        for t in (11, 64):
            lg, state = M.decode_step_paged(
                cfg_small, p, state, torch.tensor([t, 0], dtype=torch.int32).to(dev),
                lens.to(dev), bt.to(dev))
            logits.append(lg[:1].cpu())
            lens = lens + torch.tensor([1, 0], dtype=torch.int32)
        out[dev] = torch.cat(logits)
    err = float((out["cuda"] - out["cpu"]).abs().max())
    if not torch.allclose(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4):
        fail(f"reduced model on the card disagrees with the CPU: max |err| {err}")
    log(f"parity: reduced stablelm fp32 logits card vs cpu max|err| {err:.3g} "
        f"(tol 1e-4)")


def serve_phase(torch, cfg, counters):
    from repro_torch.launch.serve import (MIX_ENGINE, MIX_NEW_TOKENS,
                                          shared_prefix_mix)
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} params on the card in "
        f"{time.perf_counter() - t0:.1f} s ({cfg.n_layers} L, d {cfg.d_model}, "
        f"{cfg.n_heads} H, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size})")
    kw = MIX_ENGINE
    prompts = shared_prefix_mix(cfg.vocab_size)
    new_tokens = MIX_NEW_TOKENS

    # warm-up on a small engine: cuBLAS handles and the GEMM shapes
    warm = ServeEngine(cfg, params, slots=8, max_seq=160, block_size=16,
                       prefill_buckets=(32, 128))
    warm.submit(prompts[0][:40], max_new_tokens=3)
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def run(prefix_caching: bool):
        eng = ServeEngine(cfg, params, prefix_caching=prefix_caching, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in counters.values():
            mod.launches = 0
        t = time.perf_counter()
        for p in prompts:
            eng.submit(p, max_new_tokens=new_tokens)
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {name: mod.launches for name, mod in counters.items()}
        out = {r.rid: list(r.out_tokens) for r in done}
        stats = dict(eng.stats)
        ttfts = sorted(r.ttft for r in done)
        peak = torch.cuda.max_memory_allocated()
        del eng
        torch.cuda.empty_cache()
        return out, stats, wall, launches, ttfts, peak

    out, stats, wall, launches, ttfts, peak = run(True)
    n_tok = sum(len(t) for t in out.values())
    if len(out) != len(prompts) or any(len(t) != new_tokens for t in out.values()):
        fail(f"serve: {len(out)} of {len(prompts)} requests finished, token "
             f"counts {sorted({len(t) for t in out.values()})}")
    if any(not 0 <= x < cfg.vocab_size for t in out.values() for x in t):
        fail("serve: a token id outside the vocabulary")
    L = cfg.n_layers
    P, Dd = stats["prefill_dispatches"], stats["decode_dispatches"]
    expect = {"rmsnorm": (2 * L + 1) * (P + Dd), "apply_rope": 2 * L * (P + Dd),
              "silu_mul": L * (P + Dd), "paged_decode_attention": L * Dd,
              "paged_prefill_attention": L * P}
    log(f"serve: {len(out)} requests, {n_tok} tokens in {wall:.3f} s "
        f"({n_tok / wall:.1f} tok/s), ttft p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} ms, "
        f"prefix_hit_tokens {stats['prefix_hit_tokens']}, prefill chunks {P}, "
        f"decode steps {Dd}, peak memory {peak / 2**30:.2f} GiB")
    log(f"serve: kernel launches {launches} (expected {expect})")
    for name, n in launches.items():
        if n <= 0:
            fail(f"serve: kernel {name} was never launched on the main path")
        if n != expect[name]:
            fail(f"serve: kernel {name} launched {n} times, expected {expect[name]}")
    if stats["prefix_hit_tokens"] <= 0:
        fail("serve: the shared-prefix requests never hit the prefix cache")

    out_off, stats_off, wall_off, _, _, _ = run(False)
    if out_off != out:
        diff = [rid for rid in out if out[rid] != out_off.get(rid)]
        fail(f"serve: greedy outputs differ with prefix caching off (rids {diff})")
    log(f"serve: prefix caching off: token-identical, {wall_off:.3f} s, "
        f"prefill tokens {stats_off['prefill_tokens']} vs "
        f"{stats['prefill_tokens']} with caching")
    return launches, dict(requests=len(out), tokens=n_tok, wall_s=wall,
                          tok_s=n_tok / wall,
                          ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3,
                          prefix_hit_tokens=stats["prefix_hit_tokens"],
                          prefill_dispatches=P, decode_dispatches=Dd,
                          peak_mem_bytes=peak, wall_s_cache_off=wall_off)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an "
             "NVIDIA GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from the root "
             f"of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention, prefill_attention
    from repro_torch.kernels import rmsnorm, rope, swiglu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    log(f"card: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    _build.load()
    info = _build.build_info
    (OUT / "ptxas.txt").write_text(str(info["ptxas"]))
    log(f"build: {info['seconds']:.1f} s ({'reused' if info['reused'] else 'built'}) "
        f"-> {info['path']}")
    for line in str(info["ptxas"]).splitlines():
        if "registers" in line or line.startswith("=="):
            log(f"ptxas {line.strip()}")

    cfg = get_config("stablelm-1.6b")
    timer = Timer(torch)
    rows = kernel_phase(torch, timer, cfg)
    parity_phase(torch, reduced(cfg))
    counters = {"rmsnorm": rmsnorm, "apply_rope": rope, "silu_mul": swiglu,
                "paged_decode_attention": decode_attention,
                "paged_prefill_attention": prefill_attention}
    launches, serve = serve_phase(torch, cfg, counters)
    for row in rows:
        row["launches"] = launches[row["name"]]
    kernels = {"kernels": rows}
    (OUT / "results.json").write_text(json.dumps(
        dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
             build_s=info["seconds"], serve=serve, **kernels), indent=1))
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
