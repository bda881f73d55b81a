#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100.  Phases:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every kernel from ``src/repro_torch/kernels/csrc`` with nvcc for
   sm_90a (one process per source, all at once), with the ptxas
   register/shared-memory report;
3. kernels: each of the five serving kernels at the full-width
   stablelm-1.6b shapes of the serving path, in bf16, held against its plain
   PyTorch version on the card (stated tolerance) and timed with CUDA
   events beside the plain version, the least time the card could take, and
   a library call where one computes the same function; rmsnorm at a
   prefill chunk [512, 2048] and at decode's [8, 2048], rope on the chunk's
   q, on its q and k in one launch and on decode's q and k [8, 1, 32, 64],
   each held to one bf16 ulp relative plus ``NORM_ATOL`` and a relative norm
   of ``NORM_REL``, a control (each row's last 8 elements left out of the
   sum of squares) caught at both rmsnorm shapes, and logged with its GB/s,
   share of the bound, a PyTorch read of as many bytes and an empty
   launch's time; silu_mul on the chunk's FFN hidden [512, 5632] and on
   decode's [8, 5632], held to one bf16 ulp relative plus ``SILU_TOL``'s
   1e-5 and a relative norm of ``SILU_REL`` and logged the same way;
   rmsnorm, the first kernel timed, is timed again after the others and its
   row keeps the repeat (the first timed launch of a run reads slow); the
   paged decode
   (flash-decoding split over a thread-block cluster) is held like the
   dense decode of 5b, also per sequence, twice bitwise equal, with a
   control that drops the longest sequence's second split, and logged with
   its GB/s, its share of the bound and the time of a PyTorch sum over as
   many bytes; then timed with its split forced to 1, 2, 4 and 8 (logged,
   not gated); the paged prefill (the bf16 tensor-core form) is held to one
   bf16 ulp relative plus 2e-3 and a relative norm of 1e-2, twice bitwise
   equal, with a control that drops one 64-key stage of its last row tile,
   and SDPA over the same K/V gathered beforehand into a slab is timed
   beside it (logged, not gated);
4. parity: the reduced stablelm-1.6b model on the card (CUDA kernels)
   against the CPU (plain versions) at fp32;
5. serve: stablelm-1.6b at full width and depth (random bf16 weights from a
   seed) serving 16 requests through ``repro_torch.serve.ServeEngine``; the
   kernels' launch counters are zeroed just before and read just after,
   and every kernel must have run (every paged prefill launch a bf16 one,
   on the tensor cores, every rope launch q and k together, every rmsnorm
   and rope launch on the 16-byte vector route and no silu_mul launch on
   its scalar route (decode's calls take its element route, prefill chunks
   past one wave of the card's threads the vector route), here and in 5d,
   17 and 18); a rerun with prefix caching
   off must give token-identical greedy outputs;
5b. dense kernels: flash-decoding over a dense KV slab (q [8, 32, 64],
   k/v [8, 1024, 32, 64], the live lengths of phase 3's paged decode) and
   the flash forward with a per-sequence key bound (q/k/v [1, 1024, 32, 64]
   at length 700), held against their plain versions in bf16 (timed as in
   3, beside SDPA with a key mask) and in f32; the decode kernel also at
   granite-3-2b's 8 kv heads, and as partials over two shards at
   ``kv_offset`` 512 (combined) and over a shard no length reaches, each
   call twice bitwise equal; a control shows the decode tolerances catch a
   kernel that drops the longest sequence's second split, and the flash
   tolerances one that drops the last 32-key step below its bound; the
   flash row (``PERF.md`` row 6e) runs the bf16 tensor-core
   forward, and SDPA's own error against the plain version is logged
   beside the kernel's (a yardstick, not gated);
5c. dense parity: reduced stablelm-1.6b at fp32, a batched ``prefill`` and
   two ``decode_step``s over the slabs on the card against the CPU;
5d. dense serve: the mix of 5 through ``ServeEngine(paged=False)`` with
   the parameters of 5; every launch count equal to its formula (no paged
   kernel launched), tok/s, TTFT and peak memory beside the paged run's,
   the share of requests token-identical to it (reported, not gated: bf16
   near-ties may flip), a ~640-token prompt's last-token logits from the
   slab ``prefill`` against the paged chunked prefill (relative norm), and
   the mix again at fp32 (the same seed), where the two engines must give
   token-identical greedy outputs;
6. train kernels: the flash-attention forward and backward (``PERF.md``
   rows 6 and 6b, the bf16 kernels on ``mma.sync`` tensor cores with
   ``ldmatrix`` and ``cp.async`` rings), the rmsnorm and silu_mul backward
   passes, silu_mul's forward on the FFN hidden [8192, 8192] and rope's
   backward (the forward kernel at sign -1 on dq and dk in one launch) at
   full-width granite-3-2b shapes in bf16, held against their plain
   versions and timed as in 3 (library: SDPA forward/backward, autograd of
   ``F.rms_norm``); the rmsnorm backward's dx and dw are held to one bf16
   ulp relative plus ``BWD_DX_TOL`` / ``BWD_DW_TOL`` and a relative norm of
   ``BWD_REL``, with a control (its last 16 rows left out of dw) that must
   be caught, and logged with the silu_mul forward as in 3; SDPA's own
   error against the plain version is logged beside the flash kernels' (a
   yardstick, not gated); the flash backward twice must give the same bits,
   and a control shows the flash tolerances catch a forward that skips one
   64-key tile;
7. train parity: reduced granite-3-2b at fp32, every gradient leaf of the
   train loss and one train step on the card against the CPU, then a
   driver run on the card that crashes, resumes from its checkpoint and
   must end bit-identical to an uninterrupted run;
8. train: granite-3-2b at full width and depth (random bf16 weights from a
   seed) for ``TRAIN_STEPS`` steps of 2 x 4096 tokens through
   ``make_train_step`` with remat (the step ``launch/train.py`` drives, called
   directly so that no 30 GB checkpoint is written); counters zeroed just
   before, read just after, and every training-path kernel must have run
   (every silu_mul and rmsnorm backward launch on the vector route, here
   and in 11 and 15);
9. rwkv kernels: the wkv6 forward and backward at full-width rwkv6-3b
   shapes (r, k, v [2, 4096, 40, 64] bf16, a data-dependent decay drawn
   through the model's ``_decay`` with a random nonzero ``w_b``), held
   against their plain versions and timed as in 3 (no PyTorch call
   computes wkv6: no library time); a control shows the forward's
   tolerance catches a kernel that drops one chunk's state contribution,
   another that the backward's catch one that drops one chunk's exit-state
   gradient, and the backward twice gives the same bits;
10. rwkv train parity: phase 7 for reduced rwkv6-3b with a random nonzero
   ``w_b``;
11. rwkv train: rwkv6-3b at full width and depth as in 8, with the wkv6
   and rmsnorm launch counts held to the remat formulas, every wkv6 call
   on the bf16 tensor-core route;
12. mamba kernels: the Mamba2 scan forward and backward at full-width
   zamba2-7b shapes (x [2, 4096, 112, 64] bf16, B, C [2, 4096, 64] bf16,
   dt = softplus(N(0, 1)) f32, A = -linspace(1, 16, 112) as at init), held
   against their plain versions and timed as in 3 (no PyTorch call
   computes the SSD scan: no library time); a control shows the forward's
   tolerance catches a kernel that drops one chunk's state term, another
   that the backward's catch one that drops one chunk's exit-state
   gradient, and the backward twice gives the same bits;
13. flash attention at zamba2-7b's head dim 112 (q, k, v [2, 4096, 32,
   112] bf16, causal; rows 6c and 6d), forward and backward held with the
   flash tolerances of phase 6 and timed beside SDPA, SDPA's own error
   logged as in 6;
14. hybrid train parity: phase 7 for reduced zamba2-7b (2 groups of 2
   Mamba2 layers and a 1-layer tail, P 16, N 8, head dim 16);
15. hybrid train: zamba2-7b at full width and the depth one card holds
   (``launch/trace_train.py:ONE_CARD_LAYERS``, 33 of 81 layers: 5 groups of
   6, the 3-layer tail, 5 applications of the shared block) as in 8, with
   every kernel's launch count held to the nested-remat formulas;
16. fidelity kernels (the kernel API's entries that no model path calls):
   the weight-stationary GEMM at full-width stablelm-1.6b projections in
   bf16 (M 8 at decode: [2048, 2048], [2048, 5632], [5632, 2048], the
   lm_head [2048, 100352]; M 512, a prefill chunk: [2048, 5632], [5632,
   2048], the lm_head), driven through ``ops.matmul`` with its counters
   zeroed before and read after (every one launches the wgmma route, wgmma
   fed by TMA through an mbarrier ring; an f32 [512, 5632] @ [5632, 2048],
   a 5.5 MiB panel, and a 3-D input launch nothing), each held against its
   plain version, twice bitwise equal, its tolerance shown to catch a
   product that loses its last 32 K rows (half a 64-deep stage), and timed
   as in 3 beside ``torch.matmul`` with its TFLOP/s or GB/s and share of
   the bound; the mma.sync route held, repeated and timed beside it at the
   same shape; the JAX sweep's odd shapes in f32 and bf16 (bf16 on its
   planned route and on mma.sync, each counted), an x off 16-byte
   alignment on the mma.sync route, and f32 at [512, 2048] @ [2048, 2048];
   bf16 [513, 5624] @ [5624, 136] to an f32 output on both bf16 routes,
   its mean error against the float64 product held to 2x cuBLAS's f32
   GEMM's;
   and the Curry-ALU forms through ``ops`` (rmsnorm [512, 2048] with 1 and
   3 Newton rounds, silu_mul [512, 5632] with 6 and 8 Taylor rounds, bf16
   and f32), held, with f32 controls that the native kernels fail, and
   timed beside the native kernels at the same shapes; after it, row 7
   (5b's dense decode kernel) is timed again beside SDPA, alternating;
17. int8 pool (run after 5d, while the serving parameters are on the card):
   phase 3's decode and prefill pools quantized per (kv head, page), both
   int8-page variants of the paged kernels in bf16 and f32 held against
   their plain versions, a control that doubles one live page's K scale in
   the kernel's input (and, at decode, one that drops the longest
   sequence's second split), a second call bitwise equal, and timed as in 3
   beside the float kernel on the pool before quantization; reduced
   stablelm-1.6b at fp32 over an int8 pool (two prefill chunks, four decode
   steps) on the card against the CPU; and the mix of 5 through
   ``ServeEngine(kv_dtype="int8")``, the int8 variants launched L times a
   decode step and a prefill chunk and the float paged kernels not at all,
   token-identical with prefix caching off, beside phase 5's run;
18. sequence-sharded pool (after 17, with the same parameters): phase 3's
   pool grown to 516 pages and cut into 4 shards, the decode slots (the
   last cut to 40 keys, so shard 3 owns none of them) and the prefill
   sequence placed round-robin by the port's ``BlockAllocator``; rows 1s /
   2s, the skip_null partials over each shard's view with its local table,
   held per shard against the plain version (m on every row, l and acc / l
   where a row sees an owned key, exactly (0, -1e30, 0) where it sees
   none) in bf16 and f32 over the float and the int8 pool, their NoC tree
   combine against the unsharded kernel, a control (the local tables with
   skip_null off) caught, at decode each shard's call twice bitwise equal
   and a control that drops the longest sequence's second split, timed per
   shard launch beside the shard's bound;
   the decode partial at ``kv_offset`` 512 combined with the lower half;
   reduced stablelm-1.6b at fp32 through ``ServeEngine(seq_shards=S)`` on
   the card, token-identical at S = 1, 2, 4 (and 1, 2 over an int8 pool)
   with a prefix hit and a copy-on-write; and the mix of 5 through
   ``ServeEngine(seq_shards=4)``, the skip_null kernels launched 4 L times a
   decode step and a prefill chunk and the unsharded paged kernels not at
   all, one NoC combine per layer and dispatch, beside phase 5's run;
19. rwkv serving (after 11, with rwkv6-3b): row 9s, the wkv6 forward from
   a carried state at the serving prefill chunk (r, k, v [1, 512, 40, 64]
   bf16, S0 [1, 40, 64, 64] f32, the state a previous chunk leaves), held
   against the plain chunked scan from the same S0 in bf16 and in f32 with
   ``scan_tol``, twice bitwise equal, S0 = 0 bitwise equal to the
   zero-state kernel (also at row 9's training shape), a control (the
   plain scan with S0 left out) caught, timed beside the zero-state kernel
   on the same chunk; rmsnorm at rwkv6-3b's decode [8, 2560] beside row
   3d; reduced rwkv6-3b at fp32 through the runner's entry points from a
   mid-stream slot state (two chunks, a decode step) on the card against
   the CPU, logits and every slot-state key; rwkv6-3b at full width and
   depth in fp32 through the runner engine (prompts of 40-700 tokens in
   chunks of at most 128, so chunks carry their slot's state) and
   ``ServeEngine(paged=False)``, token-identical; and the mix of 5 in bf16
   through both engines, the carried-state kernel L times a prefill chunk
   on the runner path and never on the slab path (the zero-state kernel L
   times a prefill there), rmsnorm (3L + 1) times a prefill chunk and a
   decode step, all on the vector route, with tok/s, TTFT and peak memory;
20. hybrid serving (after 15, with zamba2-7b at its full 81 layers): row
   8s, the Mamba2 forward from a carried state at the serving prefill
   chunk (x [1, 512, 112, 64] bf16, h0 [1, 112, 64, 64] f32, the state a
   previous chunk leaves), held against the plain scan from the same h0 in
   bf16 and in f32 with ``scan_tol``, twice bitwise equal, h0 = 0 bitwise
   equal to the zero-state kernel (also at row 8's training shape with its
   chunk-entry states; rows 8 and 8b carry their outputs' hashes), a
   control (the plain scan with h0 left out) caught, timed beside the
   zero-state kernel on the same chunk; readings 1h, 2h and 7h, the paged
   decode, paged prefill and slab decode at head dim 112 (zamba2-7b's 32
   heads over 32 kv heads: decode q [8, 32, 112] over a 513-page pool,
   a 512-row chunk at offset 256), held in bf16 (twice bitwise equal) and
   f32, 1h and 2h also over the int8 pool and as the partials of 4
   shards, each with a control (the kernel's output with its last 16 dims
   dropped, the trap of a lane holding D // 32 dims) caught, timed as in
   3; reduced zamba2-7b at fp32 through the runner's entry points from a
   mid-stream slot state and pool (two chunks, a decode step) on the card
   against the CPU, logits, every slot-state key and the pages; zamba2-7b
   at full width and depth in fp32 through the runner engine (prefix
   caching on and off; a shared-prefix pair must report 0 prefix-hit
   tokens) and ``ServeEngine(paged=False)``, token-identical, prompts
   crossing prefill-chunk boundaries; and the mix of 5 in bf16 through the
   runner, slab, int8-pool and 4-shard engines, every kernel launch count
   at its formula (the carried-state Mamba2 kernel 81 times a runner
   prefill chunk and no zero-state one there, the paged kernels 13 times a
   chunk and a step; the zero-state kernel 81 times a slab prefill, the
   slab decode 13 times a step), with tok/s, TTFT and peak memory;
21. MoE serving (after 20, with olmoe-1b-7b at its full 16 layers, 64
   experts of 1024, top 8, head dim 128): rows 5e and 5ed, silu_mul
   through ``ops.silu_mul`` on the routed experts' [64, 80, 1024] (a
   512-row prefill chunk, the vector route) and [64, 4, 1024] (a decode
   step of 8 slots, the element route), held in bf16 (twice bitwise equal,
   timed as row 5) and f32; readings 1o, 2o and 7o, 20's attention rows at
   olmoe's 16 heads of 128 (decode q [8, 16, 128], prefill q [1, 512, 16,
   128]); one MoE layer at olmoe's and at qwen2-moe-a2.7b's width (60
   experts padded to 64, 4 shared) in f32 on the card against the CPU, a
   dispatch that drops, the routing and drops equal; reduced olmoe at fp32
   skewed towards two experts, the runner and slab engines on the card
   token-identical to the CPU's with as many dropped assignments; the mix
   of 5 in bf16 at the default capacity factor through the runner, slab,
   int8-pool and 4-shard engines, every launch count at its formula
   (silu_mul L times a dispatch, on the element route at decode and the
   vector route at prefill), with tok/s, TTFT and peak memory; and olmoe
   at full width and depth in fp32 at the dropless cf = E / k through the
   runner and 4 shards (prefix caching on and off) and the slab engine,
   token-identical, no assignment dropped;
22. preemption and swap (a page pool below full capacity): stablelm-1.6b
   at full width and depth on the mix of 5 over 129 pages (128 usable, a
   quarter of the full pool) in bf16 with phase 5's parameters under the
   swap, recompute and auto policies, every launch count at phase 5's
   formulas over the engine's own (grown) dispatch counts, tok/s, TTFT and
   peak memory logged beside phase 5's run with the preemptions by arm and
   the swap bytes, the runs probed: every swapped victim's pages read back
   bit-equal after its swap-in, the arena's device-to-host and
   host-to-device GB/s and a replayed prefill token's seconds logged
   beside the cost model's (the paper's CXL link and PIM banks); in fp32
   (seed 0) swap, recompute, auto and swap with a proactive horizon of 2,
   each token-identical to the unpressured run, preempted by its arm,
   restored tokens no more than preempted ones and the decode work
   unchanged; an int8 pool under swap against the unpressured int8 run,
   its int8 pages and scales bit-equal after the round trip; 4 shards over
   132 pages, swap and recompute, token-identical to the one-shard
   pressured runs; then (after 20) zamba2-7b at full width cut to 14
   layers in fp32 under swap and recompute against its unpressured run,
   the slot-state blobs bit-equal after the round trip; and (after 21)
   ROADMAP queue C: reduced olmoe skewed at the default capacity factor
   over 4 shards, the 8-slot mix whose first four requests finish early,
   the card engine token-identical to the CPU's with as many drops, every
   decode step's logits (idle rows included) within 1e-4, two card runs'
   null pages bit-equal and within 1e-4 of the CPU's, a control (the idle
   row given the plain version's mean of the null pages) caught, and the
   JAX package's scatter targets with duplicates in the card's write order
   logged against the CPU's index order.

Prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero without the last line; so does a run
with no CUDA device or outside a checkout.  Long output (the full ptxas
report, the results) goes to ``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import hashlib
import json
import math
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
# rmsnorm and rope (rows 3, 3d, 4, 4qk and 4d), bf16 at full width.  Kernel
# and plain version round one f32 result once and differ only in the order
# of rmsnorm's sum of squares and in how rope's products contract, so an
# output is held to one bf16 ulp relative plus NORM_ATOL and to a relative
# norm error of NORM_REL, both set from the parent's readings at these
# shapes (tools/norm_rope_readings.py on an H100): every output within one
# ulp relative (the largest excess over it -3.4e-10), relative norm errors
# up to 1.34e-5 (rope; rmsnorm 7.6e-6), so 1e-5 absolute for results that
# cancel towards zero and 1e-4 relative norm; BF16_TOL would pass a norm
# whose scale is off by half a percent.  The control: the plain
# rmsnorm with each row's last NORM_DROPPED elements (one 16-byte vector of
# bf16) left out of its sum of squares, the mean still over the width.
NORM_ATOL = 1e-5
NORM_REL = 1e-4
NORM_TOL = dict(rtol=2 ** -7, atol=NORM_ATOL)
NORM_DROPPED = 8
# silu_mul (rows 5, 5d, 5t) and the rmsnorm backward (row 3b), bf16 at full
# width, held as rmsnorm is: one bf16 ulp relative plus an absolute term and
# a relative norm error, both set from the parent's readings at these
# shapes and at the backward's widths 2560-7168
# (tools/swiglu_norm_bwd_readings.py on an H100).  silu_mul's parent read
# no error at all against the plain version (both round the same f32
# silu(g) and product), so 1e-5 and a relative norm of 1e-4.  The
# backward's dx read every output within one ulp relative (largest excess
# 1.1e-8) and relative norms up to 1.43e-5, so 1e-5 and 1e-4; its dw (8192
# rows summed in f32 in another order, then rounded) read within one ulp
# but near zero, where the largest excess was 8.8e-6, and relative norms
# up to 3.9e-6 (3.0e-5 on this phase's inputs, where one bf16 ulp of the
# largest entries flips, in the parent and the redesign alike), so 1e-4 and
# 1e-4.  BF16_TOL's two ulps plus 1e-2 were looser than any of these
# readings needs.  The control: the plain backward with its last
# BWD_DROPPED_ROWS rows left out of dw.
SILU_TOL = dict(rtol=2 ** -7, atol=1e-5)
SILU_REL = 1e-4
BWD_DX_TOL = dict(rtol=2 ** -7, atol=1e-5)
BWD_DW_TOL = dict(rtol=2 ** -7, atol=1e-4)
BWD_REL = 1e-4
BWD_DROPPED_ROWS = 16
# the redesigns of rmsnorm, rope, silu_mul and the rmsnorm backward, named on
# their rows of the ``{"kernels": ...}`` line
RMSNORM_DESIGN = ("the row in registers: 16-byte vectors, w held across the "
                  "rows a thread walks, warp-shuffle sums, the grid from the card")
ROPE_DESIGN = ("cos/sin once per (token, pair) in shared memory, 16-byte "
               "vectors, q and k in one launch, the grid from the card")
SILU_DESIGN = ("16-byte vector streams of gate and up past one wave of the card's "
               "threads, one element a thread within it (decode), a grid of up to "
               "eight waves from the card")
RMSNORM_BWD_DESIGN = ("the row in registers: 16-byte vectors, the next row's loads "
                      "in flight, w and f32 dw partials held across a block's "
                      "contiguous rows, one barrier a row, a column pass of fixed "
                      "warp slices, the grid from the card")
# rows whose launches are read from another counter than their name's
ROW_COUNTER = {"rmsnorm_decode": "rmsnorm", "apply_rope_qk_decode": "apply_rope_qk",
               "silu_mul_decode": "silu_mul", "silu_mul_train": "silu_mul"}
ATTN_TOL = dict(rtol=2e-2, atol=2e-2)
# flash attention at S = 4096: a late row's output averages ~i keys, so |o|,
# dq, dk and dv there are ~0.02-0.04 and ATTN_TOL's 2e-2 would pass a kernel
# that loses part of the softmax mass.  o is held to one bf16 ulp relative
# plus 4e-3 (2x the 0.00195 the kernel reads), lse (~8.3, f32, read to
# ~1e-6) to 1e-4 absolute, the gradients to two ulps plus 4e-3; every output
# also to a relative norm error of 1e-2 (one bf16 rounding is ~2^-9)
FLASH_O_TOL = dict(rtol=2 ** -7, atol=4e-3)
FLASH_LSE_TOL = dict(rtol=0.0, atol=1e-4)
FLASH_GRAD_TOL = dict(rtol=2 ** -6, atol=4e-3)
FLASH_REL = 1e-2
FLASH_TILE = 64                                # key tile of csrc/flash_attention.cu (both forms)
# the redesign of the bf16 flash kernels, named on their rows of the
# ``{"kernels": ...}`` line with their PERF.md row
FLASH_DESIGN = "bf16 on mma.sync m16n8k16 tensor cores, ldmatrix, cp.async ring"
# The decode kernel (rows 1, 1q, 1s, 7) and the flash-lengths row (5b).
# Decode attention at full width: a row of ~500 live keys has |o| ~ 0.1, so
# ATTN_TOL's 2e-2 would pass a kernel that loses part of its keys.  The
# paged and dense decode and the flash-lengths outputs are held like
# the flash forward (one bf16 ulp relative plus 4e-3, relative norm 1e-2),
# each decode sequence to a relative norm of 1e-2, and in f32 to 1e-5
# relative plus 1e-5.  Readings on the first full-width runs (PERF.md,
# Findings): decode bf16 0.0078 (one ulp where |o| ~ 1-2, rows of few
# keys), a sequence's relative norm <= 0.0026, f32 <= 4.4e-7;
# flash-lengths bf16 0.00098, f32 4.8e-7.  The controls: decode, the
# longest sequence loses its second split of the kernel's plan (PERF.md,
# Findings); flash, the last 32-key step below the bound (0.257): all
# caught.
DECODE_TOL = dict(rtol=2 ** -7, atol=4e-3)
DECODE_REL = 1e-2
DECODE_SEQ_REL = 1e-2
DENSE_F32_TOL = dict(rtol=1e-5, atol=1e-5)
DENSE_F32_REL = 1e-5
DENSE_STEP = 32                                # keys the flash-lengths control drops
# the flash-decoding kernel (csrc/decode_attention.cu), named on the rows of
# the ``{"kernels": ...}`` line that run it (PERF.md rows 1, 1q, 1s, 7)
DECODE_DESIGN = ("decode cluster: a split key walk over a thread-block cluster, "
                 "cp.async rings, merged over distributed shared memory")
FLASH_LEN = 700                                # the flash-lengths row's bound
# The paged prefill (row 2), bf16 at full width: a row of ~500-770 keys has
# |o| ~ 0.05-0.2, where ATTN_TOL's 2e-2 is 10-20 bf16 ulps, the size of the
# outputs themselves.  The output is held to one bf16 ulp relative plus
# 2e-3 (2x the 0.000977 the CUDA-core kernel read at these shapes, PERF.md
# row 2) and a relative norm error of 1e-2; the control drops one 64-key
# stage of the last row tile (PREFILL_DROP_STAGE of its walk).
PREFILL_TOL = dict(rtol=2 ** -7, atol=2e-3)
PREFILL_REL = 1e-2
PREFILL_DROP_STAGE = 6                         # keys [384, 448) of the last tile's walk
# the redesign of the bf16 paged prefill, named on rows 2, 2q and 2s
PREFILL_DESIGN = ("bf16 on mma.sync m16n8k16: 64-row tiles, the tile's owned "
                  "pages listed once, 64-key stages through a cp.async ring, "
                  "P as a bf16 hi + lo pair")
# the slab prefill against the paged chunked prefill, full width in bf16:
# the last-token logits' relative norm error read 0.0143 (PERF.md,
# Findings); the tolerance is 3.5x that
PREFILL_GATE_REL = 5e-2
# The chunked scans, wkv6 at rwkv6-3b's full width (bf16 r, k, v, o and
# their gradients; f32 S_final, dl = dw w and du) and Mamba2 at zamba2-7b's
# (bf16 y, dx, dB, dC; f32 h_final, ddt, dA).  Tolerances set from the
# readings of the first full-width runs (PERF.md, Findings): the bf16
# outputs differ by at most one bf16 ulp (wkv6 0.5 at |o| ~ 181, Mamba2
# 0.25 at |y| up to 280 and 2 at |dB| up to 1088; relative norm errors <=
# 5.7e-5), so they are held to one ulp relative (2^-7) plus 1e-3 of the
# tensor's largest entry; the f32 outputs read <= 4.8e-5 of their largest
# entry (Mamba2's ddt 0.181 of 3745) and are held to 1e-4 relative plus
# 1e-4 of it; every output to a relative norm error of 1e-3 (17x the
# largest reading)
# the redesign of the bf16 Mamba2 scan, named on rows 8 and 8b of the
# ``{"kernels": ...}`` line
MAMBA_DESIGN = ("bf16 on mma.sync m16n8k16: C B^T once per (batch, chunk); a "
                "forward state walk per (batch, head), cp.async a chunk ahead; "
                "a reverse dS walk, then chunk-parallel gradients over head groups")
# the redesign of the bf16 wkv6 scan, named on rows 9 and 9b
WKV_DESIGN = ("bf16 on mma.sync m16n8k16, chunks of 64: chunk-parallel "
              "increments, an in-place state scan a thread four values, then "
              "chunk-parallel outputs / gradients from each chunk's state alone")
SCAN_RTOL, SCAN_ATOL = 2 ** -7, 1e-3
SCAN_F32_RTOL, SCAN_F32_ATOL = 1e-4, 1e-4
SCAN_REL = 1e-3
WKV_WB_STD = 1.0                               # std of the random w_b
# The fidelity kernels (16).  Kernel and plain version round one f32
# result once.  Readings on the first full-width run (PERF.md, Findings): the
# GEMM's bf16 outputs differ by at most one bf16 ulp (0.0156 at |out| in
# [2, 4), 0.0312 in [4, 8); relative norm <= 1.7e-4), the curry rmsnorm's
# by one ulp, the curry silu_mul's not at all; a bf16 output is held to one
# ulp relative (2^-7) plus 1e-5 for results that cancel towards zero.  f32:
# the GEMM read 9.5e-6 at K 2048 (the same products summed in another
# order, outputs ~ N(0, 1)) and is held to 1e-5 relative plus 4e-5.  The
# curry forms in f32 take the plain version's steps one by one and read
# <= 9.5e-7 at outputs up to ~5 (rmsnorm's mean of squares in another
# order; silu_mul 0, every step pinned); they are held relative only, to
# 2e-6, which the native forms fail: one Newton step from the bf16 seed is
# up to ~6e-6 relative off the exact rsqrt, six Taylor terms ~5e-3 off exp
# in the tail (|g| ~ 15), where the values are too small for an absolute
# term to see (the curry controls).
FID_BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
GEMM_F32_TOL = dict(rtol=1e-5, atol=4e-5)
# an f32 output from bf16 inputs at K 5624: each bf16 route's mean |error|
# against the float64 product, as a multiple of cuBLAS's f32 GEMM's (the
# kernels add the tensor cores' sum of each K piece on the CUDA cores; the
# first version, which kept the whole sum on the tensor cores, missed
# test_torch_cuda.py's 1e-5 hold of the f32 output at this K)
GEMM_F32_ERR_RATIO = 2.0
CURRY_F32_TOL = dict(rtol=2e-6, atol=0.0)
# the GEMM's control drops the last 32 rows of K: half of one 64-deep stage
# of the wgmma ring in csrc/matmul.cu (a smaller fault than a lost stage, so
# a stricter test of the tolerance)
GEMM_DROPPED_K = 32
# The int8 pool (17).  The int8 variants and their plain versions form the
# same f32 products int8 * scale and sum them in another order.  Readings on
# the first full-width run (PERF.md, Findings): bf16 one ulp at most
# (decode 0.000488, prefill 0.000977; relative norm <= 4.1e-5), f32 <=
# 3.6e-7.  A bf16 output is held to one bf16 ulp relative (2^-7) plus 1e-5
# and a relative norm error of 1e-2, an f32 one to 1e-5 relative plus 1e-5.
# The control doubles one (kv head, page) K scale in the kernel's input
# only: the longest sequence's first page at decode (read max|err| 0.0118,
# relative norm 0.0018: caught elementwise), the chunk's first page at
# prefill (2.09, 0.24).
Q8_BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
Q8_REL = 1e-2
Q8_F32_TOL = dict(rtol=1e-5, atol=1e-5)
# reduced stablelm at fp32 with an int8 pool, card against CPU: K/V rows
# that differ by float rounding can land one int8 step apart where a value
# sits at a rounding tie, and one such step moved the logits by up to
# 7.4e-3 on the CPU (each of the two layers' K and V pages perturbed at one
# element; logits of scale ~1); the logits are held to 2e-2 absolute.  The
# first run read 2.15e-6 with no int8 value a step apart
Q8_LOGITS_TOL = dict(rtol=0.0, atol=2e-2)
# The sequence-sharded pool (18): shards of phase 3's pool; the skip_null
# partials are held with the tolerances of their pools' rows (float:
# DECODE_TOL / DECODE_REL in bf16, DENSE_F32_TOL in f32; int8: Q8_*), m on
# every row, l and acc / l on rows that see an owned key
SEQ_SHARDS = 4
# the full-width training run: granite-3-2b at TRAIN_4K's sequence length,
# global batch 2, all 40 layers; only the step count is cut
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 3
# rwkv serving (19): row 9s's prefill chunk, the engine's slots (the mix of
# 5) and the new tokens a request of the fp32 identity check
SERVE_CHUNK, SERVE_SLOTS, FP32_NEW_TOKENS = 512, 8, 16
# preemption (22): the mix of 5 over 129 pages (128 usable: a quarter of the
# full pool's 512, above the longest request's 52), over 132 at 4 shards (33
# a shard, a null page each); the hybrid cut to 14 of zamba2-7b's 81 layers
# (2 groups of 6 and a 2-layer tail: G = 2) to keep the phase's time
PRESSURE_BLOCKS, PRESSURE_SHARD_BLOCKS, HYBRID_PRESSURE_LAYERS = 129, 132, 14


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



class Counter:
    """One kernel's launch count: an integer attribute of its wrapper
    module (``launches`` for forward kernels, ``bwd_launches`` for the
    backward kernels), or one ``route``'s entry of a dict attribute
    (``launches_by_route``)."""

    def __init__(self, module, attr: str = "launches", route=None):
        self.module, self.attr, self.route = module, attr, route

    def reset(self) -> None:
        if self.route is None:
            setattr(self.module, self.attr, 0)
        else:
            getattr(self.module, self.attr)[self.route] = 0

    def read(self) -> int:
        value = getattr(self.module, self.attr)
        return value if self.route is None else value[self.route]


def rel_err(torch, got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in f32."""
    diff = torch.linalg.vector_norm(got.float() - want.float())
    return float(diff / torch.linalg.vector_norm(want.float()).clamp_min(1e-30))


def hold(torch, name, got, want, tol, rel=None) -> float:
    """Fail unless ``got`` is finite and within ``tol`` elementwise (and,
    given ``rel``, within that relative norm error) of ``want``; returns
    the max |err|."""
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"{name}: non-finite kernel output")
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), **tol):
        fail(f"{name}: kernel and plain version disagree, max |err| {err} "
             f"(tolerance {tol})")
    if rel is not None and rel_err(torch, got, want) > rel:
        fail(f"{name}: kernel and plain version disagree, relative norm error "
             f"{rel_err(torch, got, want)} (tolerance {rel})")
    return err


def yardstick(torch, row, names, library, plain) -> None:
    """Log SDPA's own max |err| and relative norm error against the plain
    version beside the kernel's (a yardstick for the tolerances, not
    gated), and keep the largest on the kernel's row."""
    errs = [(n, float((a.float() - b.float()).abs().max()), rel_err(torch, a, b))
            for n, a, b in zip(names, library, plain)]
    log(f"kernel {row['name']}: SDPA against the plain version (yardstick, not "
        f"gated): " + ", ".join(f"{n} {e:.3g} (rel {r:.2g})" for n, e, r in errs)
        + f"; the kernel: max|err| {row['max_abs_err']:.3g}")
    row["library_max_abs_err"] = max(e for _, e, _ in errs)
    row["library_rel_err"] = max(r for _, _, r in errs)


def measure(torch, timer, name, source, replaces, kernel, plain, tol, nbytes,
            flops, library=None, note="", iters=20, plain_iters=20, rel=None,
            view=None):
    """Hold ``kernel()`` against ``plain()`` on the same inputs (each may
    return a tensor or a tuple of tensors, mapped through ``view`` first
    when given; ``tol`` is one tolerance or a tuple of one per output),
    time both and ``library`` (one PyTorch call computing the same
    function, or None), and return the kernel's row of the ``{"kernels":
    ...}`` line (launches filled in by the path that runs it)."""
    got, want = kernel(), plain()
    if view is not None:
        got, want = view(got), view(want)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tols = tol if isinstance(tol, tuple) else (tol,) * len(got)
    errs = [hold(torch, name, g, w, t, rel) for g, w, t in zip(got, want, tols)]
    err = max(errs)
    if len(errs) > 1:
        note += "; per output max|err| " + ", ".join(
            f"{e:.3g} (rel {rel_err(torch, g, w):.2g})"
            for e, g, w in zip(errs, got, want))
    del got, want
    ms = timer(kernel, iters=iters)
    plain_ms = timer(plain, iters=plain_iters)
    lib_ms = timer(library, iters=iters) if library is not None else None
    bms, by = bound(nbytes, flops)
    log(f"kernel {name}: max|err| {err:.3g} (tol {tol}{note}), "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
        f"({by})" + (f", library {lib_ms:.4f} ms" if lib_ms else ""))
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms)


def to_device(tree, dev):
    """A nested dict / list of tensors (parameters) moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def norm_control(torch, name, x, w, eps) -> None:
    """Fail unless NORM_TOL / NORM_REL tell the plain rmsnorm of x from one
    whose sum of squares leaves out each row's last NORM_DROPPED elements
    (what a kernel that loses one 16-byte vector of the row would give)."""
    from repro_torch.kernels import ref

    xf = x.float()
    ss = (xf[..., :-NORM_DROPPED] ** 2).sum(-1, keepdim=True) / x.shape[-1]
    bad = (xf * torch.rsqrt(ss + eps) * w.float()).to(x.dtype)
    dropped_step_control(torch, name, f"each row's last {NORM_DROPPED} elements "
                         f"from its sum of squares", ref.rmsnorm(x, w, eps), bad,
                         NORM_TOL, NORM_REL)


def kernel_phase(torch, timer, cfg):
    """Each kernel at the serving path's full-width shapes, bf16."""
    from repro_torch.kernels import _build
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

    def record(*args, **kw):
        rows.append(measure(torch, timer, *args, **kw))

    csrc = "src/repro_torch/kernels/csrc/"
    eps, theta = cfg.norm_eps, cfg.rope_theta
    # the decode-shape inputs of rows 3d / 4d and rope's k from a generator
    # of their own, so the other rows keep their inputs
    gen_new = torch.Generator(device=dev).manual_seed(11)

    def randn_new(*shape):
        return torch.randn(shape, generator=gen_new, device=dev).to(bf)

    floor = timer(lambda: torch.cuda._sleep(1))
    one = torch.zeros(1, device=dev)
    one_ms = timer(lambda: one.add_(1.0))
    log(f"empty launch (torch.cuda._sleep(1)) under the same timer: {floor:.4f} ms; "
        f"a one-element add_ {one_ms:.4f} ms")

    def small(name, source, replaces, kernel, plain, nbytes, flops, design,
              library=None, note="", tol=NORM_TOL, rel=NORM_REL):
        """Rows 3, 3d, 4, 4qk, 4d, 5 and 5d: held to ``tol`` / ``rel``
        (NORM_TOL / NORM_REL for rmsnorm and rope, SILU_TOL / SILU_REL for
        silu_mul), their rates logged beside an empty launch's time."""
        record(name, csrc + source, replaces, kernel, plain, tol,
               rel=rel, nbytes=nbytes, flops=flops, library=library,
               note=f"; rel {rel}" + note)
        rows[-1].update(design=design, launch_floor_ms=floor, one_element_ms=one_ms)
        log_rate(torch, timer, rows[-1], nbytes)

    # rmsnorm on a prefill chunk's activations [1, 512, 2048] (row 3) and on
    # decode's [8, 2048] (row 3d), each beside a control the holds catch
    x, w = randn(1, c, d), randn(d)
    xd = randn_new(slots, d)
    for name, xx in (("rmsnorm", x), ("rmsnorm_decode", xd)):
        norm_control(torch, name, xx, w, eps)
        small(name, "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:51",
              lambda xx=xx: krn.rmsnorm(xx, w, eps),
              lambda xx=xx: ref.rmsnorm(xx, w, eps),
              nbytes=2 * xx.numel() * 2 + d * 2, flops=4 * xx.numel(),
              design=RMSNORM_DESIGN,
              library=lambda xx=xx: torch.nn.functional.rms_norm(xx, (d,), w, eps))
    # rope on the chunk's queries [1, 512, 32, 64] at positions 256..767
    # (row 4), on its queries and keys in one launch (4qk), and on decode's
    # q and k [8, 1, 32, 64] (4d)
    q = randn(1, c, h, hd)
    k = randn_new(1, c, kvh, hd)
    pos = (qoff + torch.arange(c, dtype=torch.int32, device=dev))[None]
    qd1, kd1 = randn_new(slots, 1, h, hd), randn_new(slots, 1, kvh, hd)
    posd = torch.randint(1, mb * bs, (slots, 1), generator=gen_new, device=dev,
                         dtype=torch.int32)
    small("apply_rope", "rope.cu", "src/repro/kernels/rope.py:52",
          lambda: krope.apply_rope(q, pos, theta),
          lambda: ref.apply_rope(q, pos, theta),
          nbytes=2 * q.numel() * 2 + c * 4, flops=3 * q.numel(), design=ROPE_DESIGN,
          note="; the TPU kernel forms 1/theta^(j/half) as exp(-ln theta "
               "j/half), the port follows the plain version")
    for name, qq, kk, pp in (("apply_rope_qk", q, k, pos),
                             ("apply_rope_qk_decode", qd1, kd1, posd)):
        small(name, "rope.cu", "src/repro/kernels/rope.py:52",
              lambda qq=qq, kk=kk, pp=pp: krope.apply_rope_qk(qq, kk, pp, theta),
              lambda qq=qq, kk=kk, pp=pp: (ref.apply_rope(qq, pp, theta),
                                           ref.apply_rope(kk, pp, theta)),
              nbytes=2 * (qq.numel() + kk.numel()) * 2 + pp.numel() * 4,
              flops=3 * (qq.numel() + kk.numel()), design=ROPE_DESIGN,
              note="; q and k in one launch")
    # silu_mul on the chunk's FFN hidden [1, 512, 5632] (row 5) and on
    # decode's [8, 5632] (row 5d, its inputs from a generator of its own)
    g, u = randn(1, c, ff, scale=3.0), randn(1, c, ff)
    gen_silu = torch.Generator(device=dev).manual_seed(13)
    gd, ud = ((torch.randn((slots, ff), generator=gen_silu, device=dev) * sc).to(bf)
              for sc in (3.0, 1.0))
    for name, gg, uu in (("silu_mul", g, u), ("silu_mul_decode", gd, ud)):
        small(name, "swiglu.cu", "src/repro/kernels/swiglu.py:59",
              lambda gg=gg, uu=uu: ksw.silu_mul(gg, uu),
              lambda gg=gg, uu=uu: ref.silu_mul(gg, uu),
              nbytes=3 * gg.numel() * 2, flops=5 * gg.numel(), design=SILU_DESIGN,
              tol=SILU_TOL, rel=SILU_REL,
              note=f"; the {ksw.plan(gg.numel(), 2, True, _build.n_sms(gg.device)).route} "
                   f"route; rounds silu(gate) to bf16 before the product as the plain "
                   f"version does (the TPU kernel keeps it in f32)")
    # decode attention: 8 slots, pages [32, 513, 16, 64], tables [8, 64]
    kp, vp = randn(kvh, nb, bs, hd), randn(kvh, nb, bs, hd)
    perm = torch.randperm(nb - 1, generator=gen, device=dev)[:slots * mb] + 1
    tables = perm.to(torch.int32).reshape(slots, mb).contiguous()
    lens = torch.randint(1, mb * bs + 1, (slots,), generator=gen, device=dev,
                         dtype=torch.int32)
    qd = randn(slots, h, hd)
    live = int(lens.clamp(max=mb * bs).sum())
    kv_row = kvh * hd * 2 * 2                     # K and V bytes of one token
    # held as row 7 is (the same function on the same lengths), per sequence
    # too, twice bitwise equal, and against a kernel that loses a split
    got = repeat_equal(torch, "paged_decode_attention",
                       lambda: kda.paged_decode_attention(qd, kp, vp, tables, lens))
    want = ref.paged_decode_attention(qd, kp, vp, tables, lengths=lens)
    hold(torch, "paged_decode_attention", got, want, DECODE_TOL, DECODE_REL)
    rs = seq_rel_err(torch, got, want)
    if rs > DECODE_SEQ_REL:
        fail(f"paged_decode_attention: a sequence's relative norm error {rs} "
             f"(tolerance {DECODE_SEQ_REL})")
    n_split, split = decode_split(torch, qd, kvh, mb * bs, bs)
    kl, vl = ref.gather_pages(kp, tables), ref.gather_pages(vp, tables)
    valid = torch.arange(mb * bs, device=dev)[None, :] < lens[:, None]
    bad, what = second_split_dropped(torch, valid, lens, split)
    dropped_step_control(torch, "paged_decode_attention", what,
                         masked_decode(torch, qd, kl, vl, valid).to(bf),
                         masked_decode(torch, qd, kl, vl, bad).to(bf),
                         DECODE_TOL, DECODE_REL, DECODE_SEQ_REL)
    del got, want, kl, vl, valid, bad
    dec_bytes = 2 * qd.numel() * 2 + live * kv_row + tables.numel() * 4
    record("paged_decode_attention", csrc + "decode_attention.cu",
           "src/repro/kernels/decode_attention.py:300",
           lambda: kda.paged_decode_attention(qd, kp, vp, tables, lens),
           lambda: ref.paged_decode_attention(qd, kp, vp, tables, lengths=lens),
           DECODE_TOL, rel=DECODE_REL, nbytes=dec_bytes, flops=4 * h * hd * live,
           note=f"; rel {DECODE_REL}, per sequence {rs:.3g}; {n_split} splits of "
                f"{split} keys; the plain version rounds p to bf16 before the PV "
                f"product")
    rows[-1]["design"] = DECODE_DESIGN
    log_rate(torch, timer, rows[-1], dec_bytes)
    # prefill attention: a 512-row chunk at q_offset 256, table [64]; held
    # twice bitwise equal, and against a kernel that loses one stage of its
    # last row tile
    qp = randn(1, c, h, hd)
    table = tables[0].contiguous()
    total = qoff + c
    attended = sum(min(qoff + i + 1, total) for i in range(c))
    repeat_equal(torch, "paged_prefill_attention",
                 lambda: kpf.paged_prefill_attention(qp, kp, vp, table, q_offset=qoff,
                                                     length=c))
    kl, vl = ref.gather_pages(kp, table)[:total], ref.gather_pages(vp, table)[:total]
    valid = (torch.arange(total, device=dev)[None, :]
             <= qoff + torch.arange(c, device=dev)[:, None])
    bad, what = stage_dropped(torch, valid, h // kvh)
    dropped_step_control(torch, "paged_prefill_attention", what,
                         masked_prefill(torch, qp, kl, vl, valid).to(bf),
                         masked_prefill(torch, qp, kl, vl, bad).to(bf),
                         PREFILL_TOL, PREFILL_REL)
    del bad
    record("paged_prefill_attention", csrc + "paged_attention.cu",
           "src/repro/kernels/prefill_attention.py:273",
           lambda: kpf.paged_prefill_attention(qp, kp, vp, table, q_offset=qoff,
                                               length=c),
           lambda: ref.paged_prefill_attention(qp, kp, vp, table, q_offset=qoff,
                                               length=c),
           PREFILL_TOL, rel=PREFILL_REL,
           nbytes=2 * qp.numel() * 2 + total * kv_row + mb * 4,
           flops=4 * h * hd * attended, note=f"; rel {PREFILL_REL}")
    rows[-1]["design"] = PREFILL_DESIGN
    sdpa_slab_yardstick(torch, timer, rows[-1], qp, kl, vl, valid)
    del kl, vl, valid
    # rmsnorm again, now that the card has run the phase's other kernels: the
    # first timed launch of a run has read up to 8x slower (PERF.md, section
    # 7), so the row keeps the repeat and the log both readings
    again = measure(torch, timer, "rmsnorm", csrc + "rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:51",
                    lambda: krn.rmsnorm(x, w, eps),
                    lambda: ref.rmsnorm(x, w, eps), NORM_TOL, rel=NORM_REL,
                    nbytes=2 * x.numel() * 2 + d * 2, flops=4 * x.numel(),
                    library=lambda: torch.nn.functional.rms_norm(x, (d,), w, eps))
    again.update(design=RMSNORM_DESIGN, launch_floor_ms=floor, one_element_ms=one_ms)
    log_rate(torch, timer, again, 2 * x.numel() * 2 + d * 2)
    first = rows[0]
    log(f"kernel rmsnorm re-timed after the phase: {again['ms']:.4f} ms (first "
        f"reading {first['ms']:.4f}), plain {again['plain_ms']:.4f} (first "
        f"{first['plain_ms']:.4f}), F.rms_norm {again['library_ms']:.4f} (first "
        f"{first['library_ms']:.4f})")
    rows[0] = again
    pool = dict(qd=qd, kp=kp, vp=vp, tables=tables, lens=lens, qp=qp,
                table=table, qoff=qoff)
    return rows, lens.clamp(max=mb * bs), pool, first


def split_sweep(torch, timer, pool):
    """Row 1 on phase 3's pool with the split forced to 1, 2, 4 and 8 (and
    at every length 1, where the grid's fixed cost shows), beside the
    plan's own choice: what the plan (kernels/_paged.py:decode_plan) is
    chosen from; logged, not gated."""
    from repro_torch.kernels import _paged
    from repro_torch.kernels import decode_attention as kda

    qd, kp, vp, tables, lens = (pool[k] for k in ("qd", "kp", "vp", "tables", "lens"))
    keys = tables.shape[1] * kp.shape[2]
    planned = kda._plan
    ones = torch.ones_like(lens)
    out = {"plan": decode_split(torch, qd, kp.shape[0], keys, kp.shape[2])}
    try:
        for n in (1, 2, 4, 8):
            def forced(q, kvh, keys, grain, n=n):
                p = planned(q, kvh, keys, grain)
                split = -(-keys // n)
                split = -(-split // grain) * grain
                return _paged.DecodePlan(keys, -(-keys // split), split,
                                         p.row_tiles, p.grid, p.cluster)
            kda._plan = forced
            out[n] = (timer(lambda: kda.paged_decode_attention(qd, kp, vp, tables, lens)),
                      timer(lambda: kda.paged_decode_attention(qd, kp, vp, tables, ones)))
    finally:
        kda._plan = planned
    log("paged decode split sweep (ms at phase 3's lengths / at length 1; the "
        f"plan takes {out['plan'][0]} splits of {out['plan'][1]} keys): " +
        ", ".join(f"{n} splits {a:.4f} / {b:.4f}" for n, (a, b) in out.items()
                  if n != "plan"))
    return out


def parity_phase(torch, cfg_small):
    """Reduced stablelm at fp32: a prefill chunk and two decode steps on the
    card against the CPU, same parameters (the repo's own reference)."""
    from repro_torch.models import model as M

    params = M.init_params(cfg_small, seed=0, device="cpu", dtype=torch.float32)
    out = {}
    for dev, p in (("cpu", params), ("cuda", to_device(params, "cuda"))):
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


def serve_params(torch, cfg):
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} params on the card in "
        f"{time.perf_counter() - t0:.1f} s ({cfg.n_layers} L, d {cfg.d_model}, "
        f"{cfg.n_heads} H, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size})")
    return params


def serve_mix(torch, cfg, params, counters, hook=None, **engine_kw):
    """Serve the full-width mix once through an engine built with
    ``engine_kw`` (``hook(engine)``, given, is called before the first
    submission); the counters are zeroed just before and read just
    after."""
    from repro_torch.launch.serve import (MIX_ENGINE, MIX_NEW_TOKENS,
                                          shared_prefix_mix)
    from repro_torch.serve import ServeEngine

    prompts = shared_prefix_mix(cfg.vocab_size)
    eng = ServeEngine(cfg, params, **{**MIX_ENGINE, **engine_kw})
    if hook is not None:
        hook(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new_tokens=MIX_NEW_TOKENS)
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {name: c.read() for name, c in counters.items()}
    out = {r.rid: list(r.out_tokens) for r in done}
    stats = dict(eng.stats)
    ttfts = sorted(r.ttft for r in done)
    peak = torch.cuda.max_memory_allocated()
    pool_bytes = eng.kv_cache_bytes()
    del eng
    torch.cuda.empty_cache()
    n_tok = sum(len(t) for t in out.values())
    if len(out) != len(prompts) or any(len(t) != MIX_NEW_TOKENS
                                       for t in out.values()):
        fail(f"serve: {len(out)} of {len(prompts)} requests finished, token "
             f"counts {sorted({len(t) for t in out.values()})}")
    if any(not 0 <= x < cfg.vocab_size for t in out.values() for x in t):
        fail("serve: a token id outside the vocabulary")
    summary = dict(requests=len(out), tokens=n_tok, wall_s=wall,
                   tok_s=n_tok / wall, ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3,
                   prefill_dispatches=stats["prefill_dispatches"],
                   decode_dispatches=stats["decode_dispatches"],
                   peak_mem_bytes=peak, pool_bytes=pool_bytes)
    return out, stats, launches, summary


def check_launches(tag, launches, expect):
    log(f"{tag}: kernel launches {launches} (expected {expect})")
    for name, n in launches.items():
        if expect[name] > 0 and n <= 0:
            fail(f"{tag}: kernel {name} was never launched on the main path")
        if n != expect[name]:
            fail(f"{tag}: kernel {name} launched {n} times, expected {expect[name]}")


def serve_expect(L, P, Dd):
    """Phase 5's launch formulas over P prefill chunks and Dd decode steps
    (a dense model of L layers, one shard, the engine dtype's pool)."""
    return {
        "rmsnorm": (2 * L + 1) * (P + Dd), "apply_rope": L * (P + Dd),
        "apply_rope_qk": L * (P + Dd), "rmsnorm_vector": (2 * L + 1) * (P + Dd),
        "apply_rope_vector": L * (P + Dd),
        "silu_mul": L * (P + Dd), "silu_mul_scalar": 0,
        "paged_decode_attention": L * Dd,
        "paged_prefill_attention": L * P, "paged_prefill_attention_tc": L * P}


def serve_phase(torch, cfg, params, counters):
    from repro_torch.serve import ServeEngine

    # warm-up on a small engine: cuBLAS handles and the GEMM shapes
    warm = ServeEngine(cfg, params, slots=8, max_seq=160, block_size=16,
                       prefill_buckets=(32, 128))
    warm.submit(list(range(40)), max_new_tokens=3)
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    out, stats, launches, summary = serve_mix(torch, cfg, params, counters,
                                              prefix_caching=True)
    L = cfg.n_layers
    P, Dd = stats["prefill_dispatches"], stats["decode_dispatches"]
    log(f"serve: {summary['requests']} requests, {summary['tokens']} tokens in "
        f"{summary['wall_s']:.3f} s ({summary['tok_s']:.1f} tok/s), ttft p50 "
        f"{summary['ttft_p50_ms']:.1f} ms, prefix_hit_tokens "
        f"{stats['prefix_hit_tokens']}, prefill chunks {P}, decode steps {Dd}, "
        f"peak memory {summary['peak_mem_bytes'] / 2**30:.2f} GiB")
    check_launches("serve", launches, serve_expect(L, P, Dd))
    if stats["prefix_hit_tokens"] <= 0:
        fail("serve: the shared-prefix requests never hit the prefix cache")

    out_off, stats_off, _, summary_off = serve_mix(torch, cfg, params, counters,
                                                   prefix_caching=False)
    if out_off != out:
        diff = [rid for rid in out if out[rid] != out_off.get(rid)]
        fail(f"serve: greedy outputs differ with prefix caching off (rids {diff})")
    log(f"serve: prefix caching off: token-identical, {summary_off['wall_s']:.3f} s, "
        f"prefill tokens {stats_off['prefill_tokens']} vs "
        f"{stats['prefill_tokens']} with caching")
    summary.update(prefix_hit_tokens=stats["prefix_hit_tokens"],
                   wall_s_cache_off=summary_off["wall_s"])
    return launches, summary, out


def seq_rel_err(torch, got, want) -> float:
    """The largest relative norm error of one sequence (dim 0)."""
    g, w = got.float().flatten(1), want.float().flatten(1)
    return float(((g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-30)).max())


def dropped_step_control(torch, name, what, ok, bad, tol, rel, seq_rel=None):
    """Fail unless the check of a kernel's output (``tol`` elementwise,
    ``rel`` relative norm, ``seq_rel`` per-sequence relative norm) tells
    the right output ``ok`` from ``bad``, that of a kernel that drops some
    of its keys (``what`` says which)."""
    d = float((bad.float() - ok.float()).abs().max())
    r = rel_err(torch, bad, ok)
    caught = [not torch.allclose(bad.float(), ok.float(), **tol), r > rel]
    msg = (f"{name} control: a kernel that drops {what} reads max|err| {d:.3g} "
           f"(caught: {caught[0]}), relative norm {r:.3g} (caught: {caught[1]})")
    if seq_rel is not None:
        rs = seq_rel_err(torch, bad, ok)
        caught.append(rs > seq_rel)
        msg += f", per-sequence relative norm {rs:.3g} (caught: {caught[2]})"
    log(msg)
    if not any(caught):
        fail(f"{name} control: the tolerances pass a kernel that drops "
             f"{what}")


def masked_prefill(torch, q, k, v, valid):
    """Plain f32 attention of a chunk q [1, C, H, D] over gathered keys k, v
    [Sk, KvH, D] with a [C, Sk] bool key mask."""
    g = q.shape[2] // k.shape[1]
    kh = k.float().repeat_interleave(g, dim=1)
    vh = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("chd,khd->chk", q[0].float(), kh) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    return torch.einsum("chk,khd->chd", torch.softmax(s, dim=-1), vh)[None]


def stage_dropped(torch, valid, group):
    """``valid`` [C, Sk] with one 64-key stage of the bf16 paged prefill's
    last row tile masked (stage PREFILL_DROP_STAGE of its walk, for that
    tile's chunk positions): what a kernel that loses the stage would
    attend; also returns what it says."""
    from repro_torch.kernels import _paged

    c = valid.shape[0]
    n_rows = c * group
    first = (n_rows - 1) // _paged.TC_ROWS * _paged.TC_ROWS // group
    k0 = PREFILL_DROP_STAGE * _paged.PREFILL_STAGE
    k1 = k0 + _paged.PREFILL_STAGE
    if not bool(valid[first:, k0:k1].all()):
        fail(f"prefill control: the last tile's rows do not all see keys "
             f"[{k0}, {k1})")
    bad = valid.clone()
    bad[first:, k0:k1] = False
    return bad, (f"keys [{k0}, {k1}) (stage {PREFILL_DROP_STAGE} of the last "
                 f"row tile) for chunk positions {first}-{c - 1}")


def sdpa_slab_yardstick(torch, timer, row, q, k, v, valid) -> None:
    """Log, not gated: SDPA with the same causal mask over the K/V gathered
    beforehand into a slab (the gather outside the timed call): what the
    same attention costs when nothing reads a page table.  Kept on the row
    as ``sdpa_slab_ms`` (not ``library_ms``: no PyTorch call reads a paged
    pool)."""
    g = q.shape[2] // k.shape[1]
    qs = q.transpose(1, 2).contiguous()
    ks = k.repeat_interleave(g, dim=1).transpose(0, 1)[None].contiguous()
    vs = v.repeat_interleave(g, dim=1).transpose(0, 1)[None].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    got = sdpa(qs, ks, vs, attn_mask=valid).transpose(1, 2)
    want = masked_prefill(torch, q, k, v, valid)
    row["sdpa_slab_ms"] = timer(lambda: sdpa(qs, ks, vs, attn_mask=valid))
    log(f"kernel {row['name']}: SDPA over K/V gathered beforehand (a slab, the "
        f"same causal mask; yardstick, not gated) {row['sdpa_slab_ms']:.4f} ms "
        f"(the kernel {row['ms']:.4f}), its max|err| against the plain f32 "
        f"attention {float((got.float() - want).abs().max()):.3g} (the "
        f"kernel's against the plain version {row['max_abs_err']:.3g})")


def masked_decode(torch, q, k, v, valid):
    """Plain f32 one-row attention (MHA) with a [B, Sk] bool key mask."""
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    return torch.einsum("bhk,bkhd->bhd", torch.softmax(s, dim=-1), v.float())


def decode_split(torch, q, kvh, keys, grain):
    """The split the decode kernel's plan gives these shapes on this card:
    (n_split, split_keys)."""
    from repro_torch.kernels import _build, _paged

    b, h, _ = q.shape
    plan = _paged.decode_plan(b, kvh, h // kvh, keys, grain, _build.n_sms(q.device))
    return plan.n_split, plan.split_keys


def second_split_dropped(torch, valid, lens, split):
    """``valid`` [B, keys] with the longest sequence's keys [split, 2 split)
    masked: what a decode kernel that loses its second split of the
    longest sequence would attend; also returns what it says."""
    longest = int(torch.argmax(lens))
    n = int(lens[longest])
    if n <= split:
        fail(f"decode control: the longest sequence ({n} keys) does not reach "
             f"a second split of {split} keys")
    bad = valid.clone()
    bad[longest, split:2 * split] = False
    return bad, (f"the second {split}-key split of the longest sequence "
                 f"(sequence {longest}, {n} keys)")


def log_rate(torch, timer, row, nbytes) -> None:
    """Log a bytes-bound row's GB/s and its share of the bound (the bound
    over the card time), and time beside it one PyTorch sum over as many
    bytes (``read_ms``: a plain read of the same size under the same
    protocol, whose flush leaves the L2 full of dirty lines); keep all
    three on the row."""
    row["gb_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
    row["bound_share"] = row["bound_ms"] / row["ms"]
    buf = torch.zeros(int(nbytes) // 4, dtype=torch.float32, device="cuda")
    row["read_ms"] = timer(lambda: buf.sum())
    del buf
    log(f"kernel {row['name']}: {row['gb_s']:.1f} GB/s of the bytes it must "
        f"move, {row['bound_share']:.3f} of its bound; a PyTorch sum over as "
        f"many bytes {row['read_ms']:.4f} ms ({row['ms'] / row['read_ms']:.3f}x)")


def repeat_equal(torch, name, fn):
    """Fail unless two calls of ``fn`` give the same bits; returns the
    first."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    pairs = zip(a, b) if isinstance(a, tuple) else ((a, b),)
    if not all(torch.equal(x, y) for x, y in pairs):
        fail(f"{name}: two calls on the same inputs differ")
    return a


def dense_kernel_phase(torch, timer, cfg, lens):
    """Row 7 (dense-slab flash-decoding) at the serving path's full-width
    stablelm-1.6b shapes with ``lens``, the live lengths of the paged decode
    row, and the flash forward with a key bound at the slab prefill's
    shape; bf16 timed, f32 held."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref

    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    slots, max_seq = lens.shape[0], 1024
    src = "src/repro_torch/kernels/csrc/decode_attention.cu"
    rep = "src/repro/kernels/decode_attention.py:114"
    kpos = torch.arange(max_seq, device=dev)

    def dense_holds(tag, q, k, v, tol, rel, seq_rel):
        """Output (also per sequence, to ``seq_rel``; twice bitwise equal),
        the partials of two shards at kv_offset 0 and 512 combined, and a
        shard past every length (the identity)."""
        n = q.shape[1] // k.shape[2]
        got = repeat_equal(torch, f"decode_attention {tag}",
                           lambda: kda.decode_attention(q, k, v, lens))
        want = ref.decode_attention(q, k, v, lengths=lens)
        hold(torch, f"decode_attention {tag}", got, want, tol, rel)
        rs = seq_rel_err(torch, got, want)
        if rs > seq_rel:
            fail(f"decode_attention {tag}: a sequence's relative norm error "
                 f"{rs} (tolerance {seq_rel})")
        cut = max_seq // 2
        k1, v1, k2, v2 = (t.contiguous() for t in (k[:, :cut], v[:, :cut],
                                                   k[:, cut:], v[:, cut:]))
        got = ref.combine_partials(kda.decode_attention_partial(q, k1, v1, lens),
                                   kda.decode_attention_partial(q, k2, v2, lens, cut))
        want = ref.decode_attention_partial(q, k, v, lengths=lens)
        # acc normalised: in bf16 the plain version rounds p before the PV
        # product, an error that grows with l in acc itself
        errs = [hold(torch, f"decode_attention_partial {tag} {part}", g, w, tol,
                     rel if part == "acc / l" else None)
                for part, g, w in (("acc / l", got[0] / got[2][..., None],
                                    want[0] / want[2][..., None]),
                                   ("m", got[1], want[1]), ("l", got[2], want[2]))]
        acc, m, l = kda.decode_attention_partial(q, k2, v2, lens, max_seq)
        torch.cuda.synchronize()
        if not (bool((acc == 0).all()) and bool((m == -1e30).all())
                and bool((l == 0).all())):
            fail(f"decode_attention_partial {tag}: a shard past every length "
                 f"is not the combine identity (0, -1e30, 0)")
        log(f"decode_attention {tag} (G = {n}): per-sequence relative norm "
            f"error up to {rs:.3g}; shards at kv_offset 0 / {cut} "
            f"combined max|err| acc / l {errs[0]:.3g}, m {errs[1]:.3g}, l "
            f"{errs[2]:.3g}; a shard at kv_offset {max_seq} is the identity")

    q = randn(slots, h, hd)
    k, v = randn(slots, max_seq, kvh, hd), randn(slots, max_seq, kvh, hd)
    live = int(lens.sum())
    kv_row = kvh * hd * 2 * 2                     # K and V bytes of one token
    qs, ks, vs = q[:, :, None], k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = (kpos[None, :] < lens[:, None])[:, None, None, :]
    n_split, split = decode_split(torch, q, kvh, max_seq, 32)
    dec_bytes = 2 * q.numel() * 2 + live * kv_row + slots * 4
    rows = [measure(
        torch, timer, "decode_attention", src, rep,
        lambda: kda.decode_attention(q, k, v, lens),
        lambda: ref.decode_attention(q, k, v, lengths=lens), DECODE_TOL,
        rel=DECODE_REL, nbytes=dec_bytes, flops=4 * h * hd * live,
        library=lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
        note=f"; rel {DECODE_REL}; {live} live keys of {slots * max_seq}; "
             f"{n_split} splits of {split} keys; the plain version rounds p to "
             f"bf16 before the PV product")]
    rows[0]["design"] = DECODE_DESIGN
    log_rate(torch, timer, rows[0], dec_bytes)

    # row 7 and SDPA on these inputs (bound now: the names are reused below)
    again = (lambda q=q, k=k, v=v: kda.decode_attention(q, k, v, lens),
             lambda qs=qs, ks=ks, vs=vs, mask=mask: F.scaled_dot_product_attention(
                 qs, ks, vs, attn_mask=mask))

    def row7_again():
        """Row 7 and SDPA timed again, alternating, later in the run: its
        first reading's gap to SDPA is inside the spread between calls."""
        t = [timer(f) for f in again * 2]
        return (t[0] + t[2]) / 2, (t[1] + t[3]) / 2

    dense_holds("bf16", q, k, v, DECODE_TOL, DECODE_REL, DECODE_SEQ_REL)
    qf, kf, vf = q.float(), k.float(), v.float()
    dense_holds("f32", qf, kf, vf, DENSE_F32_TOL, DENSE_F32_REL, DENSE_F32_REL)
    # the kernel's grain: the longest sequence loses its second split
    valid = kpos[None, :] < lens[:, None]
    bad, what = second_split_dropped(torch, valid, lens, split)
    dropped_step_control(
        torch, "decode_attention", what, masked_decode(torch, q, k, v, valid).to(bf),
        masked_decode(torch, q, k, v, bad).to(bf), DECODE_TOL, DECODE_REL,
        DECODE_SEQ_REL)
    del qs, ks, vs, mask, qf, kf, vf, valid, bad
    # GQA: granite-3-2b's 32 query heads over 8 kv heads
    kg, vg = randn(slots, max_seq, 8, hd), randn(slots, max_seq, 8, hd)
    dense_holds("bf16 GQA", q, kg, vg, DECODE_TOL, DECODE_REL, DECODE_SEQ_REL)
    dense_holds("f32 GQA", q.float(), kg.float(), vg.float(), DENSE_F32_TOL,
                DENSE_F32_REL, DENSE_F32_REL)
    del q, k, v, kg, vg

    # the flash forward with a key bound: one 1024-row prefill at length 700
    fa_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    fa_rep = "src/repro/kernels/flash_attention.py:109"
    q, k, v = (randn(1, max_seq, h, hd) for _ in range(3))
    ln = torch.tensor([FLASH_LEN], dtype=torch.int32, device=dev)
    pairs = sum(min(i + 1, FLASH_LEN) for i in range(max_seq))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    vis = (kpos[None, :] <= kpos[:, None]) & (kpos[None, :] < FLASH_LEN)
    rows.append(measure(
        torch, timer, "flash_attention_lengths", fa_src, fa_rep,
        lambda: kfa.flash_attention_fwd(q, k, v, causal=True, lengths=ln)[0],
        lambda: ref.flash_attention(q, k, v, causal=True, lengths=ln),
        FLASH_O_TOL, rel=FLASH_REL,
        nbytes=(2 * q.numel() + 2 * FLASH_LEN * kvh * hd) * 2 + h * max_seq * 4,
        flops=4 * h * hd * pairs,
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis),
        note=f"; rel {FLASH_REL}; causal, keys below {FLASH_LEN}; the TPU "
             f"path runs the plain version here", iters=10, plain_iters=3))
    rows[-1].update(row="6e", design=FLASH_DESIGN)
    yardstick(torch, rows[-1], ("o",),
              (F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis).transpose(1, 2),),
              (ref.flash_attention(q, k, v, causal=True, lengths=ln),))
    qf, kf, vf = q.float(), k.float(), v.float()
    err = hold(torch, "flash_attention_lengths f32",
               kfa.flash_attention_fwd(qf, kf, vf, causal=True, lengths=ln)[0],
               ref.flash_attention(qf, kf, vf, causal=True, lengths=ln),
               DENSE_F32_TOL, DENSE_F32_REL)
    log(f"flash_attention_lengths f32: max|err| {err:.3g} (tol {DENSE_F32_TOL}, "
        f"rel {DENSE_F32_REL})")
    bad = torch.full_like(ln, (FLASH_LEN - 1) // DENSE_STEP * DENSE_STEP)
    dropped_step_control(
        torch, "flash_attention_lengths",
        f"the last {DENSE_STEP}-key step below the bound (keys {int(bad)} to "
        f"{FLASH_LEN - 1})",
        ref.flash_attention(qf, kf, vf, causal=True, lengths=ln).to(bf),
        ref.flash_attention(qf, kf, vf, causal=True, lengths=bad).to(bf),
        FLASH_O_TOL, FLASH_REL)
    del q, k, v, qt, kt, vt, vis, qf, kf, vf
    torch.cuda.empty_cache()
    return rows, row7_again


def dense_parity_phase(torch, cfg_small):
    """Reduced stablelm at fp32 over the dense slabs: a batched prefill of
    two ragged prompts and two decode steps on the card against the CPU,
    same parameters."""
    from repro_torch.models import model as M

    params = M.init_params(cfg_small, seed=0, device="cpu", dtype=torch.float32)
    tok = torch.tensor([[5, 9, 2, 77, 3, 3, 41, 0], [8, 1, 6, 0, 0, 0, 0, 0]],
                       dtype=torch.int32)
    lens = torch.tensor([7, 3], dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = to_device(params, dev)
        state = M.init_decode_state(cfg_small, 2, 16, dtype=torch.float32,
                                    device=dev)
        lg, state = M.prefill(cfg_small, p, state, tokens=tok.to(dev),
                              lengths=lens.to(dev))
        logits = [lg[:, 0].cpu()]
        for i, t in enumerate((11, 64)):
            toks = torch.tensor([t, t + 1], dtype=torch.int32)
            lg, state = M.decode_step(cfg_small, p, state, toks.to(dev),
                                      (lens + i).to(dev))
            logits.append(lg.cpu())
        out[dev] = torch.cat(logits)
    err = float((out["cuda"] - out["cpu"]).abs().max())
    if not torch.allclose(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4):
        fail(f"dense parity: reduced model over the slabs on the card disagrees "
             f"with the CPU: max |err| {err}")
    log(f"dense parity: reduced stablelm fp32 slab prefill + 2 decode steps, "
        f"logits card vs cpu max|err| {err:.3g} (tol 1e-4)")


def prefill_gate(torch, cfg, params):
    """One ~640-token prompt's last-token logits: the slab ``prefill``
    (bucket 1024, flash with a key bound) against the paged path's chunked
    prefill (chunks of 512 and 128), full width, bf16."""
    from repro_torch.models import model as M

    n, bs = 640, 16
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                           device="cuda", dtype=torch.int32)
    slab = M.init_decode_state(cfg, 1, 1024, dtype=torch.bfloat16)
    padded = torch.zeros((1, 1024), dtype=torch.int32, device="cuda")
    padded[0, :n] = prompt
    lens = torch.tensor([n], dtype=torch.int32, device="cuda")
    want, _ = M.prefill(cfg, params, slab, tokens=padded, lengths=lens)
    del slab
    pages = M.init_serve_state(cfg, 1, 1 + n // bs, bs, dtype=torch.bfloat16)
    table = torch.arange(1, 1 + n // bs, dtype=torch.int32, device="cuda")
    for off, c in ((0, 512), (512, 128)):
        got, _ = M.prefill_paged(cfg, params, pages, tokens=prompt[None, off:off + c],
                                 length=c, q_offset=off,
                                 block_table=table[:-(-(off + c) // bs)])
    del pages
    torch.cuda.empty_cache()
    r = rel_err(torch, got, want[:, 0])
    agree = bool(torch.argmax(got) == torch.argmax(want[:, 0]))
    log(f"dense serve gate: {n}-token prompt, last-token logits slab prefill vs "
        f"paged chunked prefill relative norm error {r:.3g} (tolerance "
        f"{PREFILL_GATE_REL}), argmax agrees: {agree}")
    if not math.isfinite(r) or r > PREFILL_GATE_REL:
        fail(f"dense serve gate: slab and paged prefill logits differ, relative "
             f"norm error {r} (tolerance {PREFILL_GATE_REL})")
    return r


def dense_serve_phase(torch, cfg, params, counters, paged_out, paged_summary):
    out, stats, launches, summary = serve_mix(torch, cfg, params, counters,
                                              paged=False)
    L = cfg.n_layers
    P, Dd = stats["prefill_dispatches"], stats["decode_dispatches"]
    check_launches("dense serve", launches, {
        "rmsnorm": (2 * L + 1) * (P + Dd), "apply_rope": L * (P + Dd),
        "apply_rope_qk": L * (P + Dd), "rmsnorm_vector": (2 * L + 1) * (P + Dd),
        "apply_rope_vector": L * (P + Dd),
        "silu_mul": L * (P + Dd), "silu_mul_scalar": 0,
        "flash_attention_lengths": L * P,
        "decode_attention": L * Dd, "flash_attention": 0,
        "paged_decode_attention": 0, "paged_prefill_attention": 0,
        "paged_prefill_attention_tc": 0})
    same = sum(out[rid] == paged_out.get(rid) for rid in out)
    first = sorted(next((i for i, (a, b) in enumerate(zip(out[rid], paged_out[rid]))
                         if a != b), len(out[rid])) for rid in out)
    log(f"dense serve: {summary['requests']} requests, {summary['tokens']} "
        f"tokens in {summary['wall_s']:.3f} s ({summary['tok_s']:.1f} tok/s; "
        f"paged {paged_summary['tok_s']:.1f}), ttft p50 "
        f"{summary['ttft_p50_ms']:.1f} ms (paged "
        f"{paged_summary['ttft_p50_ms']:.1f}), prefills {P}, decode steps {Dd}, "
        f"peak memory {summary['peak_mem_bytes'] / 2**30:.2f} GiB (paged "
        f"{paged_summary['peak_mem_bytes'] / 2**30:.2f}); {same} of "
        f"{len(out)} requests token-identical to the paged run (not gated; "
        f"first differing token of each request, sorted: {first})")
    summary.update(same_as_paged=same, first_difference=first,
                   prefill_gate_rel=prefill_gate(torch, cfg, params))
    fp32_identity(torch, cfg)
    return launches, summary


def fp32_identity(torch, cfg):
    """The mix at full width in fp32 (parameters from the same seed): the
    dense-slab engine must be token-identical to the paged one."""
    from repro_torch.models import model as M

    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    paged, _, _, s_paged = serve_mix(torch, cfg, params, {})
    dense, _, _, s_dense = serve_mix(torch, cfg, params, {}, paged=False)
    del params
    torch.cuda.empty_cache()
    diff = [rid for rid in paged if paged[rid] != dense.get(rid)]
    log(f"dense serve fp32: {len(paged) - len(diff)} of {len(paged)} requests "
        f"token-identical to the paged engine ({s_dense['tok_s']:.1f} vs "
        f"{s_paged['tok_s']:.1f} tok/s)")
    if diff:
        fail(f"dense serve fp32: greedy outputs differ from the paged engine "
             f"(rids {diff})")


def quantize_pages(torch, pages):
    """Per-(kv head, page) int8 quantization of float pages [KvH, NB, BS,
    D], the scale formed as the port's quantizers form it."""
    from repro_torch.models.layers import _INV127, KV_SCALE_EPS

    p = pages.float()
    scales = (p.abs().amax(dim=(2, 3)) * _INV127).clamp_min(KV_SCALE_EPS)
    q8 = torch.clamp(torch.round(p / scales[..., None, None]), -127, 127)
    return q8.to(torch.int8).contiguous(), scales.contiguous()


def int8_kernel_phase(torch, timer, cfg, pool):
    """Phase 17, kernels: phase 3's full-width pools quantized per (kv head,
    page); both int8 variants in bf16 (timed beside the float kernel on the
    pool before quantization) and in f32, held against their plain versions,
    a control that doubles one live page's K scale, and a second call bitwise
    equal to the first."""
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import prefill_attention as kpf
    from repro_torch.kernels import ref

    qd, kp, vp, tables, lens = (pool[k] for k in ("qd", "kp", "vp", "tables", "lens"))
    qp, table, qoff = pool["qp"], pool["table"], pool["qoff"]
    k8, ks = quantize_pages(torch, kp)
    v8, vs = quantize_pages(torch, vp)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    slots, mb = tables.shape
    bs = kp.shape[2]
    c = qp.shape[1]
    live = lens.clamp(max=mb * bs)
    live_pages = int(((live + bs - 1) // bs).sum())
    csrc = "src/repro_torch/kernels/csrc/"
    longest = int(torch.argmax(live))
    cases = {
        "paged_decode_attention_int8": dict(
            replaces="src/repro/kernels/decode_attention.py:300",
            source=csrc + "decode_attention.cu",
            kernel=lambda q, s: kda.paged_decode_attention(q, k8, v8, tables, lens, s, vs),
            plain=lambda q: ref.paged_decode_attention(q, k8, v8, tables, lengths=lens,
                                                       k_scales=ks, v_scales=vs),
            float_kernel=lambda: kda.paged_decode_attention(qd, kp, vp, tables, lens),
            q=qd, n_live=int(live.sum()), pages=live_pages,
            table_bytes=tables.numel() * 4, flops=4 * h * hd * int(live.sum()),
            ctrl_page=int(tables[longest, 0]),
            what=f"sequence {longest}'s first page ({int(live[longest])} keys)"),
        "paged_prefill_attention_int8": dict(
            replaces="src/repro/kernels/prefill_attention.py:273",
            source=csrc + "paged_attention.cu",
            kernel=lambda q, s: kpf.paged_prefill_attention(
                q, k8, v8, table, q_offset=qoff, length=c, k_scales=s, v_scales=vs),
            plain=lambda q: ref.paged_prefill_attention(
                q, k8, v8, table, q_offset=qoff, length=c, k_scales=ks, v_scales=vs),
            float_kernel=lambda: kpf.paged_prefill_attention(
                qp, kp, vp, table, q_offset=qoff, length=c),
            q=qp, n_live=qoff + c, pages=-(-(qoff + c) // bs), table_bytes=mb * 4,
            flops=4 * h * hd * sum(qoff + i + 1 for i in range(c)),
            ctrl_page=int(table[0]),
            what="the chunk's first page (every row attends to it)"),
    }
    rows, float_ms = [], {}
    for name, cs in cases.items():
        q = cs["q"]
        ks_ctrl = ks.clone()
        ks_ctrl[0, cs["ctrl_page"]] *= 2
        for dtype, tol, rel in ((torch.float32, Q8_F32_TOL, None),
                                (torch.bfloat16, Q8_BF16_TOL, Q8_REL)):
            qq = q.to(dtype)
            got = cs["kernel"](qq, ks)
            again = cs["kernel"](qq, ks)
            want = cs["plain"](qq)
            torch.cuda.synchronize()
            tag = f"{name} {str(dtype)[6:]}"
            err = hold(torch, tag, got, want, tol, rel)
            if not torch.equal(got, again):
                fail(f"{tag}: two calls on the same inputs differ")
            bad = cs["kernel"](qq, ks_ctrl)
            d = float((bad.float() - want.float()).abs().max())
            r = rel_err(torch, bad, want)
            caught = not torch.allclose(bad.float(), want.float(), **tol)
            log(f"{tag}: max|err| {err:.3g} (tol {tol}), relative norm "
                f"{rel_err(torch, got, want):.3g}, second call bitwise equal; "
                f"control (K scale of {cs['what']} doubled, kv head 0) reads "
                f"max|err| {d:.3g}, relative norm {r:.3g} (caught: {caught})")
            if not caught:
                fail(f"{tag} control: the tolerance {tol} passes a kernel whose "
                     f"input has one K scale doubled")
            del got, again, want, bad
        float_ms[name] = timer(cs["float_kernel"])
        qb = q.to(torch.bfloat16)
        io = 2 * qb.numel() * 2                     # q read, out written, bf16
        nbytes = (io + cs["n_live"] * kvh * hd * 2 + cs["pages"] * kvh * 2 * 4
                  + cs["table_bytes"])
        row = measure(torch, timer, name, cs["source"], cs["replaces"],
                      lambda: cs["kernel"](qb, ks), lambda: cs["plain"](qb),
                      Q8_BF16_TOL, rel=Q8_REL, nbytes=nbytes, flops=cs["flops"],
                      note=f"; rel {Q8_REL}; the float kernel on the pool before "
                           f"quantization {float_ms[name]:.4f} ms")
        rows.append(row)
        row["design"] = DECODE_DESIGN if name.startswith("paged_decode") else PREFILL_DESIGN
        if name.startswith("paged_decode"):
            # the decode kernel's grain: the longest sequence loses its
            # second split (the plain version over the dequantized pages)
            _, split = decode_split(torch, qb, kvh, mb * bs, bs)
            kl, vl = ref.gather_pages(k8, tables, ks), ref.gather_pages(v8, tables, vs)
            valid = torch.arange(mb * bs, device=qb.device)[None, :] < live[:, None]
            bad, what = second_split_dropped(torch, valid, live, split)
            dropped_step_control(torch, name, what,
                                 masked_decode(torch, qb, kl, vl, valid).to(qb.dtype),
                                 masked_decode(torch, qb, kl, vl, bad).to(qb.dtype),
                                 Q8_BF16_TOL, Q8_REL)
            del kl, vl, valid, bad
            log_rate(torch, timer, row, nbytes)
    del k8, v8, ks, vs, ks_ctrl
    torch.cuda.empty_cache()
    return rows, float_ms


def int8_parity_phase(torch, cfg_small):
    """Phase 17, parity: reduced stablelm at fp32 over an int8 pool, two
    prefill chunks (5 rows, then 6 from mid-page) and four decode steps on
    the card against the CPU; the logits held to Q8_LOGITS_TOL, the int8
    pages and scales (the null page 0 left out) reported."""
    from repro_torch.models import model as M

    params = M.init_params(cfg_small, seed=0, device="cpu", dtype=torch.float32)
    tok = torch.tensor([[5, 9, 2, 77, 3, 3, 41, 0, 8, 1, 6, 2]], dtype=torch.int32)
    bt = torch.tensor([[2, 4, 6, 8], [1, 3, 0, 0]], dtype=torch.int32)
    out, pools = {}, {}
    for dev in ("cpu", "cuda"):
        p = to_device(params, dev)
        state = M.init_serve_state(cfg_small, 2, 9, 8, dtype=torch.float32,
                                   device=dev, kv_dtype="int8")
        logits = []
        for off, n, mbk in ((0, 5, 1), (5, 6, 2)):
            lg, state = M.prefill_paged(cfg_small, p, state,
                                        tokens=tok[:, off:off + 8].to(dev), length=n,
                                        q_offset=off, block_table=bt[0, :mbk].to(dev))
            logits.append(lg.cpu())
        lens = torch.tensor([11, 0], dtype=torch.int32)
        for t in (11, 64, 7, 99):
            lg, state = M.decode_step_paged(
                cfg_small, p, state, torch.tensor([t, 0], dtype=torch.int32).to(dev),
                lens.to(dev), bt.to(dev))
            logits.append(lg[:1].cpu())
            lens = lens + torch.tensor([1, 0], dtype=torch.int32)
        out[dev] = torch.cat(logits)
        pools[dev] = {k: v[:, :, 1:].cpu() for k, v in state["attn"].items()}
    err = float((out["cuda"] - out["cpu"]).abs().max())
    n_diff = sum(int((pools["cuda"][k] != pools["cpu"][k]).sum())
                 for k in ("k_pages", "v_pages"))
    n_vals = sum(pools["cpu"][k].numel() for k in ("k_pages", "v_pages"))
    step = max(int((pools["cuda"][k].int() - pools["cpu"][k].int()).abs().max())
               for k in ("k_pages", "v_pages"))
    s_rel = max(float(((pools["cuda"][k] - pools["cpu"][k]).abs()
                       / pools["cpu"][k]).max()) for k in ("k_scales", "v_scales"))
    log(f"int8 parity: reduced stablelm fp32, 2 prefill chunks + 4 decode steps, "
        f"logits card vs cpu max|err| {err:.3g} (tol {Q8_LOGITS_TOL}); int8 "
        f"values differing {n_diff} of {n_vals} (largest step {step}), scales "
        f"max relative difference {s_rel:.3g}")
    if not torch.allclose(out["cuda"], out["cpu"], **Q8_LOGITS_TOL):
        fail(f"int8 parity: reduced model over an int8 pool on the card disagrees "
             f"with the CPU: max |err| {err}")
    return dict(logits_err=err, int8_diff=n_diff, int8_values=n_vals,
                largest_step=step, scale_rel=s_rel)


def int8_serve_phase(torch, cfg, params, counters, paged_out, paged_summary):
    """Phase 17, serve: the mix of 5 through ``ServeEngine(kv_dtype="int8")``
    with the parameters of 5; the int8 variants launched at their formulas
    and the float paged kernels not at all, token-identical with prefix
    caching off; tok/s, TTFT, peak memory and pool bytes beside phase 5's
    run, and the share of requests token-identical to it (not gated: int8
    and the bf16 pool differ in the reference too)."""
    from repro_torch.serve import ServeEngine

    warm = ServeEngine(cfg, params, slots=8, max_seq=160, block_size=16,
                       prefill_buckets=(32, 128), kv_dtype="int8")
    warm.submit(list(range(40)), max_new_tokens=3)
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    out, stats, launches, summary = serve_mix(torch, cfg, params, counters,
                                              kv_dtype="int8")
    L = cfg.n_layers
    P, Dd = stats["prefill_dispatches"], stats["decode_dispatches"]
    check_launches("int8 serve", launches, {
        "rmsnorm": (2 * L + 1) * (P + Dd), "apply_rope": L * (P + Dd),
        "apply_rope_qk": L * (P + Dd), "rmsnorm_vector": (2 * L + 1) * (P + Dd),
        "apply_rope_vector": L * (P + Dd),
        "silu_mul": L * (P + Dd), "silu_mul_scalar": 0,
        "paged_decode_attention": 0,
        "paged_prefill_attention": 0, "paged_decode_attention_int8": L * Dd,
        "paged_prefill_attention_int8": L * P, "paged_prefill_attention_tc": L * P})
    if stats["prefix_hit_tokens"] <= 0:
        fail("int8 serve: the shared-prefix requests never hit the prefix cache")
    out_off, _, _, summary_off = serve_mix(torch, cfg, params, {},
                                           kv_dtype="int8", prefix_caching=False)
    if out_off != out:
        diff = [rid for rid in out if out[rid] != out_off.get(rid)]
        fail(f"int8 serve: greedy outputs differ with prefix caching off (rids {diff})")
    same = sum(out[rid] == paged_out.get(rid) for rid in out)
    first = sorted(next((i for i, (a, b) in enumerate(zip(out[rid], paged_out[rid]))
                         if a != b), len(out[rid])) for rid in out)
    log(f"int8 serve: {summary['requests']} requests, {summary['tokens']} tokens "
        f"in {summary['wall_s']:.3f} s ({summary['tok_s']:.1f} tok/s; bf16 pool "
        f"{paged_summary['tok_s']:.1f}), ttft p50 {summary['ttft_p50_ms']:.1f} ms "
        f"(bf16 {paged_summary['ttft_p50_ms']:.1f}), prefill chunks {P}, decode "
        f"steps {Dd}, peak memory {summary['peak_mem_bytes'] / 2**30:.2f} GiB "
        f"(bf16 {paged_summary['peak_mem_bytes'] / 2**30:.2f}), pool "
        f"{summary['pool_bytes'] / 1e9:.4f} GB (bf16 "
        f"{paged_summary['pool_bytes'] / 1e9:.4f}); prefix caching off: "
        f"token-identical, {summary_off['wall_s']:.3f} s; {same} of {len(out)} "
        f"requests token-identical to the bf16 pool's run (not gated; first "
        f"differing token of each request, sorted: {first})")
    summary.update(prefix_hit_tokens=stats["prefix_hit_tokens"],
                   wall_s_cache_off=summary_off["wall_s"], same_as_bf16=same,
                   first_difference=first)
    return launches, summary


def shard_pool(torch, pool, n_shards):
    """Phase 3's pool grown to a whole number of shards (its 513 pages plus
    copies of its last pages up to 516 = 4 + 8 x 64), the decode slots and
    one prefill sequence placed round-robin by the port's allocator, and
    each shard's local tables and view of the pool."""
    from repro_torch.models.layers import pool_shards
    from repro_torch.serve.engine import BlockAllocator

    kp, vp, lens = pool["kp"], pool["vp"], pool["lens"].clone()
    slots, mb = pool["tables"].shape
    bs = kp.shape[2]
    nb = n_shards + slots * mb
    pad = nb - kp.shape[1]
    kp = torch.cat([kp, kp[:, -pad:]], dim=1).contiguous()
    vp = torch.cat([vp, vp[:, -pad:]], dim=1).contiguous()
    # the last sequence cut to 3 pages: shard 3 owns none of its keys
    lens[-1] = 3 * bs - 8
    alloc = BlockAllocator(nb, bs, slots, mb, num_shards=n_shards)
    for s in range(slots):
        if not alloc.ensure(s, int(lens[s])):
            fail(f"seq shards: page pool too small for slot {s}")
    total = pool["qoff"] + pool["qp"].shape[1]
    palloc = BlockAllocator(nb, bs, 1, mb, num_shards=n_shards)
    if not palloc.ensure(0, total):
        fail("seq shards: page pool too small for the prefill sequence")
    dev = kp.device
    # the float pool in each q dtype (the kernel takes q and pages of one
    # dtype), and each shard's view of it
    pools = {kp.dtype: (kp, vp), torch.float32: (kp.float(), vp.float())}
    return dict(
        pools=pools, lens=lens, n=n_shards, bs=bs, mb=mb,
        table=torch.from_numpy(alloc.table).to(dev),
        local=torch.from_numpy(alloc.shard_local(alloc.table)).to(dev),
        ptable=torch.from_numpy(palloc.table[0]).to(dev),
        plocal=torch.from_numpy(palloc.shard_local(palloc.table[0])).to(dev),
        views={dt: list(zip(pool_shards(k, n_shards), pool_shards(v, n_shards)))
               for dt, (k, v) in pools.items()})


def owned_keys(torch, local, bs, n):
    """[..., n] bool: key j < n lies on a page this shard's local table owns."""
    return torch.repeat_interleave(local != 0, bs, dim=-1)[..., :n]


def parts_view(torch, parts, live):
    """Shard partials as the kernel contract compares them: m on every row,
    l and acc / l on the rows that see a key (``live``, from the plain
    version)."""
    return (torch.cat([p[1].flatten() for p in parts]),
            torch.cat([p[2][lv] for p, lv in zip(parts, live)]),
            torch.cat([(p[0] / p[2][..., None])[lv] for p, lv in zip(parts, live)]))


def hold_identity(torch, tag, parts, live):
    """Rows that see no key must be exactly (0, -1e30, 0); returns their
    count."""
    n = 0
    for (acc, m, l), lv in zip(parts, live):
        dead = ~lv
        n += int(dead.sum())
        if not bool((acc[dead] == 0).all() and (m[dead] == -1e30).all()
                    and (l[dead] == 0).all()):
            fail(f"{tag}: a row that sees no owned key is not (0, -1e30, 0)")
    return n


def shard_kernel_phase(torch, timer, cfg, pool):
    """Phase 18, kernels: rows 1s / 2s, the skip_null partials of the paged
    kernel over each of 4 shards' views of phase 3's pool with the
    shard-local tables of a round-robin placement; held per shard against
    the plain version (bf16 and f32, float and int8 pools), their tree
    combine against the unsharded kernel, the identity on a sequence shard
    3 does not own, kv_offset once, and the skip-off control; at decode
    each shard's call twice bitwise equal and a control that drops the
    longest sequence's second split; bf16 timed per shard launch beside the
    shard's bound."""
    from repro_torch.core import noc
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import prefill_attention as kpf
    from repro_torch.kernels import ref
    from repro_torch.models.layers import pool_shards

    sp = shard_pool(torch, pool, SEQ_SHARDS)
    S, bs, mb = sp["n"], sp["bs"], sp["mb"]
    lens, local, ptable, plocal = (sp[k] for k in (
        "lens", "local", "ptable", "plocal"))
    kp, vp = sp["pools"][torch.bfloat16]
    qd, qp, qoff = pool["qd"], pool["qp"], pool["qoff"]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    slots, c = qd.shape[0], qp.shape[1]
    total = qoff + c
    k8, ks = quantize_pages(torch, kp)
    v8, vs = quantize_pages(torch, vp)
    q8_views = list(zip(pool_shards(k8, S), pool_shards(v8, S),
                        pool_shards(ks, S), pool_shards(vs, S)))
    csrc = "src/repro_torch/kernels/csrc/"
    kv_row = kvh * hd * 2 * 2                   # K and V bytes of one key, bf16

    def dec(q, s, skip=True, int8=False):
        if int8:
            k, v, kss, vss = q8_views[s]
            return kda.paged_decode_attention_partial(q, k, v, local[s], lens, kss,
                                                      vss, skip_null=skip)
        k, v = sp["views"][q.dtype][s]
        return kda.paged_decode_attention_partial(q, k, v, local[s], lens,
                                                  skip_null=skip)

    def dec_plain(q, s, int8=False):
        if int8:
            k, v, kss, vss = q8_views[s]
            return ref.paged_decode_attention_partial(
                q, k, v, local[s], lengths=lens, skip_null=True, k_scales=kss,
                v_scales=vss)
        k, v = sp["views"][q.dtype][s]
        return ref.paged_decode_attention_partial(q, k, v, local[s], lengths=lens,
                                                  skip_null=True)

    def pre(q, s, skip=True, int8=False):
        kw = dict(q_offset=qoff, length=c, skip_null=skip)
        if int8:
            k, v, kss, vss = q8_views[s]
            return kpf.paged_prefill_attention_partial(q, k, v, plocal[s], k_scales=kss,
                                                       v_scales=vss, **kw)
        k, v = sp["views"][q.dtype][s]
        return kpf.paged_prefill_attention_partial(q, k, v, plocal[s], **kw)

    def pre_plain(q, s, int8=False):
        kw = dict(q_offset=qoff, length=c, skip_null=True)
        if int8:
            k, v, kss, vss = q8_views[s]
            return ref.paged_prefill_attention_partial(q, k, v, plocal[s],
                                                       k_scales=kss, v_scales=vss, **kw)
        k, v = sp["views"][q.dtype][s]
        return ref.paged_prefill_attention_partial(q, k, v, plocal[s], **kw)

    rows_of = {
        "paged_decode_attention_skip_null": dict(
            replaces="src/repro/kernels/decode_attention.py:300", q=qd,
            source=csrc + "decode_attention.cu",
            kernel=dec, plain=dec_plain,
            whole=lambda q, int8: (
                kda.paged_decode_attention(q, k8, v8, sp["table"], lens, ks, vs)
                if int8 else kda.paged_decode_attention(
                    q, *sp["pools"][q.dtype], sp["table"], lens))),
        "paged_prefill_attention_skip_null": dict(
            replaces="src/repro/kernels/prefill_attention.py:273", q=qp,
            source=csrc + "paged_attention.cu",
            kernel=pre, plain=pre_plain,
            whole=lambda q, int8: (
                kpf.paged_prefill_attention(q, k8, v8, ptable, q_offset=qoff,
                                            length=c, k_scales=ks, v_scales=vs)
                if int8 else kpf.paged_prefill_attention(
                    q, *sp["pools"][q.dtype], ptable, q_offset=qoff, length=c))),
    }
    readings, rows = {}, []
    for name, cs in rows_of.items():
        for int8 in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                q = cs["q"].to(dtype)
                f32 = dtype == torch.float32
                tol = (Q8_F32_TOL if f32 else Q8_BF16_TOL) if int8 else \
                    (DENSE_F32_TOL if f32 else DECODE_TOL)
                rel = None if f32 else (Q8_REL if int8 else DECODE_REL)
                tag = f"{name} {'int8' if int8 else 'float'} pool {str(dtype)[6:]}"
                if name.startswith("paged_decode"):
                    got = [repeat_equal(torch, tag, lambda s=s: cs["kernel"](q, s, int8=int8))
                           for s in range(S)]
                else:
                    got = [cs["kernel"](q, s, int8=int8) for s in range(S)]
                want = [cs["plain"](q, s, int8=int8) for s in range(S)]
                torch.cuda.synchronize()
                live = [w[1] > -1e29 for w in want]
                errs = [hold(torch, tag, g, w, tol, rel) for g, w in zip(
                    parts_view(torch, got, live), parts_view(torch, want, live))]
                n_dead = hold_identity(torch, tag, got, live)
                whole = cs["whole"](q, int8)
                comb = noc.tree_softmax_combine(got).to(dtype)
                c_err = hold(torch, tag + " combined vs unsharded kernel", comb,
                             whole, tol, rel)
                bad = noc.tree_softmax_combine(
                    [cs["kernel"](q, s, skip=False, int8=int8) for s in range(S)]
                ).to(dtype)
                d = float((bad.float() - whole.float()).abs().max())
                r = rel_err(torch, bad, whole)
                caught = not torch.allclose(bad.float(), whole.float(), **tol) or \
                    (rel is not None and r > rel)
                log(f"{tag}: per shard max|err| m {errs[0]:.3g}, l {errs[1]:.3g}, "
                    f"acc/l {errs[2]:.3g} (tol {tol}, rel {rel}); {n_dead} rows "
                    f"see no owned key and read (0, -1e30, 0); combined vs the "
                    f"unsharded kernel max|err| {c_err:.3g} (relative norm "
                    f"{rel_err(torch, comb, whole):.3g}); control (the local "
                    f"tables with skip_null off) max|err| {d:.3g}, relative "
                    f"norm {r:.3g} (caught: {caught})")
                if not caught:
                    fail(f"{tag} control: the tolerance passes the local tables "
                         f"read with skip_null off")
                if name.startswith("paged_decode") and n_dead < h:
                    fail(f"{tag}: no sequence left a shard without an owned key")
                readings[tag] = dict(m=errs[0], l=errs[1], acc_over_l=errs[2],
                                     combined=c_err, identity_rows=n_dead,
                                     control_rel=r)
                del got, want, whole, comb, bad
        # timing: bf16 on the float pool, the S shard launches of one call,
        # per launch
        qb = cs["q"].to(torch.bfloat16)
        plain_live = [w[1] > -1e29 for w in (cs["plain"](qb, s) for s in range(S))]
        if name.startswith("paged_decode"):
            keys = [owned_keys(torch, local[s], bs, mb * bs)
                    & (torch.arange(mb * bs, device=lens.device)[None] < lens[:, None])
                    for s in range(S)]
            n_keys = [int(k.sum()) for k in keys]
            flops = [4 * h * hd * n for n in n_keys]
            io = qb.numel() * 2 + qb.numel() * 4 + 2 * slots * h * 4 + local[0].numel() * 4
        else:
            keys = [owned_keys(torch, plocal[s], bs, total) for s in range(S)]
            n_keys = [int(k.sum()) for k in keys]
            pos = qoff + torch.arange(c, device=qb.device)
            flops = [4 * h * hd * int((torch.cumsum(k.int(), 0)[pos]).sum())
                     for k in keys]
            io = qb.numel() * 2 + qb.numel() * 4 + 2 * c * h * 4 + plocal[0].numel() * 4
        nbytes = io + sum(n_keys) * kv_row / S
        row = measure(torch, timer, name, cs["source"], cs["replaces"],
                      lambda: tuple(cs["kernel"](qb, s) for s in range(S)),
                      lambda: tuple(cs["plain"](qb, s) for s in range(S)),
                      (DECODE_TOL,) * 3, rel=DECODE_REL, nbytes=nbytes,
                      flops=sum(flops) / S,
                      view=lambda parts: parts_view(torch, parts, plain_live),
                      note=f"; the {S} shard launches of one call, per launch; "
                           f"owned keys per shard {n_keys}")
        for key in ("ms", "plain_ms"):
            row[key] /= S
        log(f"kernel {name}: per shard launch {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
        rows.append(row)
        row["design"] = DECODE_DESIGN if name.startswith("paged_decode") else PREFILL_DESIGN
        if name.startswith("paged_decode"):
            log_rate(torch, timer, row, nbytes)
            # the decode kernel's grain: shard 0's partial with the longest
            # sequence's second split of its table keys lost
            _, split = decode_split(torch, qb, kvh, mb * bs, bs)
            k, v = sp["views"][torch.bfloat16][0]
            kl, vl = ref.gather_pages(k, local[0]), ref.gather_pages(v, local[0])
            owned = keys[0]
            bad_mask, what = second_split_dropped(torch, owned, lens, split)
            ok = ref.decode_attention_partial(qb, kl, vl, lengths=lens, kv_valid=owned)
            bad = ref.decode_attention_partial(qb, kl, vl, lengths=lens,
                                               kv_valid=bad_mask)
            lv = [ok[1] > -1e29]
            pairs = list(zip(parts_view(torch, [bad], lv), parts_view(torch, [ok], lv)))
            caught = [not torch.allclose(x.float(), y.float(), **DECODE_TOL)
                      for x, y in pairs] + [rel_err(torch, *pairs[2]) > DECODE_REL]
            log(f"{name} control: shard 0's partial without {what} reads max|err| "
                f"m / l / acc/l " + " / ".join(
                    f"{float((x.float() - y.float()).abs().max()):.3g}" for x, y in pairs)
                + f" (caught: {caught})")
            if not any(caught):
                fail(f"{name} control: the tolerances pass a kernel that drops {what}")
            del kl, vl, ok, bad
    # kv_offset: the decode tables cut at block 32, the upper half at global
    # position 512; the two halves' partials combine to the whole
    half = mb // 2
    lo, hi = (sp["table"][:, :half].contiguous(), sp["table"][:, half:].contiguous())
    for dtype in (torch.float32, torch.bfloat16):
        q = qd.to(dtype)
        kp, vp = sp["pools"][dtype]
        tol = DENSE_F32_TOL if dtype == torch.float32 else DECODE_TOL
        rel = None if dtype == torch.float32 else DECODE_REL
        tag = f"paged_decode_attention kv_offset {half * bs} {str(dtype)[6:]}"
        got = kda.paged_decode_attention_partial(q, kp, vp, hi, lens,
                                                 kv_offset=half * bs)
        want = ref.paged_decode_attention_partial(q, kp, vp, hi, lengths=lens,
                                                  kv_offset=half * bs)
        torch.cuda.synchronize()
        live = [want[1] > -1e29]
        errs = [hold(torch, tag, g, w, tol, rel) for g, w in zip(
            parts_view(torch, [got], live), parts_view(torch, [want], live))]
        n_dead = hold_identity(torch, tag, [got], live)
        comb = noc.tree_softmax_combine(
            [kda.paged_decode_attention_partial(q, kp, vp, lo, lens), got]).to(dtype)
        whole = kda.paged_decode_attention(q, kp, vp, sp["table"], lens)
        c_err = hold(torch, tag + " combined", comb, whole, tol, rel)
        log(f"{tag}: max|err| m {errs[0]:.3g}, l {errs[1]:.3g}, acc/l "
            f"{errs[2]:.3g}; {n_dead} rows below the offset read (0, -1e30, 0); "
            f"the two halves combined vs the whole max|err| {c_err:.3g}")
        if n_dead == 0:
            fail(f"{tag}: no sequence ends below the offset")
        readings[tag] = dict(m=errs[0], l=errs[1], acc_over_l=errs[2],
                             combined=c_err, identity_rows=n_dead)
    del k8, v8, ks, vs, q8_views, sp
    torch.cuda.empty_cache()
    return rows, readings


def shard_parity_phase(torch, cfg_small):
    """Phase 18, parity: reduced stablelm at fp32 on the card through
    ServeEngine at 1, 2 and 4 sequence shards with prefix caching on (a
    shared prefix and a mid-page copy-on-write), and over an int8 pool at 1
    and 2: greedy outputs token-identical across shard counts."""
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    params = M.init_params(cfg_small, seed=0, device="cuda", dtype=torch.float32)
    rng = torch.Generator().manual_seed(5)
    prefix = torch.randint(2, cfg_small.vocab_size, (20,), generator=rng).tolist()
    prompts = [list(range(2, 50)), [3, 1, 4], prefix + [9], [42], prefix + [11],
               list(range(2, 50))]
    kw = dict(max_seq=64, slots=3, prefill_buckets=(8, 16, 32), block_size=8)
    out = {}
    for kv_dtype, shard_counts in (("fp16", (1, 2, 4)), ("int8", (1, 2))):
        for S in shard_counts:
            eng = ServeEngine(cfg_small, params, seq_shards=S, kv_dtype=kv_dtype, **kw)
            for p in prompts:
                eng.submit(p, max_new_tokens=6)
            toks = {r.rid: r.out_tokens for r in eng.run_until_drained()}
            out[(kv_dtype, S)] = toks
            if eng.stats["cow_copies"] < 1 or eng.stats["prefix_hits"] < 1:
                fail(f"seq parity: {kv_dtype} pool at {S} shards made no prefix "
                     f"hit with a copy-on-write")
            if S > 1 and eng.stats["noc_combines"] <= 0:
                fail(f"seq parity: {S} shards counted no NoC combine")
        for S in shard_counts[1:]:
            if out[(kv_dtype, S)] != out[(kv_dtype, 1)]:
                fail(f"seq parity: {kv_dtype} pool, {S} shards give other greedy "
                     f"tokens than one shard")
    log(f"seq parity: reduced stablelm fp32 on the card, token-identical at "
        f"1/2/4 shards (float pool) and 1/2 (int8 pool), prefix hits with a "
        f"copy-on-write in each")


def shard_serve_phase(torch, cfg, params, counters, paged_out, paged_summary):
    """Phase 18, serve: the mix of 5 through ServeEngine(seq_shards=4) with
    the parameters of 5; the skip_null kernels launched 4 L times a decode
    step and a prefill chunk and the unsharded paged kernels not at all;
    tok/s, TTFT, peak memory and the NoC stats beside phase 5's run, and the
    share of requests token-identical to it (not gated)."""
    from repro_torch.serve import ServeEngine

    warm = ServeEngine(cfg, params, slots=8, max_seq=160, block_size=16,
                       prefill_buckets=(32, 128), seq_shards=SEQ_SHARDS)
    warm.submit(list(range(40)), max_new_tokens=3)
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    out, stats, launches, summary = serve_mix(torch, cfg, params, counters,
                                              seq_shards=SEQ_SHARDS)
    L, S = cfg.n_layers, SEQ_SHARDS
    P, Dd = stats["prefill_dispatches"], stats["decode_dispatches"]
    check_launches("seq serve", launches, {
        "rmsnorm": (2 * L + 1) * (P + Dd), "apply_rope": L * (P + Dd),
        "apply_rope_qk": L * (P + Dd), "rmsnorm_vector": (2 * L + 1) * (P + Dd),
        "apply_rope_vector": L * (P + Dd),
        "silu_mul": L * (P + Dd), "silu_mul_scalar": 0,
        "paged_decode_attention": 0,
        "paged_prefill_attention": 0, "paged_decode_attention_int8": 0,
        "paged_prefill_attention_int8": 0,
        "paged_decode_attention_skip_null": S * L * Dd,
        "paged_prefill_attention_skip_null": S * L * P,
        "paged_prefill_attention_tc": S * L * P})
    if stats["prefix_hit_tokens"] <= 0:
        fail("seq serve: the shared-prefix requests never hit the prefix cache")
    if stats["noc_combines"] != L * (P + Dd):
        fail(f"seq serve: {stats['noc_combines']} NoC combines, expected "
             f"{L * (P + Dd)}")
    noc_stats = {k: stats[k] for k in ("noc_combines", "noc_hops", "noc_bytes",
                                       "noc_energy_pj")}
    same = sum(out[rid] == paged_out.get(rid) for rid in out)
    first = sorted(next((i for i, (a, b) in enumerate(zip(out[rid], paged_out[rid]))
                         if a != b), len(out[rid])) for rid in out)
    log(f"seq serve: {S} shards, {summary['requests']} requests, "
        f"{summary['tokens']} tokens in {summary['wall_s']:.3f} s "
        f"({summary['tok_s']:.1f} tok/s; one shard {paged_summary['tok_s']:.1f}), "
        f"ttft p50 {summary['ttft_p50_ms']:.1f} ms (one shard "
        f"{paged_summary['ttft_p50_ms']:.1f}), prefill chunks {P}, decode steps "
        f"{Dd}, peak memory {summary['peak_mem_bytes'] / 2**30:.2f} GiB (one "
        f"shard {paged_summary['peak_mem_bytes'] / 2**30:.2f}), pool "
        f"{summary['pool_bytes'] / 1e9:.4f} GB; noc {noc_stats}; {same} of "
        f"{len(out)} requests token-identical to phase 5's run (not gated; "
        f"first differing token of each request, sorted: {first})")
    summary.update(prefix_hit_tokens=stats["prefix_hit_tokens"], same_as_paged=same,
                   first_difference=first, **noc_stats)
    return launches, summary


def dropped_tile_control(torch, q, k, v):
    """What the flash-forward check reads for a wrong kernel: one that skips
    the first key tile of every row of the last query tile (the rows that
    average the most keys, so the smallest outputs).  Exact f32 attention of
    those rows with and without that tile; fails unless the forward's
    tolerances tell the two apart."""
    b, s, h, d = q.shape
    t, group = FLASH_TILE, h // k.shape[2]
    kk = k.float().repeat_interleave(group, dim=2)
    vv = v.float().repeat_interleave(group, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q[:, s - t:].float(), kk) / math.sqrt(d)
    qpos = torch.arange(s - t, s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    sc = sc.masked_fill(kpos > qpos, float("-inf"))

    def attend(scores):
        lse = torch.logsumexp(scores, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), vv)
        return o.to(q.dtype), lse

    o_ok, lse_ok = attend(sc)
    o_bad, lse_bad = attend(sc.masked_fill(kpos < t, float("-inf")))
    d_o = float((o_bad.float() - o_ok.float()).abs().max())
    d_lse = float((lse_bad - lse_ok).abs().max())
    caught = lambda a, b_, tol: not torch.allclose(a.float(), b_.float(), **tol)
    caught_o = caught(o_bad, o_ok, FLASH_O_TOL)
    caught_lse = caught(lse_bad, lse_ok, FLASH_LSE_TOL)
    log(f"flash attention control: a forward that skips key tile 0 for the "
        f"last query tile (rows {s - t}-{s - 1}) reads max|err| o {d_o:.3g} "
        f"(rel {rel_err(torch, o_bad, o_ok):.2g}; caught: {caught_o}), lse "
        f"{d_lse:.3g} (caught: {caught_lse}); under ATTN_TOL: o caught "
        f"{caught(o_bad, o_ok, ATTN_TOL)}, lse caught {caught(lse_bad, lse_ok, ATTN_TOL)}")
    if not (caught_o or caught_lse):
        fail("flash attention control: the forward's tolerances pass a kernel "
             "that skips a key tile")
    del kk, vv, sc


def flash_rows(torch, timer, q, k, v, do, suffix=""):
    """The flash-attention forward and backward on q [B, S, H, D], k, v
    [B, S, KvH, D] (causal), held to the plain versions with the flash
    tolerances and timed beside SDPA; the backward twice must give the same
    bits.  Returns the two rows, named ``flash_attention{suffix}`` and
    ``flash_attention_bwd{suffix}``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref

    b, s, h, hd = q.shape
    fa_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    fa_rep = "src/repro/kernels/flash_attention.py:109"
    pairs = s * (s + 1) // 2                        # causal (q, k) pairs per head
    io = (2 * q.numel() + 2 * k.numel()) * 2 + b * h * s * 4   # q, k, v, o + lse
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    rows = [measure(
        torch, timer, "flash_attention" + suffix, fa_src, fa_rep,
        lambda: kfa.flash_attention_fwd(q, k, v, causal=True),
        lambda: ref.flash_attention_lse(q, k, v, causal=True),
        (FLASH_O_TOL, FLASH_LSE_TOL), rel=FLASH_REL,
        nbytes=io, flops=4 * b * h * hd * pairs,
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True),
        note=f"; o, lse; rel {FLASH_REL}", iters=10, plain_iters=3)]
    hd112 = suffix == "_hd112"
    rows[0].update(row="6c" if hd112 else "6", design=FLASH_DESIGN)
    want_o = ref.flash_attention_lse(q, k, v, causal=True)[0]
    yardstick(torch, rows[0], ("o",), (F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2),), (want_o,))
    del want_o
    o, lse = kfa.flash_attention_fwd(q, k, v, causal=True)
    first = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    again = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        fail(f"flash attention{suffix} backward: two runs on the same inputs differ")
    log(f"flash attention{suffix} backward: two runs on the same inputs are "
        f"bitwise equal")
    del first, again
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    dog = do.transpose(1, 2).contiguous()
    rows.append(measure(
        torch, timer, "flash_attention_bwd" + suffix, fa_src, fa_rep,
        lambda: kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True),
        lambda: ref.flash_attention_bwd(q, k, v, o, lse, do, causal=True),
        FLASH_GRAD_TOL, rel=FLASH_REL,
        nbytes=(3 * q.numel() + 4 * k.numel()) * 2 + 2 * b * h * s * 4
        + q.numel() * 2, flops=10 * b * h * hd * pairs,
        library=lambda: torch.autograd.grad(og, (qg, kg, vg), dog,
                                            retain_graph=True),
        note=f"; dq, dk, dv; rel {FLASH_REL}", iters=10, plain_iters=3))
    rows[1].update(row="6d" if hd112 else "6b", design=FLASH_DESIGN)
    lib = torch.autograd.grad(og, (qg, kg, vg), dog)
    yardstick(torch, rows[1], ("dq", "dk", "dv"), [g.transpose(1, 2) for g in lib],
              ref.flash_attention_bwd(q, k, v, o, lse, do, causal=True))
    del o, lse, qt, kt, vt, qg, kg, vg, og, dog, lib
    return rows


def train_kernel_phase(torch, timer, cfg):
    """The training path's kernels at full-width granite-3-2b shapes, bf16:
    attention q [2, 4096, 32, 64], k/v [2, 4096, 8, 64] causal; the
    backward passes of rmsnorm [8192, 2048] and silu_mul [8192, 8192]."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.kernels import rope as krope
    from repro_torch.kernels import swiglu as ksw

    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    b, s = TRAIN_BATCH, TRAIN_SEQ
    d, h, kvh, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    csrc = "src/repro_torch/kernels/csrc/"
    rows = []

    # -- flash attention: extra shapes held to the plain version only
    names = ("o", "lse", "dq", "dk", "dv")
    tols = (FLASH_O_TOL, FLASH_LSE_TOL) + (FLASH_GRAD_TOL,) * 3
    for (sl, window) in ((s, 512), (4000, None)):
        q, k, v = randn(b, sl, h, hd), randn(b, sl, kvh, hd), randn(b, sl, kvh, hd)
        do = randn(b, sl, h, hd)
        o, lse = kfa.flash_attention_fwd(q, k, v, causal=True, window=window)
        wo, wl = ref.flash_attention_lse(q, k, v, causal=True, window=window)
        grads = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=window)
        wgrads = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=window)
        torch.cuda.synchronize()
        errs = [f"{n} {hold(torch, f'flash attention S={sl} window={window}: {n}', g, w, t, FLASH_REL):.3g}"
                f" (rel {rel_err(torch, g, w):.2g})"
                for n, g, w, t in zip(names, (o, lse, *grads), (wo, wl, *wgrads), tols)]
        log(f"flash attention S={sl} window={window}: max|err| {', '.join(errs)}")
        del q, k, v, do, o, lse, wo, wl, grads, wgrads

    # -- flash attention forward and backward at the main shape
    q, k, v = randn(b, s, h, hd), randn(b, s, kvh, hd), randn(b, s, kvh, hd)
    dropped_tile_control(torch, q, k, v)
    rows += flash_rows(torch, timer, q, k, v, randn(b, s, h, hd))
    del q, k, v

    # -- rope backward: the forward kernel at sign -1 on dq and dk in one
    # launch (no row of its own); k's side from a generator of its own, so
    # the rows after keep their inputs
    gen_k = torch.Generator(device=dev).manual_seed(12)
    x, dy = randn(b, s, h, hd), randn(b, s, h, hd)
    xk, dk = (torch.randn((b, s, kvh, hd), generator=gen_k, device=dev).to(bf)
              for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s).contiguous()
    xg, xkg = x.detach().requires_grad_(), xk.detach().requires_grad_()
    want = torch.autograd.grad((ref.apply_rope(xg, pos, cfg.rope_theta),
                                ref.apply_rope(xkg, pos, cfg.rope_theta)),
                               (xg, xkg), (dy, dk))
    got = krope.apply_rope_qk(dy, dk, pos, cfg.rope_theta, sign=-1)
    torch.cuda.synchronize()
    err = max(float((g.float() - w_.float()).abs().max()) for g, w_ in zip(got, want))
    if not all(torch.allclose(g.float(), w_.float(), **BF16_TOL)
               for g, w_ in zip(got, want)):
        fail(f"rope backward (forward kernel at sign -1 on dq and dk) disagrees "
             f"with autograd of the plain version: max |err| {err}")
    log(f"rope backward dq [{b},{s},{h},{hd}], dk [{b},{s},{kvh},{hd}] (forward "
        f"kernel at sign -1, one launch) vs autograd of the plain version: "
        f"max|err| {err:.3g} (tol {BF16_TOL}), "
        f"{timer(lambda: krope.apply_rope_qk(dy, dk, pos, cfg.rope_theta, sign=-1)):.4f} ms")
    del x, xk, dy, dk, xg, xkg, want, got

    floor = timer(lambda: torch.cuda._sleep(1))
    one = torch.zeros(1, device=dev)
    one_ms = timer(lambda: one.add_(1.0))

    def rate_row(nbytes, design):
        """Rows 3b and 5t: the design, an empty launch's time and the
        rate on the last row."""
        rows[-1].update(design=design, launch_floor_ms=floor, one_element_ms=one_ms)
        log_rate(torch, timer, rows[-1], nbytes)

    # -- rmsnorm backward on the training activations [8192, 2048], beside
    # a control the holds catch
    x, w, dy = randn(b * s, d), randn(d), randn(b * s, d)
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
    yg = F.rms_norm(xg, (d,), wg, cfg.norm_eps)
    ok_dw = ref.rmsnorm_bwd(x, w, dy, cfg.norm_eps)[1]
    bad_dw = ref.rmsnorm_bwd(x[:-BWD_DROPPED_ROWS], w, dy[:-BWD_DROPPED_ROWS],
                             cfg.norm_eps)[1]
    dropped_step_control(torch, "rmsnorm_bwd", f"the last {BWD_DROPPED_ROWS} rows "
                         f"from dw", ok_dw, bad_dw, BWD_DW_TOL, BWD_REL)
    del ok_dw, bad_dw
    rows.append(measure(
        torch, timer, "rmsnorm_bwd", csrc + "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:51",
        lambda: krn.rmsnorm_bwd(x, w, dy, cfg.norm_eps),
        lambda: ref.rmsnorm_bwd(x, w, dy, cfg.norm_eps), (BWD_DX_TOL, BWD_DW_TOL),
        nbytes=3 * x.numel() * 2 + 2 * d * 2, flops=10 * x.numel(), rel=BWD_REL,
        library=lambda: torch.autograd.grad(yg, (xg, wg), dy, retain_graph=True),
        note=f"; dx and dw; rel {BWD_REL}"))
    repeat_equal(torch, "rmsnorm_bwd", lambda: krn.rmsnorm_bwd(x, w, dy, cfg.norm_eps))
    rate_row(3 * x.numel() * 2 + 2 * d * 2, RMSNORM_BWD_DESIGN)
    del x, w, dy, xg, wg, yg

    # -- silu_mul backward on the FFN hidden [8192, 8192], then the forward
    # on the same gate and up (row 5t)
    g, u, dy = randn(b * s, ff, scale=3.0), randn(b * s, ff), randn(b * s, ff)
    rows.append(measure(
        torch, timer, "silu_mul_bwd", csrc + "swiglu.cu", "src/repro/kernels/swiglu.py:59",
        lambda: ksw.silu_mul_bwd(g, u, dy), lambda: ref.silu_mul_bwd(g, u, dy),
        BF16_TOL, nbytes=5 * g.numel() * 2, flops=12 * g.numel(),
        note="; dgate and dup"))
    del dy
    rows.append(measure(
        torch, timer, "silu_mul_train", csrc + "swiglu.cu", "src/repro/kernels/swiglu.py:59",
        lambda: ksw.silu_mul(g, u), lambda: ref.silu_mul(g, u), SILU_TOL,
        nbytes=3 * g.numel() * 2, flops=5 * g.numel(), rel=SILU_REL,
        note=f"; rel {SILU_REL}"))
    repeat_equal(torch, "silu_mul_train", lambda: ksw.silu_mul(g, u))
    rate_row(3 * g.numel() * 2, SILU_DESIGN)
    del g, u
    torch.cuda.empty_cache()
    return rows


def _batch_to(batch, dev):
    import torch
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def determinism_probe(torch, cfg_small):
    """Run each operation of the train step twice on the same inputs on the
    card and name every one whose outputs differ."""
    import torch.nn.functional as F

    from repro_torch.kernels import autograd as ag
    from repro_torch.train.step import cross_entropy

    gen = torch.Generator(device="cuda").manual_seed(5)
    r = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    tok = torch.randint(0, cfg_small.vocab_size, (4, 64), generator=gen, device="cuda")
    table = r(cfg_small.vocab_size, cfg_small.d_model)
    x, w, dy = r(4, 64, cfg_small.d_model), r(cfg_small.d_model), r(4, 64, cfg_small.d_model)
    pos = torch.arange(64, dtype=torch.int32, device="cuda")
    ops = {
        "embedding backward (F.embedding)": (lambda t: F.embedding(tok, t), (table,)),
        "matmul backward (torch.matmul)": (lambda a, b_: a @ b_, (x, r(cfg_small.d_model, 96))),
        "cross-entropy backward": (lambda a: cross_entropy(a, tok), (r(4, 64, cfg_small.vocab_size),)),
        "rmsnorm kernels": (lambda a, b_: ag.RMSNorm.apply(a, b_, 1e-5), (x, w)),
        "silu_mul kernels": (ag.SiluMul.apply, (x, dy)),
    }
    if cfg_small.n_heads:
        q = r(4, 64, cfg_small.n_heads, cfg_small.hd)
        k = r(4, 64, cfg_small.n_kv_heads, cfg_small.hd)
        ops["rope kernel"] = (lambda a: ag.Rope.apply(a, pos, 1e4), (q,))
        ops["flash attention kernels"] = (
            lambda a, b_, c: ag.FlashAttention.apply(a, b_, c, True, None), (q, k, k))
    if cfg_small.ssm_state and not cfg_small.rwkv:
        hh, p, n = cfg_small.ssm_heads, cfg_small.ssm_head_dim, cfg_small.ssm_state
        dt = torch.nn.functional.softplus(r(4, 64, hh))
        ops["mamba2 kernels"] = (
            lambda a, b_, c, d_, e_: ag.Mamba2.apply(a, b_, c, d_, e_)[0],
            (r(4, 64, hh, p), dt, -torch.linspace(1.0, 16.0, hh, device="cuda"),
             r(4, 64, n), r(4, 64, n)))
    if cfg_small.rwkv:
        hh, hd = cfg_small.rwkv_heads, cfg_small.rwkv_head_dim
        wd = torch.rand((4, 64, hh, hd), generator=gen, device="cuda") * 0.9 + 0.05
        ops["rwkv6 kernels"] = (lambda a, b_, c, d_, e_: ag.RWKV6.apply(a, b_, c, d_, e_)[0],
                                (r(4, 64, hh, hd), r(4, 64, hh, hd), r(4, 64, hh, hd), wd,
                                 r(hh, hd)))
    bad = []
    for name, (fn, xs) in ops.items():
        outs = []
        for _ in range(2):
            live = [t.detach().requires_grad_() for t in xs]
            y = fn(*live)
            outs.append([y] + list(torch.autograd.grad(y, live, torch.ones_like(y))))
        if not all(torch.equal(a, b_) for a, b_ in zip(*outs)):
            bad.append(name)
    return bad


def train_parity_phase(torch, cfg_small, perturb=None):
    """A reduced config at fp32: every gradient leaf and one train step on
    the card (kernels) against the CPU (plain versions) from the same
    parameters (``perturb`` edits the initial parameters in place), then a
    crash and resume on the card that must end bit-identical to an
    uninterrupted run (the JAX driver's contract)."""
    import shutil

    from repro_torch import tree as T
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime import SimulatedFailure, TrainDriver
    from repro_torch.train import step as TS

    def init(dev):
        state = TS.init_state(cfg_small, seed=0, dtype=torch.float32, device="cpu")
        if perturb is not None:
            perturb(state.params)
        return T.map(lambda t: t.to(dev) if t.dim() else t, state)

    lr, wd = 1e-3, 0.1
    batch = SyntheticLM(cfg_small.vocab_size, 64, 4, seed=1).batch(0)
    grad_fn = TS.value_and_grad(TS.make_loss_fn(cfg_small))
    out = {}
    for dev in ("cpu", "cuda"):
        state = init(dev)
        (_, _), grads = grad_fn(state.params, _batch_to(batch, dev))
        grads = [g.cpu() for g in T.leaves(grads)]
        step = TS.make_train_step(cfg_small, base_lr=lr, warmup=1, weight_decay=wd)
        state, met = step(state, _batch_to(batch, dev))
        out[dev] = (grads, T.leaves(state.params), float(met["loss"]),
                    float(met["grad_norm"]))
    (grc, pc, lc, gc), (grg, pg, lg, gg) = out["cpu"], out["cuda"]
    # every gradient leaf, card (kernels forward and backward) against the
    # CPU (autograd of the plain versions), relative to the leaf's largest
    # entry: a wrong sign or a lost term in one leaf shows here even where
    # the global grad norm and Adam's first update (~lr sign(g)) hide it
    paths = [p for p, _ in T.leaves_with_paths(state.params)]
    rel = [float((a - b_).abs().max() / b_.abs().max().clamp_min(1e-30))
           for a, b_ in zip(grg, grc)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    dp = max(float((a.cpu() - b_).abs().max()) for a, b_ in zip(pg, pc))
    n_over = sum(int(((a.cpu() - b_).abs() > 1e-5).sum()) for a, b_ in zip(pg, pc))
    bound_p = 2 * lr * (1 + wd)
    log(f"train parity: {cfg_small.name} fp32 card vs cpu: {len(rel)} gradient "
        f"leaves, largest max|diff| / max|g| {rel[worst]:.3g} at "
        f"{paths[worst]} (tolerance 1e-4); one step: loss {lg:.6f} vs "
        f"{lc:.6f}, grad norm {gg:.6f} vs {gc:.6f}, params max |diff| "
        f"{dp:.3g} (bound 2 lr (1 + wd) = {bound_p:.3g}), {n_over} elements "
        f"over 1e-5")
    if rel[worst] > 1e-4:
        fail(f"train parity: the card's gradient of {paths[worst]} disagrees "
             f"with the CPU's")
    if abs(lg - lc) > 1e-4 or abs(gg - gc) > 1e-4 * max(1.0, gc) or dp > bound_p:
        fail("train parity: the card's train step disagrees with the CPU's")

    ckpt = OUT / "ckpt"
    ds = SyntheticLM(cfg_small.vocab_size, 64, 4, seed=3)
    step = TS.make_train_step(cfg_small, base_lr=lr)

    def driver(inject=None):
        return TrainDriver(
            train_step=step, dataset=ds, ckpt_dir=str(ckpt), ckpt_every=3,
            init_state=lambda: init("cuda"),
            put_batch=lambda bt: _batch_to(bt, "cuda"), inject_failure_at=inject)

    quiet = lambda *a: None
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        driver(inject=5).run(total_steps=10, log_fn=quiet)
        fail("train parity: the injected failure did not fire")
    except SimulatedFailure:
        pass
    resumed = driver().run(total_steps=10, log_fn=quiet)
    shutil.rmtree(ckpt, ignore_errors=True)
    straight = driver().run(total_steps=10, log_fn=quiet)
    shutil.rmtree(ckpt, ignore_errors=True)
    diff = [p for (p, a), (_, b_) in zip(T.leaves_with_paths(resumed["state"]),
                                         T.leaves_with_paths(straight["state"]))
            if not torch.equal(a, b_)]
    if diff:
        for name in determinism_probe(torch, cfg_small):
            print(f"[chip_smoke] not bitwise repeatable: {name}", flush=True)
        fail(f"train parity: crash-and-resume differs from an uninterrupted "
             f"run in {len(diff)} leaves (first {diff[:3]})")
    log(f"train parity: {cfg_small.name}: crash at step 5, resume, 10 steps: "
        f"bit-identical to an "
        f"uninterrupted run ({len(T.leaves(straight['state']))} leaves, loss "
        f"{float(straight['metrics']['loss']):.6f})")


def scan_tol(torch, want):
    """The elementwise tolerance of one wkv6 or Mamba2 scan output, by its
    dtype, with the absolute part scaled to the plain version's largest
    entry."""
    scale = float(want.float().abs().max())
    if want.dtype == torch.bfloat16:
        return dict(rtol=SCAN_RTOL, atol=SCAN_ATOL * scale)
    return dict(rtol=SCAN_F32_RTOL, atol=SCAN_F32_ATOL * scale)


def rwkv_inputs(torch, cfg, seed, b=TRAIN_BATCH, s=TRAIN_SEQ):
    """Full-width wkv6 inputs: r, k, v, do [b, s, H, D] (default
    TRAIN_BATCH, TRAIN_SEQ) bf16 ~ N(0, 1) (what the projections of a
    normed input give), u [H, D]
    f32, and w drawn through the port's ``models/rwkv.py:_decay`` on random
    inputs with a random nonzero ``w_b`` (N(0, WKV_WB_STD^2)), so the decay
    is data-dependent: its logit -5 + tanh(x W_a) W_b spreads over the
    whole clip range [-12, 4], and the rows at 4 (w = 1.8e-24) lie below
    the 1e-20 clamp."""
    from repro_torch.models import rwkv as R

    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    h, d, dm = cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    r, k, v, do = (randn(b, s, h, d) for _ in range(4))
    tm = {"w0": torch.full((dm,), -5.0, device=dev),
          "w_a": randn(dm, cfg.rwkv_lora, scale=dm ** -0.5),
          "w_b": randn(cfg.rwkv_lora, dm, scale=WKV_WB_STD)}
    w = R._decay(tm, randn(b, s, dm)).reshape(b, s, h, d).contiguous()
    u = randn(h, d, scale=0.5, dtype=torch.float32)
    return r, k, v, w, u, do


def dropped_chunk_control(torch, r, k, v, w, o_ok, tol):
    """What the wkv6 forward check reads for a wrong kernel: one that drops
    the state's contribution (r_t e^{cin_t}) S0 to one chunk of one
    (sequence, head), the chunk whose contribution is the smallest of all
    (the hardest to see).  Fails unless the forward's tolerance tells the
    two apart."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_chunk as kwkv

    b, s, h, d = r.shape
    t = kwkv.chunk_of(r.dtype)
    nc = s // t
    states = ref.rwkv6_chunk_states(k, v, w, chunk=t)              # [B,H,NC,D,D]
    lw = torch.log(torch.clamp(w, min=ref.W_FLOOR)).reshape(b, nc, t, h, d)
    cum = torch.cumsum(lw, dim=2)
    rin = r.float().reshape(b, nc, t, h, d) * torch.exp(cum - lw)
    contrib = torch.einsum("bcthd,bhcde->bcthe", rin, states)     # [B,NC,T,H,D]
    size = contrib.abs().amax(dim=(2, 4))                          # [B, NC, H]
    size[:, 0] = float("inf")                                      # S0 = 0 there
    bi, ci, hi = (int(x) for x in torch.unravel_index(torch.argmin(size), size.shape))
    bad = o_ok.float().reshape(b, nc, t, h, d).clone()
    bad[bi, ci, :, hi] -= contrib[bi, ci, :, hi]
    bad = bad.reshape(b, s, h, d).to(o_ok.dtype)
    caught = not torch.allclose(bad.float(), o_ok.float(), **tol)
    d_o = float((bad.float() - o_ok.float()).abs().max())
    rel = rel_err(torch, bad, o_ok)
    log(f"wkv6 control: a forward that drops the state contribution to chunk "
        f"{ci} of sequence {bi}, head {hi} (the smallest of all: max|contribution| "
        f"{float(size[bi, ci, hi]):.3g}; the largest {float(size[:, 1:].max()):.3g}) "
        f"reads max|err| o {d_o:.3g} (caught elementwise: {caught}; tolerance "
        f"{tol}) and relative norm error {rel:.2g} (caught: {rel > SCAN_REL})")
    if not caught:
        fail("wkv6 control: the forward's tolerance passes a kernel that drops "
             "one chunk's state contribution")
    del states, lw, cum, rin, contrib, bad


def dropped_wkv_dstate_control(torch, r, k, v, w, u, do, want, tols):
    """What the wkv6 backward check reads for a wrong kernel: one that drops
    the exit-state gradient dS of one chunk of one (sequence, head), the one
    whose dS term (k_u e^{cT - cum_u}) dS in dv is the smallest of all.
    Fails unless the backward's tolerances tell the two apart (dw held as
    dl = dw w, as the backward's check holds it)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_chunk as kwkv

    b, s, h, d = r.shape
    t = kwkv.chunk_of(r.dtype)
    nc = s // t
    dstates = ref.rwkv6_chunk_dstates(r, w, do, chunk=t)           # [B,H,NC,D,D]
    lw = torch.log(torch.clamp(w, min=ref.W_FLOOR)).reshape(b, nc, t, h, d)
    cum = torch.cumsum(lw, dim=2)
    kd = k.float().reshape(b, nc, t, h, d) * torch.exp(cum[:, :, -1:] - cum)
    term = torch.einsum("bcthd,bhcde->bcthe", kd, dstates)         # [B,NC,T,H,D]
    size = term.abs().amax(dim=(2, 4))                             # [B, NC, H]
    size[:, -1] = float("inf")                                     # dS = 0 there
    bi, ci, hi = (int(x) for x in torch.unravel_index(torch.argmin(size), size.shape))
    del lw, cum, kd, term
    dstates[bi, hi, ci] = 0.0
    bad = ref.rwkv6_bwd_local(r, k, v, w, u, do,
                              ref.rwkv6_chunk_states(k, v, w, chunk=t), dstates,
                              chunk=t)
    bad = (bad[0], bad[1], bad[2], bad[3] * w, bad[4])
    names = ("dr", "dk", "dv", "dl", "du")
    caught = [not torch.allclose(g.float(), x.float(), **tol)
              for g, x, tol in zip(bad, want, tols)]
    rels = [rel_err(torch, g, x) for g, x in zip(bad, want)]
    log(f"wkv6 backward control: a backward that drops the exit-state gradient "
        f"of chunk {ci} of sequence {bi}, head {hi} (the smallest dS term: "
        f"max|kd dS| {float(size[bi, ci, hi]):.3g}; the largest "
        f"{float(size[:, :-1].max()):.3g}) reads " + ", ".join(
            f"{n} max|err| {float((g.float() - x.float()).abs().max()):.3g} "
            f"(caught: {c}), rel {e:.2g}"
            for n, g, x, c, e in zip(names, bad, want, caught, rels)))
    if not any(caught):
        fail("wkv6 backward control: the backward's tolerances pass a kernel "
             "that drops one chunk's exit-state gradient")
    del dstates, bad


def rwkv_kernel_phase(torch, timer, cfg):
    """The wkv6 forward and backward at full-width rwkv6-3b shapes, bf16: r,
    k, v [2, 4096, 40, 64], w f32 data-dependent, u [40, 64] f32."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_chunk as kwkv

    r, k, v, w, u, do = rwkv_inputs(torch, cfg, seed=4)
    b, s, h, d = r.shape
    clamped = w <= ref.W_FLOOR
    log(f"wkv6 inputs [{b},{s},{h},{d}]: w in [{float(w.min()):.3g}, "
        f"{float(w.max()):.6g}], {float(clamped.float().mean()):.4f} of it below "
        f"the 1e-20 clamp, {float((w < 1e-3).float().mean()):.4f} below 1e-3")
    src, rep = "src/repro_torch/kernels/csrc/rwkv6.cu", "src/repro/kernels/rwkv_chunk.py:87"
    t = kwkv.chunk_of(r.dtype)
    nc = kwkv.n_chunks(s, t)
    # FLOPs of the chunked algorithm per (batch, head, chunk): the state
    # products 2 T D^2 each (o from S and the S update forward; dr, dk, dv
    # and the dS update backward), the pair terms ~5 T^2 D / 2 each (att
    # forward; att, do . v, dr' and dk' backward)
    fwd_flops = b * h * nc * (4 * t * d * d + 5 * t * t * d)
    bwd_flops = b * h * nc * (8 * t * d * d + 10 * t * t * d)
    io = r.numel() * 2                                   # one [B,S,H,D] bf16 tensor
    state_bytes = b * h * nc * d * d * 4                 # the chunk-entry states

    want_o, want_sf = ref.rwkv6_scan_chunked(r, k, v, w, u, chunk=t)
    o_tol = scan_tol(torch, want_o)
    s_tol = scan_tol(torch, want_sf)
    dropped_chunk_control(torch, r, k, v, w, want_o, o_tol)
    del want_o, want_sf
    rows = [measure(
        torch, timer, "rwkv6", src, rep,
        lambda: kwkv.rwkv6_fwd(r, k, v, w, u, save_states=True)[:2],
        lambda: ref.rwkv6_scan_chunked(r, k, v, w, u, chunk=t), (o_tol, s_tol),
        nbytes=4 * io + w.numel() * 4 + u.numel() * 4 + b * h * d * d * 4
        + state_bytes, flops=fwd_flops, rel=SCAN_REL, iters=10, plain_iters=3,
        note=f"; o, S_final; rel {SCAN_REL}; the training forward, which also "
             f"writes the {nc} chunk-entry states")]

    _, _, states = kwkv.rwkv6_fwd(r, k, v, w, u, save_states=True)
    first = kwkv.rwkv6_bwd(r, k, v, w, u, do, states)
    again = kwkv.rwkv6_bwd(r, k, v, w, u, do, states)
    want = ref.rwkv6_bwd(r, k, v, w, u, do, chunk=t)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        fail("wkv6 backward: two runs on the same inputs differ")
    if bool(first[3][clamped].any()) or bool(want[3][clamped].any()):
        fail("wkv6 backward: dw is not 0 where the 1e-20 clamp holds")
    log("wkv6 backward: two runs on the same inputs are bitwise equal; dw is 0 "
        "wherever the clamp holds, in the kernel and the plain version")
    # dw = dl / w; where w is tiny but above the clamp it is the rounding of
    # a difference of running sums times 1 / w in both versions, so the
    # check holds dl = dw w (what d logit = -dl e^logit uses)
    view = lambda g: (g[0], g[1], g[2], g[3] * w, g[4])
    want = view(want)
    tols = tuple(scan_tol(torch, y) for y in want)
    del first, again
    dropped_wkv_dstate_control(torch, r, k, v, w, u, do, want, tols)
    del want
    rows.append(measure(
        torch, timer, "rwkv6_bwd", src, rep,
        lambda: kwkv.rwkv6_bwd(r, k, v, w, u, do, states),
        lambda: ref.rwkv6_bwd(r, k, v, w, u, do, chunk=t), tols,
        nbytes=7 * io + 2 * w.numel() * 4 + 2 * u.numel() * 4 + state_bytes,
        flops=bwd_flops, rel=SCAN_REL, iters=10, plain_iters=3, view=view,
        note=f"; dr, dk, dv, dl = dw w, du; rel {SCAN_REL}"))
    rows[0].update(row="9", design=WKV_DESIGN, hash=digest(
        torch, kwkv.rwkv6_fwd(r, k, v, w, u, save_states=True)))
    rows[1].update(row="9b", design=WKV_DESIGN, hash=digest(
        torch, kwkv.rwkv6_bwd(r, k, v, w, u, do, states)))
    log(f"wkv6 hashes (sha256 of the outputs' bits on these inputs): row 9 "
        f"{rows[0]['hash']}, row 9b {rows[1]['hash']}")
    del r, k, v, w, u, do, states, clamped
    torch.cuda.empty_cache()
    return rows


def rwkv_perturb(params):
    """A random nonzero w_b in every layer (zero at init), so the reduced
    model's decay depends on the data and W_a gets a gradient."""
    import torch

    gen = torch.Generator().manual_seed(11)
    for lp in params["layers"]:
        wb = lp["tm"]["w_b"]
        wb.copy_(torch.randn(wb.shape, generator=gen) * WKV_WB_STD)


def granite_expect(cfg, n):
    """Counted launches of n granite steps with remat: the forward, the
    recompute of each layer's forward in the backward, and the backward
    (rope's is its forward kernel at sign -1, q and k in one launch each
    way); the final norm is outside the remat."""
    L = cfg.n_layers
    return {"flash_attention": 2 * L * n, "flash_attention_bwd": L * n,
            "rmsnorm": (4 * L + 1) * n, "rmsnorm_bwd": (2 * L + 1) * n,
            "rmsnorm_bwd_vector": (2 * L + 1) * n,
            "apply_rope": 3 * L * n, "apply_rope_qk": 3 * L * n,
            "silu_mul": 2 * L * n, "silu_mul_bwd": L * n, "silu_mul_vector": 2 * L * n}


def granite_watched(st):
    return {"embed": st.params["embed"]["table"][:4],
            "wq0": st.params["layers"][0]["attn"]["wq"]["w"][:4],
            "down_last": st.params["layers"][-1]["ffn"]["down"]["w"][:4]}


def rwkv_expect(cfg, n):
    """Counted launches of n rwkv steps with remat: wkv6 in the forward and
    the recompute, its backward once, every call on the bf16 tensor-core
    route; three norms a layer (ln1, ln2 and the time mix's) plus the final
    norm outside the remat."""
    L = cfg.n_layers
    return {"rwkv6": 2 * L * n, "rwkv6_bwd": L * n,
            "rwkv6_tc": 2 * L * n, "rwkv6_bwd_tc": L * n,
            "rmsnorm": (6 * L + 1) * n, "rmsnorm_bwd": (3 * L + 1) * n,
            "rmsnorm_bwd_vector": (3 * L + 1) * n}


def rwkv_watched(st):
    return {"embed": st.params["embed"]["table"][:4],
            "wr0": st.params["layers"][0]["tm"]["wr"]["w"][:4],
            "cm_wv_last": st.params["layers"][-1]["cm"]["wv"]["w"][:4],
            "lm_head": st.params["lm_head"]["w"][:4]}


def train_phase(torch, cfg, counters, expect_fn, watched):
    """Full width and depth, bf16, TRAIN_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ tokens through make_train_step with remat; ``expect_fn(cfg,
    steps)`` gives the exact launch count of every counted kernel and
    ``watched(state)`` the weight matrices that must move.  Weight
    matrices, not norm scales: a scale of 1.0 has a bf16 ulp of 2^-7,
    larger than an early step's update (~lr), so it stays at 1.0 in bf16
    training in either framework."""
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import for_cell
    from repro_torch.train import step as TS

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state = TS.init_state(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    state_mem = torch.cuda.memory_allocated()
    n_params = sum(p.numel() for p in T.leaves(state.params))
    shape = (f"{cfg.rwkv_heads} heads of {cfg.rwkv_head_dim}, LoRA {cfg.rwkv_lora}"
             if cfg.rwkv else f"{cfg.n_heads} H / {cfg.n_kv_heads} KV, hd {cfg.hd}")
    if cfg.family == "hybrid":
        shape += (f"; Mamba2 {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
                  f"{cfg.ssm_state}, a shared block every {cfg.attn_every} layers")
    log(f"train: {cfg.name} state on the card in {time.perf_counter() - t0:.1f} s: "
        f"{n_params / 1e9:.3f} B params bf16 + f32 m/v = {state_mem / 2**30:.2f} GiB "
        f"({cfg.n_layers} L, d {cfg.d_model}, {shape}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {'tied' if cfg.tie_embeddings else 'untied'} embeddings)")
    ds = for_cell(cfg, ShapeSpec("train_chip", TRAIN_SEQ, TRAIN_BATCH, "train"))
    batches = [_batch_to(ds.batch(i), "cuda") for i in range(TRAIN_STEPS)]
    step = TS.make_train_step(cfg, base_lr=3e-4, warmup=1, total_steps=TRAIN_STEPS)
    before = {k: v.clone() for k, v in watched(state).items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    times, losses, gnorms = [], [], []
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        state, met = step(state, batches[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    launches = {name: c.read() for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    n = TRAIN_STEPS
    expect = expect_fn(cfg, n)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = times[1:] or times
    step_s = sum(steady) / len(steady)
    log(f"train: {cfg.name}: {n} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: step "
        f"seconds {[round(x, 4) for x in times]}, steady {step_s:.4f} s/step "
        f"({tokens / step_s:.1f} tokens/s), losses {losses}, grad norms {gnorms}, "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"train: {cfg.name}: kernel launches {launches} (per-step formula with "
        f"remat x {n}: {expect})")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"train: non-finite loss or grad norm: {losses} {gnorms}")
    for name, c in launches.items():
        if c <= 0:
            fail(f"train: kernel {name} was never launched on the training path")
        if c != expect[name]:
            fail(f"train: kernel {name} launched {c} times, expected {expect[name]}")
    moved = {k: not torch.equal(v, before[k]) for k, v in watched(state).items()}
    if not all(moved.values()):
        fail(f"train: parameters did not move: {moved}")
    del state, batches, before, step
    torch.cuda.empty_cache()
    return launches, dict(steps=n, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                          step_s=times, steady_step_s=step_s,
                          tokens_s=tokens / step_s, losses=losses,
                          grad_norms=gnorms, peak_mem_bytes=peak,
                          state_mem_bytes=state_mem, n_params=n_params,
                          launches_expected=expect)


# ---------------------------------------------------------------------------
# rwkv serving (19): the wkv6 forward from a carried state, the reduced
# model's serving entry points, and rwkv6-3b through both engine paths
# ---------------------------------------------------------------------------

def digest(torch, outs) -> str:
    """sha256 (first 16 hex digits) of the bytes of a tensor or a tuple of
    tensors, in order: two trees' bits compared by their hashes."""
    h = hashlib.sha256()
    for t in outs if isinstance(outs, tuple) else (outs,):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def carried_state(torch, cfg, seed, s=SERVE_CHUNK):
    """Row 9s's inputs: a serving prefill chunk [1, s, H, D] (rwkv_inputs'
    draws) and the wkv state S0 [1, H, D, D] f32 that a previous chunk of
    the same kind leaves (the plain chunked scan from zero over it): the
    state a slot carries into its next chunk."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_chunk as kwkv

    prev = rwkv_inputs(torch, cfg, seed + 1, b=1, s=s)
    s0 = ref.rwkv6_scan_chunked(*prev[:5], chunk=kwkv.TC_CHUNK)[1].contiguous()
    del prev
    return rwkv_inputs(torch, cfg, seed, b=1, s=s)[:5] + (s0,)


def rwkv_serve_kernel_phase(torch, timer, cfg):
    """Row 9s, the wkv6 forward from a carried state at rwkv6-3b's serving
    prefill chunk (r, k, v [1, 512, 40, 64] bf16, S0 [1, 40, 64, 64] f32),
    held against the plain chunked scan from the same S0 in bf16 and in
    f32 with ``scan_tol``, twice bitwise equal, with S0 = 0 giving the bits
    of the zero-state kernel (here and at row 9's training shape) and a
    control (the plain scan with S0 left out) that the hold must catch;
    then rmsnorm at rwkv6-3b's decode [8, 2560] beside row 3d."""
    from repro_torch.kernels import ref, rmsnorm
    from repro_torch.kernels import rwkv_chunk as kwkv

    r, k, v, w, u, s0 = carried_state(torch, cfg, seed=21)
    b, s, h, d = r.shape
    t = kwkv.chunk_of(r.dtype)
    nc = kwkv.n_chunks(s, t)
    src = "src/repro_torch/kernels/csrc/rwkv6.cu"
    rep = "src/repro/kernels/rwkv_chunk.py:87"
    want_o, want_sf = ref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0, chunk=t)
    o_tol, s_tol = scan_tol(torch, want_o), scan_tol(torch, want_sf)
    dropped = ref.rwkv6_scan_chunked(r, k, v, w, u, chunk=t)
    caught = [not torch.allclose(g.float(), x.float(), **tol) or rel_err(torch, g, x) > SCAN_REL
              for g, x, tol in zip(dropped, (want_o, want_sf), (o_tol, s_tol))]
    log(f"wkv6 s0 control: the plain scan with S0 left out reads o max|err| "
        f"{float((dropped[0].float() - want_o.float()).abs().max()):.3g} (rel "
        f"{rel_err(torch, dropped[0], want_o):.2g}), S_final max|err| "
        f"{float((dropped[1] - want_sf).abs().max()):.3g} (rel "
        f"{rel_err(torch, dropped[1], want_sf):.2g}); caught: {caught}")
    if not caught[0]:
        fail("wkv6 s0 control: the hold passes an output that drops the carried state")
    del dropped, want_o, want_sf
    repeat_equal(torch, "wkv6 s0", lambda: kwkv.rwkv6_fwd(r, k, v, w, u, s0=s0)[:2])
    zero = kwkv.rwkv6_fwd(r, k, v, w, u, s0=torch.zeros_like(s0))[:2]
    none = kwkv.rwkv6_fwd(r, k, v, w, u)[:2]
    if not all(torch.equal(x, y) for x, y in zip(zero, none)):
        fail("wkv6 s0: S0 = 0 does not give the zero-state kernel's bits")
    # f32 (the fp32 parity runs' route, chunks of 32)
    rf, kf, vf = r.float(), k.float(), v.float()
    got32 = kwkv.rwkv6_fwd(rf, kf, vf, w, u, s0=s0)[:2]
    want32 = ref.rwkv6_scan_chunked(rf, kf, vf, w, u, s0=s0, chunk=kwkv.CHUNK)
    torch.cuda.synchronize()
    err32 = [hold(torch, "wkv6 s0 f32", g, x, scan_tol(torch, x), SCAN_REL)
             for g, x in zip(got32, want32)]
    zero32 = kwkv.rwkv6_fwd(rf, kf, vf, w, u, s0=torch.zeros_like(s0))[:2]
    none32 = kwkv.rwkv6_fwd(rf, kf, vf, w, u)[:2]
    if not all(torch.equal(x, y) for x, y in zip(zero32, none32)):
        fail("wkv6 s0 f32: S0 = 0 does not give the zero-state kernel's bits")
    del rf, kf, vf, got32, want32, zero32, none32, zero, none
    # at row 9's training shape: S0 = 0 against no S0
    tr, tk, tv, tw, tu, _ = rwkv_inputs(torch, cfg, seed=4)
    z = torch.zeros((tr.shape[0], h, d, d), device="cuda")
    if not all(torch.equal(x, y) for x, y in zip(
            kwkv.rwkv6_fwd(tr, tk, tv, tw, tu, s0=z)[:2],
            kwkv.rwkv6_fwd(tr, tk, tv, tw, tu)[:2])):
        fail("wkv6 s0: S0 = 0 at row 9's shape does not give the zero-state bits")
    del tr, tk, tv, tw, tu, z
    log(f"wkv6 s0: f32 route max|err| o {err32[0]:.3g}, S_final {err32[1]:.3g}; "
        f"bf16 twice bitwise equal; S0 = 0 gives the zero-state kernel's bits in "
        f"bf16 and f32 at [1, {s}] and in bf16 at row 9's [{TRAIN_BATCH}, {TRAIN_SEQ}]")
    io = r.numel() * 2
    row = measure(
        torch, timer, "rwkv6_s0", src, rep,
        lambda: kwkv.rwkv6_fwd(r, k, v, w, u, s0=s0)[:2],
        lambda: ref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0, chunk=t), (o_tol, s_tol),
        nbytes=4 * io + w.numel() * 4 + u.numel() * 4 + 2 * s0.numel() * 4,
        flops=b * h * nc * (4 * t * d * d + 5 * t * t * d), rel=SCAN_REL, iters=20,
        plain_iters=5, note=f"; o, S_final; rel {SCAN_REL}; the serving chunk from a "
                            f"carried state")
    # the zero-state kernel on the same chunk: what S0's load costs
    row["zero_state_ms"] = timer(lambda: kwkv.rwkv6_fwd(r, k, v, w, u)[:2])
    row.update(row="9s", design=WKV_DESIGN + "; the scan starts at the carried S0",
               hash=digest(torch, kwkv.rwkv6_fwd(r, k, v, w, u, s0=s0)[:2]),
               f32_max_abs_err=max(err32),
               replaces_note="rwkv6_chunked's counterpart with an initial state: the "
                             "TPU path runs its plain chunked scan there "
                             "(src/repro/kernels/ops.py:247-253)")
    log(f"kernel rwkv6_s0: the zero-state kernel on the same chunk "
        f"{row['zero_state_ms']:.4f} ms (S0's load and the carried scan: "
        f"{row['ms'] - row['zero_state_ms']:+.4f} ms)")
    del r, k, v, w, u, s0
    x = (torch.randn((SERVE_SLOTS, cfg.d_model), generator=torch.Generator(
        device="cuda").manual_seed(22), device="cuda")).to(torch.bfloat16)
    wn = torch.ones((cfg.d_model,), dtype=torch.bfloat16, device="cuda")
    norm = measure(
        torch, timer, "rmsnorm_decode_rwkv", "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:51",
        lambda: rmsnorm.rmsnorm(x, wn, cfg.norm_eps),
        lambda: ref.rmsnorm(x, wn, cfg.norm_eps), NORM_TOL,
        nbytes=2 * x.numel() * 2 + wn.numel() * 2, flops=0, rel=NORM_REL,
        library=lambda: torch.nn.functional.rms_norm(x, (cfg.d_model,), wn, cfg.norm_eps),
        note=f"; rwkv6-3b's decode [{SERVE_SLOTS}, {cfg.d_model}]")
    norm.update(row="3d", design=RMSNORM_DESIGN)
    del x, wn
    torch.cuda.empty_cache()
    return [row, norm]


def rwkv_serve_parity_phase(torch, cfg_small):
    """Reduced rwkv6-3b at fp32 (a random nonzero w_b) through the runner's
    entry points from a mid-stream slot state: two right-padded 8-token
    chunks (7 and 3 valid rows) at slot 1, then a batched decode step; the
    logits and every slot-state key on the card (the kernel from a carried
    state, f32 route) against the CPU (plain versions), within 1e-4."""
    from repro_torch.models import model as M

    params = M.init_params(cfg_small, seed=0, device="cpu", dtype=torch.float32)
    rwkv_perturb(params)
    gen = torch.Generator().manual_seed(23)
    start = {k: torch.randn(v.shape, generator=gen) * (0.3 if k == "wkv" else 1.0)
             for k, v in M.init_serve_state(cfg_small, 3, 0, 8, dtype=torch.float32,
                                            device="cpu").items()}
    chunks = [torch.randint(0, cfg_small.vocab_size, (1, 8), generator=gen,
                            dtype=torch.int32) for _ in range(2)]
    nxt = torch.tensor([5, 9, 11], dtype=torch.int32)
    lens = torch.tensor([4, 10, 2], dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = to_device(params, dev)
        state = {k: v.to(dev, copy=True) for k, v in start.items()}
        logits = []
        for n, toks in zip((7, 3), chunks):
            lg, state = M.serve_prefill_chunk(cfg_small, p, state, tokens=toks.to(dev),
                                              length=n, q_offset=0, block_table=None,
                                              slot=1)
            logits.append(lg.cpu())
        lg, state = M.serve_decode_step(cfg_small, p, state, nxt.to(dev), lens.to(dev))
        out[dev] = [torch.cat(logits + [lg.cpu()])] + [state[k].cpu() for k in M.RWKV_STATE]
    names = ("logits",) + M.RWKV_STATE
    errs = {n: float((a - b).abs().max()) for n, a, b in zip(names, out["cuda"], out["cpu"])}
    log(f"rwkv serve parity: reduced rwkv6-3b fp32, 2 chunks + 1 decode step from a "
        f"carried slot state, card vs cpu max|err| {errs} (tol 1e-4)")
    for n, a, b in zip(names, out["cuda"], out["cpu"]):
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
            fail(f"rwkv serve parity: {n} on the card disagrees with the CPU: "
                 f"max |err| {errs[n]}")
    return errs


def rwkv_fp32_identity(torch, cfg):
    """rwkv6-3b at full width and depth in fp32 (parameters from seed 0):
    prompts whose chunks cross prefill-chunk boundaries (budget 136, buckets
    32 and 128: 40 -> one chunk, 200 -> 128 + 72, 333 -> 128 + 128 + 77, 700
    -> six chunks) through the runner engine, every chunk after the first
    carrying its slot's state into the kernel, against the dense-slab
    engine's monolithic prefill from zero: greedy outputs must be
    token-identical."""
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    gen = torch.Generator().manual_seed(24)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (40, 200, 333, 700)]
    kw = dict(slots=4, max_seq=1024, prefill_buckets=(32, 128),
              max_tokens_per_tick=136)
    outs, stats = {}, {}
    for name, paged in (("runner", None), ("slab", False)):
        eng = ServeEngine(cfg, params, paged=paged, **kw)
        for p in prompts:
            eng.submit(p, max_new_tokens=FP32_NEW_TOKENS)
        outs[name] = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        stats[name] = dict(eng.stats)
        del eng
    del params
    torch.cuda.empty_cache()
    diff = [rid for rid in outs["runner"] if outs["runner"][rid] != outs["slab"].get(rid)]
    log(f"rwkv serve fp32: {len(prompts) - len(diff)} of {len(prompts)} requests "
        f"token-identical, runner ({stats['runner']['prefill_dispatches']} prefill "
        f"chunks) against the slab engine ({stats['slab']['prefill_dispatches']} "
        f"monolithic prefills)")
    if diff or len(outs["runner"]) != len(prompts):
        fail(f"rwkv serve fp32: the runner and slab engines' greedy outputs differ "
             f"(rids {diff})")
    if stats["runner"]["prefill_dispatches"] <= len(prompts):
        fail("rwkv serve fp32: no prompt crossed a prefill-chunk boundary")
    return dict(prefill_chunks=stats["runner"]["prefill_dispatches"], requests=len(prompts))


def rwkv_serve_phase(torch, cfg, counters):
    """rwkv6-3b at full width and depth in bf16 (random weights, seed 0):
    the mix of 5 through the runner engine (slot state, chunked prefill:
    the wkv6 kernel from a carried state L times a prefill chunk, the
    zero-state kernel never) and through ``ServeEngine(paged=False)`` (the
    zero-state kernel L times a prefill, the carried-state one never),
    rmsnorm (3L + 1) times a prefill chunk and a decode step on both,
    counted; tok/s, TTFT and peak memory of each; token identity between
    the two reported, not gated (bf16 near-ties may flip)."""
    from repro_torch.serve import ServeEngine

    params = serve_params(torch, cfg)
    warm = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_seq=160,
                       prefill_buckets=(32, 128))
    warm.submit(list(range(40)), max_new_tokens=3)
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()
    L = cfg.n_layers
    runs = {}
    for name, kw in (("runner", {}), ("slab", dict(paged=False))):
        out, stats, launches, summary = serve_mix(torch, cfg, params, counters, **kw)
        P, Dd = stats["prefill_dispatches"], stats["decode_dispatches"]
        norms = (3 * L + 1) * (P + Dd)
        check_launches(f"rwkv serve {name}", launches, {
            "rwkv6": L * P, "rwkv6_tc": L * P,
            "rwkv6_s0": L * P if name == "runner" else 0, "rwkv6_bwd": 0,
            "rmsnorm": norms, "rmsnorm_vector": norms})
        log(f"rwkv serve {name}: {summary['requests']} requests, {summary['tokens']} "
            f"tokens in {summary['wall_s']:.3f} s ({summary['tok_s']:.1f} tok/s), ttft "
            f"p50 {summary['ttft_p50_ms']:.1f} ms, prefill dispatches {P}, decode steps "
            f"{Dd}, state {summary['pool_bytes'] / 2**20:.1f} MiB, peak memory "
            f"{summary['peak_mem_bytes'] / 2**30:.2f} GiB")
        runs[name] = (out, launches, summary)
    same = sum(runs["runner"][0][rid] == runs["slab"][0].get(rid) for rid in runs["runner"][0])
    log(f"rwkv serve: {same} of {len(runs['runner'][0])} requests token-identical "
        f"between the runner and slab engines in bf16 (not gated)")
    del params
    torch.cuda.empty_cache()
    return ({n: r[1] for n, r in runs.items()},
            dict(runner=runs["runner"][2], slab=runs["slab"][2], same_bf16=same))


def mamba_inputs(torch, cfg, seed, b=TRAIN_BATCH, s=TRAIN_SEQ):
    """Full-width Mamba2 scan inputs as the model makes them at init: x, dy
    [b, s, H, P] (default TRAIN_BATCH, TRAIN_SEQ) and B, C [.., N] bf16 ~
    N(0, 1); dt = softplus(N(0, 1) + dt_bias) f32 with the init's dt_bias =
    0; A = -exp(A_log) f32 with the init's A_log = log(linspace(1, 16,
    H))."""
    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x, dy = randn(b, s, h, p), randn(b, s, h, p)
    B, C = randn(b, s, n), randn(b, s, n)
    dt_bias = torch.zeros((h,), device=dev)
    dt = torch.nn.functional.softplus(randn(b, s, h, dtype=torch.float32) + dt_bias)
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, h, device=dev)))
    return x, dt, A, B, C, dy


def dropped_state_control(torch, x, dt, A, B, C, y_ok, tol):
    """What the Mamba2 forward check reads for a wrong kernel: one that
    drops the state term e^{cum_t} h0 C_t of one chunk of one sequence (all
    heads), the chunk whose term is the smallest of all.  Fails unless the
    forward's tolerance tells the two apart."""
    from repro_torch.kernels import mamba_chunk as kmamba
    from repro_torch.kernels import ref

    b, s, h, p = x.shape
    t = kmamba.CHUNK
    nc = s // t
    states = ref.mamba2_chunk_states(x, dt, A, B, chunk=t)        # [B,H,NC,P,N]
    cum = torch.cumsum((dt * A).reshape(b, nc, t, h), dim=2)
    contrib = torch.einsum("bctn,bhcpn,bcth->bcthp", C.float().reshape(b, nc, t, -1),
                           states, torch.exp(cum))                 # [B,NC,T,H,P]
    size = contrib.abs().amax(dim=(2, 3, 4))                        # [B, NC]
    size[:, 0] = float("inf")                                       # h0 = 0 there
    bi, ci = (int(i) for i in torch.unravel_index(torch.argmin(size), size.shape))
    bad = y_ok.float().reshape(b, nc, t, h, p).clone()
    bad[bi, ci] -= contrib[bi, ci]
    bad = bad.reshape(b, s, h, p).to(y_ok.dtype)
    caught = not torch.allclose(bad.float(), y_ok.float(), **tol)
    d_y = float((bad.float() - y_ok.float()).abs().max())
    rel = rel_err(torch, bad, y_ok)
    log(f"mamba2 control: a forward that drops the state term of chunk {ci} of "
        f"sequence {bi} (the smallest of all: max|term| {float(size[bi, ci]):.3g}; "
        f"the largest {float(size[:, 1:].max()):.3g}) reads max|err| y {d_y:.3g} "
        f"(caught elementwise: {caught}; tolerance {tol}) and relative norm "
        f"error {rel:.2g} (caught: {rel > SCAN_REL})")
    if not caught:
        fail("mamba2 control: the forward's tolerance passes a kernel that drops "
             "one chunk's state term")
    del states, cum, contrib, bad


def rounded_w_control(torch, x, dt, A, B, C, y_ok, tol):
    """What the Mamba2 forward check reads for a kernel that drops the lo
    half of its f32 operand: the plain forward with W = L o CB o dt rounded
    once to bf16 before its product with x (the state term exact).  Logged
    against the forward's hold, not gated: a single bf16 rounding of W may
    lie inside y's one-ulp tolerance."""
    from repro_torch.kernels import mamba_chunk as kmamba
    from repro_torch.kernels import ref

    b, s, h, p = x.shape
    t = kmamba.CHUNK
    nc = s // t
    tri = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    states = ref.mamba2_chunk_states(x, dt, A, B, chunk=t)        # [B,H,NC,P,N]
    cum = torch.cumsum((dt * A).reshape(b, nc, t, h), dim=2)
    Bc, Cc = (m.float().reshape(b, nc, t, -1) for m in (B, C))
    W = ref._seg_decay(cum.flatten(0, 1), tri).reshape(b, nc, t, t, h)
    W *= torch.einsum("bctn,bcun->bctu", Cc, Bc)[..., None]
    W *= dt.reshape(b, nc, 1, t, h)
    W = W.to(torch.bfloat16).float()
    y = torch.einsum("bctuh,bcuhp->bcthp", W, x.float().reshape(b, nc, t, h, p))
    del W
    y += torch.einsum("bctn,bhcpn,bcth->bcthp", Cc, states, torch.exp(cum))
    bad = y.reshape(b, s, h, p).to(y_ok.dtype)
    del states, cum, y
    caught = not torch.allclose(bad.float(), y_ok.float(), **tol)
    d_y = float((bad.float() - y_ok.float()).abs().max())
    rel = rel_err(torch, bad, y_ok)
    log(f"mamba2 lo-half control: a forward whose W = L o CB o dt is rounded to "
        f"bf16 before its product reads max|err| y {d_y:.3g} (caught "
        f"elementwise: {caught}; tolerance {tol}) and relative norm error "
        f"{rel:.2g} (caught: {rel > SCAN_REL}); the forward's hold "
        f"{'catches' if caught or rel > SCAN_REL else 'passes'} it")
    del bad


def dropped_dstate_control(torch, x, dt, A, B, C, dy, want, tols):
    """What the Mamba2 backward check reads for a wrong kernel: one that
    drops the exit-state gradient dS of one chunk of one sequence (all
    heads), the chunk whose dS term is the smallest of all (the term dt_t
    e^{cT - cum_t} dS B_t it adds to dx).  Fails unless the backward's
    tolerances tell the two apart."""
    from repro_torch.kernels import mamba_chunk as kmamba
    from repro_torch.kernels import ref

    b, s, h, p = x.shape
    t = kmamba.CHUNK
    nc = s // t
    dstates = ref.mamba2_chunk_dstates(dt, A, C, dy, chunk=t)     # [B,H,NC,P,N]
    cum = torch.cumsum((dt * A).reshape(b, nc, t, h), dim=2)
    tail = torch.exp(cum[:, :, -1:] - cum) * dt.reshape(b, nc, t, h)
    term = torch.einsum("bcth,bhcpn,bctn->bcthp", tail, dstates,
                        B.float().reshape(b, nc, t, -1))           # [B,NC,T,H,P]
    size = term.abs().amax(dim=(2, 3, 4))                          # [B, NC]
    size[:, -1] = float("inf")                                     # dS = 0 there
    bi, ci = (int(i) for i in torch.unravel_index(torch.argmin(size), size.shape))
    del cum, tail, term
    dstates[bi, :, ci] = 0.0
    bad = ref.mamba2_bwd_local(x, dt, A, B, C, dy,
                               ref.mamba2_chunk_states(x, dt, A, B, chunk=t),
                               dstates, chunk=t)
    names = ("dx", "ddt", "dA", "dB", "dC")
    caught = [not torch.allclose(g.float(), w.float(), **tol)
              for g, w, tol in zip(bad, want, tols)]
    rels = [rel_err(torch, g, w) for g, w in zip(bad, want)]
    log(f"mamba2 backward control: a backward that drops the exit-state gradient "
        f"of chunk {ci} of sequence {bi} (the smallest dS term: max|dt tail dS B| "
        f"{float(size[bi, ci]):.3g}; the largest {float(size[:, :-1].max()):.3g}) "
        f"reads " + ", ".join(
            f"{n} max|err| {float((g.float() - w.float()).abs().max()):.3g} "
            f"(caught: {c}), rel {r:.2g}"
            for n, g, w, c, r in zip(names, bad, want, caught, rels)))
    if not any(caught):
        fail("mamba2 backward control: the backward's tolerances pass a kernel "
             "that drops one chunk's exit-state gradient")
    del dstates, bad


def mamba_kernel_phase(torch, timer, cfg):
    """The Mamba2 scan forward and backward at full-width zamba2-7b shapes:
    x [2, 4096, 112, 64] bf16, dt [2, 4096, 112] f32, A [112] f32, B, C
    [2, 4096, 64] bf16."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba_chunk as kmamba
    from repro_torch.kernels import ref

    x, dt, A, B, C, dy = mamba_inputs(torch, cfg, seed=6)
    b, s, h, p = x.shape
    n = B.shape[-1]
    t, nc = kmamba.CHUNK, kmamba.n_chunks(s)
    la = (dt * A).abs()
    log(f"mamba2 inputs x [{b},{s},{h},{p}], B/C [{b},{s},{n}]: dt in "
        f"[{float(dt.min()):.3g}, {float(dt.max()):.3g}], A in [{float(A.min()):.3g}, "
        f"{float(A.max()):.3g}], |A dt| up to {float(la.max()):.3g}, a chunk's "
        f"decay sum up to {float(la.reshape(b, nc, t, h).sum(2).max()):.4g}")
    del la
    src, rep = "src/repro_torch/kernels/csrc/mamba2.cu", "src/repro/kernels/mamba_chunk.py:86"
    # FLOPs per (batch, head, chunk) of the chunked algorithm: C B^T 2 T^2 N,
    # its causal product with x T^2 P, the state's read 2 T P N and its
    # update 2 T P N forward; backward C B^T and dy x^T (2 T^2 (N + P)), the
    # causal products for dx, dB and dC (T^2 (P + 2 N)) and four state
    # products (8 T P N)
    fwd_flops = b * h * nc * (2 * t * t * n + t * t * p + 4 * t * p * n)
    bwd_flops = b * h * nc * (4 * t * t * n + 3 * t * t * p + 8 * t * p * n)
    io = x.numel() * 2                                   # one [B,S,H,P] bf16 tensor
    bc = B.numel() * 2                                   # one [B,S,N] bf16 tensor
    state_bytes = b * h * nc * p * n * 4                 # the chunk-entry states

    want_y, want_hf = ref.mamba2_scan(x, dt, A, B, C, chunk=t)
    y_tol, h_tol = scan_tol(torch, want_y), scan_tol(torch, want_hf)
    dropped_state_control(torch, x, dt, A, B, C, want_y, y_tol)
    rounded_w_control(torch, x, dt, A, B, C, want_y, y_tol)
    del want_y, want_hf
    rows = [measure(
        torch, timer, "mamba2", src, rep,
        lambda: kmamba.mamba2_fwd(x, dt, A, B, C, save_states=True)[:2],
        lambda: ref.mamba2_scan(x, dt, A, B, C, chunk=t), (y_tol, h_tol),
        nbytes=2 * io + dt.numel() * 4 + 2 * bc + h * 4 + b * h * p * n * 4
        + state_bytes, flops=fwd_flops, rel=SCAN_REL, iters=10, plain_iters=3,
        note=f"; y, h_final; rel {SCAN_REL}; the training forward, which also "
             f"writes the {nc} chunk-entry states")]

    slots = kmamba.bwd_slots(x.device, p, n)
    log(f"mamba2 backward plan: {slots} resident blocks of the gradient kernel "
        f"({slots // _build.n_sms(x.device)} an SM), groups of "
        f"{kmamba.bwd_plan(b, s, h, slots)} heads")
    _, _, states = kmamba.mamba2_fwd(x, dt, A, B, C, save_states=True)
    first = kmamba.mamba2_bwd(x, dt, A, B, C, dy, states)
    again = kmamba.mamba2_bwd(x, dt, A, B, C, dy, states)
    want = ref.mamba2_bwd(x, dt, A, B, C, dy, chunk=t)
    torch.cuda.synchronize()
    if not all(torch.equal(u, w) for u, w in zip(first, again)):
        fail("mamba2 backward: two runs on the same inputs differ")
    log("mamba2 backward: two runs on the same inputs are bitwise equal")
    tols = tuple(scan_tol(torch, w) for w in want)
    del first, again
    dropped_dstate_control(torch, x, dt, A, B, C, dy, want, tols)
    del want
    rows.append(measure(
        torch, timer, "mamba2_bwd", src, rep,
        lambda: kmamba.mamba2_bwd(x, dt, A, B, C, dy, states),
        lambda: ref.mamba2_bwd(x, dt, A, B, C, dy, chunk=t), tols,
        nbytes=3 * io + 2 * dt.numel() * 4 + 4 * bc + 2 * h * 4 + state_bytes,
        flops=bwd_flops, rel=SCAN_REL, iters=10, plain_iters=3,
        note=f"; dx, ddt, dA, dB, dC; rel {SCAN_REL}"))
    rows[0].update(row="8", design=MAMBA_DESIGN, hash=digest(
        torch, kmamba.mamba2_fwd(x, dt, A, B, C, save_states=True)))
    rows[1].update(row="8b", design=MAMBA_DESIGN,
                   hash=digest(torch, kmamba.mamba2_bwd(x, dt, A, B, C, dy, states)))
    del x, dt, A, B, C, dy, states
    torch.cuda.empty_cache()
    return rows


def flash112_phase(torch, timer, cfg):
    """Flash attention at zamba2-7b's shared-attention shapes: q, k, v
    [2, 4096, 32, 112] bf16 (MHA), causal."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.hd)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    rows = flash_rows(torch, timer, q, k, v, do, suffix="_hd112")
    del q, k, v, do
    torch.cuda.empty_cache()
    return rows


def zamba_expect(cfg, n):
    """Counted launches of n hybrid steps with the nested remat: a grouped
    Mamba2 layer runs its forward three times a step (the forward, its
    group's recompute, its own recompute), a tail layer and the shared
    block twice; each backward once.  A Mamba2 layer runs two norms (ln1,
    the gated norm) and one silu_mul; the shared block two norms, rope on q
    and k in one launch, flash attention and the FFN's silu_mul (rope's
    backward is its forward kernel at sign -1); the final norm is outside
    the remat.  Every
    Mamba2 forward also writes its chunk-entry states: under the
    non-reentrant checkpoint the first forward wants a gradient too, and
    its saved tensors are dropped, not left unwritten."""
    from repro_torch.models.model import hybrid_layout

    g, k, t = hybrid_layout(cfg)
    mf, mb = 3 * g * k + 2 * t, g * k + t          # Mamba2 layer forwards, backwards
    sf, sb = 2 * g, g                              # shared-block forwards, backwards
    return {"mamba2": mf * n, "mamba2_bwd": mb * n, "mamba2_states": mf * n,
            "flash_attention": sf * n, "flash_attention_bwd": sb * n,
            "rmsnorm": (2 * mf + 2 * sf + 1) * n, "rmsnorm_bwd": (2 * mb + 2 * sb + 1) * n,
            "rmsnorm_bwd_vector": (2 * mb + 2 * sb + 1) * n,
            "apply_rope": (sf + sb) * n, "apply_rope_qk": (sf + sb) * n,
            "silu_mul": (mf + sf) * n, "silu_mul_bwd": (mb + sb) * n,
            "silu_mul_vector": (mf + sf) * n}


def zamba_watched(st):
    p = st.params
    return {"embed": p["embed"]["table"][:4],
            "g0_in_proj": p["groups"][0][0]["mamba"]["in_proj"]["w"][:4],
            "tail_out_proj": p["tail"][-1]["mamba"]["out_proj"]["w"][:4],
            "shared_wq": p["shared"]["attn"]["wq"]["w"][:4],
            "lm_head": p["lm_head"]["w"][:4]}


# ---------------------------------------------------------------------------
# phase 20: hybrid serving (zamba2-7b)
# ---------------------------------------------------------------------------

def mamba_carried_state(torch, cfg, seed, s=SERVE_CHUNK):
    """Row 8s's inputs: a serving prefill chunk x [1, s, H, P] with its dt,
    A, B, C (mamba_inputs' draws) and the SSM state h0 [1, H, P, N] f32
    that a previous chunk of the same kind leaves (the plain scan from zero
    over it): the state a slot carries into its next chunk."""
    from repro_torch.kernels import mamba_chunk as kmamba
    from repro_torch.kernels import ref

    prev = mamba_inputs(torch, cfg, seed + 1, b=1, s=s)
    h0 = ref.mamba2_scan(*prev[:5], chunk=kmamba.CHUNK)[1].contiguous()
    del prev
    return mamba_inputs(torch, cfg, seed, b=1, s=s)[:5] + (h0,)


def mamba_serve_row(torch, timer, cfg):
    """Row 8s, the Mamba2 forward from a carried state at zamba2-7b's
    serving prefill chunk (x [1, 512, 112, 64] bf16, h0 [1, 112, 64, 64]
    f32), held against the plain scan from the same h0 in bf16 and in f32
    with ``scan_tol``, twice bitwise equal, with h0 = 0 giving the bits of
    the zero-state kernel (here and at row 8's training shape, its
    chunk-entry states included) and a control (the plain scan with h0 left
    out) that the hold must catch; timed beside the zero-state kernel on
    the same chunk."""
    from repro_torch.kernels import mamba_chunk as kmamba
    from repro_torch.kernels import ref

    x, dt, A, B, C, h0 = mamba_carried_state(torch, cfg, seed=25)
    b, s, h, p = x.shape
    n = B.shape[-1]
    t, nc = kmamba.CHUNK, kmamba.n_chunks(s)
    want_y, want_hf = ref.mamba2_scan(x, dt, A, B, C, h0=h0, chunk=t)
    y_tol, h_tol = scan_tol(torch, want_y), scan_tol(torch, want_hf)
    dropped = ref.mamba2_scan(x, dt, A, B, C, chunk=t)
    caught = [not torch.allclose(g.float(), w.float(), **tol) or rel_err(torch, g, w) > SCAN_REL
              for g, w, tol in zip(dropped, (want_y, want_hf), (y_tol, h_tol))]
    log(f"mamba2 h0 control: the plain scan with h0 left out reads y max|err| "
        f"{float((dropped[0].float() - want_y.float()).abs().max()):.3g} (rel "
        f"{rel_err(torch, dropped[0], want_y):.2g}), h_final max|err| "
        f"{float((dropped[1] - want_hf).abs().max()):.3g} (rel "
        f"{rel_err(torch, dropped[1], want_hf):.2g}); caught: {caught}")
    if not caught[0]:
        fail("mamba2 h0 control: the hold passes an output that drops the carried state")
    del dropped, want_y, want_hf
    repeat_equal(torch, "mamba2 h0", lambda: kmamba.mamba2_fwd(x, dt, A, B, C, h0=h0)[:2])
    zero = kmamba.mamba2_fwd(x, dt, A, B, C, h0=torch.zeros_like(h0))[:2]
    none = kmamba.mamba2_fwd(x, dt, A, B, C)[:2]
    if not all(torch.equal(u, v) for u, v in zip(zero, none)):
        fail("mamba2 h0: h0 = 0 does not give the zero-state kernel's bits")
    # f32 (the fp32 parity runs' route)
    xf, Bf, Cf = x.float(), B.float(), C.float()
    got32 = kmamba.mamba2_fwd(xf, dt, A, Bf, Cf, h0=h0)[:2]
    want32 = ref.mamba2_scan(xf, dt, A, Bf, Cf, h0=h0, chunk=t)
    torch.cuda.synchronize()
    err32 = [hold(torch, "mamba2 h0 f32", g, w, scan_tol(torch, w), SCAN_REL)
             for g, w in zip(got32, want32)]
    zero32 = kmamba.mamba2_fwd(xf, dt, A, Bf, Cf, h0=torch.zeros_like(h0))[:2]
    none32 = kmamba.mamba2_fwd(xf, dt, A, Bf, Cf)[:2]
    if not all(torch.equal(u, v) for u, v in zip(zero32, none32)):
        fail("mamba2 h0 f32: h0 = 0 does not give the zero-state kernel's bits")
    del xf, Bf, Cf, got32, want32, zero32, none32, zero, none
    # at row 8's training shape, the chunk-entry states written too
    tx, tdt, tA, tB, tC, _ = mamba_inputs(torch, cfg, seed=6)
    z = torch.zeros((tx.shape[0], h, p, n), device="cuda")
    if not all(torch.equal(u, v) for u, v in zip(
            kmamba.mamba2_fwd(tx, tdt, tA, tB, tC, h0=z, save_states=True),
            kmamba.mamba2_fwd(tx, tdt, tA, tB, tC, save_states=True))):
        fail("mamba2 h0: h0 = 0 at row 8's shape does not give the zero-state bits")
    del tx, tdt, tA, tB, tC, z
    log(f"mamba2 h0: f32 route max|err| y {err32[0]:.3g}, h_final {err32[1]:.3g}; "
        f"bf16 twice bitwise equal; h0 = 0 gives the zero-state kernel's bits in "
        f"bf16 and f32 at [1, {s}] and in bf16 at row 8's [{TRAIN_BATCH}, "
        f"{TRAIN_SEQ}] with its chunk-entry states")
    io, bc, st = x.numel() * 2, B.numel() * 2, b * h * p * n * 4
    row = measure(
        torch, timer, "mamba2_h0", "src/repro_torch/kernels/csrc/mamba2.cu",
        "src/repro/kernels/mamba_chunk.py:86",
        lambda: kmamba.mamba2_fwd(x, dt, A, B, C, h0=h0)[:2],
        lambda: ref.mamba2_scan(x, dt, A, B, C, h0=h0, chunk=t), (y_tol, h_tol),
        nbytes=2 * io + dt.numel() * 4 + 2 * bc + h * 4 + 2 * st,
        flops=b * h * nc * (2 * t * t * n + t * t * p + 4 * t * p * n), rel=SCAN_REL,
        iters=20, plain_iters=5,
        note=f"; y, h_final; rel {SCAN_REL}; the serving chunk from a carried state")
    row["zero_state_ms"] = timer(lambda: kmamba.mamba2_fwd(x, dt, A, B, C)[:2])
    row.update(row="8s", design=MAMBA_DESIGN + "; the state walk starts at the carried h0",
               hash=digest(torch, kmamba.mamba2_fwd(x, dt, A, B, C, h0=h0)[:2]),
               f32_max_abs_err=max(err32),
               replaces_note="mamba2_chunked's counterpart with an initial state: the "
                             "TPU path runs its plain chunked scan there "
                             "(src/repro/kernels/ops.py:259-263)")
    log(f"kernel mamba2_h0: the zero-state kernel on the same chunk "
        f"{row['zero_state_ms']:.4f} ms (h0's load and the carried walk: "
        f"{row['ms'] - row['zero_state_ms']:+.4f} ms)")
    del x, dt, A, B, C, h0
    torch.cuda.empty_cache()
    return row


def dims_dropped_control(torch, name, got, want, tol, rel, seq_rel=None):
    """The head-dim trap (a lane holding D // 32 output dims drops the last
    16 of 112): the kernel's output with its last 16 dims zeroed must fail
    the hold that the output itself passes."""
    bad = got.clone()
    bad[..., -16:] = 0
    d = got.shape[-1]
    dropped_step_control(torch, name, f"its last 16 output dims ({d - 16}-{d - 1})",
                         want, bad, tol, rel, seq_rel)


def attn_rows(torch, timer, cfg, labels=("1h", "2h", "7h"), seed=26):
    """Readings ``labels`` (1h, 2h and 7h at zamba2-7b's shared-attention
    shapes, 32 heads over 32 kv heads at head dim 112; 1o, 2o and 7o at
    olmoe-1b-7b's, 16 over 16 at head dim 128): the paged decode, the paged
    prefill and the slab decode of ``cfg``'s attention, named with the head
    dim: decode q [8, H, hd] over a pool [KvH, 513, 16, hd] through tables
    [8, 64]; a 512-row prefill chunk at q_offset 256; the slab decode over
    [8, 1024, KvH, hd].  Each held against its plain version in bf16 (twice
    bitwise equal; per sequence too at decode) and in f32, with the
    dims-dropped control; the paged two also over the int8 pool and as
    skip_null partials over 4 shards (each shard held, their NoC combine
    against the unsharded kernel); bf16 timed as in 3."""
    import torch.nn.functional as F

    from repro_torch.core import noc
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import prefill_attention as kpf
    from repro_torch.kernels import ref

    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sfx, who = f"_hd{hd}", cfg.name
    c, qoff = SERVE_CHUNK, 256
    slots, bs, mb = SERVE_SLOTS, 16, 64
    nb = 1 + slots * mb
    csrc = "src/repro_torch/kernels/csrc/"
    kp, vp = randn(kvh, nb, bs, hd), randn(kvh, nb, bs, hd)
    perm = torch.randperm(nb - 1, generator=gen, device=dev)[:slots * mb] + 1
    tables = perm.to(torch.int32).reshape(slots, mb).contiguous()
    lens = torch.randint(1, mb * bs + 1, (slots,), generator=gen, device=dev,
                         dtype=torch.int32)
    qd, qp = randn(slots, h, hd), randn(1, c, h, hd)
    table = tables[0].contiguous()
    total = qoff + c
    live = int(lens.sum())
    kv_row = kvh * hd * 2 * 2
    attended = sum(min(qoff + i + 1, total) for i in range(c))
    k8, ks = quantize_pages(torch, kp)
    v8, vs = quantize_pages(torch, vp)
    pool = dict(kp=kp, vp=vp, lens=lens, tables=tables, qoff=qoff, qp=qp)
    sp = shard_pool(torch, pool, SEQ_SHARDS)
    S = sp["n"]

    dec = dict(
        kernel=lambda q, k, v, **kw: kda.paged_decode_attention(q, k, v, tables, lens, **kw),
        plain=lambda q, k, v, **kw: ref.paged_decode_attention(q, k, v, tables,
                                                               lengths=lens, **kw),
        part=lambda q, k, v, s, **kw: kda.paged_decode_attention_partial(
            q, k, v, sp["local"][s], sp["lens"], skip_null=True, **kw),
        part_plain=lambda q, k, v, s, **kw: ref.paged_decode_attention_partial(
            q, k, v, sp["local"][s], lengths=sp["lens"], skip_null=True, **kw),
        whole=lambda q, k, v: kda.paged_decode_attention(q, k, v, sp["table"], sp["lens"]),
        q=qd, tol=DECODE_TOL, rel=DECODE_REL, seq_rel=DECODE_SEQ_REL)
    pre = dict(
        kernel=lambda q, k, v, **kw: kpf.paged_prefill_attention(
            q, k, v, table, q_offset=qoff, length=c, **kw),
        plain=lambda q, k, v, **kw: ref.paged_prefill_attention(
            q, k, v, table, q_offset=qoff, length=c, **kw),
        part=lambda q, k, v, s, **kw: kpf.paged_prefill_attention_partial(
            q, k, v, sp["plocal"][s], q_offset=qoff, length=c, skip_null=True, **kw),
        part_plain=lambda q, k, v, s, **kw: ref.paged_prefill_attention_partial(
            q, k, v, sp["plocal"][s], q_offset=qoff, length=c, skip_null=True, **kw),
        whole=lambda q, k, v: kpf.paged_prefill_attention(
            q, k, v, sp["ptable"], q_offset=qoff, length=c),
        q=qp, tol=PREFILL_TOL, rel=PREFILL_REL, seq_rel=None)
    for tag, cs in ((f"paged_decode_attention{sfx}", dec),
                    (f"paged_prefill_attention{sfx}", pre)):
        q = cs["q"]
        got = repeat_equal(torch, tag, lambda: cs["kernel"](q, kp, vp))
        want = cs["plain"](q, kp, vp)
        hold(torch, tag, got, want, cs["tol"], cs["rel"])
        if cs["seq_rel"] is not None and seq_rel_err(torch, got, want) > cs["seq_rel"]:
            fail(f"{tag}: a sequence's relative norm error {seq_rel_err(torch, got, want)}")
        dims_dropped_control(torch, tag, got, want, cs["tol"], cs["rel"], cs["seq_rel"])
        qf, kf, vf = q.float(), kp.float(), vp.float()
        e32 = hold(torch, f"{tag} f32", cs["kernel"](qf, kf, vf), cs["plain"](qf, kf, vf),
                   DENSE_F32_TOL, DENSE_F32_REL)
        errs8 = []
        for dtype, tol, rel in ((bf, Q8_BF16_TOL, Q8_REL), (torch.float32, Q8_F32_TOL, None)):
            qq = q.to(dtype)
            g8 = repeat_equal(torch, f"{tag} int8", lambda: cs["kernel"](
                qq, k8, v8, k_scales=ks, v_scales=vs))
            w8 = cs["plain"](qq, k8, v8, k_scales=ks, v_scales=vs)
            errs8.append(hold(torch, f"{tag} int8 {str(dtype)[6:]}", g8, w8, tol, rel))
            if dtype == bf:
                dims_dropped_control(torch, f"{tag} int8", g8, w8, tol, rel)
        errs_s = []
        for dtype, tol, rel in ((bf, DECODE_TOL if cs is dec else PREFILL_TOL, cs["rel"]),
                                (torch.float32, DENSE_F32_TOL, None)):
            qq = q.to(dtype)
            views = sp["views"][dtype]
            parts = [cs["part"](qq, *views[s], s) for s in range(S)]
            wparts = [cs["part_plain"](qq, *views[s], s) for s in range(S)]
            torch.cuda.synchronize()
            lv = [w[1] > -1e29 for w in wparts]
            for g, w in zip(parts_view(torch, parts, lv), parts_view(torch, wparts, lv)):
                hold(torch, f"{tag} shards {str(dtype)[6:]}", g, w, tol, rel)
            n_dead = hold_identity(torch, f"{tag} shards", parts, lv)
            comb = noc.tree_softmax_combine(parts).to(dtype)
            errs_s.append(hold(torch, f"{tag} shards combined {str(dtype)[6:]}", comb,
                               cs["whole"](qq, *sp["pools"][dtype]), tol, rel))
        log(f"{tag}: f32 max|err| {e32:.3g}; int8 pool bf16 {errs8[0]:.3g}, f32 "
            f"{errs8[1]:.3g}; {S} shards' NoC combine vs the unsharded kernel bf16 "
            f"{errs_s[0]:.3g}, f32 {errs_s[1]:.3g} ({n_dead} f32 rows see no owned key)")
        del got, want, qf, kf, vf
    rows = []
    rows.append(measure(
        torch, timer, f"paged_decode_attention{sfx}", csrc + "decode_attention.cu",
        "src/repro/kernels/decode_attention.py:300", lambda: dec["kernel"](qd, kp, vp),
        lambda: dec["plain"](qd, kp, vp), DECODE_TOL, rel=DECODE_REL,
        nbytes=2 * qd.numel() * 2 + live * kv_row + tables.numel() * 4,
        flops=4 * h * hd * live,
        note=f"; rel {DECODE_REL}; {who}'s decode, {live} live keys"))
    rows.append(measure(
        torch, timer, f"paged_prefill_attention{sfx}", csrc + "paged_attention.cu",
        "src/repro/kernels/prefill_attention.py:273", lambda: pre["kernel"](qp, kp, vp),
        lambda: pre["plain"](qp, kp, vp), PREFILL_TOL, rel=PREFILL_REL,
        nbytes=2 * qp.numel() * 2 + total * kv_row + mb * 4,
        flops=4 * h * hd * attended,
        note=f"; rel {PREFILL_REL}; {who}'s prefill chunk at offset {qoff}"))
    rows[0].update(row=labels[0], design=DECODE_DESIGN)
    rows[1].update(row=labels[1], design=PREFILL_DESIGN)
    del sp, k8, v8, ks, vs, qp
    # the slab decode (7h) at the same lengths
    k, v = randn(slots, mb * bs, kvh, hd), randn(slots, mb * bs, kvh, hd)
    got = repeat_equal(torch, f"decode_attention{sfx}",
                       lambda: kda.decode_attention(qd, k, v, lens))
    want = ref.decode_attention(qd, k, v, lengths=lens)
    dims_dropped_control(torch, f"decode_attention{sfx}", got, want, DECODE_TOL,
                         DECODE_REL, DECODE_SEQ_REL)
    e32 = hold(torch, f"decode_attention{sfx} f32",
               kda.decode_attention(qd.float(), k.float(), v.float(), lens),
               ref.decode_attention(qd.float(), k.float(), v.float(), lengths=lens),
               DENSE_F32_TOL, DENSE_F32_REL)
    kpos = torch.arange(mb * bs, device=dev)
    qs, kss, vss = qd[:, :, None], k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = (kpos[None, :] < lens[:, None])[:, None, None, :]
    rows.append(measure(
        torch, timer, f"decode_attention{sfx}", csrc + "decode_attention.cu",
        "src/repro/kernels/decode_attention.py:114",
        lambda: kda.decode_attention(qd, k, v, lens),
        lambda: ref.decode_attention(qd, k, v, lengths=lens), DECODE_TOL, rel=DECODE_REL,
        nbytes=2 * qd.numel() * 2 + live * kv_row + slots * 4, flops=4 * h * hd * live,
        library=lambda: F.scaled_dot_product_attention(qs, kss, vss, attn_mask=mask),
        note=f"; rel {DECODE_REL}; f32 max|err| {e32:.3g}; {who}'s slab decode"))
    rows[-1].update(row=labels[2], design=DECODE_DESIGN)
    del k, v, kp, vp, got, want, qs, kss, vss, mask
    torch.cuda.empty_cache()
    return rows


# (row of the {"kernels": ...} line) -> the launch counter it is read from
# in the zamba2-7b serving runs
ZAMBA_ROW_COUNTER = {"mamba2_h0": ("runner", "mamba2_h0"),
                     "paged_decode_attention_hd112": ("runner", "paged_decode_attention"),
                     "paged_prefill_attention_hd112": ("runner", "paged_prefill_attention"),
                     "decode_attention_hd112": ("slab", "decode_attention")}


def zamba_serve_parity_phase(torch, cfg_small):
    """Reduced zamba2-7b at fp32 through the runner's entry points from a
    mid-stream state: slot state and pages drawn at random, two
    right-padded 8-token chunks (7 and 3 valid rows) at slot 1 and q_offset
    16 and 23 over its pages, then a batched decode step of 3 slots; the
    logits, every slot-state key and the pages on the card (the Mamba2
    kernel from a carried state, f32 route; the paged kernels at head dim
    16) against the CPU (plain versions), within 1e-4."""
    from repro_torch.models import model as M

    params = M.init_params(cfg_small, seed=0, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(27)
    start = M.init_serve_state(cfg_small, 3, 9, 8, dtype=torch.float32, device="cpu")
    start = {k: ({kk: torch.randn(vv.shape, generator=gen) for kk, vv in v.items()}
                 if k == "attn" else
                 torch.randn(v.shape, generator=gen) * (0.3 if "ssm" in k else 1.0))
             for k, v in start.items()}
    tables = torch.tensor([[1, 4, 0, 0], [3, 5, 2, 7], [6, 0, 0, 0]], dtype=torch.int32)
    chunks = [torch.randint(0, cfg_small.vocab_size, (1, 8), generator=gen,
                            dtype=torch.int32) for _ in range(2)]
    nxt = torch.tensor([5, 9, 11], dtype=torch.int32)
    lens = torch.tensor([9, 26, 2], dtype=torch.int32)
    names = ("logits",) + M.HYBRID_STATE + ("k_pages", "v_pages")
    out = {}
    for dev in ("cpu", "cuda"):
        p = to_device(params, dev)
        state = to_device(start, dev)
        if dev == "cpu":                       # the calls update it in place
            state = {k: ({kk: vv.clone() for kk, vv in v.items()}
                         if isinstance(v, dict) else v.clone()) for k, v in state.items()}
        logits, qoff = [], 16
        for n, toks in zip((7, 3), chunks):
            lg, state = M.serve_prefill_chunk(cfg_small, p, state, tokens=toks.to(dev),
                                              length=n, q_offset=qoff,
                                              block_table=tables[1].to(dev), slot=1)
            logits.append(lg.cpu())
            qoff += n
        lg, state = M.serve_decode_step(cfg_small, p, state, nxt.to(dev), lens.to(dev),
                                        tables.to(dev))
        out[dev] = ([torch.cat(logits + [lg.cpu()])]
                    + [state[k].cpu() for k in M.HYBRID_STATE]
                    + [state["attn"][k].cpu() for k in ("k_pages", "v_pages")])
    errs = {n: float((a - b).abs().max()) for n, a, b in zip(names, out["cuda"], out["cpu"])}
    log(f"zamba serve parity: reduced zamba2-7b fp32, 2 chunks + 1 decode step from a "
        f"mid-stream slot state and pool, card vs cpu max|err| {errs} (tol 1e-4)")
    for n, a, b in zip(names, out["cuda"], out["cpu"]):
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
            fail(f"zamba serve parity: {n} on the card disagrees with the CPU: "
                 f"max |err| {errs[n]}")
    return errs


def zamba_fp32_identity(torch, cfg):
    """zamba2-7b at full width and depth in fp32 (parameters from seed 0):
    a shared-prefix pair (a 256-token prefix, 16 pages; its second member
    admitted after the first has published them) and prompts of 40-700
    tokens whose chunks cross prefill-chunk boundaries (budget 136, buckets
    32 and 128), through the runner engine with prefix caching on and off,
    every chunk after a prompt's first carrying its slot's state into the
    Mamba2 kernel from a carried state, against the dense-slab engine's
    monolithic prefill from zero (the zero-state kernel): greedy outputs
    must be token-identical, and the runner must report 0 prefix-hit
    tokens (a recurrent family never skips prefill)."""
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    gen = torch.Generator().manual_seed(28)
    shared = torch.randint(0, cfg.vocab_size, (256,), generator=gen).tolist()
    rest = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in (40, 200, 333, 700, 40, 72)]
    prompts = [shared + rest[4]] + rest[:4] + [shared + rest[5]]
    kw = dict(slots=4, max_seq=1024, prefill_buckets=(32, 128), max_tokens_per_tick=136)
    outs, stats = {}, {}
    for name, opts in (("runner", {}), ("runner_cache_off", dict(prefix_caching=False)),
                       ("slab", dict(paged=False))):
        eng = ServeEngine(cfg, params, **kw, **opts)
        for p in prompts:
            eng.submit(p, max_new_tokens=FP32_NEW_TOKENS)
        outs[name] = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        stats[name] = dict(eng.stats, prefix_caching=eng.prefix_caching)
        del eng
    del params
    torch.cuda.empty_cache()
    diff = {name: [rid for rid in outs["slab"] if outs[name].get(rid) != outs["slab"][rid]]
            for name in ("runner", "runner_cache_off")}
    run = stats["runner"]
    log(f"zamba serve fp32: runner (prefix caching {run['prefix_caching']}, "
        f"{run['prefill_dispatches']} prefill chunks, prefix-hit tokens "
        f"{run['prefix_hit_tokens']}) and runner with caching off against the slab "
        f"engine ({stats['slab']['prefill_dispatches']} monolithic prefills): "
        f"requests differing {diff} of {len(prompts)}")
    if any(diff.values()) or len(outs["slab"]) != len(prompts):
        fail(f"zamba serve fp32: the runner and slab engines' greedy outputs differ {diff}")
    if not run["prefix_caching"] or run["prefix_hit_tokens"] != 0:
        fail("zamba serve fp32: the runner with prefix caching on attached a cached "
             "prefix (or had caching off)")
    if run["prefill_dispatches"] <= len(prompts):
        fail("zamba serve fp32: no prompt crossed a prefill-chunk boundary")
    return dict(prefill_chunks=run["prefill_dispatches"], requests=len(prompts),
                prefix_hit_tokens=run["prefix_hit_tokens"])


def zamba_serve_phase(torch, cfg, counters):
    """zamba2-7b at full width and depth in bf16 (random weights, seed 0):
    the mix of 5 through the runner engine (the pool beside the slot state,
    chunked prefill: the Mamba2 kernel from a carried state L times a
    prefill chunk, the zero-state one never; the paged prefill G times a
    chunk, the paged decode G times a step), ``ServeEngine(paged=False)``
    (the zero-state Mamba2 kernel L times a prefill, the flash forward with
    a key bound G times, the slab decode G times a step), an int8 pool and
    4 sequence shards (their kernels G and 4 G times), with the rmsnorm,
    rope and silu_mul counts of every step, counted; no prefix hit on a
    paged run; tok/s, TTFT and peak memory of each."""
    from repro_torch.models.model import hybrid_layout
    from repro_torch.serve import ServeEngine

    params = serve_params(torch, cfg)
    warm = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_seq=160,
                       prefill_buckets=(32, 128))
    warm.submit(list(range(40)), max_new_tokens=3)
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()
    L, G = cfg.n_layers, hybrid_layout(cfg)[0]
    runs = {}
    for name, kw in (("runner", {}), ("slab", dict(paged=False)),
                     ("int8", dict(kv_dtype="int8")), ("seq4", dict(seq_shards=SEQ_SHARDS))):
        out, stats, launches, summary = serve_mix(torch, cfg, params, counters, **kw)
        P, Dd = stats["prefill_dispatches"], stats["decode_dispatches"]
        steps = P + Dd
        expect = {k: 0 for k in counters}
        expect.update({
            "mamba2": L * P, "rmsnorm": (2 * L + 2 * G + 1) * steps,
            "rmsnorm_vector": (2 * L + 2 * G + 1) * steps, "apply_rope": G * steps,
            "apply_rope_qk": G * steps, "apply_rope_vector": G * steps,
            "silu_mul": (L + G) * steps})
        if name == "slab":
            expect.update(flash_attention_lengths=G * P, decode_attention=G * Dd)
        else:
            expect["mamba2_h0"] = L * P
            n = SEQ_SHARDS if name == "seq4" else 1
            key = {"runner": "", "int8": "_int8", "seq4": "_skip_null"}[name]
            expect.update({f"paged_decode_attention{key}": n * G * Dd,
                           f"paged_prefill_attention{key}": n * G * P,
                           "paged_prefill_attention_tc": n * G * P})
        check_launches(f"zamba serve {name}", launches, expect)
        if stats["prefix_hit_tokens"]:
            fail(f"zamba serve {name}: {stats['prefix_hit_tokens']} prefix-hit tokens "
                 f"(a recurrent family must prefill every prompt)")
        log(f"zamba serve {name}: {summary['requests']} requests, {summary['tokens']} "
            f"tokens in {summary['wall_s']:.3f} s ({summary['tok_s']:.1f} tok/s), ttft "
            f"p50 {summary['ttft_p50_ms']:.1f} ms, prefill dispatches {P}, decode steps "
            f"{Dd}, state {summary['pool_bytes'] / 2**20:.1f} MiB, peak memory "
            f"{summary['peak_mem_bytes'] / 2**30:.2f} GiB")
        runs[name] = (out, launches, summary)
    ref_out = runs["runner"][0]
    same = {name: sum(runs[name][0][rid] == ref_out.get(rid) for rid in runs[name][0])
            for name in ("slab", "int8", "seq4")}
    first = {name: sorted(next((i for i, (a, b) in enumerate(zip(out[rid], ref_out[rid]))
                                if a != b), len(out[rid])) for rid in out)
             for name, (out, _, _) in runs.items() if name != "runner"}
    log(f"zamba serve: requests token-identical to the runner run in bf16 (not "
        f"gated): {same} of {len(ref_out)}; first differing token of each request, "
        f"sorted: {first}")
    gate = zamba_prefill_gate(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    return ({n: r[1] for n, r in runs.items()},
            dict({n: r[2] for n, r in runs.items()}, same_bf16=same,
                 first_difference=first, prefill_gate_rel=gate))


def zamba_prefill_gate(torch, cfg, params):
    """One ~640-token prompt's last-token logits in bf16 at full width: the
    slab ``prefill`` (bucket 1024: the zero-state Mamba2 kernel, flash with
    a key bound) against the runner's chunked prefill (chunks of 512 and
    128, the second carrying the slot's state into the Mamba2 kernel from a
    carried state, the shared block through the pool); relative norm error
    and argmax, logged (a reading, not gated)."""
    from repro_torch.models import model as M

    n, bs = 640, 16
    gen = torch.Generator(device="cuda").manual_seed(29)
    prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                           device="cuda", dtype=torch.int32)
    slab = M.init_decode_state(cfg, 1, 1024, dtype=torch.bfloat16)
    padded = torch.zeros((1, 1024), dtype=torch.int32, device="cuda")
    padded[0, :n] = prompt
    want, _ = M.prefill(cfg, params, slab, tokens=padded,
                        lengths=torch.tensor([n], dtype=torch.int32, device="cuda"))
    del slab
    state = M.init_serve_state(cfg, 1, 1 + n // bs, bs, dtype=torch.bfloat16)
    table = torch.arange(1, 1 + n // bs, dtype=torch.int32, device="cuda")
    for off, c in ((0, 512), (512, 128)):
        got, _ = M.serve_prefill_chunk(cfg, params, state, tokens=prompt[None, off:off + c],
                                       length=c, q_offset=off, slot=0,
                                       block_table=table[:-(-(off + c) // bs)])
    del state
    torch.cuda.empty_cache()
    r = rel_err(torch, got, want[:, 0])
    agree = bool(torch.argmax(got) == torch.argmax(want[:, 0]))
    log(f"zamba serve gate: {n}-token prompt, last-token logits slab prefill vs the "
        f"runner's chunked prefill (512 + 128, state carried) relative norm error "
        f"{r:.3g}, argmax agrees: {agree} (a reading, not gated)")
    if not math.isfinite(r):
        fail("zamba serve gate: non-finite logits")
    return r


# ---------------------------------------------------------------------------
# phase 21: MoE serving (olmoe-1b-7b)
# ---------------------------------------------------------------------------

def expert_silu_rows(torch, timer, cfg):
    """Rows 5e and 5ed: silu_mul through ``ops.silu_mul`` at olmoe-1b-7b's
    routed-expert shapes [E_pad, cap, moe_d_ff]: a 512-row prefill chunk's
    (cap 80, the vector route) and a decode step's of 8 slots (cap 4,
    262144 elements: the element route); each held in bf16 (twice bitwise
    equal, timed and logged as row 5) and in f32."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import swiglu as ksw
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(30)
    e_pad, ff = moe.moe_padded_experts(cfg), cfg.moe_d_ff
    floor = timer(lambda: torch.cuda._sleep(1))
    rows = []
    for name, label, t in (("silu_mul_experts", "5e", SERVE_CHUNK),
                           ("silu_mul_experts_decode", "5ed", SERVE_SLOTS)):
        cap = moe.capacity(t, cfg.top_k, cfg.capacity_factor, e_pad)
        shape = (e_pad, cap, ff)
        g = torch.randn(shape, generator=gen, device="cuda") * 3.0
        u = torch.randn(shape, generator=gen, device="cuda")
        e32 = hold(torch, f"{name} f32", ops.silu_mul(g, u), ref.silu_mul(g, u),
                   DENSE_F32_TOL, DENSE_F32_REL)
        g, u = g.to(torch.bfloat16), u.to(torch.bfloat16)
        route = ksw.plan(g.numel(), 2, True, _build.n_sms(g.device)).route
        repeat_equal(torch, name, lambda: ops.silu_mul(g, u))
        nbytes = 3 * g.numel() * 2
        row = measure(
            torch, timer, name, "src/repro_torch/kernels/csrc/swiglu.cu",
            "src/repro/kernels/swiglu.py:59", lambda: ops.silu_mul(g, u),
            lambda: ref.silu_mul(g, u), SILU_TOL, rel=SILU_REL, nbytes=nbytes,
            flops=5 * g.numel(),
            note=f"; rel {SILU_REL}; f32 max|err| {e32:.3g}; [{e_pad}, {cap}, {ff}], "
                 f"a dispatch of {t} rows; the {route} route")
        row.update(row=label, design=SILU_DESIGN, launch_floor_ms=floor, route_taken=route)
        log_rate(torch, timer, row, nbytes)
        rows.append(row)
        del g, u
    return rows


def skew_moe(torch, params, cfg, seed):
    """Lean every token of ``params`` (an MoE model, in place) towards
    experts 0 and 1: a unit direction c added three times to each
    embedding row, c and c / 2 to every layer's router columns 0 and 1."""
    d = cfg.d_model
    gen = torch.Generator().manual_seed(seed)
    c = torch.randn(d, generator=gen)
    c = (c / c.norm()).to(params["embed"]["table"].device)
    params["embed"]["table"] += (3.0 * c).to(params["embed"]["table"].dtype)
    for lp in params["layers"]:
        lp["moe"]["router"][:, 0] += c
        lp["moe"]["router"][:, 1] += 0.5 * c


class DropCounter:
    """While entered, counts the dispatches of ``models/moe.py`` and the
    assignments they drop (a host read per dispatch: checks only, never in
    a timed run)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe.route
        self.dispatches = self.dropped = 0

    def __enter__(self):
        def counted(*args, **kwargs):
            r = self.route(*args, **kwargs)
            self.dispatches += 1
            self.dropped += int((~r.keep).sum())
            return r
        self.moe.route = counted
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def moe_layer_check(torch, cfg, seed):
    """One MoE layer at ``cfg``'s full width in f32 on the card against the
    CPU, same parameters (drawn on the card, copied): 40 rows leaning
    towards expert 0 at the default capacity factor, so the dispatch drops;
    each assignment's buffer row, the kept set and the expert loads equal,
    the gates and the output within 1e-4 (the card's f32 GEMMs sum in
    another order)."""
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = moe.moe_init(cfg, gen, dtype=torch.float32, device="cuda")
    c = torch.randn(cfg.d_model, generator=gen, device="cuda")
    c /= c.norm()
    x = torch.randn((1, 40, cfg.d_model), generator=gen, device="cuda") + 2.0 * c
    p["router"][:, 0] += c
    e_pad = p["router"].shape[1]
    cap = moe.capacity(40, cfg.top_k, cfg.capacity_factor, e_pad)
    out = {}
    for dev in ("cuda", "cpu"):
        pd, xd = to_device(p, dev), x.to(dev)
        r = moe.route(pd, xd[0], cfg, cap)
        y, aux = moe.moe_apply(pd, xd, cfg, return_stats=True)
        out[dev] = dict(slot=r.slot.cpu(), keep=r.keep.cpu(), gates=r.gates.cpu(),
                        y=y.cpu(), load=aux["expert_load"].cpu(),
                        frac=float(aux["frac_dropped"]))
        del pd
    a, b = out["cuda"], out["cpu"]
    errs = {k: float((a[k] - b[k]).abs().max()) for k in ("gates", "y")}
    log(f"moe layer {cfg.name}: d {cfg.d_model}, {cfg.n_experts} experts (padded "
        f"{e_pad}) of {cfg.moe_d_ff}, top {cfg.top_k}, {cfg.n_shared_experts} shared; "
        f"40 rows, cap {cap}: dropped {a['frac']:.3f} (cpu {b['frac']:.3f}); card vs "
        f"cpu f32 max|err| {errs} (tol 1e-4)")
    if not (torch.equal(a["slot"], b["slot"]) and torch.equal(a["keep"], b["keep"])
            and torch.equal(a["load"], b["load"])):
        fail(f"moe layer {cfg.name}: the card routes or drops otherwise than the CPU")
    if not a["frac"] > 0 or a["load"][cfg.n_experts:].any():
        fail(f"moe layer {cfg.name}: no assignment dropped, or a padded expert routed")
    for k in ("gates", "y"):
        if not torch.allclose(a[k], b[k], rtol=1e-4, atol=1e-4):
            fail(f"moe layer {cfg.name}: {k} on the card disagrees with the CPU: "
                 f"max |err| {errs[k]}")
    del p, x
    torch.cuda.empty_cache()
    return dict(errs, frac_dropped=a["frac"], cap=cap)


def moe_serve_parity_phase(torch, cfg_small):
    """Reduced olmoe-1b-7b at fp32, skewed towards experts 0 and 1 (so its
    dispatches drop at the default capacity factor), through the runner
    engine and the slab engine on the card (the paged kernels at head dim
    16, silu_mul on the experts' [8, cap, 32]) against the same engines on
    the CPU (plain versions): 8 prompts on 8 slots, the first four
    finishing early so that idle decode rows come ahead of live ones;
    token-identical, with the same number of dropped assignments."""
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    params = M.init_params(cfg_small, seed=0, device="cpu", dtype=torch.float32)
    skew_moe(torch, params, cfg_small, seed=31)
    prompts = [[5 + i, 9, 2 * i + 1] for i in range(8)]
    news = [2] * 4 + [7] * 4
    res = {}
    for paged in (None, False):
        for dev in ("cpu", "cuda"):
            eng = ServeEngine(cfg_small, to_device(params, dev), paged=paged, slots=8,
                              max_seq=32, block_size=8, prefill_buckets=(8, 32))
            with DropCounter() as dc:
                for p, n in zip(prompts, news):
                    eng.submit(p, max_new_tokens=n)
                out = {r.rid: r.out_tokens for r in eng.run_until_drained()}
            res[paged, dev] = (out, dc.dropped, dc.dispatches)
    log(f"moe serve parity: reduced olmoe fp32 skewed, runner and slab engines, card "
        f"vs cpu: dropped assignments (dispatches) "
        f"{ {('slab' if k[0] is False else 'runner', k[1]): v[1:] for k, v in res.items()} }")
    for paged in (None, False):
        (o_cpu, d_cpu, _), (o_gpu, d_gpu, _) = res[paged, "cpu"], res[paged, "cuda"]
        if o_cpu != o_gpu or d_cpu != d_gpu or d_cpu <= 0:
            fail(f"moe serve parity ({'slab' if paged is False else 'runner'}): the "
                 f"card's outputs or drops differ from the CPU's ({d_gpu} vs {d_cpu})")
    return {("slab" if k[0] is False else "runner") + "_" + k[1]: v[1]
            for k, v in res.items()}


def moe_fp32_identity(torch, cfg):
    """olmoe-1b-7b at full width and depth in fp32 (parameters from seed 0)
    at the dropless capacity factor E / k (cap = the dispatch's rows): a
    shared-prefix pair (a 256-token prefix, 16 pages; its second member
    admitted after the first has published them) and prompts of 40-333
    tokens whose chunks cross prefill-chunk boundaries (budget 136, buckets
    32 and 128), through the runner engine and 4 sequence shards, each with
    prefix caching on and off, against the dense-slab engine's monolithic
    prefill: greedy outputs token-identical, no assignment dropped, the
    prefix hit on the caching runs."""
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    gen = torch.Generator().manual_seed(32)
    shared = torch.randint(0, cfg.vocab_size, (256,), generator=gen).tolist()
    rest = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in (40, 200, 333, 40, 72)]
    prompts = [shared + rest[3]] + rest[:3] + [shared + rest[4]]
    kw = dict(slots=4, max_seq=1024, prefill_buckets=(32, 128), max_tokens_per_tick=136)
    outs, stats = {}, {}
    engines = (("runner", {}), ("runner_cache_off", dict(prefix_caching=False)),
               ("slab", dict(paged=False)), ("seq4", dict(seq_shards=SEQ_SHARDS)),
               ("seq4_cache_off", dict(seq_shards=SEQ_SHARDS, prefix_caching=False)))
    for name, opts in engines:
        eng = ServeEngine(cfg, params, **kw, **opts)
        with DropCounter() as dc:
            for p in prompts:
                eng.submit(p, max_new_tokens=FP32_NEW_TOKENS)
            outs[name] = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        stats[name] = dict(eng.stats, dropped=dc.dropped, dispatches=dc.dispatches)
        del eng
    del params
    torch.cuda.empty_cache()
    diff = {name: [rid for rid in outs["slab"] if outs[name].get(rid) != outs["slab"][rid]]
            for name, _ in engines if name != "slab"}
    log(f"moe serve fp32 (cf = E/k = {cfg.capacity_factor:g}): against the slab "
        f"engine ({stats['slab']['prefill_dispatches']} monolithic prefills), requests "
        f"differing {diff} of {len(prompts)}; prefill chunks / prefix-hit tokens / "
        f"dropped assignments by engine "
        f"{ {n: (s['prefill_dispatches'], s['prefix_hit_tokens'], s['dropped']) for n, s in stats.items()} }")
    if any(diff.values()) or len(outs["slab"]) != len(prompts):
        fail(f"moe serve fp32: the engines' greedy outputs differ {diff}")
    if any(s["dropped"] for s in stats.values()):
        fail("moe serve fp32: an assignment dropped at the dropless capacity factor")
    for name in ("runner", "seq4"):
        if stats[name]["prefix_hit_tokens"] <= 0:
            fail(f"moe serve fp32: {name} with prefix caching on never hit")
    if stats["runner_cache_off"]["prefill_dispatches"] <= len(prompts):
        fail("moe serve fp32: no prompt crossed a prefill-chunk boundary")
    return dict(requests=len(prompts), **{f"{n}_prefill_chunks": s["prefill_dispatches"]
                                          for n, s in stats.items()},
                prefix_hit_tokens=stats["runner"]["prefix_hit_tokens"])


def moe_serve_phase(torch, cfg, counters):
    """olmoe-1b-7b at full width and depth in bf16 (random weights, seed 0)
    on the mix of 5 at the default capacity factor: the runner engine
    (prefix caching on), ``ServeEngine(paged=False)``, an int8 pool and 4
    sequence shards, every kernel's launch count at its formula (the paged
    kernels L times a chunk and a step; silu_mul L times a dispatch, on the
    experts' [E_pad, cap, ff], the element route at decode and the vector
    route at prefill; the slab's flash and decode L times); prefix hits on
    the paged runs; tok/s, TTFT and peak memory of each, and the share of
    requests token-identical to the runner's (not gated: the drops follow
    each dispatch's rows, which prefix hits and bf16 near-ties move)."""
    from repro_torch.serve import ServeEngine

    params = serve_params(torch, cfg)
    warm = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_seq=160,
                       prefill_buckets=(32, 128))
    warm.submit(list(range(40)), max_new_tokens=3)
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()
    L = cfg.n_layers
    runs = {}
    for name, kw in (("runner", {}), ("slab", dict(paged=False)),
                     ("int8", dict(kv_dtype="int8")), ("seq4", dict(seq_shards=SEQ_SHARDS))):
        out, stats, launches, summary = serve_mix(torch, cfg, params, counters, **kw)
        P, Dd = stats["prefill_dispatches"], stats["decode_dispatches"]
        steps = P + Dd
        expect = {k: 0 for k in counters}
        expect.update({
            "rmsnorm": (2 * L + 1) * steps, "rmsnorm_vector": (2 * L + 1) * steps,
            "apply_rope": L * steps, "apply_rope_qk": L * steps,
            "apply_rope_vector": L * steps, "silu_mul": L * steps,
            "silu_mul_element": L * Dd, "silu_mul_vector": L * P})
        if name == "slab":
            expect.update(flash_attention_lengths=L * P, decode_attention=L * Dd)
        else:
            n = SEQ_SHARDS if name == "seq4" else 1
            key = {"runner": "", "int8": "_int8", "seq4": "_skip_null"}[name]
            expect.update({f"paged_decode_attention{key}": n * L * Dd,
                           f"paged_prefill_attention{key}": n * L * P,
                           "paged_prefill_attention_tc": n * L * P})
        check_launches(f"moe serve {name}", launches, expect)
        if (name != "slab") != (stats["prefix_hit_tokens"] > 0):
            fail(f"moe serve {name}: {stats['prefix_hit_tokens']} prefix-hit tokens "
                 f"(the paged runs share the 256-token prefix, the slab never)")
        log(f"moe serve {name}: {summary['requests']} requests, {summary['tokens']} "
            f"tokens in {summary['wall_s']:.3f} s ({summary['tok_s']:.1f} tok/s), ttft "
            f"p50 {summary['ttft_p50_ms']:.1f} ms, prefill dispatches {P}, decode steps "
            f"{Dd}, prefix-hit tokens {stats['prefix_hit_tokens']}, pool "
            f"{summary['pool_bytes'] / 2**20:.1f} MiB, peak memory "
            f"{summary['peak_mem_bytes'] / 2**30:.2f} GiB")
        summary["prefix_hit_tokens"] = stats["prefix_hit_tokens"]
        runs[name] = (out, launches, summary)
    ref_out = runs["runner"][0]
    same = {name: sum(runs[name][0][rid] == ref_out.get(rid) for rid in runs[name][0])
            for name in ("slab", "int8", "seq4")}
    log(f"moe serve: requests token-identical to the runner run in bf16 (not gated): "
        f"{same} of {len(ref_out)}")
    del params
    torch.cuda.empty_cache()
    return ({n: r[1] for n, r in runs.items()},
            dict({n: r[2] for n, r in runs.items()}, same_bf16=same))


# (row of the {"kernels": ...} line) -> the launch counter it is read from
# in the olmoe-1b-7b serving runs
MOE_ROW_COUNTER = {"silu_mul_experts": ("runner", "silu_mul_vector"),
                   "silu_mul_experts_decode": ("runner", "silu_mul_element"),
                   "paged_decode_attention_hd128": ("runner", "paged_decode_attention"),
                   "paged_prefill_attention_hd128": ("runner", "paged_prefill_attention"),
                   "decode_attention_hd128": ("slab", "decode_attention")}


def gemm_inputs(torch, gen, m, k, n, dtype):
    """x [m, k] ~ N(0, 1) and w [k, n] ~ N(0, 1 / k) (the outputs ~ N(0,
    1)), in ``dtype``."""
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5).to(dtype)
    return x, w


def fid_tol(torch, dtype, f32_tol):
    return FID_BF16_TOL if dtype == torch.bfloat16 else f32_tol


def gemm_counters(kmm):
    """The GEMM's launch counters: all launches, and each route's."""
    return {"all": Counter(kmm), **{r: Counter(kmm, f"{r}_launches")
                                    for r in kmm.ROUTES}}


def gemm_odd_shapes(torch, gen):
    """The JAX sweep's shapes in f32 and bf16 (bf16 also to an f32 output)
    and f32 at a full-width [512, 2048] @ [2048, 2048], each on the route
    its plan picks (counted) and, in bf16, on the mma.sync route too; an
    x whose base is 2 bytes off 16-byte alignment on the mma.sync route:
    held against the plain version, and twice bitwise equal."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ref

    cases = [(s, dt) for s in ((16, 8, 16), (100, 40, 50), (128, 128, 128),
                               (33, 17, 9))
             for dt in (torch.float32, torch.bfloat16)]
    cases.append(((512, 2048, 2048), torch.float32))
    cases.append(((40, 64, 24), "unaligned"))    # rows TMA could load, x's base not
    counters = gemm_counters(kmm)
    errs = []
    for (m, k, n), dtype in cases:
        unaligned = dtype == "unaligned"
        dtype = torch.bfloat16 if unaligned else dtype
        x, w = gemm_inputs(torch, gen, m, k, n, dtype)
        if unaligned:
            base = torch.empty(m * k + 1, dtype=dtype, device="cuda")
            x = base[1:].view(m, k).copy_(x)          # 2 bytes off alignment
        want = ref.matmul(x, w)
        auto = kmm.plan(m, n, k, dtype, x.data_ptr() % 16 == 0).route
        if unaligned and auto != "mma_sync":
            fail(f"matmul [{m},{k}] @ [{k},{n}] from an unaligned base: planned "
                 f"on the {auto} route")
        for route in dict.fromkeys((auto, "mma_sync" if dtype == torch.bfloat16 else auto)):
            tag = f"matmul {str(dtype)[6:]} [{m},{k}] @ [{k},{n}] ({route})"
            for c in counters.values():
                c.reset()
            got = kmm.weight_stationary_matmul(x, w, route=route)
            errs.append(hold(torch, tag, got, want,
                             fid_tol(torch, dtype, GEMM_F32_TOL)))
            if not torch.equal(got, kmm.weight_stationary_matmul(x, w, route=route)):
                fail(f"{tag}: two launches on the same inputs differ")
            if dtype == torch.bfloat16:
                hold(torch, tag + " -> f32",
                     kmm.weight_stationary_matmul(x, w, out_dtype=torch.float32,
                                                  route=route),
                     ref.matmul(x, w, out_dtype=torch.float32), GEMM_F32_TOL)
            torch.cuda.synchronize()
            launched = {r: c.read() for r, c in counters.items()}
            if launched[route] != launched["all"]:
                fail(f"{tag}: launches by route {launched}")
    log("fidelity: matmul at the JAX sweep's shapes (f32, bf16, bf16 -> f32; "
        "bf16 on its planned route and on mma.sync, and [40,64]@[64,24] from "
        "a base off 16-byte alignment on mma.sync) and f32 [512,2048]@[2048,2048] hold, twice "
        "bitwise equal; max|err| " + ", ".join(f"{e:.3g}" for e in errs))


def gemm_f32_accuracy(torch, gen):
    """bf16 [513, 5624] @ [5624, 136] to an f32 output on both bf16 routes,
    and in f32 through ``ref.matmul`` (cuBLAS's f32 GEMM, no TF32), each
    against the exact float64 product.  The tensor cores' own f32
    accumulation truncates, so both kernels sum each K piece there and add
    it on the CUDA cores; each route's mean |error| must stay within
    GEMM_F32_ERR_RATIO of the library's."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ref

    m, k, n = 513, 5624, 136
    x, w = gemm_inputs(torch, gen, m, k, n, torch.bfloat16)
    exact = x.double() @ w.double()
    outs = {"library": ref.matmul(x, w, out_dtype=torch.float32)}
    for route in ("wgmma", "mma_sync"):
        outs[route] = kmm.weight_stationary_matmul(x, w, out_dtype=torch.float32,
                                                   route=route)
    errs = {name: (float((o.double() - exact).abs().mean()),
                   float((o.double() - exact).abs().max())) for name, o in outs.items()}
    log(f"matmul bf16 [{m},{k}] @ [{k},{n}] -> f32 against the float64 product, "
        f"mean / max |err|: " + ", ".join(f"{name} {a:.3g} / {b:.3g}"
                                          for name, (a, b) in errs.items()))
    for route in ("wgmma", "mma_sync"):
        if errs[route][0] > GEMM_F32_ERR_RATIO * errs["library"][0]:
            fail(f"matmul -> f32 on the {route} route: mean |err| {errs[route][0]:.3g} "
                 f"against the float64 product, over {GEMM_F32_ERR_RATIO}x the "
                 f"library's {errs['library'][0]:.3g}")


def gemm_rows(torch, timer, cfg, gen, routes):
    """The GEMM at full-width stablelm-1.6b projections in bf16: routed
    through ``ops.matmul`` with the counters zeroed before and read after
    (every launch on the wgmma route), held, twice bitwise equal, a
    dropped-K control, and timed with its rate and share of the bound; the
    mma.sync route held and timed beside it at the same shape (into
    ``routes``)."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops, ref

    bf = torch.bfloat16
    d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.vocab_size
    counters = gemm_counters(kmm)
    counter = counters["all"]
    # the reference's rule routes neither of these to the kernel
    x, w = gemm_inputs(torch, gen, 512, ff, d, torch.float32)
    x3, w3 = gemm_inputs(torch, gen, 512, d, d, bf)
    counter.reset()
    ops.matmul(x, w)
    ops.matmul(x3[None], w3)
    torch.cuda.synchronize()
    if counter.read():
        fail(f"fidelity: an f32 [512,{ff}]@[{ff},{d}] (panel "
             f"{ff * 256 * 4 / 2**20:.2f} MiB) or a 3-D input launched the "
             f"kernel {counter.read()} times; the reference's rule routes "
             f"neither there")
    del x, w, x3, w3
    src, rep = "src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:50"
    # (rows, weight, K, N, its calls in one layer's projections and the head)
    shapes = [(8, "wq/wk/wv/wo", d, d, 4), (8, "gate/up", d, ff, 2),
              (8, "down", ff, d, 1), (8, "lm_head", d, vocab, 1),
              (512, "gate/up", d, ff, 2), (512, "down", ff, d, 1),
              (512, "lm_head", d, vocab, 1)]
    rows = []
    for m, what, k, n, calls in shapes:
        x, w = gemm_inputs(torch, gen, m, k, n, bf)
        tag = f"matmul bf16 [{m},{k}] @ [{k},{n}] ({what})"
        panel = k * min(256, n) * 2
        if not ops.weight_panel_fits(2, k, n, 2):
            fail(f"{tag}: the reference's rule does not route a "
                 f"{panel / 2**20:.2f} MiB panel to the kernel")
        plan = kmm.plan(m, n, k, bf, True)
        for c in counters.values():
            c.reset()
        outs = [ops.matmul(x, w) for _ in range(calls)]
        torch.cuda.synchronize()
        launched = {r: c.read() for r, c in counters.items()}
        if launched["all"] != calls or launched["wgmma"] != calls:
            fail(f"{tag}: {calls} ops.matmul calls launched {launched} (all "
                 f"must take the wgmma route)")
        if not all(torch.equal(o, outs[0]) for o in outs):
            fail(f"{tag}: launches on the same inputs differ")
        want = ref.matmul(x, w)
        bk = GEMM_DROPPED_K
        bad = ref.matmul(x[:, :k - bk], w[:k - bk])
        caught = not torch.allclose(bad.float(), want.float(), **FID_BF16_TOL)
        log(f"{tag} control: the product without its last {bk} K rows "
            f"reads max|err| {float((bad.float() - want.float()).abs().max()):.3g}, "
            f"relative norm {rel_err(torch, bad, want):.3g} (caught: {caught})")
        if not caught:
            fail(f"{tag} control: the tolerance passes a product that loses "
                 f"its last {bk} K rows")
        rel = rel_err(torch, outs[0], want)
        # the mma.sync route at the same shape: held, twice bitwise equal
        mma = kmm.weight_stationary_matmul(x, w, route="mma_sync")
        mma_err = hold(torch, tag + " mma.sync route", mma, want, FID_BF16_TOL)
        if not torch.equal(mma, kmm.weight_stationary_matmul(x, w, route="mma_sync")):
            fail(f"{tag} mma.sync route: two launches on the same inputs differ")
        del outs, want, bad, mma
        nbytes, flops = (m * k + k * n + m * n) * 2, 2 * m * k * n
        name = "weight_stationary_matmul" + ("" if not rows else f"_m{m}_{k}x{n}")
        row = measure(torch, timer, name, src, rep,
                      lambda: kmm.weight_stationary_matmul(x, w),
                      lambda: ref.matmul(x, w), FID_BF16_TOL,
                      nbytes=nbytes, flops=flops,
                      library=lambda: torch.matmul(x, w),
                      note=f"; {what}, panel {panel / 2**20:.2f} MiB, "
                           f"relative norm {rel:.2g}; wgmma tile {plan.tile}, "
                           f"grid {plan.grid}")
        mma_ms = timer(lambda: kmm.weight_stationary_matmul(x, w, route="mma_sync"))
        ms = row["ms"]
        rate = (f"{flops / ms / 1e9:.1f} TFLOP/s" if row["bound_by"] == "operations"
                else f"{nbytes / ms / 1e6:.1f} GB/s")
        log(f"kernel {name}: {rate}, {row['bound_ms'] / ms:.3f} of the bound "
            f"({row['bound_by']}), {ms / row['library_ms']:.3f}x torch.matmul; "
            f"the mma.sync route {mma_ms:.4f} ms (max|err| {mma_err:.3g}), "
            f"{mma_ms / ms:.2f}x the wgmma route")
        row.update(launches=launched["wgmma"], gemm_route="wgmma",
                   tile=list(plan.tile), mma_sync_ms=mma_ms)
        routes.append(dict(m=m, k=k, n=n, tile=list(plan.tile), grid=list(plan.grid),
                           wgmma_ms=ms, mma_sync_ms=mma_ms,
                           torch_ms=row["library_ms"]))
        rows.append(row)
        del x, w
        torch.cuda.empty_cache()
    return rows


def curry_rows(torch, timer, cfg, gen):
    """The Curry-ALU forms through ``ops`` (counters zeroed before, read
    after): rmsnorm [512, d_model] with 1 and 3 Newton rounds, silu_mul
    [512, d_ff] with 6 and 8 Taylor rounds, in bf16 and f32, held against
    their plain versions; in f32 the native kernels must fail the same hold
    against 1 Newton round and 6 Taylor rounds (the controls); timed in
    bf16 beside the native kernels."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.kernels import swiglu as ksw

    d, ff, eps = cfg.d_model, cfg.d_ff, cfg.norm_eps
    counters = {"rmsnorm_curry": Counter(krn, "curry_launches"),
                "silu_mul_curry": Counter(ksw, "curry_launches"),
                "rmsnorm": Counter(krn), "silu_mul": Counter(ksw)}
    inputs = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((512, d), generator=gen, device="cuda").to(dtype)
        w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(dtype)
        g = (3 * torch.randn((512, ff), generator=gen, device="cuda")).to(dtype)
        u = torch.randn((512, ff), generator=gen, device="cuda").to(dtype)
        inputs[dtype] = x, w, g, u
    for c in counters.values():
        c.reset()
    outs = {}
    for dtype, (x, w, g, u) in inputs.items():
        for r in (1, 3):
            outs[dtype, "rmsnorm", r] = ops.rmsnorm(x, w, eps=eps, curry_rounds=r)
        for r in (6, 8):
            outs[dtype, "silu_mul", r] = ops.silu_mul(g, u, curry_rounds=r)
    torch.cuda.synchronize()
    launches = {name: c.read() for name, c in counters.items()}
    check_launches("fidelity curry", launches, {
        "rmsnorm_curry": 4, "silu_mul_curry": 4, "rmsnorm": 0, "silu_mul": 0})
    errs = []
    for (dtype, op, r), got in outs.items():
        x, w, g, u = inputs[dtype]
        want = (ref.rmsnorm(x, w, eps, curry_rounds=r) if op == "rmsnorm"
                else ref.silu_mul(g, u, curry_rounds=r))
        tol = fid_tol(torch, dtype, CURRY_F32_TOL)
        errs.append(f"{op} {str(dtype)[6:]} rounds {r}: "
                    f"{hold(torch, f'{op}_curry', got, want, tol):.3g}")
    log("fidelity curry holds, max|err| " + "; ".join(errs))
    x, w, g, u = inputs[torch.float32]
    for op, native, want in (
            ("rmsnorm", krn.rmsnorm(x, w, eps), ref.rmsnorm(x, w, eps, curry_rounds=1)),
            ("silu_mul", ksw.silu_mul(g, u), ref.silu_mul(g, u, curry_rounds=6))):
        caught = not torch.allclose(native, want, **CURRY_F32_TOL)
        worst = float(((native - want).abs() / want.abs().clamp_min(1e-30)).max())
        log(f"{op}_curry control: the native f32 kernel against the curry "
            f"plain version reads max relative {worst:.3g} (caught: {caught})")
        if not caught:
            fail(f"{op}_curry control: the f32 tolerance {CURRY_F32_TOL} passes "
                 f"the native kernel for the curry form")
    x, w, g, u = inputs[torch.bfloat16]
    native_rms = timer(lambda: krn.rmsnorm(x, w, eps))
    native_silu = timer(lambda: ksw.silu_mul(g, u))
    csrc = "src/repro_torch/kernels/csrc/"
    rows = [
        measure(torch, timer, "rmsnorm_curry", csrc + "rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:51",
                lambda: krn.rmsnorm(x, w, eps, curry_rounds=3),
                lambda: ref.rmsnorm(x, w, eps, curry_rounds=3), FID_BF16_TOL,
                nbytes=2 * x.numel() * 2 + d * 2, flops=4 * x.numel(),
                library=lambda: torch.nn.functional.rms_norm(x, (d,), w, eps),
                note=f"; 3 Newton rounds; the native kernel at the same shape "
                     f"{native_rms:.4f} ms"),
        measure(torch, timer, "silu_mul_curry", csrc + "swiglu.cu",
                "src/repro/kernels/swiglu.py:59",
                lambda: ksw.silu_mul(g, u, curry_rounds=6),
                lambda: ref.silu_mul(g, u, curry_rounds=6), FID_BF16_TOL,
                nbytes=3 * g.numel() * 2, flops=(3 * 6 + 12) * g.numel(),
                note=f"; 6 Taylor rounds; the native kernel at the same shape "
                     f"{native_silu:.4f} ms")]
    rows[0]["launches"] = launches["rmsnorm_curry"]
    rows[1]["launches"] = launches["silu_mul_curry"]
    rows[1]["design"] = SILU_DESIGN + "; the Taylor rounds at a runtime count"
    return rows


def fidelity_phase(torch, timer, cfg):
    """Phase 16: the weight-stationary GEMM and the Curry-ALU forms."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    gemm_odd_shapes(torch, gen)
    gemm_f32_accuracy(torch, gen)
    routes = []
    rows = gemm_rows(torch, timer, cfg, gen, routes)
    rows += curry_rows(torch, timer, cfg, gen)
    torch.cuda.empty_cache()
    return rows, routes


# ---------------------------------------------------------------------------
# 22: preemption and swap (an oversubscribed page pool)
# ---------------------------------------------------------------------------

class SwapProbe:
    """Around one engine: each swap victim's live pages (the pinned prefix
    chain and the parked rest, an int8 pool's scales) and, for a slot-state
    family, its slot-state blob are read before its swap-out and again after
    its swap-in, where they must be the same bytes; the arena's
    device-to-host and host-to-device copies are timed (the card
    synchronized on each side); and a recompute restore's replayed prefill
    chunks (a request's that has decoded already, or below the tokens it
    held at its eviction) are timed with the tokens they carry.  The
    synchronizes slow the run, and its times carry them."""

    def __init__(self, torch, eng):
        from repro_torch.serve import swap

        self.torch, self.eng = torch, eng
        self.parked, self.checked = {}, 0
        self.d2h, self.h2d, self.replay = [0, 0.0], [0, 0.0], [0, 0.0]
        swap_out, restore = eng._swap_out, eng._restore_swapped
        run_chunk = eng._run_prefill_chunk

        def pages(slot, n):
            ids = torch.as_tensor(eng.alloc.table[slot, :n].astype("int64"),
                                  device=eng.device)
            return [t.clone() for t in eng.runner.extract_pages(eng.state, ids)
                    if t is not None]

        def blob(slot):
            if not eng.has_slot_state:
                return {}
            return eng.runner.extract_slot_state(eng.state, slot)

        def probed_out(slot, live):
            n = -(-live // eng.block_size)
            before, rid = (pages(slot, n), blob(slot)), eng.active[slot].rid
            ok = swap_out(slot, live)
            if ok:
                self.parked[rid] = (n, before)
            return ok

        def probed_in(slot, req):
            ok = restore(slot, req)
            if ok and req.rid in self.parked:
                n, (p0, b0) = self.parked.pop(req.rid)
                p1, b1 = pages(slot, n), blob(slot)
                same = all(torch.equal(a, b) for a, b in zip(p0, p1)) and all(
                    torch.equal(b0[k], b1[k]) for k in b0)
                if not same:
                    fail(f"swap probe: request {req.rid}'s pages or slot state "
                         f"came back changed after its swap-in")
                self.checked += 1
            return ok

        def probed_chunk(slot, req, bucket, n):
            if not req.out_tokens and req.prefill_pos >= req._preempted_live:
                return run_chunk(slot, req, bucket, n)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run_chunk(slot, req, bucket, n)
            torch.cuda.synchronize()
            self.replay[0] += n
            self.replay[1] += time.perf_counter() - t
            return out

        eng._swap_out, eng._restore_swapped = probed_out, probed_in
        eng._run_prefill_chunk = probed_chunk
        self.arena_cls = swap.SwapArena
        self.write, self.read = swap.SwapArena.write, swap.SwapArena.read

    def time_arena(self):
        """Time every ``SwapArena`` write and read until the caller puts the
        class's methods back (``probed_mix`` does)."""
        torch, probe = self.torch, self

        def timed_write(arena, slots, *ts):
            torch.cuda.synchronize()
            t = time.perf_counter()
            probe.write(arena, slots, *ts)
            torch.cuda.synchronize()
            probe.d2h[0] += sum(x.numel() * x.element_size() for x in ts
                                if x is not None)
            probe.d2h[1] += time.perf_counter() - t

        def timed_read(arena, slots):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = probe.read(arena, slots)
            torch.cuda.synchronize()
            probe.h2d[0] += sum(x.numel() * x.element_size() for x in out)
            probe.h2d[1] += time.perf_counter() - t
            return out

        self.arena_cls.write, self.arena_cls.read = timed_write, timed_read
        return self

    def rates(self) -> dict:
        """GB/s of the arena's copies (None where none ran) and seconds per
        replayed token."""
        gbs = lambda b_s: b_s[0] / b_s[1] / 1e9 if b_s[1] else None   # noqa: E731
        return dict(d2h_gb_s=gbs(self.d2h), h2d_gb_s=gbs(self.h2d),
                    d2h_bytes=self.d2h[0], h2d_bytes=self.h2d[0],
                    replay_tokens=self.replay[0], replay_s=self.replay[1],
                    victims_checked=self.checked)


PREEMPT_KEYS = ("preemptions", "preempt_proactive", "preempt_swaps",
                "preempt_recomputes", "swap_bytes", "preempted_tokens",
                "restored_tokens", "stalled_ticks", "decode_tokens",
                "prefill_tokens", "prefill_dispatches", "decode_dispatches")


def probed_mix(torch, cfg, params, counters, **engine_kw):
    """``serve_mix`` with a ``SwapProbe`` around its engine; returns its
    four results and the probe."""
    from repro_torch.serve import swap

    probes = []
    saved = swap.SwapArena.write, swap.SwapArena.read
    try:
        res = serve_mix(torch, cfg, params, counters,
                        hook=lambda e: probes.append(SwapProbe(torch, e).time_arena()),
                        **engine_kw)
    finally:
        swap.SwapArena.write, swap.SwapArena.read = saved
    return res + (probes[0],)


def pressure_gate(tag, out, stats, base_out, base_stats, arm=None):
    """An fp32 pressured run against its unpressured counterpart: every
    request token-identical, preempted at least once (by ``arm`` when
    given), restored_tokens <= preempted_tokens, and no decoded token
    replayed (the same decode work)."""
    diff = [rid for rid in base_out if out.get(rid) != base_out[rid]]
    st = {k: stats[k] for k in PREEMPT_KEYS}
    log(f"{tag}: {len(base_out) - len(diff)} of {len(base_out)} requests "
        f"token-identical to the unpressured run; {st}")
    if diff or len(out) != len(base_out):
        fail(f"{tag}: greedy outputs differ from the unpressured run (rids {diff})")
    if stats["preemptions"] < 1 or (arm is not None and stats[arm] < 1):
        fail(f"{tag}: no preemption{'' if arm is None else ' by ' + arm}")
    if stats["preempt_swaps"] + stats["preempt_recomputes"] < 1:
        fail(f"{tag}: no victim took the swap or the recompute arm")
    if stats["restored_tokens"] > stats["preempted_tokens"]:
        fail(f"{tag}: restored_tokens above preempted_tokens")
    if stats["decode_tokens"] != base_stats["decode_tokens"]:
        fail(f"{tag}: {stats['decode_tokens']} decode tokens against the "
             f"unpressured {base_stats['decode_tokens']}: a decoded token replayed")
    return st


def preempt_phase(torch, cfg, params, counters, serve):
    """22: stablelm-1.6b at full width and depth on the mix of 5 over a pool
    of ``PRESSURE_BLOCKS`` pages (128 usable, a quarter of the full 513,
    still above the longest request's 52).  bf16 (``params``, logged
    beside phase 5's run, not gated but for the launch formulas and the
    probe): swap, recompute and auto, every launch count at phase 5's
    formulas over the engine's own dispatches, tok/s, TTFT, peak memory,
    the preemptions by arm and the swap bytes; the swap run probed
    (``SwapProbe``: the victims' pages bit-equal after the round trip, the
    copies' GB/s beside the paper's modeled link), the recompute run too
    (a replayed token's seconds beside ``recompute_cost``).  fp32 (the same
    seed), gated against the unpressured mix: swap, recompute, auto and
    swap with ``proactive_horizon=2``; an int8 pool under swap (probed: the
    int8 pages and their scales bit-equal) against the unpressured int8
    run; 4 shards over ``PRESSURE_SHARD_BLOCKS`` pages, swap and recompute,
    against the one-shard pressured runs."""
    from repro_torch.core import noc
    from repro_torch.models import model as M

    L = cfg.n_layers
    fpt = 2.0 * cfg.param_count(active_only=True)
    res = dict(modeled=dict(swap_link_gb_s=noc.SWAP_LINK_BYTES_PER_S / 1e9,
                            recompute_s_per_token=noc.recompute_cost(1, fpt)["seconds"],
                            source="the paper's CXL link and SRAM-PIM banks "
                                   "(pimsim.params), not the H100's"))
    for pol in ("swap", "recompute", "auto"):
        out, stats, launches, summary, probe = probed_mix(
            torch, cfg, params, counters, num_blocks=PRESSURE_BLOCKS,
            preempt_policy=pol)
        P, Dd = stats["prefill_dispatches"], stats["decode_dispatches"]
        check_launches(f"pressure bf16 {pol}", launches, serve_expect(L, P, Dd))
        rates = probe.rates()
        res[f"bf16_{pol}"] = dict(summary, **{k: stats[k] for k in PREEMPT_KEYS},
                                  launches=launches, **rates)
        log(f"pressure bf16 {pol} ({PRESSURE_BLOCKS} pages; probed, so the "
            f"times carry its synchronizes): "
            f"{summary['tok_s']:.1f} tok/s (phase 5, full pool: {serve['tok_s']:.1f}), "
            f"ttft p50 {summary['ttft_p50_ms']:.1f} ms ({serve['ttft_p50_ms']:.1f}), "
            f"peak memory {summary['peak_mem_bytes'] / 2**30:.2f} GiB "
            f"({serve['peak_mem_bytes'] / 2**30:.2f}); preemptions "
            f"{stats['preemptions']} (swap {stats['preempt_swaps']}, recompute "
            f"{stats['preempt_recomputes']}), swap bytes {stats['swap_bytes']}, "
            f"prefill chunks {P} (phase 5: {serve['prefill_dispatches']}), "
            f"decode steps {Dd}")
        log(f"pressure bf16 {pol} probe: {rates['victims_checked']} swapped "
            f"victims' pages bit-equal after the round trip; arena copies "
            f"device-to-host {rates['d2h_gb_s']} GB/s ({rates['d2h_bytes']} B), "
            f"host-to-device {rates['h2d_gb_s']} GB/s ({rates['h2d_bytes']} B), "
            f"beside the modeled link's {noc.SWAP_LINK_BYTES_PER_S / 1e9:.1f} GB/s; "
            f"replayed prefill {rates['replay_tokens']} tokens in "
            f"{rates['replay_s']:.4f} s "
            f"({rates['replay_s'] / max(rates['replay_tokens'], 1) * 1e6:.2f} us a "
            f"token, beside the modeled recompute_cost's "
            f"{noc.recompute_cost(1, fpt)['seconds'] * 1e6:.4f} us)")
        if stats["preemptions"] < 1:
            fail(f"pressure bf16 {pol}: the pool of {PRESSURE_BLOCKS} pages never "
                 f"preempted")
        if pol == "swap" and rates["victims_checked"] < 1:
            fail("pressure bf16 swap: no swapped victim came back to be checked")
    params32 = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    base, base_st, _, _ = serve_mix(torch, cfg, params32, {})
    if base_st["preemptions"]:
        fail("pressure fp32: the full pool preempted")
    gates = {}
    runs = {}
    for name, kw, arm in (("swap", dict(preempt_policy="swap"), "preempt_swaps"),
                          ("recompute", dict(preempt_policy="recompute"),
                           "preempt_recomputes"),
                          ("auto", dict(preempt_policy="auto"), None),
                          ("proactive", dict(preempt_policy="swap",
                                             proactive_horizon=2), "preempt_proactive")):
        out, st, _, _ = serve_mix(torch, cfg, params32, {},
                                  num_blocks=PRESSURE_BLOCKS, **kw)
        gates[name] = pressure_gate(f"pressure fp32 {name}", out, st, base, base_st, arm)
        runs[name] = out
    q8_base, q8_st, _, _ = serve_mix(torch, cfg, params32, {}, kv_dtype="int8")
    out, st, _, _, probe = probed_mix(torch, cfg, params32, {}, kv_dtype="int8",
                                      num_blocks=PRESSURE_BLOCKS,
                                      preempt_policy="swap")
    gates["int8_swap"] = pressure_gate("pressure fp32 int8 swap", out, st, q8_base,
                                       q8_st, "preempt_swaps")
    gates["int8_swap"].update(probe.rates())
    if probe.checked < 1:
        fail("pressure fp32 int8 swap: no swapped victim came back to be checked")
    log(f"pressure fp32 int8 swap: {probe.checked} victims' int8 pages and "
        f"scales bit-equal after the round trip")
    for pol in ("swap", "recompute"):
        out, st, _, _ = serve_mix(torch, cfg, params32, {}, seq_shards=SEQ_SHARDS,
                                  num_blocks=PRESSURE_SHARD_BLOCKS, preempt_policy=pol)
        gates[f"seq4_{pol}"] = pressure_gate(
            f"pressure fp32 {SEQ_SHARDS} shards {pol}", out, st, base, base_st,
            "preempt_swaps" if pol == "swap" else "preempt_recomputes")
        diff = [rid for rid in runs[pol] if runs[pol][rid] != out.get(rid)]
        if diff:
            fail(f"pressure fp32 {SEQ_SHARDS} shards {pol}: differs from the "
                 f"one-shard pressured run (rids {diff})")
    del params32
    torch.cuda.empty_cache()
    res["fp32"] = gates
    return res


def hybrid_preempt_phase(torch, cfg):
    """22, hybrid: zamba2-7b at full width, cut to ``HYBRID_PRESSURE_LAYERS``
    layers (2 groups of 6 Mamba2 layers with the shared attention block
    after each, and a 2-layer tail: G = 2 applications), in fp32 from seed
    0, on the mix of 5 over a pool of ``PRESSURE_BLOCKS`` pages: swap and
    recompute token-identical to the unpressured run, the swap run probed
    (every swapped victim's pages and Mamba2 slot-state blob bit-equal after
    the round trip)."""
    from repro_torch.models import model as M

    cfg = cfg.replace(n_layers=HYBRID_PRESSURE_LAYERS)
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    base, base_st, _, _ = serve_mix(torch, cfg, params, {})
    gates = {}
    for pol in ("swap", "recompute"):
        out, st, _, _, probe = probed_mix(torch, cfg, params, {},
                                          num_blocks=PRESSURE_BLOCKS,
                                          preempt_policy=pol)
        gates[pol] = pressure_gate(
            f"pressure hybrid fp32 {pol} ({cfg.n_layers} layers)", out, st, base,
            base_st, "preempt_swaps" if pol == "swap" else "preempt_recomputes")
        gates[pol].update(probe.rates())
        if pol == "swap":
            if probe.checked < 1:
                fail("pressure hybrid swap: no swapped victim came back to be checked")
            log(f"pressure hybrid swap: {probe.checked} victims' pages and "
                f"slot-state blobs bit-equal after the round trip")
    del params
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, **gates)


def queue_c_phase(torch, cfg_small):
    """22, queue C: reduced olmoe at fp32, skewed towards experts 0 and 1,
    the default capacity factor 1.25, 4 sequence shards, on the mix of
    8 slots whose first four requests finish early (their idle decode rows
    then see no key in any shard, and the MoE layers route them ahead of
    the live rows).  The card engine against the CPU engine: token-identical,
    as many dropped assignments, every decode step's logits (idle rows
    included) within 1e-4; two card runs leave the same bytes in the null
    pages (the ordered scatter), within 1e-4 of the CPU's.  Controls: the
    CPU engine without the idle row's zeroing (the plain version's mean of
    the null pages, the value the card's zero-weight partial never gave)
    must fail the logits check; the engines with the JAX package's scatter
    targets, duplicates left in the order each device writes them, are
    logged: whether the card's null pages match the CPU's index order then
    depends on which writer the card lets win."""
    from repro_torch.models import layers, model as M
    from repro_torch.serve import ServeEngine

    params = M.init_params(cfg_small, seed=0, device="cpu", dtype=torch.float32)
    skew_moe(torch, params, cfg_small, seed=31)
    prompts = [[5 + i, 9, 2 * i + 1] for i in range(8)]
    news = [2] * 4 + [7] * 4
    kw = dict(slots=8, max_seq=32, block_size=8, prefill_buckets=(8, 32),
              seq_shards=SEQ_SHARDS)
    sharded = layers._sharded_attention
    indices = layers.decode_scatter_index, layers.prefill_scatter_index

    def run(dev, zero_idle=True, ordered=True):
        eng = ServeEngine(cfg_small, to_device(params, dev), **kw)
        decode, logits = eng.runner.decode, []

        def recorded(*a, **k):
            out = decode(*a, **k)
            logits.append(out[0].float().cpu())
            return out
        eng.runner.decode = recorded
        if not zero_idle:
            layers._sharded_attention = lambda *a, unseen_zero=False, **k: sharded(*a, **k)
        if not ordered:
            # the targets as the JAX package computes them, duplicates left to
            # the order the card writes them in
            def decode_index(lengths, tables, bs):
                lens = lengths.long()
                rows = torch.arange(lens.shape[0], device=lens.device)
                return tables.long()[rows, lens // bs], lens % bs, None

            def prefill_index(*a):
                return indices[1](*a)[:2] + (None,)
            layers.decode_scatter_index, layers.prefill_scatter_index = (
                decode_index, prefill_index)
        try:
            with DropCounter() as dc:
                for p, n in zip(prompts, news):
                    eng.submit(p, max_new_tokens=n)
                out = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        finally:
            layers._sharded_attention = sharded
            layers.decode_scatter_index, layers.prefill_scatter_index = indices
        nbl = eng.alloc.nb_local
        nulls = [s * nbl for s in range(SEQ_SHARDS)]
        null = torch.cat([eng.state["attn"][k][:, :, nulls].float().cpu().flatten()
                          for k in ("k_pages", "v_pages")])
        return out, dc.dropped, logits, null

    cpu = run("cpu")
    gpu = run("cuda")
    gpu2 = run("cuda")
    ctrl = run("cpu", zero_idle=False)
    unord, unord_cpu = run("cuda", ordered=False), run("cpu", ordered=False)

    def logits_err(a, b):
        if len(a[2]) != len(b[2]):
            return math.inf
        return max(float((x - y).abs().max()) for x, y in zip(a[2], b[2]))

    err = logits_err(gpu, cpu)
    ctrl_err = logits_err(gpu, ctrl)
    null_err = float((gpu[3] - cpu[3]).abs().max())
    unord_err = float((unord[3] - unord_cpu[3]).abs().max())
    log(f"queue C: reduced olmoe fp32 skewed, cf {cfg_small.capacity_factor}, "
        f"{SEQ_SHARDS} shards, 4 idle decode rows: card vs cpu tokens "
        f"{'identical' if gpu[0] == cpu[0] else 'DIFFERENT'}, dropped "
        f"{gpu[1]} vs {cpu[1]}, decode logits max|err| {err:.3g} over "
        f"{len(gpu[2])} steps; null pages card vs cpu {null_err:.3g}, two card "
        f"runs {'bit-equal' if torch.equal(gpu[3], gpu2[3]) else 'DIFFERENT'}; "
        f"control without the idle row's zeroing: logits max|err| {ctrl_err:.3g}; "
        f"the JAX package's scatter targets, duplicates in the card's write order "
        f"(logged): null pages vs the CPU's index order {unord_err:.3g}")
    if gpu[0] != cpu[0] or gpu[1] != cpu[1] or cpu[1] <= 0:
        fail(f"queue C: the card's 4-shard MoE engine differs from the CPU's "
             f"(drops {gpu[1]} vs {cpu[1]})")
    if err > 1e-4:
        fail(f"queue C: decode logits card vs cpu max|err| {err} (tolerance 1e-4)")
    if not torch.equal(gpu[3], gpu2[3]):
        fail("queue C: two card runs left different null-page bytes")
    if null_err > 1e-4:
        fail(f"queue C: the card's null pages differ from the CPU's by {null_err}")
    if ctrl_err <= 1e-4:
        fail("queue C: the control (the idle row's mean of the null pages) was "
             "not caught by the logits check")
    return dict(tokens_identical=gpu[0] == cpu[0], dropped=gpu[1],
                logits_err=err, null_err=null_err, control_logits_err=ctrl_err,
                unordered_null_err=unord_err, decode_steps=len(gpu[2]))


def main() -> None:
    import torch

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an "
             "NVIDIA GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from the root "
             f"of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import mamba_chunk, prefill_attention, rmsnorm, rope
    from repro_torch.kernels import rwkv_chunk, swiglu
    from repro_torch.launch.trace_train import one_card_config

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
    rows, decode_lens, pool, rmsnorm_first = kernel_phase(torch, timer, cfg)
    sweep = split_sweep(torch, timer, pool)
    parity_phase(torch, reduced(cfg))
    counters = {"rmsnorm": Counter(rmsnorm), "apply_rope": Counter(rope),
                "apply_rope_qk": Counter(rope, "qk_launches"),
                "rmsnorm_vector": Counter(rmsnorm, "launches_by_route", "vector"),
                "apply_rope_vector": Counter(rope, "launches_by_route", "vector"),
                "silu_mul": Counter(swiglu),
                "silu_mul_scalar": Counter(swiglu, "launches_by_route", "scalar"),
                "paged_decode_attention": Counter(decode_attention),
                "paged_prefill_attention": Counter(prefill_attention),
                "paged_prefill_attention_tc": Counter(prefill_attention, "tc_launches")}
    params = serve_params(torch, cfg)
    launches, serve, paged_out = serve_phase(torch, cfg, params, counters)
    for row in rows:
        row["launches"] = launches[ROW_COUNTER.get(row["name"], row["name"])]

    dense_rows, row7_again = dense_kernel_phase(torch, timer, cfg, decode_lens)
    dense_parity_phase(torch, reduced(cfg))
    dense_counters = {
        **counters, "decode_attention": Counter(decode_attention, "dense_launches"),
        "flash_attention_lengths": Counter(flash_attention, "lengths_launches"),
        "flash_attention": Counter(flash_attention)}
    dense_launches, dense_serve = dense_serve_phase(
        torch, cfg, params, dense_counters, paged_out, serve)
    for row in dense_rows:
        row["launches"] = dense_launches[row["name"]]
    rows += dense_rows

    q8_rows, q8_float_ms = int8_kernel_phase(torch, timer, cfg, pool)
    q8_parity = int8_parity_phase(torch, reduced(cfg))
    q8_counters = {
        **counters,
        "paged_decode_attention_int8": Counter(decode_attention, "q8_launches"),
        "paged_prefill_attention_int8": Counter(prefill_attention, "q8_launches")}
    q8_launches, q8_serve = int8_serve_phase(torch, cfg, params, q8_counters,
                                             paged_out, serve)
    for row in q8_rows:
        row["launches"] = q8_launches[row["name"]]
    rows += q8_rows

    seq_rows, seq_readings = shard_kernel_phase(torch, timer, cfg, pool)
    del pool
    shard_parity_phase(torch, reduced(cfg))
    seq_counters = {
        **q8_counters,
        "paged_decode_attention_skip_null": Counter(decode_attention, "shard_launches"),
        "paged_prefill_attention_skip_null": Counter(prefill_attention, "shard_launches")}
    seq_launches, seq_serve = shard_serve_phase(torch, cfg, params, seq_counters,
                                                paged_out, serve)
    for row in seq_rows:
        row["launches"] = seq_launches[row["name"]]
    rows += seq_rows
    t_phase = time.perf_counter()
    pressure = preempt_phase(torch, cfg, params, counters, serve)
    log(f"pressure: phase 22's stablelm part took {time.perf_counter() - t_phase:.1f} s")
    for row in rows:
        name = ROW_COUNTER.get(row["name"], row["name"])
        for pol in ("swap", "recompute"):
            if name in pressure[f"bf16_{pol}"]["launches"]:
                row[f"pressure_{pol}_launches"] = pressure[f"bf16_{pol}"]["launches"][name]
    del params
    torch.cuda.empty_cache()

    gcfg = get_config("granite-3-2b")
    train_rows = train_kernel_phase(torch, timer, gcfg)
    train_parity_phase(torch, reduced(gcfg))
    train_counters = {
        "flash_attention": Counter(flash_attention),
        "flash_attention_bwd": Counter(flash_attention, "bwd_launches"),
        "rmsnorm": Counter(rmsnorm), "rmsnorm_bwd": Counter(rmsnorm, "bwd_launches"),
        "rmsnorm_bwd_vector": Counter(rmsnorm, "bwd_launches_by_route", "vector"),
        "apply_rope": Counter(rope), "apply_rope_qk": Counter(rope, "qk_launches"),
        "silu_mul": Counter(swiglu), "silu_mul_bwd": Counter(swiglu, "bwd_launches"),
        "silu_mul_vector": Counter(swiglu, "launches_by_route", "vector")}
    train_launches, train = train_phase(torch, gcfg, train_counters,
                                        granite_expect, granite_watched)
    for row in train_rows:
        row["launches"] = train_launches[ROW_COUNTER.get(row["name"], row["name"])]
    rows += train_rows

    rcfg = get_config("rwkv6-3b")
    rwkv_rows = rwkv_kernel_phase(torch, timer, rcfg)
    train_parity_phase(torch, reduced(rcfg), perturb=rwkv_perturb)
    rwkv_counters = {
        "rwkv6": Counter(rwkv_chunk), "rwkv6_bwd": Counter(rwkv_chunk, "bwd_launches"),
        "rwkv6_tc": Counter(rwkv_chunk, "tc_launches"),
        "rwkv6_bwd_tc": Counter(rwkv_chunk, "tc_bwd_launches"),
        "rmsnorm": Counter(rmsnorm), "rmsnorm_bwd": Counter(rmsnorm, "bwd_launches"),
        "rmsnorm_bwd_vector": Counter(rmsnorm, "bwd_launches_by_route", "vector")}
    rwkv_launches, rwkv_train = train_phase(torch, rcfg, rwkv_counters,
                                            rwkv_expect, rwkv_watched)
    for row in rwkv_rows:
        row["launches"] = rwkv_launches[row["name"]]
    rows += rwkv_rows

    rwkv_serve_rows = rwkv_serve_kernel_phase(torch, timer, rcfg)
    rwkv_parity = rwkv_serve_parity_phase(torch, reduced(rcfg))
    rwkv_fp32 = rwkv_fp32_identity(torch, rcfg)
    rwkv_serve_counters = {
        "rwkv6": Counter(rwkv_chunk), "rwkv6_tc": Counter(rwkv_chunk, "tc_launches"),
        "rwkv6_s0": Counter(rwkv_chunk, "s0_launches"),
        "rwkv6_bwd": Counter(rwkv_chunk, "bwd_launches"),
        "rmsnorm": Counter(rmsnorm),
        "rmsnorm_vector": Counter(rmsnorm, "launches_by_route", "vector")}
    rwkv_serve_launches, rwkv_serve = rwkv_serve_phase(torch, rcfg, rwkv_serve_counters)
    runner_launches = rwkv_serve_launches["runner"]
    rwkv_serve_rows[0]["launches"] = runner_launches["rwkv6_s0"]
    rwkv_serve_rows[1]["launches"] = runner_launches["rmsnorm"]
    rwkv_rows[0]["serve_dense_launches"] = rwkv_serve_launches["slab"]["rwkv6"]
    for row in rows:
        if row["name"] in ("rmsnorm", "rmsnorm_decode"):
            row["rwkv_serve_launches"] = runner_launches["rmsnorm"]
    rows += rwkv_serve_rows

    zcfg = one_card_config("zamba2-7b")
    hybrid_rows = mamba_kernel_phase(torch, timer, zcfg)
    hybrid_rows += flash112_phase(torch, timer, zcfg)
    train_parity_phase(torch, reduced(get_config("zamba2-7b")))
    zamba_counters = {
        "mamba2": Counter(mamba_chunk), "mamba2_bwd": Counter(mamba_chunk, "bwd_launches"),
        "mamba2_states": Counter(mamba_chunk, "states_launches"),
        **train_counters}
    zamba_launches, zamba_train = train_phase(torch, zcfg, zamba_counters,
                                              zamba_expect, zamba_watched)
    for row in hybrid_rows:
        row["launches"] = zamba_launches[row["name"].removesuffix("_hd112")]
    rows += hybrid_rows

    sz_cfg = get_config("zamba2-7b")
    zserve_rows = [mamba_serve_row(torch, timer, sz_cfg)] + attn_rows(torch, timer, sz_cfg)
    zamba_parity = zamba_serve_parity_phase(torch, reduced(sz_cfg))
    zamba_fp32 = zamba_fp32_identity(torch, sz_cfg)
    zserve_counters = {
        "mamba2": Counter(mamba_chunk), "mamba2_h0": Counter(mamba_chunk, "h0_launches"),
        "mamba2_states": Counter(mamba_chunk, "states_launches"),
        "mamba2_bwd": Counter(mamba_chunk, "bwd_launches"),
        **seq_counters, "decode_attention": Counter(decode_attention, "dense_launches"),
        "flash_attention_lengths": Counter(flash_attention, "lengths_launches"),
        "flash_attention": Counter(flash_attention)}
    zserve_launches, zamba_serve = zamba_serve_phase(torch, sz_cfg, zserve_counters)
    for row in zserve_rows:
        path, counter = ZAMBA_ROW_COUNTER[row["name"]]
        row["launches"] = zserve_launches[path][counter]
    zrun = zserve_launches["runner"]
    for row in rows:
        name = ROW_COUNTER.get(row["name"], row["name"])
        if row["name"] in ("rmsnorm", "rmsnorm_decode", "apply_rope_qk", "silu_mul"):
            row["zamba_serve_launches"] = zrun[name]
        if row["name"] == "mamba2":
            row["zamba_serve_launches"] = zserve_launches["slab"]["mamba2"]
    rows += zserve_rows
    t_phase = time.perf_counter()
    hybrid_pressure = hybrid_preempt_phase(torch, sz_cfg)
    log(f"pressure: phase 22's hybrid part took {time.perf_counter() - t_phase:.1f} s")

    mcfg = get_config("olmoe-1b-7b")
    moe_rows = expert_silu_rows(torch, timer, mcfg) + attn_rows(
        torch, timer, mcfg, labels=("1o", "2o", "7o"), seed=33)
    moe_layers = {c.name: moe_layer_check(torch, c, seed) for c, seed in (
        (mcfg, 34), (get_config("qwen2-moe-a2.7b"), 35))}
    moe_parity = moe_serve_parity_phase(torch, reduced(mcfg))
    moe_counters = {
        **seq_counters, "decode_attention": Counter(decode_attention, "dense_launches"),
        "flash_attention_lengths": Counter(flash_attention, "lengths_launches"),
        "silu_mul_element": Counter(swiglu, "launches_by_route", "element"),
        "silu_mul_vector": Counter(swiglu, "launches_by_route", "vector")}
    moe_launches, moe_serve = moe_serve_phase(torch, mcfg, moe_counters)
    moe_fp32 = moe_fp32_identity(torch, mcfg)
    for row in moe_rows:
        path, counter = MOE_ROW_COUNTER[row["name"]]
        row["launches"] = moe_launches[path][counter]
    mrun = moe_launches["runner"]
    for row in rows:
        if row["name"] in ("rmsnorm", "rmsnorm_decode", "apply_rope_qk", "silu_mul"):
            row["moe_serve_launches"] = mrun[ROW_COUNTER.get(row["name"], row["name"])]
    rows += moe_rows
    queue_c = queue_c_phase(torch, reduced(mcfg))

    fid_rows, gemm_routes = fidelity_phase(torch, timer, cfg)
    rows += fid_rows
    row7 = dense_rows[0]
    row7["second_ms"], row7["second_library_ms"] = row7_again()
    del row7_again
    log(f"kernel decode_attention, read again after phase 16: "
        f"{row7['second_ms']:.4f} ms against SDPA's {row7['second_library_ms']:.4f} "
        f"({row7['second_ms'] / row7['second_library_ms']:.3f}x; first reading "
        f"{row7['ms']:.4f} / {row7['library_ms']:.4f}, "
        f"{row7['ms'] / row7['library_ms']:.3f}x)")

    kernels = {"kernels": rows}
    (OUT / "results.json").write_text(json.dumps(
        dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
             build_s=info["seconds"], rmsnorm_first_reading=rmsnorm_first,
             decode_split_sweep={str(k): v for k, v in sweep.items()},
             serve=serve, dense_serve=dense_serve, int8_serve=q8_serve,
             int8_launches=q8_launches, int8_parity=q8_parity,
             int8_float_kernel_ms=q8_float_ms, seq_serve=seq_serve,
             seq_launches=seq_launches, seq_readings=seq_readings,
             dense_launches=dense_launches, train=train,
             train_launches=train_launches, rwkv_train=rwkv_train,
             rwkv_launches=rwkv_launches, rwkv_serve=rwkv_serve,
             rwkv_serve_launches=rwkv_serve_launches, rwkv_serve_parity=rwkv_parity,
             rwkv_fp32_identity=rwkv_fp32, zamba_train=zamba_train,
             zamba_launches=zamba_launches, zamba_serve=zamba_serve,
             zamba_serve_launches=zserve_launches, zamba_serve_parity=zamba_parity,
             zamba_fp32_identity=zamba_fp32, moe_layers=moe_layers,
             moe_serve_parity=moe_parity, moe_serve=moe_serve,
             moe_serve_launches=moe_launches, moe_fp32_identity=moe_fp32,
             pressure=pressure, hybrid_pressure=hybrid_pressure, queue_c=queue_c,
             gemm_routes=gemm_routes, **kernels),
        indent=1))
    log(f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
