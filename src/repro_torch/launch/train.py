"""Training entry point of the port: the fault-tolerant driver over the
train step, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --reduced --device cpu --steps 50 --ckpt-dir /tmp/ckpt

``--arch`` takes every family: the dense configs, rwkv6-3b (RWKV6),
zamba2-7b (the Mamba2 hybrid) and the MoE configs olmoe-1b-7b and
qwen2-moe-a2.7b (the loss adds 0.01 x the load-balance loss and 1e-3 x
the router z-loss, as the JAX package's).  At 12 bytes a parameter (bf16
weights and gradients, f32 AdamW moments) three of them do not fit one 80
GB card at full depth: zamba2-7b at 81 layers (6.75 B parameters, ~81
GB), olmoe-1b-7b at 16 layers (6.92 B, 83.0 GB) and qwen2-moe-a2.7b at 24
layers (14.3 B, 171.8 GB), as in the JAX package on one chip.
``launch/trace_train.py`` and ``chip_smoke.py`` train zamba2-7b and
olmoe-1b-7b at full width and the depth one card holds
(``trace_train.ONE_CARD_LAYERS``: 33 and 8 layers).

The step runs on the card (``--device cuda``, the default) through the
hand-written CUDA kernels, forward and backward; ``--device cpu`` runs the
plain PyTorch versions.  Parameters are random, made from ``--seed``; the
data is the deterministic synthetic pipeline.

``--mesh single|multi`` builds the port's production mesh (16 x 16 chips,
or 2 pods of them: ``launch/mesh.py``) and stops there with an error: a
mesh trains with one chip a shard, 256 or 512 devices, and this process
drives one card (the JAX launcher fails at mesh construction on a
one-device host too).  The plan such a run would use is
``core/mapping.py:sharding_plan`` over that mesh.  ``--distributed``
(one process per host) raises as well: the port has no multi-process
training.  Only ``--mesh none`` trains.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import ARCHS, TRAIN_4K, get_config, reduced as reduce_cfg
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import for_cell
from repro_torch.launch.mesh import chips, make_production_mesh
from repro_torch.runtime import TrainDriver
from repro_torch.train import step as train_step_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none",
                    choices=("none", "single", "multi"),
                    help="'none' = one device; 'single' (16 x 16) and 'multi' "
                         "(2 x 16 x 16) build the production mesh and raise: "
                         "it needs one device a shard")
    ap.add_argument("--distributed", action="store_true",
                    help="one process per host: raises, the port trains in "
                         "one process")
    ap.add_argument("--device", default="cuda",
                    help="where the step runs: cuda (the CUDA kernels) or "
                         "cpu (their plain PyTorch versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random parameters")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=args.device)
        raise RuntimeError(
            f"--mesh {args.mesh}: {mesh} trains with one device a shard, "
            f"chips(mesh) = {chips(mesh)}, and this process drives one "
            f"{args.device} device; use --mesh none")
    if args.distributed:
        raise NotImplementedError(
            "--distributed: the port trains in one process on one device "
            "(--mesh none); it has no multi-process training")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible; pass --device cpu to run "
                         "the plain PyTorch path")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    shape = ShapeSpec("train_cli",
                      args.seq_len or (32 if args.reduced else TRAIN_4K.seq_len),
                      args.global_batch or (8 if args.reduced else TRAIN_4K.global_batch),
                      "train")
    tstep = train_step_mod.make_train_step(
        cfg, base_lr=args.lr, total_steps=args.steps,
        microbatch=args.microbatch)
    driver = TrainDriver(
        train_step=tstep,
        init_state=lambda: train_step_mod.init_state(cfg, args.seed,
                                                     device=device),
        dataset=for_cell(cfg, shape), ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        put_batch=lambda b: {k: torch.from_numpy(v).to(device)
                             for k, v in b.items()})
    out = driver.run(total_steps=args.steps)
    print(f"[train] done at step {out['last_step']} "
          f"loss={float(out['metrics']['loss']):.4f} "
          f"mean_step={out['mean_step_s']} on {device}")


if __name__ == "__main__":
    main()
