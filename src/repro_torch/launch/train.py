"""Training CLI: the end-to-end loop over the port's training substrate.

Port of ``repro``'s ``launch/train.py``, flag for flag and line for line,
on one device: any ``--arch`` (full or smoke geometry) with the synthetic
AoS data pipeline, AdamW, checkpointing (async, atomic; resume with
``--resume``), the straggler policy's hooks and optional gradient
compression / microbatching.

On the CPU (reduced geometry):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --device cpu --steps 6 --batch 4 --seq 64

On the card, under the ``ref`` policy:

  REPRO_TORCH_VX_IMPL=ref PYTHONPATH=src python -m \\
      repro_torch.launch.train --arch qwen3-0.6b --steps 6 --batch 4 \\
      --seq 512 --lr 1e-3

The hand-written kernels have no backward, and the card's default policy
is ``kernel``: there the first step's forward reaches a ``vx`` verb that
refuses an operand requiring grad, and the CLI exits with that
``RuntimeError``, as the reference's training does under ``pallas`` on
its TPU.  Train with ``REPRO_TORCH_VX_IMPL=ref`` (the reference:
``REPRO_VX_IMPL=ref``).  ``--mesh single-pod`` / ``multi-pod`` wait for
the port's dist slice (item 9h) and raise ``NotImplementedError``.

``--device`` defaults to CUDA and follows the port's rule: without a GPU
the CLI raises unless ``--device cpu`` is given.  The printed step time
is the host clock around a step that ends with a device synchronize.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticAoSPipeline
from repro_torch.device import refuse_mesh, resolve as resolve_device
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.ft.straggler import StragglerPolicy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import CompressionConfig
from repro_torch.train.step import (TrainConfig, init_full_state,
                                    jit_train_step)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family geometry (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "GPU unless 'cpu' is given)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single-pod", "multi-pod"],
                    help="production meshes wait for the port's dist slice")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    args = parser().parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.model
    ctx = None if args.mesh == "none" else argparse.Namespace(mesh=args.mesh)
    refuse_mesh(ctx)
    device = resolve_device(args.device)

    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(1, args.steps // 10)),
        microbatches=args.microbatches,
        compression=CompressionConfig(kind=args.compression))

    pipe = SyntheticAoSPipeline(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch),
        process_index=0, process_count=1, device=device)
    straggler = StragglerPolicy(n_hosts=1)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    state = init_full_state(cfg, tcfg, 0, device)
    start_step = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        state, extra = mgr.restore(state)
        pipe.load_state_dict(extra["pipeline"])
        start_step = extra["step"]
        print(f"resumed from step {start_step}")

    batch0 = pipe.next_batch()
    step_fn = jit_train_step(cfg, tcfg, ctx, state, batch0)
    pipe.load_state_dict({"step": pipe.state.step - 1,
                          "seed": pipe.state.seed})  # rewind the peek

    for step in range(start_step, args.steps):
        t0 = time.time()
        batch = pipe.next_batch()
        state, metrics = step_fn(state, batch)
        _sync(device)
        dt = time.time() - t0
        straggler.record_step({0: dt})
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms "
                  f"excluded_hosts={sorted(straggler.excluded())}",
                  flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state,
                     extra={"step": step + 1,
                            "pipeline": pipe.state_dict()})
    if mgr:
        mgr.save(args.steps, state,
                 extra={"step": args.steps, "pipeline": pipe.state_dict()},
                 blocking=True)
    print("done; final loss", float(metrics["loss"]))


if __name__ == "__main__":
    main()
