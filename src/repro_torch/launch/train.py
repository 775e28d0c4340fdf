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
``REPRO_VX_IMPL=ref``).

``--mesh single-pod`` / ``multi-pod`` train on the production mesh,
``(16, 16)`` = (data, model) or ``(2, 16, 16)`` = (pod, data, model)
(``launch/mesh.py``), with the sharded step (ZeRO-1 moments) of
``train/step.py``: one process per rank, launched by ``torchrun`` (the
process group comes from its environment, ``init_method="env://"``:
``gloo`` on the CPU, ``nccl`` on GPUs; without that environment the
process is a world of one).  A world of any other size than 256 / 512
raises ``make_mesh``'s ``ValueError``: the mesh is never shrunk.  Every
rank makes the whole batch and trains on its block; rank 0 prints and
writes the checkpoints, which hold the logical arrays.

``--device`` defaults to CUDA and follows the port's rule: without a GPU
the CLI raises unless ``--device cpu`` is given.  The printed step time
is the host clock around a step that ends with a device synchronize.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticAoSPipeline
from repro_torch.device import resolve as resolve_device
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.ft.straggler import StragglerPolicy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import CompressionConfig
from repro_torch.train.step import (TrainConfig, full_state_shardings,
                                    init_full_state, jit_train_step)


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
                    help="train on a production mesh (256 / 512 ranks)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _process_group(device: torch.device) -> bool:
    """Join ``torchrun``'s process group (its environment), else make a
    world of one.  True when this call created it."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def main(argv=None) -> None:
    args = parser().parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.model
    device = resolve_device(args.device)
    if args.mesh == "none":
        train(args, cfg, device, None)
        return
    from repro_torch.launch.mesh import make_ctx, make_production_mesh
    owned = _process_group(device)
    try:
        ctx = make_ctx(make_production_mesh(
            multi_pod=args.mesh == "multi-pod", device=device))
        train(args, cfg, device, ctx)
    finally:
        if owned:
            dist.destroy_process_group()


def train(args, cfg, device: torch.device, ctx) -> None:
    """The loop: on one device (``ctx`` None) or on ``ctx``'s mesh."""
    lead = ctx is None or dist.get_rank() == 0

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
        state, extra = mgr.restore(
            state, shardings=full_state_shardings(state, ctx, tcfg))
        pipe.load_state_dict(extra["pipeline"])
        start_step = extra["step"]
        if lead:
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
        if lead and (step % 5 == 0 or step == args.steps - 1):
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
    if lead:
        print("done; final loss", float(metrics["loss"]))


if __name__ == "__main__":
    main()
