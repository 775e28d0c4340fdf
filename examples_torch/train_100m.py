"""End-to-end driver: train a ~100M-param qwen3-family model for a few
hundred steps with the port's full substrate (AoS pipeline, AdamW,
checkpoint/restart, EARTH segment ops in the input path).

The PyTorch / CUDA twin of ``examples/train_100m.py``: the same model
(:func:`build_cfg`, field for field), optimizer, data and checkpoint
cadence (every 100 steps; ``--ckpt-every``).  The step runs under the
``ref`` policy: the hand-written
kernels have no backward, and a ``vx`` verb refuses to launch one on an
operand that requires grad.  When the last step is a checkpoint step,
that checkpoint is restored and held against the live state bit for
bit.

Run:  PYTHONPATH=src python examples_torch/train_100m.py [--steps 300] \\
          [--device cpu]
"""
import argparse
import dataclasses
import math
import os
import tempfile
import time

import torch

from repro_torch import vx
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticAoSPipeline
from repro_torch.device import resolve
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.kernels._common import tree_leaves
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import TrainConfig, init_full_state, jit_train_step


def build_cfg():
    """~100M params: d=512, 8 layers, vocab 32k, GQA + qk-norm."""
    base = get_arch("qwen3-0.6b").model
    return dataclasses.replace(
        base, name="qwen3-100m", d_model=512, n_layers=8, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=1536, vocab=32768,
        compute_dtype="float32", remat="none")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Train; return the losses, the verdict and, when the last step was
    a checkpoint step, whether its restore equals the state bit for
    bit."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "earth_torch_100m_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "GPU unless 'cpu' is given)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = build_cfg()
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=1e-3, warmup_steps=20, total_steps=args.steps))
    state = init_full_state(cfg, tcfg, 0, device=dev)
    n = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"model: {cfg.name} params={n/1e6:.1f}M")

    pipe = SyntheticAoSPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch),
        device=dev)
    mgr = CheckpointManager(args.ckpt)
    batch = pipe.next_batch()
    step_fn = jit_train_step(cfg, tcfg, None, state, batch)

    losses = []
    saved = None
    t0 = time.time()
    for step in range(args.steps):
        with vx.use("ref"):
            state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        batch = pipe.next_batch()
        if step % 20 == 0:
            _sync(dev)
            print(f"step {step:4d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)", flush=True)
        if (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state, extra={"pipeline": pipe.state_dict(),
                                             "step": step + 1})
            saved = step + 1
    mgr.wait()
    first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
    verdict = "LEARNING" if last < first - 0.5 else "check setup"
    print(f"loss {first:.3f} -> {last:.3f} ({verdict})")
    out = {"losses": losses, "verdict": verdict, "params": n,
           "restored_equal": None}
    if saved is not None and saved == args.steps:
        restored, extra = mgr.restore(state, step=saved)
        out["restored_equal"] = all(
            torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                              tree_leaves(state))) and \
            extra["step"] == saved
        print(f"checkpoint step {saved} restored bit for bit: "
              f"{out['restored_equal']}")
    out["finite"] = all(math.isfinite(v) for v in losses)
    return out


if __name__ == "__main__":
    main()
