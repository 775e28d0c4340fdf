"""AdamW + schedules + global-norm clipping, as torch ops (no torch.optim).

Port of ``repro``'s ``optim/adamw.py``.  Optimizer state is a tree of
float32 tensors mirroring the params (``m``, ``v``) plus an int32
``step``.  :func:`apply_updates` consumes its state: params, ``m``, ``v``
and ``step`` are updated in place (the reference donates them to its
jit'd step), so a step holds one copy of the state and one leaf's
temporaries.  The arithmetic is float32 in the reference's operation
order, so the same gradients give the same state bit for bit.  ZeRO-1
sharding of the moments waits for ``dist`` (item 9h).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.kernels._common import tree_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, float32."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE (correctly rounded) float32 sqrt on every device.  The CPU's
    vectorized float32 sqrt in torch is one ulp off for about 0.6% of
    inputs; float64's rounded back is the correctly rounded float32 root,
    which the card's ``sqrtf`` and the reference's XLA give."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def global_norm(tree: Any) -> torch.Tensor:
    return _sqrt(sum(torch.sum(torch.square(x.float()))
                     for x in tree_leaves(tree)))


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return _map(lambda g: g.float() * scale, grads), norm


def init_opt_state(params: Any) -> dict:
    def zeros(p):
        return _map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), p)
    dev = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _decay_mask(path: str) -> bool:
    """No weight decay on norms/biases/1-D scales."""
    return not any(t in path for t in ("norm", "scale", "bias", "ln", "fb",
                                       "dt_bias", "D"))


def _paths(tree, prefix: str = "") -> Any:
    """The tree with each leaf replaced by its ``/``-joined key path."""
    return {k: (_paths(v, f"{prefix}{k}/") if isinstance(v, dict)
                else f"{prefix}{k}") for k, v in tree.items()}


@torch.no_grad()
def apply_updates(params: Any, grads: Any, opt: dict, cfg: AdamWConfig
                  ) -> tuple[Any, dict, dict]:
    """Returns (params, opt_state, metrics): ``params`` and ``opt`` are
    updated in place and returned; ``grads`` are read only.  The clip
    scale applies per leaf as the update reads it."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = opt["step"].add_(1)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v, path):
        wd = cfg.weight_decay if _decay_mask(path) else 0.0
        g = g.float() * scale
        p32 = p.float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        step_dir = (m / b1c) / (_sqrt(v / b2c) + cfg.eps) + wd * p32
        p.copy_(p32 - lr * step_dir)

    _map(upd, params, grads, opt["m"], opt["v"], _paths(params))
    return params, opt, {"grad_norm": gnorm, "lr": lr}
