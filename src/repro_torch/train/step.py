"""Train-step factory on one device: mixed precision, microbatch
accumulation, gradient compression with error feedback, AdamW.

Port of ``repro``'s ``train/step.py``.  The step is eager: each
microbatch runs :func:`models.transformer.loss_fn` on fresh leaves of the
params that require grad and ``loss.backward()``; microbatch gradients
are averaged in float32 in the reference's order (``acc + g / n``), then
compressed with error feedback (``optim/compression.py``) and applied by
AdamW (``optim/adamw.py``).  The step consumes its state, as the
reference's donation does: params, the AdamW moments and the error state
are updated in place and the returned state holds the same tensors.

Training runs under ``vx`` policy ``ref``: the hand-written kernels have
no backward, and under ``kernel`` / ``kernel_dynamic`` every ``vx`` verb
that would reach one refuses an operand that requires grad, as the
reference cannot differentiate its Pallas path either.  Shardings
(``full_state_shardings``, ``batch_shardings``) are ``None`` without a
mesh; a mesh waits for the training half of ``dist`` (item 9h).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.device import refuse_mesh
from repro_torch.models.transformer import ModelConfig, loss_fn
from repro_torch.optim.adamw import AdamWConfig, _map, apply_updates
from repro_torch.optim.compression import (CompressionConfig,
                                           compress_with_feedback,
                                           init_error_state)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    compression: CompressionConfig = CompressionConfig()


def _split_microbatches(batch: dict, n: int) -> dict:
    def r(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape((n, b // n) + tuple(x.shape[1:]))
    return {k: r(v) for k, v in batch.items()}


def _loss_and_grads(params, batch, cfg: ModelConfig, ctx):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``: leaves
    detached from any graph, ``loss.backward()``, a zero gradient for a
    leaf the loss does not reach (as ``jax.grad`` gives)."""
    leaves = _map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch, cfg, ctx)
        loss.backward()
    grads = _map(lambda p: p.grad if p.grad is not None
                 else torch.zeros_like(p), leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, ctx=None
                    ) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``."""
    refuse_mesh(ctx)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        n = tcfg.microbatches
        if n == 1:
            _, metrics, grads = _loss_and_grads(params, batch, cfg, ctx)
        else:
            mb = _split_microbatches(batch, n)
            grads = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
            loss = 0.0
            for i in range(n):
                b = {k: v[i] for k, v in mb.items()}
                l_i, _, g = _loss_and_grads(params, b, cfg, ctx)
                _map(lambda a, x: a.add_(x.float() / n), grads, g)
                del g
                loss = loss + l_i / n
            metrics = {"loss": loss, "aux": torch.zeros(
                (), dtype=torch.float32, device=loss.device)}

        if tcfg.compression.kind != "none":
            grads, _, cm = compress_with_feedback(
                grads, state["grad_error"], tcfg.compression)
            metrics.update(cm)
        _, _, om = apply_updates(params, grads, state["opt"], tcfg.optimizer)
        metrics.update(om)
        return state, metrics

    return train_step


def init_full_state(cfg: ModelConfig, tcfg: TrainConfig, generator=0,
                    device=None) -> dict:
    """Seeded params (``init_params``), the AdamW state and, under
    compression, the error-feedback state."""
    from repro_torch.models.transformer import init_params
    from repro_torch.train.state import init_train_state
    params = init_params(cfg, generator, device=device)
    state = init_train_state(params)
    if tcfg.compression.kind != "none":
        state["grad_error"] = init_error_state(params)
    return state


def full_state_shardings(state: dict, ctx, tcfg: TrainConfig):
    refuse_mesh(ctx)
    return None


def batch_shardings(batch_template: Any, ctx):
    refuse_mesh(ctx)
    return None


def jit_train_step(cfg: ModelConfig, tcfg: TrainConfig, ctx, state: dict,
                   batch_template: Any):
    """The reference's name for the compiled step: here the eager
    :func:`make_train_step` (no ``torch.compile``; the state is updated
    in place where the reference donates it); the templates keep the
    reference's signature."""
    return make_train_step(cfg, tcfg, ctx)
