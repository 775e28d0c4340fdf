"""Serving engine: the dense prefill and decode steps, and the fixed-slot
server wrapper over the paged scheduler.

Port of ``repro``'s ``serve/engine.py`` on one device: :class:`ServeConfig`,
:func:`jit_decode_step` and :func:`jit_prefill` (the reference's names, so
a reader finds the counterpart; they return EAGER callables — no
``torch.compile``, no donation: the dense cache leaves are updated in
place) and :class:`BatchedServer` over
:class:`repro_torch.serve.scheduler.Scheduler`.  :func:`cache_specs` and
:func:`serve_param_shardings` return ``None`` without a mesh, as the
reference does; a mesh, and ``ServeConfig.long_context``, wait for the
port's dist slice.  ``make_fleet`` waits for the replica fleet (ROADMAP.md
queue A, item 6), and the encoder-decoder step for its model family.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import vx
from repro_torch.device import refuse_mesh, resolve as resolve_device
from repro_torch.models import decode as dec
from repro_torch.models.transformer import (ModelConfig, check_supported,
                                            forward)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    cache_dtype: str = "bfloat16"
    long_context: bool = False     # sequence-parallel KV sharding (dist)
    # Whole-step access fusion (core/accessfuse.py): one fused KV split
    # per decode step.  Costs one transient cache-sized pre-split copy;
    # set False when the cache is the memory ceiling.
    step_fusion: bool = True


def cache_specs(cfg: ModelConfig, ctx, scfg: ServeConfig, cache_template):
    """The cache's placement: ``None`` (one device) without a mesh."""
    refuse_mesh(ctx)
    return None


def serve_param_shardings(params_template, cfg: ModelConfig, ctx):
    """The weights' placement: ``None`` (one device) without a mesh."""
    refuse_mesh(ctx)
    return None


def jit_decode_step(cfg: ModelConfig, ctx, scfg: ServeConfig,
                    params_template=None, cache_template=None, *,
                    param_ctx=None, device=None):
    """``serve_step(params, cache, token) -> (logits, cache)``: one dense
    decode step (:func:`repro_torch.models.decode.decode_step`, fused per
    ``scfg.step_fusion``), eager.  ``token`` is moved to ``device`` (the
    port's rule: cuda unless the caller asks for the CPU).  The templates
    keep the reference's signature; on one device nothing reads them."""
    refuse_mesh(ctx)
    refuse_mesh(param_ctx)
    if scfg.long_context:
        raise NotImplementedError("long-context (sequence-sharded) serving "
                                  "waits for the port's dist slice")
    check_supported(cfg)
    device = resolve_device(device)
    # one-time host compile of the FIELD=2 segment plans the fused KV
    # split consults (nothing under impl="ref")
    vx.warm(2 * cfg.hd, strided=False, fields=(2,), policy=cfg.vx_policy)
    fuse = scfg.step_fusion

    def serve_step(params, cache, token):
        return dec.decode_step(params, cache, token.to(device), cfg, ctx,
                               fuse=fuse)

    return serve_step


def jit_prefill(cfg: ModelConfig, ctx, params_template=None,
                batch_template=None, *, param_ctx=None, device=None):
    """``prefill(params, batch) -> (logits (B, 1, V), cache_states)``:
    :func:`repro_torch.models.transformer.forward` in ``prefill`` mode,
    eager.  ``batch["tokens"]`` is moved to ``device``."""
    refuse_mesh(ctx)
    refuse_mesh(param_ctx)
    check_supported(cfg)
    device = resolve_device(device)

    def prefill(params, batch):
        batch = dict(batch, tokens=batch["tokens"].to(device))
        logits, _, cache_states = forward(params, batch, cfg, ctx,
                                          mode="prefill")
        return logits, cache_states

    return prefill


class BatchedServer:
    """Fixed-slot continuous batching — thin wrapper over
    :class:`repro_torch.serve.scheduler.Scheduler` (the paged runtime:
    per-slot positions, a shared page pool per layer, reclamation on
    ``finish``, multi-token prompts through chunked prefill, optional
    temperature / top-k sampling).  The single-token ``add_request(int)``
    / ``step()`` / ``finish()`` surface is the reference's; ``cache`` is
    presented in the legacy ``{"len", "blocks"}`` shape with ``len`` = the
    furthest active position.  ``device`` follows the port's rule."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int, max_len: int,
                 ctx=None, cache_dtype=torch.float32, fuse_step: bool = True,
                 page_size: int | None = None, num_pages: int | None = None,
                 temperature: float = 0.0, top_k: int | None = None,
                 seed: int = 0, device=None, **lifecycle_kw):
        from repro_torch.serve.scheduler import Scheduler
        refuse_mesh(ctx)
        self.cfg, self.params = cfg, params
        self.slots, self.max_len, self.ctx = slots, max_len, ctx
        # lifecycle_kw passes the runtime knobs through unchanged
        # (queue_depth / preemption / watchdog / debug_invariants / clock /
        # chunk_pages; see serve/scheduler.py)
        self.scheduler = Scheduler(
            cfg, params, slots=slots, max_len=max_len, page_size=page_size,
            num_pages=num_pages, cache_dtype=cache_dtype,
            fuse_step=fuse_step, temperature=temperature, top_k=top_k,
            seed=seed, device=device, **lifecycle_kw)

    @property
    def active(self) -> list:
        return self.scheduler.active

    @property
    def tokens(self) -> list:
        return self.scheduler.tokens

    @property
    def cache(self) -> dict:
        st = self.scheduler.cache.state
        return {"len": torch.max(st["pos"]), "blocks": st["blocks"]}

    def add_request(self, prompt_token=None, *, prompt=None) -> int:
        """Admit a request: a single first token (legacy form) or a full
        prompt list (prefilled to completion)."""
        req = prompt if prompt is not None else prompt_token
        if req is None:
            raise ValueError("pass a prompt token or prompt= list")
        return self.scheduler.add_request(req)

    def step(self) -> list[int]:
        """Advance every active slot one token."""
        return self.scheduler.step()

    def submit(self, prompt, **kw):
        """Queue a typed request (lifecycle surface — see Scheduler)."""
        return self.scheduler.submit(prompt, **kw)

    def tick(self):
        """One lifecycle iteration: admit / step / retire."""
        return self.scheduler.tick()

    def finish(self, slot: int) -> list[int]:
        """Release the slot (pages reclaimed, per-slot state cleared)."""
        return self.scheduler.finish(slot)
