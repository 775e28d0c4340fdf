"""TrainState tree and its placement (port of ``repro``'s
``train/state.py``).

The state is ``{"params", "opt"}`` (and the train step's ``grad_error``
under compression).  On one device every leaf lives on the params'
device and the spec builders return ``None``, as the reference's
placement does.  Under a ``ShardCtx`` with a mesh the params follow the
reference's parameter rules (``dist.sharding.tree_param_specs``) and the
AdamW moments are ZeRO-1 sharded: additionally split over the data axes
(:func:`_zero1_spec`), so a rank holds ``1 / data_size`` of its model
block of each moment.  ``train/step.py`` places the leaves as these specs
say (``DTensor`` s built with ``from_local``).
"""
from __future__ import annotations

from typing import Any

from repro_torch.dist import sharding
from repro_torch.dist.sharding import P, add_data_sharding, tree_param_specs
from repro_torch.kernels._common import tree_leaves
from repro_torch.optim.adamw import init_opt_state


def init_train_state(params: Any) -> dict:
    return {"params": params, "opt": init_opt_state(params)}


def _zero1_spec(spec: P, shape: tuple, ctx) -> P:
    """ZeRO-1: optimizer moments additionally sharded over the data axes.
    Never splits the scan-stack dim of block params (>= 3-dim leaves)."""
    return add_data_sharding(spec, shape, ctx,
                             start=1 if len(shape) >= 3 else 0)


def train_state_specs(state: dict, ctx, *, zero1: bool = True):
    """Tree of :class:`P` for the state's params and moments; ``None``
    without a mesh."""
    if not sharding.meshed(ctx):
        return None
    pspecs = tree_param_specs(state["params"], ctx)
    mspecs = pspecs
    if zero1:
        mspecs = sharding.tree_map(
            lambda p, s: _zero1_spec(s, tuple(p.shape), ctx),
            state["params"], pspecs)
    return {"params": pspecs, "opt": {"m": mspecs, "v": mspecs,
                                      "step": P()}}


def state_shardings(state: dict, ctx, *, zero1: bool = True):
    """The state's placement, a tree of ``dist.sharding.Sharding``;
    ``None`` without a mesh."""
    if not sharding.meshed(ctx):
        return None
    return sharding.spec_tree_shardings(
        train_state_specs(state, ctx, zero1=zero1), ctx)


def init_placed_state(params: Any, ctx, *, zero1: bool = True) -> dict:
    """The train state on ``ctx``'s mesh from whole ``params``: each
    rank keeps its block of every param (``dist.sharding.place``) and
    makes the AdamW moments as zeros of its ZeRO-1 blocks only, so no
    whole moment is ever made.  The whole params can be freed after."""
    import torch
    specs = train_state_specs({"params": params}, ctx, zero1=zero1)
    placed = sharding.tree_map(
        lambda p, sp: sharding.place(p, ctx.sharding(sp)), params,
        specs["params"])

    def zeros(p, sp):
        block = sharding.local_block(
            torch.empty(p.shape, device="meta"), ctx.mesh, sp)
        return sharding.from_local(
            torch.zeros(block.shape, dtype=torch.float32, device=p.device),
            ctx.mesh, sp, p.shape)

    dev = sharding.block_of(tree_leaves(params)[0]).device
    return {"params": placed, "opt": {
        "m": sharding.tree_map(zeros, params, specs["opt"]["m"]),
        "v": sharding.tree_map(zeros, params, specs["opt"]["v"]),
        "step": torch.zeros((), dtype=torch.int32, device=dev)}}

