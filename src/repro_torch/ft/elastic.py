"""Elastic rescale: resume a run on a different mesh.

Port of ``repro``'s ``ft/elastic.py``.  Checkpoints store logical
(unsharded) arrays, so restoring onto a new mesh is: rebuild the
placement for the new mesh (the reference's parameter rules,
``dist.sharding.tree_param_specs``), then keep each rank's block of each
leaf (``CheckpointManager.restore(shardings=...)``, ``from_local``).  On
one device there is no placement to rebuild (:func:`reshard_template`
returns ``None``).  The data pipeline's state (two ints) is host-count
independent.
"""
from __future__ import annotations

from typing import Any

from repro_torch.dist import sharding
from repro_torch.ft.checkpoint import CheckpointManager


def reshard_template(template: Any, ctx) -> Any:
    """The per-leaf placement of ``template`` under ``ctx``'s mesh (a
    tree of ``dist.sharding.Sharding``); ``None`` without a mesh."""
    if not sharding.meshed(ctx):
        return None
    return sharding.spec_tree_shardings(
        sharding.tree_param_specs(template, ctx), ctx)


def restore_elastic(mgr: CheckpointManager, template: Any, ctx,
                    *, step: int | None = None) -> tuple[Any, dict]:
    """Restore a checkpoint onto (possibly different) mesh ``ctx.mesh``."""
    shardings = reshard_template(template, ctx)
    return mgr.restore(template, step=step, shardings=shardings)
