"""Elastic rescale: resume a run on a different mesh.

Port of ``repro``'s ``ft/elastic.py``.  Checkpoints store logical
(unsharded) arrays, so restoring onto a new mesh is: rebuild the
placement for the new mesh, then place each leaf with it.  On one device
there is no placement to rebuild (:func:`reshard_template` returns
``None``); a context with a mesh waits for the training half of ``dist`` (item 9h).  The data
pipeline's state (two ints) is host-count independent.
"""
from __future__ import annotations

from typing import Any

from repro_torch.device import refuse_mesh
from repro_torch.ft.checkpoint import CheckpointManager


def reshard_template(template: Any, ctx) -> Any:
    """The per-leaf placement of ``template`` under ``ctx``'s mesh:
    ``None`` without a mesh; a mesh is refused."""
    refuse_mesh(ctx)
    return None


def restore_elastic(mgr: CheckpointManager, template: Any, ctx,
                    *, step: int | None = None) -> tuple[Any, dict]:
    """Restore a checkpoint onto (possibly different) mesh ``ctx.mesh``."""
    shardings = reshard_template(template, ctx)
    return mgr.restore(template, step=step, shardings=shardings)
