"""TrainState tree and its placement (port of ``repro``'s
``train/state.py``).

On one device the state is ``{"params", "opt"}`` (and the train step's
``grad_error`` under compression), every leaf on the params' device.  The
sharding spec builders return ``None`` without a mesh, as the reference's
placement does on one device; a mesh (ZeRO-1 included) waits for ``dist``
(ROADMAP.md queue A, item 9h).
"""
from __future__ import annotations

from typing import Any

from repro_torch.device import refuse_mesh
from repro_torch.optim.adamw import init_opt_state


def init_train_state(params: Any) -> dict:
    return {"params": params, "opt": init_opt_state(params)}


def train_state_specs(state: dict, ctx):
    """The state's partition specs: ``None`` on one device."""
    refuse_mesh(ctx)
    return None


def state_shardings(state: dict, ctx):
    """The state's placement: ``None`` on one device."""
    refuse_mesh(ctx)
    return None
