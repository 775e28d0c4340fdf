"""The port's device rule: ``cuda`` unless the caller asks for the CPU.
A mesh serves the sharded decode and prefill steps, the mesh forward and
loss and the sharded train step (``dist``); what still refuses one calls
:func:`refuse_mesh` with the ROADMAP item it waits for."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the GPU: raise when there is none, never fall back to
    the CPU quietly.  An explicit device (``"cpu"``, ``"cuda:0"``) is taken
    as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no GPU is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def refuse_mesh(ctx, item: str) -> None:
    """Raise for a sharding context with a mesh on a path that still runs
    on one device (the encoder-decoder's decode step), naming the ROADMAP
    item it waits for."""
    from repro_torch.dist.sharding import meshed
    if meshed(ctx):
        raise NotImplementedError(f"this sharded path waits for ROADMAP.md "
                                  f"queue A, item {item}")
