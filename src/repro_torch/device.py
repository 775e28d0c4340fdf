"""The port's device rule: ``cuda`` unless the caller asks for the CPU, and
one device (a mesh waits for the port's dist slice)."""
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


def refuse_mesh(ctx) -> None:
    """Raise for a sharding context with a mesh: the port runs on one
    device until its dist slice."""
    if ctx is not None and getattr(ctx, "mesh", None) is not None:
        raise NotImplementedError("sharded execution waits for the port's "
                                  "dist slice (ROADMAP.md queue A, item "
                                  "9h)")
