"""The port's device rule: ``cuda`` unless the caller asks for the CPU.
A mesh serves the sharded decode steps (``dist``); what still refuses one
(training, ``forward`` and the batch-sharded serve steps) calls
:func:`refuse_mesh`."""
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
    """Raise for a sharding context with a mesh where the port still runs
    on one device: training, ``forward`` and the batch-sharded steps."""
    if ctx is not None and getattr(ctx, "mesh", None) is not None:
        raise NotImplementedError("this sharded path waits for the training "
                                  "half of the port's dist slice "
                                  "(ROADMAP.md queue A, item 9h)")
