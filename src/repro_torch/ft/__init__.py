"""Fault tolerance (port of ``repro.ft``): atomic async checkpointing,
elastic restore onto any mesh or none (each rank keeps its block of the
logical arrays), the straggler policy and the serving step watchdog."""
from repro_torch.ft.checkpoint import (CheckpointError,  # noqa: F401
                                       CheckpointManager)
from repro_torch.ft.elastic import restore_elastic  # noqa: F401
from repro_torch.ft.straggler import (StepWatchdog,  # noqa: F401
                                      StragglerConfig, StragglerPolicy)
