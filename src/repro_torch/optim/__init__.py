"""Optimizer substrate: AdamW, schedules, gradient compression (port of
``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,  # noqa: F401
                                     init_opt_state, schedule)
from repro_torch.optim.compression import (CompressionConfig,  # noqa: F401
                                           compress_with_feedback)
