"""Data pipeline (port of ``repro.data``): the AoS record format (EARTH
segment ops) and the deterministic host-sharded synthetic loader."""
from repro_torch.data.aos import pack_records, unpack_records  # noqa: F401
from repro_torch.data.pipeline import (DataConfig,  # noqa: F401
                                       SyntheticAoSPipeline)
