"""Roofline terms of the port's steps against one H100 (port of
``repro``'s ``roofline``)."""
from repro_torch.roofline.analysis import (CostBundle,  # noqa: F401
                                           RooflineTerms, active_param_count,
                                           bundle_from_trace,
                                           collective_bytes, model_flops,
                                           roofline)
