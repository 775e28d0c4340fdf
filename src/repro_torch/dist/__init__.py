"""Distributed substrate (port of ``repro.dist``): the sharding context,
the spec rules, placement on a ``DeviceMesh`` and the collectives.

Modules
-------
sharding : ShardCtx + P rules for params / activations / state, placement
           of ``DTensor`` blocks, ``shard_map`` and ``make_mesh``.

GPipe pipeline parallelism (``pipeline_par``) waits for the training half
of item 9h (ROADMAP.md queue A).
"""
from repro_torch.dist import sharding  # noqa: F401
