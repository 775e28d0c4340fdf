"""Distributed substrate (port of ``repro.dist``): the sharding context,
the spec rules, placement on a ``DeviceMesh`` and the collectives.

Modules
-------
sharding     : ShardCtx + P rules for params / activations / state,
               placement of ``DTensor`` blocks, ``shard_map``,
               ``make_mesh``, the collectives and their differentiable
               forms (the weight gather, the loss's ``psum``,
               ``ppermute``) for the mesh forward and the train step.
pipeline_par : GPipe pipeline parallelism over one mesh axis (the
               multi-pod "pod" axis).
"""
from repro_torch.dist import sharding  # noqa: F401
