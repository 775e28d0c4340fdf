"""Production meshes (port of ``repro``'s ``launch/mesh.py``).

Defined as functions, so importing this module touches no process group.

Single pod: 256 ranks as (16, 16) = ("data", "model").
Multi-pod : 512 ranks as (2, 16, 16) = ("pod", "data", "model"); the
"pod" axis is data-parallel.

Each mesh is built over the default process group, which the caller
creates with ``torch.distributed.init_process_group``; a world of another
size raises ``ValueError`` (the mesh is never shrunk to fit).
"""
from __future__ import annotations

from repro_torch.dist.sharding import ShardCtx, make_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_ctx(mesh, *, long_context: bool = False,
             fsdp: bool = False) -> ShardCtx:
    """ShardCtx for a production mesh (or None mesh for local runs)."""
    if mesh is None:
        return ShardCtx(mesh=None, data_axes=(), model_axis=None)
    names = mesh.mesh_dim_names
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    if long_context:
        # batch=1: the batch dim cannot shard — activations replicate over
        # the data axes and the KV sequence dim is sharded instead.
        return ShardCtx(mesh=mesh, data_axes=(),
                        model_axis="model" if "model" in names else None,
                        seq_axes=tuple(a for a in ("data", "model")
                                       if a in names))
    return ShardCtx(
        mesh=mesh,
        data_axes=data_axes,
        model_axis="model" if "model" in names else None,
        seq_axes=(),
        fsdp=fsdp,
    )


def make_test_mesh(shape=(2, 4), axes=("data", "model"), *, device=None):
    """Small mesh over the ranks of the caller's process group."""
    return make_mesh(shape, axes, device=device)
