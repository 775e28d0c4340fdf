"""Sharding rules and placement: one :class:`ShardCtx` carries the mesh and
the axis roles, and every placement of the port derives from it.

Port of ``repro``'s ``dist/sharding.py`` onto ``torch.distributed``:

* a mesh is a ``DeviceMesh`` (:func:`make_mesh`) over the default process
  group, which the caller creates (``init_process_group``): the port never
  creates one on its own;
* a ``PartitionSpec`` is the port's :class:`P`, a tuple with one entry per
  tensor dim (``None``, a mesh axis name or a tuple of names); a
  ``NamedSharding`` is a :class:`Sharding` (the mesh, the spec and the
  ``DTensor`` placements it means);
* ``shard_map`` runs a body on the local blocks (:func:`shard_map`) and
  gives it the shard index and the reductions over named axes
  (:class:`Axes`).

Axis roles
----------
* ``data_axes``  : batch dimension of activations; gradient all-reduce.
* ``model_axis`` : tensor parallelism (Megatron column / row splits, the
                   residual stream sequence-sharded between layers,
                   expert parallelism, the vocab-sharded embedding, head
                   and cross entropy; ``models/transformer.py``).
* ``seq_axes``   : long-context serving only (B=1): KV sequence dim sharded.

Spec derivation is rule-based on the leaf's path and shape (not stored per
leaf), so a checkpoint holds logical arrays and any mesh can rebuild its
placements.

Placement
---------
A tensor sharded on a mesh is a ``DTensor`` whose local block each rank
holds.  The port builds one only with ``DTensor.from_local`` (:func:`place`
slices the rank's block out of a full tensor, so nothing is sent) and reads
one only through ``to_local``; it runs no ``DTensor`` operator.  The shard
index of a block flattens the named mesh axes in the order they are given,
first axis major (the reference's ``PartitionSpec`` split order), read
from ``DeviceMesh.get_local_rank``.  ``DTensor`` nests several mesh dims
on one tensor dim in mesh order, so a spec may name them only in mesh
order.

Collectives
-----------
Over the mesh's per-axis groups, one named axis at a time: :func:`psum`
and :func:`pmax` are ``all_reduce``; :func:`all_gather` is
``all_gather_into_tensor``; :func:`psum_scatter` is
``reduce_scatter_tensor``.  On one card shared by several ranks the group
is ``gloo`` (NCCL refuses two ranks on one GPU), which stages a CUDA
tensor through host memory; ``chip_smoke.py`` phase 16.0 probes which
collectives take CUDA tensors there.  :data:`LOG` counts each collective
by operation, shape and dtype, with its bytes and its host seconds.

Under autograd: :func:`gather_tree` (a weight gather; its transpose the
owned slice, or a ``psum_scatter`` over the axes whose cotangents are
partial), :func:`global_sum` (``psum`` forward, identity backward),
:func:`sum_grads` (identity forward, ``psum`` backward), and for tensor
parallelism, where each rank's cotangent is its share:
:func:`gather_seq` (``all_gather`` / ``psum_scatter``),
:func:`scatter_seq` (``psum_scatter`` / ``all_gather``), :func:`all_sum`
(``psum`` / ``psum``) and :func:`share` (identity / division by the
axis's size), with the layers' :func:`tp_enter` and :func:`tp_leave`.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import time
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve as resolve_device


# ---------------------------------------------------------------------------
# Specs, meshes and placements
# ---------------------------------------------------------------------------

class P(tuple):
    """The port's ``PartitionSpec``: one entry per tensor dim, each
    ``None`` (replicated), a mesh axis name or a tuple of names (split
    over them, first axis major; a one-name tuple is kept as the name, as
    ``PartitionSpec`` keeps it).  Trailing dims may be left out."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def axis_size(mesh, axis: str) -> int:
    """The size of mesh axis ``axis`` (a ``DeviceMesh`` dim name)."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axes_size(mesh, axes) -> int:
    return math.prod(axis_size(mesh, a) for a in _names(axes))


def axis_index(mesh, axes) -> int:
    """This rank's flattened index over mesh ``axes``, first axis major."""
    idx = 0
    for a in _names(axes):
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def placements(mesh, spec: P) -> tuple:
    """The ``DTensor`` placements that ``spec`` means on ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec} names mesh axes {_names(entry)} out of the "
                f"mesh's order {names}: a DTensor nests them in mesh order")
        for i in idx:
            if not out[i].is_replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def spec_of(x) -> P:
    """The :class:`P` of a ``DTensor`` (mesh order within a dim)."""
    names = x.device_mesh.mesh_dim_names
    parts: list = [[] for _ in range(x.ndim)]
    for name, pl in zip(names, x.placements):
        if pl.is_shard():
            parts[pl.dim % x.ndim].append(name)
        elif not pl.is_replicate():
            raise ValueError(f"placement {pl} has no PartitionSpec")
    return P(*[None if not p else p[0] if len(p) == 1 else tuple(p)
               for p in parts])


def _norm(spec: P, ndim: int) -> tuple:
    parts = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(None if not _names(p) else
                 (_names(p) if len(_names(p)) > 1 else _names(p)[0])
                 for p in parts)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def is_sharded(spec: P) -> bool:
    return any(_names(p) for p in spec)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The port's ``NamedSharding``: a mesh and a spec."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def local_block(x, mesh, spec: P) -> torch.Tensor:
    """The rank's block of ``x`` under ``spec``: a ``DTensor``'s local
    tensor (its placement must be ``spec``'s, else ``ValueError``), or the
    block sliced out of a plain full tensor (a view), as ``shard_map``
    slices an unsharded input."""
    if is_dtensor(x):
        if x.device_mesh != mesh:
            raise ValueError(f"operand lives on mesh {x.device_mesh}, the "
                             f"access on {mesh}")
        if _norm(spec_of(x), x.ndim) != _norm(spec, x.ndim):
            raise ValueError(f"operand is placed {spec_of(x)}, the access "
                             f"wants {P(*_norm(spec, x.ndim))}")
        return x.to_local()
    for dim, entry in enumerate(spec):
        if not _names(entry):
            continue
        n = axes_size(mesh, entry)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {n} shards")
        size = x.shape[dim] // n
        x = x.narrow(dim, axis_index(mesh, entry) * size, size)
    return x


def from_local(local: torch.Tensor, mesh, spec: P, shape=None):
    """A ``DTensor`` from the rank's block (no check, no communication);
    a plain tensor when ``spec`` shards nothing (every rank holds the
    value)."""
    if not is_sharded(spec):
        return local
    from torch.distributed.tensor import DTensor
    if shape is None:
        shape = list(local.shape)
        for dim, entry in enumerate(spec):
            shape[dim] *= axes_size(mesh, entry)
    shape = torch.Size(shape)
    stride = [1] * len(shape)                   # contiguous, row-major
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * max(shape[i + 1], 1)
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=shape,
                              stride=tuple(stride))


def full_tree(tree):
    """``tree`` with every leaf whole: the ``DTensor`` leaves gathered
    (:func:`gather_tree` of their blocks, one collective per mesh axes
    and dtype for the leaves sharded on one dim: a superblock's weights
    in one), plain leaves as they are.  Differentiable: see
    :func:`gather_tree`."""
    leaves = [x for _, x in _leaves_with_path(tree)]
    meshes = {x.device_mesh for x in leaves if is_dtensor(x)}
    if not meshes:
        return tree
    if len(meshes) > 1:
        raise ValueError("full_tree needs the leaves on one mesh")
    local, specs = split_tree(tree)
    return gather_tree(local, specs, meshes.pop())


def is_expert_bank(path: str, ndim: int, start: int = 0) -> bool:
    """Whether the leaf at ``path`` is a MoE expert bank (``moe/wg``,
    ``wu`` or ``wo``, the expert dim at ``start``), as the parameter rules
    read it."""
    return ("moe" in path and path.rsplit("/", 1)[-1] in ("wg", "wu", "wo")
            and ndim - start >= 3)


def full_tensor(x) -> torch.Tensor:
    """The whole value of ``x``: a ``DTensor``'s blocks gathered on every
    rank (:func:`all_gather` per sharded dim), a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    mesh, spec = x.device_mesh, spec_of(x)
    out = x.to_local()
    for dim, entry in enumerate(spec):
        if _names(entry):
            out = all_gather(out, mesh, entry, dim)
    return out


def place(x, sharding: Sharding):
    """``x`` placed as ``sharding`` says: a plain tensor's block is copied
    out on each rank (nothing is sent; the full tensor can be freed); a
    ``DTensor`` already so placed is returned as it is, one placed
    otherwise is gathered and sliced again.  A spec that shards nothing
    gives a plain tensor."""
    mesh, spec = sharding.mesh, sharding.spec
    if is_dtensor(x):
        if x.device_mesh == mesh and \
                _norm(spec_of(x), x.ndim) == _norm(spec, x.ndim):
            return x
        x = full_tensor(x)
    if not is_sharded(spec):
        return x
    return from_local(local_block(x, mesh, spec).clone(), mesh, spec,
                      x.shape)


def select(x, i: int):
    """``x[i]`` for a plain tensor or a ``DTensor`` that does not shard its
    first dim (the block's row, placed one dim lower)."""
    if not is_dtensor(x):
        return x[i]
    spec = spec_of(x)
    if _names(spec[0]):
        raise ValueError(f"select would index the sharded dim 0 of {spec}")
    return from_local(x.to_local()[i], x.device_mesh, P(*spec[1:]),
                      x.shape[1:])


def stack(xs: Sequence):
    """``torch.stack`` of plain tensors, or of ``DTensor`` s placed alike
    (their blocks stacked, placed one dim higher)."""
    xs = list(xs)
    if not is_dtensor(xs[0]):
        return torch.stack(xs)
    spec = spec_of(xs[0])
    for x in xs[1:]:
        if not is_dtensor(x) or spec_of(x) != spec:
            raise ValueError("stack needs operands placed alike")
    return from_local(torch.stack([x.to_local() for x in xs]),
                      xs[0].device_mesh, P(None, *spec),
                      (len(xs),) + tuple(xs[0].shape))


def replicated(x) -> torch.Tensor:
    """The local value of an operand every rank holds whole: a plain
    tensor, or a ``DTensor`` replicated on every mesh dim."""
    if is_dtensor(x):
        if is_sharded(spec_of(x)):
            raise ValueError(f"operand is placed {spec_of(x)}; this access "
                             f"wants it replicated")
        return x.to_local()
    return x


def block_of(x):
    """This rank's block: a ``DTensor``'s local tensor, a plain tensor as
    it is."""
    return x.to_local() if is_dtensor(x) else x


def owned_block(x, dim: int):
    """``(local, base, n)``: the block of ``x`` along ``dim`` this rank
    owns, its first global index and its length.  A plain tensor is all
    owned; a ``DTensor`` must shard ``dim`` and nothing else."""
    if not is_dtensor(x):
        return x, 0, x.shape[dim]
    spec = _norm(spec_of(x), x.ndim)
    dim %= x.ndim
    if any(_names(p) for i, p in enumerate(spec) if i != dim):
        raise ValueError(f"operand is placed {P(*spec)}: only dim {dim} "
                         f"may be sharded here")
    local = x.to_local()
    n = local.shape[dim]
    return local, axis_index(x.device_mesh, spec[dim]) * n, n


def map_local(fn, x):
    """``fn`` on a plain tensor, or on a ``DTensor``'s block (placed
    alike): for elementwise casts."""
    if not is_dtensor(x):
        return fn(x)
    return from_local(fn(x.to_local()), x.device_mesh, spec_of(x), x.shape)


def tree_map(fn, tree, *rest):
    """Map over nested dicts, lists and NamedTuples of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        # jax names a NamedTuple field ".name" in a key path
        for name, v in zip(tree._fields, tree):
            yield from _leaves_with_path(v, path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def tree_paths(tree, fn):
    """``fn(path, leaf)`` over every leaf, ``path`` as the reference's
    ``_kp_str`` writes it (keys joined by ``/``)."""
    it = iter(fn("/".join(p), leaf) for p, leaf in _leaves_with_path(tree))
    return tree_map(lambda _: next(it), tree)


# ---------------------------------------------------------------------------
# Collectives (all_reduce over per-axis groups)
# ---------------------------------------------------------------------------

class CollectiveLog:
    """Per-process record of the port's collectives: ``calls``, ``bytes``
    and host ``seconds`` in all, ``counts[(op, shape, dtype)]`` (a
    ``psum_scatter`` by its input, the others by their result) and
    ``results`` (every one by its result).  A packed
    weight gather (:func:`gather_tree`) is one ``all_gather`` of a flat
    buffer; ``leaves[(shape, dtype)]`` counts the whole tensors such
    gathers rebuilt."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0
        self.counts: collections.Counter = collections.Counter()
        self.results: collections.Counter = collections.Counter()
        self.leaves: collections.Counter = collections.Counter()

    def add(self, op: str, x: torch.Tensor, seconds: float,
            result: torch.Tensor | None = None) -> None:
        """Record one collective on ``x``; ``results`` counts it by its
        result (``result``, else ``x``), as an HLO line names it (the
        roofline's collective bytes)."""
        self.calls += 1
        self.bytes += x.numel() * x.element_size()
        self.seconds += seconds
        self.counts[(op, tuple(x.shape), str(x.dtype))] += 1
        out = x if result is None else result
        self.results[(op, tuple(out.shape), str(out.dtype))] += 1

    def shapes(self) -> set:
        """The shapes of the collectives and of the leaves a packed gather
        rebuilt."""
        return ({shape for _, shape, _ in self.counts}
                | {shape for shape, _ in self.leaves})


LOG = CollectiveLog()


def _groups(mesh, axes) -> list:
    """The process groups a reduction over ``axes`` runs over: the default
    group when they are every axis of a mesh over the whole world (one
    collective), else each named axis's group in turn."""
    names = _names(axes)
    if set(names) == set(mesh.mesh_dim_names) and \
            mesh.size() == dist.get_world_size():
        return [None] if mesh.size() > 1 else []
    return [mesh.get_group(a) for a in names if axis_size(mesh, a) > 1]


def _all_reduce(x: torch.Tensor, mesh, axes, op, what: str) -> torch.Tensor:
    out = x.contiguous().clone()
    t0 = time.perf_counter()
    for group in _groups(mesh, axes):
        dist.all_reduce(out, op=op, group=group)
    LOG.add(what, out, time.perf_counter() - t0)
    return out


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over the ranks of ``axes`` (a new tensor; ``x`` untouched)."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM, "psum")


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MAX, "pmax")


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return psum(x, mesh, axes) / axes_size(mesh, axes)


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The blocks of ``axes`` concatenated along ``dim``, first axis major
    (``all_gather_into_tensor`` over each axis, the last first)."""
    for a in reversed(_names(axes)):
        n = axis_size(mesh, a)
        if n == 1:
            continue
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        t0 = time.perf_counter()
        dist.all_gather_into_tensor(out, src, group=mesh.get_group(a))
        LOG.add("all_gather", out, time.perf_counter() - t0)
        x = out.movedim(0, dim)
    return x


def psum_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``lax.psum_scatter(..., tiled=True)``: the sum over ``axes``, of
    which each rank keeps its block along ``dim``, first axis major
    (``reduce_scatter_tensor`` over each axis, the first first)."""
    for a in _names(axes):
        n = axis_size(mesh, a)
        if n == 1:
            continue
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        t0 = time.perf_counter()
        dist.reduce_scatter_tensor(out, src, group=mesh.get_group(a))
        LOG.add("psum_scatter", src, time.perf_counter() - t0, out)
        x = out.movedim(0, dim)
    return x


# ---------------------------------------------------------------------------
# Differentiable collectives (the mesh forward, the loss and the pipeline)
# ---------------------------------------------------------------------------

def split_tree(tree):
    """``(local, specs)``: each ``DTensor`` leaf's block (one
    ``to_local``, differentiable: the gradient of the block comes back as
    the ``DTensor`` leaf's, placed alike) and its :class:`P`; a plain
    leaf as it is, with ``P()``."""
    return (tree_map(block_of, tree),
            tree_map(lambda x: spec_of(x) if is_dtensor(x) else P(), tree))


def _zip_leaves(tree, specs) -> list:
    out: list = []
    tree_map(lambda x, s: out.append((x, s)), tree, specs)
    return out


def _gather_blocks(mesh, axes: tuple, dims: tuple, blocks) -> list:
    """The whole tensors of ``blocks`` (block ``i`` sharded on dim
    ``dims[i]`` over ``axes``), packed into one buffer: one
    :func:`all_gather`.  Each comes back contiguous, as a weight placed
    whole is: a matmul then reads the layout the one-device program
    reads, and sums in its order."""
    n = axes_size(mesh, axes)
    moved = [b.movedim(d, 0) for b, d in zip(blocks, dims)]
    buf = torch.cat([m.reshape(-1) for m in moved])
    got = all_gather(buf, mesh, axes, 0).view(n, -1)
    out, off = [], 0
    for m, d in zip(moved, dims):
        part = got[:, off:off + m.numel()]
        off += m.numel()
        out.append(part.reshape((n * m.shape[0],) + tuple(m.shape[1:]))
                   .movedim(0, d).contiguous())
        LOG.leaves[(tuple(out[-1].shape), str(out[-1].dtype))] += 1
    return out


class _Gather(torch.autograd.Function):
    """:func:`_gather_blocks` with its transpose.  The ranks an axis
    gathers over see one cotangent of the whole tensor (they compute the
    same activations from it), so each takes its owned slice: summing the
    slices would count a model-axis replica once per rank.  Over the axes
    of ``reduce`` the ranks hold partial cotangents (each its own batch
    block), which a ``psum`` adds first."""

    @staticmethod
    def forward(fctx, mesh, axes, dims, reduce, *blocks):
        fctx.mesh, fctx.axes, fctx.dims, fctx.reduce = mesh, axes, dims, \
            reduce
        fctx.sizes = [b.shape[d] for b, d in zip(blocks, dims)]
        fctx.set_materialize_grads(False)
        return tuple(_gather_blocks(mesh, axes, dims, blocks))

    @staticmethod
    def backward(fctx, *grads):
        mesh = fctx.mesh
        if fctx.reduce and set(fctx.reduce) == set(fctx.axes):
            return (None, None, None, None) + _scatter_blocks(
                mesh, fctx.axes, fctx.dims, fctx.sizes, grads)
        if fctx.reduce:
            live = [i for i, g in enumerate(grads) if g is not None]
            if live:
                flat = psum(torch.cat([grads[i].reshape(-1) for i in live]),
                            mesh, fctx.reduce)
                grads, off = list(grads), 0
                for i in live:
                    n = grads[i].numel()
                    grads[i] = flat[off:off + n].view(grads[i].shape)
                    off += n
        idx = axis_index(mesh, fctx.axes)
        out = [None if g is None else
               g.narrow(d, idx * n, n).clone(
                   memory_format=torch.contiguous_format)
               for g, d, n in zip(grads, fctx.dims, fctx.sizes)]
        return (None, None, None, None) + tuple(out)


def _scatter_blocks(mesh, axes: tuple, dims: tuple, sizes, grads) -> tuple:
    """The transpose of :func:`_gather_blocks` where every rank of
    ``axes`` holds a partial cotangent of the whole tensors: one
    :func:`psum_scatter` of them packed, each rank keeping its blocks."""
    n = axes_size(mesh, axes)
    live = [i for i, g in enumerate(grads) if g is not None]
    out: list = [None] * len(grads)
    if not live:
        return tuple(out)
    rows = torch.cat([grads[i].movedim(dims[i], 0).reshape(n, -1)
                      for i in live], dim=1)
    got = psum_scatter(rows, mesh, axes, 0)[0]
    off = 0
    for i in live:
        moved = list(grads[i].movedim(dims[i], 0).shape)
        moved[0] = sizes[i]
        k = math.prod(moved)
        out[i] = got[off:off + k].reshape(moved).movedim(0, dims[i]) \
            .contiguous()
        off += k
    return tuple(out)


def _gather(mesh, axes: tuple, dims: tuple, reduce, blocks) -> list:
    reduce = tuple(a for a in _names(reduce) if a in axes)
    if torch.is_grad_enabled() and any(b.requires_grad for b in blocks):
        return list(_Gather.apply(mesh, axes, dims, reduce, *blocks))
    return _gather_blocks(mesh, axes, dims, blocks)


def gather_tree(local, specs, mesh, *, reduce=()):
    """The whole value of each leaf of ``local`` (this rank's blocks,
    placed on ``mesh`` as the matching :class:`P` of ``specs`` says): the
    leaves sharded on one dim, over the same axes and of one dtype, in one
    :func:`all_gather`; a leaf sharded on several dims one gather per dim;
    a leaf its spec shards on nothing as it is.

    Differentiable: the cotangent of a whole leaf comes back to the block
    as this rank's owned slice of it (:class:`_Gather`); over the axes of
    ``reduce`` (the data axes, for a spec that shards a weight over them;
    the model axis too under tensor parallelism, where each rank's
    cotangent is its share) the partial cotangents are summed first, one
    ``psum_scatter`` where ``reduce`` covers every gathered axis.  A
    weight that no spec shards over the data axes is reduced over them by
    the train step."""
    pairs = _zip_leaves(local, specs)
    out = [x for x, _ in pairs]
    groups: dict = {}
    for i, (x, spec) in enumerate(pairs):
        dims = [(d, e) for d, e in enumerate(_norm(spec, x.ndim))
                if _names(e)]
        if len(dims) == 1:
            (d, e), = dims
            groups.setdefault((_names(e), x.dtype), []).append((i, d))
            continue
        for d, e in dims:
            out[i] = _gather(mesh, _names(e), (d,), reduce, [out[i]])[0]
    for (axes, _), items in groups.items():
        got = _gather(mesh, axes, tuple(d for _, d in items), reduce,
                      [out[i] for i, _ in items])
        for (i, _), y in zip(items, got):
            out[i] = y
    it = iter(out)
    return tree_map(lambda _: next(it), local)


class _GlobalSum(torch.autograd.Function):
    """:func:`psum` whose transpose hands each rank the cotangent as it
    is: every rank holds the same total, and each rank's partial enters
    it once."""

    @staticmethod
    def forward(fctx, x, mesh, axes):
        return psum(x, mesh, axes)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


def global_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over the ranks of ``axes`` of per-rank partials (a loss's
    numerator over the data axes, the expert-parallel layer's output over
    the model axis), differentiable (:class:`_GlobalSum`): a rank's
    gradient is then its own partial's (Megatron's "``psum`` forward,
    identity backward")."""
    if not _names(axes):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GlobalSum.apply(x, mesh, axes)
    return psum(x, mesh, axes)


class _SumGrads(torch.autograd.Function):
    """The identity whose transpose is a :func:`psum`: the ranks of
    ``axes`` hold the same ``x`` and each feeds it to its own part of a
    sum (its experts), so the cotangent of ``x`` is the sum of theirs."""

    @staticmethod
    def forward(fctx, x, mesh, axes):
        fctx.mesh, fctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return psum(g, fctx.mesh, fctx.axes), None, None


def sum_grads(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` as it is, its cotangent summed over the ranks of ``axes``
    (:class:`_SumGrads`; Megatron's "identity forward, ``psum``
    backward"): the entry of a path each rank of ``axes`` evaluates in
    part, left through :func:`global_sum`."""
    if _names(axes) and torch.is_grad_enabled() and x.requires_grad:
        return _SumGrads.apply(x, mesh, axes)
    return x


# -- tensor parallelism over the model axis ---------------------------------
#
# Under tensor parallelism every rank's cotangent is its SHARE: the
# gradient of a value the ranks of the model axis hold alike is the sum
# of theirs, that of a rank's own block (of the sequence, the heads, the
# vocab, a weight) its own.  Each collective below then transposes to
# its linear transpose, whether the sequence divides the axis or not.

class _AllGatherDim(torch.autograd.Function):
    """:func:`all_gather` along ``dim``; transpose :func:`psum_scatter`."""

    @staticmethod
    def forward(fctx, x, mesh, axes, dim):
        fctx.mesh, fctx.axes, fctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(fctx, g):
        return psum_scatter(g, fctx.mesh, fctx.axes, fctx.dim), None, None, \
            None


class _ReduceScatterDim(torch.autograd.Function):
    """:func:`psum_scatter` along ``dim``; transpose :func:`all_gather`."""

    @staticmethod
    def forward(fctx, x, mesh, axes, dim):
        fctx.mesh, fctx.axes, fctx.dim = mesh, axes, dim
        return psum_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(fctx, g):
        return all_gather(g, fctx.mesh, fctx.axes, fctx.dim), None, None, \
            None


class _AllSum(torch.autograd.Function):
    """:func:`psum` whose transpose is a :func:`psum`."""

    @staticmethod
    def forward(fctx, x, mesh, axes):
        fctx.mesh, fctx.axes = mesh, axes
        return psum(x, mesh, axes)

    @staticmethod
    def backward(fctx, g):
        return psum(g, fctx.mesh, fctx.axes), None, None


class _Share(torch.autograd.Function):
    """The identity whose transpose divides by the axes' size."""

    @staticmethod
    def forward(fctx, x, n):
        fctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return g / fctx.n, None


def _live(mesh, axes) -> bool:
    return axes_size(mesh, axes) > 1


def _grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def gather_seq(x: torch.Tensor, mesh, axes, dim: int = 1) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``dim`` (the sequence) gathered
    (``all_gather``); its cotangent reduce-scattered back to the blocks
    (Megatron-SP's entry into a tensor-parallel layer)."""
    if not _live(mesh, axes):
        return x
    if _grad(x):
        return _AllGatherDim.apply(x, mesh, axes, dim)
    return all_gather(x, mesh, axes, dim)


def scatter_seq(x: torch.Tensor, mesh, axes, dim: int = 1) -> torch.Tensor:
    """The sum of the ranks' partial ``x``, of which each keeps its block
    along ``dim`` (``reduce_scatter``); its cotangent gathered
    (Megatron-SP's exit from a tensor-parallel layer)."""
    if not _live(mesh, axes):
        return x
    if _grad(x):
        return _ReduceScatterDim.apply(x, mesh, axes, dim)
    return psum_scatter(x, mesh, axes, dim)


def all_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (``all_reduce``), its cotangent
    summed alike: the exit of a tensor-parallel layer whose sequence the
    axis does not split, and the vocab-parallel loss's sums."""
    if not _live(mesh, axes):
        return x
    if _grad(x):
        return _AllSum.apply(x, mesh, axes)
    return psum(x, mesh, axes)


def share(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` as it is, its cotangent divided by the size of ``axes``: a
    value every rank of ``axes`` computes alike (the loss), whose
    gradient the ranks' shares add up to once."""
    n = axes_size(mesh, axes)
    if n == 1 or not _grad(x):
        return x
    return _Share.apply(x, n)


def _ppermute(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    """Rank ``i`` of ``axis`` receives rank ``i - shift``'s ``x`` and sends
    its own to ``i + shift`` (cyclic): one ``all_to_all_single`` over the
    axis's group, every split empty but the one peer's."""
    n = axis_size(mesh, axis)
    x = x.contiguous()
    if n == 1 or shift % n == 0:
        return x.clone()
    i = mesh.get_local_rank(axis)
    ins, outs = [0] * n, [0] * n
    ins[(i + shift) % n] = x.numel()
    outs[(i - shift) % n] = x.numel()
    out = torch.empty_like(x)
    t0 = time.perf_counter()
    dist.all_to_all_single(out.view(-1), x.view(-1), outs, ins,
                           group=mesh.get_group(axis))
    LOG.add("ppermute", x, time.perf_counter() - t0)
    return out


class _PPermute(torch.autograd.Function):
    """``lax.ppermute`` by ``shift`` along one axis; its transpose is the
    inverse permutation (by ``-shift``)."""

    @staticmethod
    def forward(fctx, x, mesh, axis, shift):
        fctx.mesh, fctx.axis, fctx.shift = mesh, axis, shift
        return _ppermute(x, mesh, axis, shift)

    @staticmethod
    def backward(fctx, g):
        return _ppermute(g, fctx.mesh, fctx.axis, -fctx.shift), None, None, \
            None


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1
             ) -> torch.Tensor:
    """Send ``x`` ``shift`` ranks on along mesh ``axis`` (cyclic) and
    receive from ``shift`` ranks back; differentiable
    (:class:`_PPermute`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _PPermute.apply(x, mesh, axis, shift)
    return _ppermute(x, mesh, axis, shift)


class Axes:
    """What a :func:`shard_map` body gets to talk to its mesh: the shard
    index and the reductions over named axes (``lax.axis_index``,
    ``psum``, ``pmean``, ``psum_scatter``)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def index(self, axes) -> int:
        return axis_index(self.mesh, axes)

    def psum(self, x, axes):
        return psum(x, self.mesh, axes)

    def pmean(self, x, axes):
        return pmean(x, self.mesh, axes)

    def psum_scatter(self, x, axis, dim: int):
        return psum_scatter(x, self.mesh, axis, dim)


def shard_map(f, *, mesh, in_specs, out_specs):
    """``shard_map``: ``f(axes, *blocks)`` runs on each rank's blocks of
    the operands (:func:`local_block`: a ``DTensor`` placed as its spec
    says, or a plain full tensor sliced) with an :class:`Axes`; its
    outputs are placed per ``out_specs`` (:func:`from_local`: a spec that
    shards nothing gives the plain value every rank holds)."""
    ax = Axes(mesh)

    def mapped(*args):
        blocks = [local_block(a, mesh, s) for a, s in zip(args, in_specs)]
        out = f(ax, *blocks)
        if isinstance(out_specs, P):
            return from_local(out, mesh, out_specs)
        return tuple(from_local(o, mesh, s) for o, s in zip(out, out_specs))

    return mapped


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, on the resolved device (cuda unless the caller asks
    for the CPU).  The caller creates the group; its world size must be
    the mesh's size."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                         f"process group has {dist.get_world_size()}")
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


# ---------------------------------------------------------------------------
# ShardCtx
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh + axis-role bundle threaded through models / serve."""
    mesh: Any
    data_axes: tuple = ()
    model_axis: str | None = None
    seq_axes: tuple = ()
    fsdp: bool = False

    # -- sizes ---------------------------------------------------------------
    def _axis_size(self, axis) -> int:
        if self.mesh is None or axis is None:
            return 1
        return axis_size(self.mesh, axis)

    @property
    def model_size(self) -> int:
        return self._axis_size(self.model_axis)

    @property
    def data_size(self) -> int:
        return math.prod(self._axis_size(a) for a in self.data_axes) \
            if self.data_axes else 1

    @property
    def seq_shard_acts(self) -> bool:
        """Megatron-SP: sequence-shard the residual stream between blocks."""
        return self.mesh is not None and self.model_axis is not None

    # -- spec helpers --------------------------------------------------------
    def model_if_divisible(self, dim: int):
        """model_axis iff ``dim`` splits evenly across it, else None."""
        if (self.mesh is None or self.model_axis is None or dim is None
                or dim % self.model_size or dim < self.model_size):
            return None
        return self.model_axis

    def batch_spec(self, *rest) -> P:
        """P for a batch-leading activation: (B over data axes, *rest)."""
        return P(self.data_axes if self.data_axes else None, *rest)

    def sharding(self, spec: P) -> Sharding:
        if self.mesh is None:
            raise ValueError("sharding() needs a mesh")
        return Sharding(self.mesh, spec)

    def constrain(self, x, spec: P):
        if self.mesh is None:
            return x
        return place(x, self.sharding(spec))

    def vx_seq_shard(self, axis: int = -3):
        """``vx.Shard`` for a buffer axis sharded over this context's
        sequence axes (long-context serving: B=1, the KV sequence dim
        takes every axis).  ``axis`` counts from the end (-3 is the
        sequence dim of an ``(NS, B, Sc, K, 2D)`` cache leaf).  None when
        mesh-less or no axis plays the sequence role."""
        if self.mesh is None:
            return None
        axes = self.seq_axes or (self.data_axes
                                 + ((self.model_axis,)
                                    if self.model_axis else ()))
        if not axes:
            return None
        from repro_torch.vx.program import Shard
        return Shard(axes=tuple(axes), axis=axis, mesh=self.mesh)

    def vx_pool_shard(self, axis: int = -4):
        """``vx.Shard`` for a PAGED-POOL leaf sharded on its page axis (the
        shared KV page pool is the memory ceiling, so its physical pages
        spread across the mesh and ``vx.Paged`` gathers run shard-locally
        on the owned page block).  Same axis roles as
        :meth:`vx_seq_shard`; -4 is the page axis of an ``(NS, P,
        page_size, K, 2D)`` pool leaf."""
        return self.vx_seq_shard(axis)


@dataclasses.dataclass(frozen=True)
class RankLocal(ShardCtx):
    """The context the mesh forward hands its layers: every operand is
    this rank's own (its block of the batch, whole weights), so the
    layers run as on one device (no mesh), but for two things.
    ``experts`` is the mesh's context: the layer's expert banks are this
    rank's block of experts over its model axis (resident, never
    gathered), which it runs expert-parallel (``models/moe.py``).  ``tp``
    is the mesh's context under tensor parallelism: a layer whose
    weights arrive as this rank's model-axis blocks (``wq`` / ``wi``
    columns, ``wo`` / ``wkv`` / router rows, the vocab rows of the
    embedding and head) computes its part and leaves through
    :func:`scatter_seq` (``seq``: the residual stream is this rank's
    block of the sequence) or :func:`all_sum`; a layer whose weights
    arrive whole runs on the whole sequence and keeps its block."""
    experts: Any = None
    tp: Any = None
    seq: bool = False

    @property
    def tp_axis(self):
        return self.tp.model_axis if self.tp is not None else None

    @property
    def tp_size(self) -> int:
        return self.tp.model_size if self.tp is not None else 1

    @property
    def tp_index(self) -> int:
        return axis_index(self.tp.mesh, self.tp.model_axis) \
            if self.tp is not None else 0


def tp_enter(x: torch.Tensor, rl) -> torch.Tensor:
    """A tensor-parallel layer's operand from the residual stream: the
    whole sequence (:func:`gather_seq` of the rank's block), or ``x``."""
    if not rl.seq:
        return x
    return gather_seq(x, rl.tp.mesh, rl.tp_axis, 1)


def tp_leave(y: torch.Tensor, rl, partial: bool = True) -> torch.Tensor:
    """A layer's output back into the residual stream: a ``partial`` sum
    (each rank its part) summed and, with ``seq``, scattered to the
    rank's block of the sequence; a whole output (every rank the same)
    cut to that block."""
    if not partial:
        if not rl.seq:
            return y
        n = y.shape[1] // rl.tp_size
        return y.narrow(1, rl.tp_index * n, n)
    if rl.seq:
        return scatter_seq(y, rl.tp.mesh, rl.tp_axis, 1)
    # summed in float32, rounded once to y's dtype (as one matmul's
    # accumulator is): the decode steps' exits
    return all_sum(y.float(), rl.tp.mesh, rl.tp_axis).to(y.dtype)


def wide_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` (``w`` 2-D) in the type a single position's partial
    products are computed in before their sum is rounded once to ``a``'s
    dtype: float32 for bf16 / fp16, float64 for float32 (a float32 part
    carries its own accumulation's rounding, as large as the one-device
    product's).  On the card a bf16 / fp16 product is one GEMM that
    accumulates into a float32 output (``torch.mm``'s ``out_dtype``),
    the weight read as it is; elsewhere both operands are widened
    first."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) and \
            w.dtype == a.dtype and _mm_out_dtype():
        return torch.mm(a.reshape(-1, a.shape[-1]), w,
                        out_dtype=torch.float32).reshape(*a.shape[:-1], -1)
    t = torch.float64 if a.dtype == torch.float32 else torch.float32
    return a.to(t) @ w.to(t)


@functools.lru_cache(maxsize=None)
def _mm_out_dtype() -> bool:
    """Whether this torch has ``torch.mm``'s ``out_dtype`` overload."""
    return "dtype" in torch.ops.aten.mm.overloads()


def tp_block(x: torch.Tensor, rl, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of a value every rank of the model
    axis holds whole (a replicated vector cut to the rank's channels): a
    view, whose gradient is zero outside the block, so the train step's
    model-axis sum of a replicated leaf's gradient rebuilds the whole
    one."""
    n = x.shape[dim] // rl.tp_size
    return x.narrow(dim, rl.tp_index * n, n)


def resident_axis(ctx):
    """The model axis whose blocks of the expert banks stay resident under
    ``ctx`` (a :class:`RankLocal` whose mesh context has a model axis of
    more than one rank: the MoE layer runs expert-parallel), else None."""
    experts = getattr(ctx, "experts", None)
    if experts is None or experts.model_size <= 1:
        return None
    return experts.model_axis


def meshed(ctx) -> bool:
    """Whether ``ctx`` (a ``ShardCtx``, or None) carries a mesh."""
    return ctx is not None and getattr(ctx, "mesh", None) is not None


def local_ctx() -> ShardCtx:
    """Single-process / single-device context (mesh-less no-op specs)."""
    return ShardCtx(mesh=None, data_axes=(), model_axis=None)


# ---------------------------------------------------------------------------
# Parameter spec rules
# ---------------------------------------------------------------------------

def _pick_model_dim(path: str, shape: tuple, start: int, ctx: ShardCtx):
    """Dim index to place the model axis on, or None (the reference's
    rules, in its order): MoE expert banks shard the expert dim; ``wo``
    output projections the input dim; ``wkv`` the input dim (the
    interleaved [k|v] beat stays whole) or nothing; otherwise the largest
    trailing dim the model axis divides."""
    ms = ctx.model_size
    nd = len(shape)
    if nd - start < 2:          # vectors (norm gains, biases): replicate
        return None

    def ok(i):
        return shape[i] % ms == 0 and shape[i] >= ms

    leaf = path.rsplit("/", 1)[-1]
    if "moe" in path and leaf in ("wg", "wu", "wo") and nd - start >= 3:
        if ok(start):
            return start
    if leaf == "wo" and nd - start == 2 and ok(start):
        return start
    if leaf == "wkv" and nd - start == 2:
        return start if ok(start) else None
    best = None
    for i in range(start, nd):
        if ok(i) and (best is None or shape[i] >= shape[best]):
            best = i
    return best


def param_spec(path: str, shape: tuple, ctx: ShardCtx) -> P:
    """P for one parameter leaf."""
    if ctx.mesh is None:
        return P()
    # block stacks carry a leading superblock dim that never shards
    stacked = path.startswith("blocks") or "/blocks/" in path
    start = 1 if (stacked and len(shape) >= 2) else 0
    parts: list = [None] * len(shape)
    if ctx.model_axis is not None:
        md = _pick_model_dim(path, shape, start, ctx)
        if md is not None:
            parts[md] = ctx.model_axis
    spec = P(*parts)
    if ctx.fsdp:
        spec = add_data_sharding(spec, shape, ctx, start=start)
    return spec


def tree_param_specs(params, ctx: ShardCtx):
    """Tree of P mirroring ``params``."""
    return tree_paths(params, lambda path, leaf: param_spec(
        path, tuple(leaf.shape), ctx))


def add_data_sharding(spec: P, shape: tuple, ctx: ShardCtx, *,
                      start: int = 0) -> P:
    """Additionally shard ``spec`` over the data axes (ZeRO-1 / FSDP): the
    first dim >= ``start`` that is unsharded and splits evenly across the
    combined data axes; ``spec`` unchanged when none fits."""
    if ctx.mesh is None or not ctx.data_axes:
        return spec
    ds = ctx.data_size
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i in range(start, len(shape)):
        if parts[i] is None and shape[i] % ds == 0 and shape[i] >= ds:
            parts[i] = ctx.data_axes if len(ctx.data_axes) > 1 \
                else ctx.data_axes[0]
            return P(*parts)
    return spec


# ---------------------------------------------------------------------------
# Misc helpers
# ---------------------------------------------------------------------------

def replicate(x, ctx: ShardCtx):
    """A tree replicated on ctx's mesh: every rank keeps its whole value
    (plain tensors; a ``DTensor`` leaf is gathered)."""
    if ctx.mesh is None:
        return x
    return tree_map(full_tensor, x)


def spec_tree_shardings(specs, ctx: ShardCtx):
    """Map a tree of P to :class:`Sharding` s."""
    if ctx.mesh is None:
        return None
    return map_specs(ctx.sharding, specs)


def map_specs(fn, specs):
    """``fn`` over the leaves (:class:`P` or :class:`Sharding`) of a tree
    of specs."""
    if isinstance(specs, (P, Sharding)):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, v) for v in specs))
    return type(specs)(map_specs(fn, v) for v in specs)


def place_tree(tree, shardings):
    """:func:`place` each leaf of ``tree`` as the matching leaf of a tree
    of :class:`Sharding` s says."""
    it = iter(_sharding_leaves(shardings))
    return tree_map(lambda x: place(x, next(it)), tree)


def _sharding_leaves(tree):
    if isinstance(tree, Sharding):
        return [tree]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _sharding_leaves(v)]
    return [s for v in tree for s in _sharding_leaves(v)]


def local_nbytes(tree) -> int:
    """Bytes this rank holds of a tree (a ``DTensor`` counts its block)."""
    total = 0
    for _, x in _leaves_with_path(tree):
        if isinstance(x, torch.Tensor):
            t = x.to_local() if is_dtensor(x) else x
            total += t.numel() * t.element_size()
    return total
