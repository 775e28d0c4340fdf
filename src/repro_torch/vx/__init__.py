"""repro_torch.vx — the declarative vector-access API (port of ``repro.vx``).

One spec type per access, a few verbs, one policy::

    from repro_torch import vx

    k, v = vx.transpose(vx.Segment(n=2 * d, fields=2), kv_beat)
    beat = vx.transpose(vx.Segment(n=2 * d, fields=2), [k, v])

    spec = vx.Strided(n=64, stride=4, offset=2, vl=8)
    dense = vx.gather(spec, window)                        # strided load
    win2  = vx.scatter(spec, window, dense)                # strided store
    outs  = vx.gather_many([spec_a, spec_b], windows)      # ONE launch
    out   = vx.gather(vx.Strided(n=64, stride=vx.BANK, vl=8), window,
                      stride=torch.tensor(s))              # plan bank

    pg   = vx.Paged(page_size=16, pages=8, trail=2)
    seqs = vx.gather(pg, pool, table=tables)               # paged read
    pool = vx.scatter(pg, pool, beats, table=tables, pos=pos)  # append
    alls = vx.gather_many(pg, pools, table=tables)         # ONE program
    aos  = vx.scatter_many(vx.Segment(n=2 * d, fields=2),
                           [[k0, v0], [k1, v1]])           # ONE interleave
    seqs = vx.gather(pg, qpool, table=tables, scales=scl)  # int8 / fp8
    qpool, scl = vx.scatter(pg, qpool, beats, table=tables, pos=pos,
                            scales=scl)                    # widen + write

    ix = vx.Indexed(n=64)
    out = vx.gather(ix, buf, shift=shift, valid=valid)     # raw GSN
    pay, occ = vx.scatter(ix, None, x, shift=s, valid=v)   # raw SSN
    packed, pv = vx.compact(vx.Compact(n=128), mask, rows) # MoE pack
    back = vx.scatter(vx.Compact(n=128), mask, packed)     # and expand
    ids = vx.compact(vx.Compact(n=128, cap=32), mask)      # packed ids

    with vx.use("kernel"):       # CUDA kernels for CUDA tensors
        ...

    sh = vx.Shard(axes=("s",), axis=-1, mesh=mesh)         # DeviceMesh
    out = vx.gather(spec, window, shard=sh)                # shard-local

The port covers ``Strided`` (static and runtime ``BANK`` strides),
``Segment``, ``Indexed``, ``Compact`` and ``Paged`` specs (float and
quantized pools) and every verb of the reference.  ``shard=`` lowers the
strided gather / scatter, the segment transposition and the paged gather
shard-locally on each rank's block (vx/lower.py): an operand is a
``DTensor`` placed as the shard says, or a plain full tensor that each
rank slices.

The reference's deprecated shims, ``repro.kernels.ops`` and
``repro.core.drom`` (impl-string wrappers that only warn and delegate to
``vx``; the reference's CI turns their warnings into errors), have no
port: callers use the verbs above, by the migration map in
``src/repro/kernels/ops.py:10-24`` (for example ``gather_strided(w, s, o,
vl, impl=i)`` -> ``vx.gather(vx.Strided(n, s, vl, o), w, policy=i)``).
"""
from repro_torch.vx import lower, program
from repro_torch.vx._dispatch import (compact, gather, gather_many,
                                      scatter, scatter_many, transpose,
                                      warm)
from repro_torch.vx.cache import PLANS, PlanCache
from repro_torch.vx.policy import (BANK_FIELDS, BANK_STRIDES, IMPLS,
                                   MIN_FUSED_ELEMS, Policy, current, resolve,
                                   use)
from repro_torch.vx.program import Program, Shard, Txn
from repro_torch.vx.spec import (BANK, AccessSpec, Compact, Indexed, Paged,
                                 Segment, Strided)

__all__ = [
    "AccessSpec", "Strided", "Segment", "Indexed", "Compact", "Paged",
    "BANK", "gather", "scatter", "transpose", "compact", "gather_many",
    "scatter_many", "warm",
    "Policy", "use", "current", "resolve",
    "PLANS", "PlanCache", "Shard", "Program", "Txn", "program", "lower",
    "MIN_FUSED_ELEMS", "BANK_STRIDES", "BANK_FIELDS", "IMPLS",
]
