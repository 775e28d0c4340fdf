"""repro_torch.vx — the declarative vector-access API (port of ``repro.vx``).

One spec type per access, a few verbs, one policy::

    from repro_torch import vx

    k, v = vx.transpose(vx.Segment(n=2 * d, fields=2), kv_beat)
    beat = vx.transpose(vx.Segment(n=2 * d, fields=2), [k, v])

    pg   = vx.Paged(page_size=16, pages=8, trail=2)
    seqs = vx.gather(pg, pool, table=tables)               # paged read
    pool = vx.scatter(pg, pool, beats, table=tables, pos=pos)  # append
    alls = vx.gather_many(pg, pools, table=tables)         # ONE program

    with vx.use("kernel"):       # CUDA kernels for CUDA tensors
        ...

This slice covers ``Segment`` and float ``Paged`` specs; the rest of the
reference's vx layer waits for later slices (ROADMAP.md, queue A).
"""
from repro_torch.vx import lower, program
from repro_torch.vx._dispatch import (gather, gather_many, scatter,
                                      transpose, warm)
from repro_torch.vx.cache import PLANS, PlanCache
from repro_torch.vx.policy import (IMPLS, MIN_FUSED_ELEMS, Policy, current,
                                   resolve, use)
from repro_torch.vx.program import Program, Txn
from repro_torch.vx.spec import AccessSpec, Paged, Segment

__all__ = [
    "AccessSpec", "Segment", "Paged",
    "gather", "scatter", "transpose", "gather_many", "warm",
    "Policy", "use", "current", "resolve",
    "PLANS", "PlanCache", "Program", "Txn", "program", "lower",
    "MIN_FUSED_ELEMS", "IMPLS",
]
