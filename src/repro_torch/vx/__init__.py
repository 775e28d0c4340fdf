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

    ix = vx.Indexed(n=64)
    out = vx.gather(ix, buf, shift=shift, valid=valid)     # raw GSN
    pay, occ = vx.scatter(ix, None, x, shift=s, valid=v)   # raw SSN
    packed, pv = vx.compact(vx.Compact(n=128), mask, rows) # MoE pack
    back = vx.scatter(vx.Compact(n=128), mask, packed)     # and expand
    ids = vx.compact(vx.Compact(n=128, cap=32), mask)      # packed ids

    with vx.use("kernel"):       # CUDA kernels for CUDA tensors
        ...

The port covers ``Strided`` (static and runtime ``BANK`` strides),
``Segment``, ``Indexed``, ``Compact`` and float ``Paged`` specs; the rest
of the reference's vx layer (``scatter_many``, quantized pools, sharded
lowering) waits for later slices (ROADMAP.md, queue A).
"""
from repro_torch.vx import lower, program
from repro_torch.vx._dispatch import (compact, gather, gather_many,
                                      scatter, transpose, warm)
from repro_torch.vx.cache import PLANS, PlanCache
from repro_torch.vx.policy import (BANK_FIELDS, BANK_STRIDES, IMPLS,
                                   MIN_FUSED_ELEMS, Policy, current, resolve,
                                   use)
from repro_torch.vx.program import Program, Txn
from repro_torch.vx.spec import (BANK, AccessSpec, Compact, Indexed, Paged,
                                 Segment, Strided)

__all__ = [
    "AccessSpec", "Strided", "Segment", "Indexed", "Compact", "Paged",
    "BANK", "gather", "scatter", "transpose", "compact", "gather_many",
    "warm",
    "Policy", "use", "current", "resolve",
    "PLANS", "PlanCache", "Program", "Txn", "program", "lower",
    "MIN_FUSED_ELEMS", "BANK_STRIDES", "BANK_FIELDS", "IMPLS",
]
