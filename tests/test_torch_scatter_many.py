"""Port parity for ``vx.scatter_many``, the step-fused segment store: same
shape SoA groups interleaved in ONE call of the segment store (B2 under
``kernel``, B7 under ``kernel_dynamic``), one AoS array per group.

The reference's ``tests/test_vx_api.py::test_segment_many_match_legacy``
pattern: ``gather_many`` splits A arrays, ``scatter_many`` packs the groups
back; under ``ref``, ``kernel`` and ``kernel_dynamic`` the port's result
equals ``repro.vx.scatter_many``'s (``ref``, ``pallas``,
``pallas_dynamic``) bit for bit, the inputs, and the per-group
``vx.transpose``.  On the CPU the kernel policies reach the wrapper once
per call (its plain version: no launch).  No tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, to_np, to_torch
from repro import vx as jvx
from repro_torch import vx
from repro_torch.kernels import segment

IMPLS = {"ref": "ref", "kernel": "pallas", "kernel_dynamic": "pallas_dynamic"}
CASES = [(2, 32, 3, "float32"), (2, 64, 1, "float32"), (3, 16, 4, "int32"),
         (4, 8, 5, "bfloat16"), (2, 128, 28, "bfloat16")]


def _aos(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    a = rng.normal(size=shape).astype(np.float32)
    return to_np(torch.from_numpy(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("fields,m,A,dtype", CASES)
def test_scatter_many_matches_reference(impl, fields, m, A, dtype):
    spec = vx.Segment(n=fields * m, fields=fields)
    jspec = jvx.Segment(n=fields * m, fields=fields)
    aos = [_aos(10 + a, (2, 3, fields * m), dtype) for a in range(A)]
    groups = vx.gather_many(spec, [to_torch(a) for a in aos], policy=impl)
    jgroups = jvx.gather_many(jspec, [jnp.asarray(a) for a in aos],
                              policy=IMPLS[impl])
    for g, jg in zip(groups, jgroups):
        for f, jf in zip(g, jg):
            assert_bits_equal(f, jf)
    segment.reset_counts()
    back = vx.scatter_many(spec, groups, policy=impl)
    calls = (segment.interleave.calls, segment.interleave_dynamic.calls)
    want = jvx.scatter_many(jspec, jgroups, policy=IMPLS[impl])
    assert len(back) == len(want) == A
    for a, (got, w) in enumerate(zip(back, want)):
        assert_bits_equal(got, w)
        assert_bits_equal(got, aos[a])
        assert_bits_equal(got, vx.transpose(spec, groups[a], policy=impl))
    assert calls == {"ref": (0, 0), "kernel": (1, 0),
                     "kernel_dynamic": (1, 1)}[impl]
    assert segment.interleave.launches == 0      # never on the CPU


def test_scatter_many_needs_a_segment_spec():
    with pytest.raises(TypeError):
        vx.scatter_many(vx.Strided(n=8, stride=2, vl=4),
                        [[torch.zeros(4), torch.zeros(4)]])
