"""Port parity for ``vx.gather(Indexed)`` on host routings whose lanes
collide: the static-routing arm of ``vx/lower._idx_gather`` takes each
output lane from the counts plan's table ``where(valid, source, -1)``,
which names the lane the reference's layer loop delivers for any counts
(the plan bodies, B11 and the reference's, refuse such plans).

Each case goes through the port under ``ref``, ``kernel`` and
``kernel_dynamic`` and through ``repro.vx.gather`` under ``ref``,
``pallas`` and ``pallas_dynamic``, bit for bit, with the routing given
both as ``shift=`` / ``valid=`` numpy operands and folded into the spec
as ``Indexed(n, routing=...)``: the example of a colliding routing over
four lanes, and numpy-seeded random routings at widths 4, 96, 100 and
256 (shifts in [0, 4), about half the lanes valid).  The arm is torch ops
under every policy: no kernel wrapper is called and nothing launches.
"""
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal
from repro_torch import vx
from repro_torch.kernels import moe_compact, shift_gather, shift_scatter
from test_torch_indexed import jnp_of, rand

POLICIES = [("ref", "ref"), ("kernel", "pallas"),
            ("kernel_dynamic", "pallas_dynamic")]
WRAPPERS = shift_gather.KERNELS + shift_scatter.KERNELS + moe_compact.KERNELS


def colliding_routings(n, seed, count=4):
    """``count`` numpy-seeded host routings over n lanes whose GSN counts
    plan has conflicts: shifts in [0, 4), about half the lanes valid."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        shift = rng.integers(0, 4, n).astype(np.int32)
        valid = rng.random(n) < 0.5
        if shift_gather.host_plan(shift, valid, gather=True).conflict:
            out.append((shift, valid))
    return out


def check_against_reference(x, shift, valid):
    """Every policy and both forms of the routing against the reference,
    bit for bit, with no kernel wrapper reached."""
    from repro import vx as jvx
    n = x.shape[-1]
    routing = (tuple(int(s) for s in shift), tuple(bool(v) for v in valid))
    jx = jnp_of(x)
    for mine, theirs in POLICIES:
        want = np.asarray(jvx.gather(jvx.Indexed(n=n), jx, shift=shift,
                                     valid=valid, policy=theirs))
        folded = np.asarray(jvx.gather(jvx.Indexed(n=n, routing=routing), jx,
                                       policy=theirs))
        np.testing.assert_array_equal(folded.view(want.dtype), want)
        before = [(f.calls, f.launches) for f in WRAPPERS]
        got = vx.gather(vx.Indexed(n=n), x, shift=shift, valid=valid,
                        policy=mine)
        got_folded = vx.gather(vx.Indexed(n=n, routing=routing), x,
                               policy=mine)
        assert [(f.calls, f.launches) for f in WRAPPERS] == before, mine
        assert_bits_equal(got, want)
        assert_bits_equal(got_folded, want)


def test_colliding_example_matches_reference():
    """Lanes 0 and 1 both land on lane 0: the reference keeps lane 1's
    element there, under every policy and in both forms."""
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    shift, valid = np.array([0, 1, 0, 0]), np.array([1, 1, 0, 0], bool)
    assert shift_gather.host_plan(shift, valid, gather=True).conflict
    check_against_reference(x, shift, valid)
    got = vx.gather(vx.Indexed(n=4), x, shift=shift, valid=valid)
    assert got.tolist() == [[1, 0, 0, 0], [5, 0, 0, 0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [4, 96, 100, 256])
def test_colliding_random_routings_match_reference(n, dtype):
    x = rand(n + 3, (3, n), dtype)
    for shift, valid in colliding_routings(n, 40 * n):
        check_against_reference(x, shift, valid)


def test_colliding_routing_equals_tensor_counts():
    """The static arm equals the dynamic network on the same counts as
    tensors (what the reference's two arms agree on), and the executor is
    built once per routing."""
    n = 96
    x = rand(5, (2, n), "float32")
    shift, valid = colliding_routings(n, 7, count=1)[0]
    dyn = vx.gather(vx.Indexed(n=n), x, shift=torch.from_numpy(shift),
                    valid=torch.from_numpy(valid), policy="ref")
    vx.PLANS.clear()
    static = vx.gather(vx.Indexed(n=n), x, shift=shift, valid=valid)
    misses = vx.PLANS.stats()["misses"]
    assert_bits_equal(static, dyn)
    again = vx.gather(vx.Indexed(n=n), x, shift=shift, valid=valid)
    assert vx.PLANS.stats()["misses"] == misses
    assert_bits_equal(again, dyn)
