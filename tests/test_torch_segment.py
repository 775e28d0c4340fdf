"""Port parity for kernels/segment.py (kernels B1 deinterleave and B2
interleave).

On the CPU the port's wrappers run their plain version (compiled shift
plans as torch ops); they must be bit-exact against repro.kernels.segment
run as its own tests run it (Pallas interpret mode) and against the
reference oracles, in both plan modes (the cost model's pick, and the
fused Benes plan forced).  The ``cuda`` cases hold the CUDA kernels
against the plain version on the card; they skip without one.  The
dynamic arm (``fused=False``, kernels B6/B7) is held against the
reference's dynamic bodies here, and on the card in
tests/test_torch_dynamic.py.  JAX is imported inside the tests that need
it, so the card cases run where only torch is installed:
``python -m pytest -m cuda tests/test_torch_segment.py``.
"""
import numpy as np
import pytest
import torch

from _torch_bridge import (assert_bits_equal, cuda_device,  # noqa: F401
                           to_torch)
from repro_torch.core import shiftplan
from repro_torch.kernels import segment

DTYPES = ["float32", "bfloat16", "int32"]


def rand(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return to_torch(rng.integers(-100, 100, shape).astype(np.int32))
    t = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return t.to(getattr(torch, dtype))


def forced_fused(direction, n, fields):
    plan = (shiftplan.deinterleave_plan(n, fields) if direction == "deint"
            else shiftplan.interleave_plan(n, fields))
    return ("fused", (plan,))


def jnp_of(t):
    import jax.numpy as jnp
    import ml_dtypes
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fields", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("lead,m", [((), 64), ((4,), 32), ((2, 2), 128)])
@pytest.mark.parametrize("mode", ["picked", "fused"])
def test_segment_plain_vs_reference_oracle(dtype, fields, lead, m, mode):
    from repro.kernels import ref as jref
    n = fields * m
    aos = rand(3, lead + (n,), dtype)
    got = segment.deinterleave(
        aos, fields, plans=forced_fused("deint", n, fields)
        if mode == "fused" else None)
    want = jref.deinterleave(jnp_of(aos), fields)
    for g, w in zip(got, want):
        assert_bits_equal(g, w)
    soa = [rand(10 + f, lead + (m,), dtype) for f in range(fields)]
    got = segment.interleave(soa, plans=forced_fused("int", n, fields)
                             if mode == "fused" else None)
    assert_bits_equal(got, jref.interleave([jnp_of(s) for s in soa]))


@pytest.mark.parametrize("dtype,fields", [("float32", 2), ("float32", 3),
                                          ("float32", 8), ("bfloat16", 2),
                                          ("int32", 4)])
def test_segment_plain_vs_pallas_interpret(dtype, fields):
    """Against the reference's Pallas kernels themselves (interpret mode):
    the same plans, the same routing, the same bits."""
    from repro.kernels import segment as jseg
    m = 32
    aos = rand(4, (3, fields * m), dtype)
    for g, w in zip(segment.deinterleave(aos, fields),
                    jseg.deinterleave(jnp_of(aos), fields)):
        assert_bits_equal(g, w)
    soa = [rand(20 + f, (3, m), dtype) for f in range(fields)]
    assert_bits_equal(segment.interleave(soa),
                      jseg.interleave([jnp_of(s) for s in soa]))


def test_counts_and_cpu_route():
    """On the CPU the wrappers count calls but never a launch."""
    segment.reset_counts()
    x = rand(0, (4, 256), "float32")
    k, v = segment.deinterleave(x, 2)
    back = segment.interleave([k, v])
    assert_bits_equal(back, x)
    assert (segment.deinterleave.calls, segment.interleave.calls) == (1, 1)
    assert segment.deinterleave.launches == segment.interleave.launches == 0


def numbered(shape, start=1):
    """int32 payload ``start + flat index``: routed by the reference, it
    records which input element each output lane holds."""
    size = int(np.prod(shape))
    return np.arange(start, start + size, dtype=np.int32).reshape(shape)


def take(sources, x):
    """``x``'s elements (flattened) at the reference's element numbers;
    number 0 is a lane the network fills with 0."""
    idx = torch.from_numpy(np.asarray(sources, np.int64))
    flat = torch.cat([torch.zeros(1, dtype=x.dtype), x.reshape(-1)])
    return flat[idx.reshape(-1)].reshape(idx.shape)


DYNAMIC_GRID = ([("deint", f, lead, m) for f in (2, 3, 4, 5, 8)
                 for lead, m in (((), 64), ((4,), 32), ((2, 2), 128))]
                + [("int", f, lead, m) for f in (2, 3, 4, 8)
                   for lead, m in (((), 64), ((4,), 32), ((2, 2), 128))])


@pytest.mark.parametrize("direction,fields,lead,m", DYNAMIC_GRID)
def test_dynamic_bodies_wait(direction, fields, lead, m):
    """The dynamic arm (``fused=False``, kernels B6/B7; their plain
    versions on the CPU) against the reference's dynamic Pallas bodies
    (interpret mode) on the segment grid of tests/test_kernels_vs_ref.py.
    The reference routes numbered int32 payloads once per geometry (a
    Pallas interpret compile costs about half a second per field); each
    dtype's output must equal its input taken through that map, bit for
    bit.  The dynamic arm also equals the plan arm."""
    import jax.numpy as jnp
    from repro.kernels import segment as jseg
    n = fields * m
    if direction == "deint":
        srcs = jseg.deinterleave(jnp.asarray(numbered(lead + (n,))), fields,
                                 fused=False)
        for dtype in DTYPES:
            aos = rand(5, lead + (n,), dtype)
            got = segment.deinterleave(aos, fields, fused=False)
            assert len(got) == fields
            for g, src, p in zip(got, srcs, segment.deinterleave(aos,
                                                                 fields)):
                assert_bits_equal(g, take(src, aos))
                assert_bits_equal(g, p)
        return
    size = int(np.prod(lead + (m,)))
    src = jseg.interleave([jnp.asarray(numbered(lead + (m,), 1 + f * size))
                           for f in range(fields)], fused=False)
    for dtype in DTYPES:
        soa = [rand(40 + f, lead + (m,), dtype) for f in range(fields)]
        got = segment.interleave(soa, fused=False)
        assert_bits_equal(got, take(src, torch.cat([s.reshape(-1)
                                                    for s in soa])))
        assert_bits_equal(got, segment.interleave(soa))


def test_shared_memory_sizing():
    assert segment.rows_per_block(1 << 20, 256, 2, 64) == \
        (segment.SMEM_BUDGET - 64) // (3 * 256 * 2)
    assert segment.rows_per_block(3, 256, 4, 64) == 3
    with pytest.raises(ValueError):
        segment.rows_per_block(4, 1 << 16, 8, 64)
    # a small call spreads over min_blocks blocks; a large one keeps the cap
    assert segment.rows_per_block(128, 256, 2, 64, min_blocks=264) == 1
    assert segment.rows_per_block(1000, 256, 2, 64, min_blocks=100) == 10
    assert segment.rows_per_block(1 << 20, 256, 2, 64, min_blocks=264) == \
        (segment.SMEM_BUDGET - 64) // (3 * 256 * 2)


# ---------------------------------------------------------------------------
# On the card: CUDA kernels against the plain version
# ---------------------------------------------------------------------------

CARD_DTYPES = ["float32", "bfloat16", "int32", "int8"]


def card_rand(seed, shape, dtype, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if dtype in ("int32", "int8"):
        return torch.randint(-100, 100, shape, generator=g, device=device,
                             dtype=getattr(torch, dtype))
    return torch.randn(shape, generator=g, device=device).to(
        getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("fields", [2, 3, 4, 8])
@pytest.mark.parametrize("rows,width", [(7, 6144), (1000, 256)])
@pytest.mark.parametrize("mode", ["picked", "fused"])
def test_kernels_match_plain_on_card(cuda_device, dtype, fields, rows, width,
                                     mode):
    m = width // fields            # fields=3 at 256 lanes: 255
    n = fields * m
    aos = card_rand(1, (rows, n), dtype, cuda_device)
    forced = forced_fused("deint", n, fields) if mode == "fused" else None
    got = segment.deinterleave(aos, fields, plans=forced)
    want = segment.deinterleave(aos.cpu(), fields, plans=forced)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert_bits_equal(g, w)
    soa = [card_rand(2 + f, (rows, m), dtype, cuda_device)
           for f in range(fields)]
    forced = forced_fused("int", n, fields) if mode == "fused" else None
    got = segment.interleave(soa, plans=forced)
    want = segment.interleave([s.cpu() for s in soa], plans=forced)
    torch.cuda.synchronize()
    assert_bits_equal(got, want)


def test_step_fused_groups_one_call_each():
    """StepScheduler merges same-shape accesses into ONE kernel call per
    group (kernel lowering pinned on the CPU) and returns each access's
    own result."""
    from repro_torch.core import accessfuse
    from repro_torch.kernels import ref
    # 3 x 4 x 4096 elements: above the launch threshold (32768)
    xs = [rand(30 + a, (4, 4096), "float32") for a in range(3)]
    with accessfuse.pinned_kernel_lowering():
        segment.reset_counts()
        outs = accessfuse.fuse_deinterleave(xs, 2, impl="kernel")
        groups = [[o[0], o[1]] for o in outs]
        packed = accessfuse.fuse_interleave(groups, impl="kernel")
    assert (segment.deinterleave.calls, segment.interleave.calls) == (1, 1)
    for x, (k, v), p in zip(xs, outs, packed):
        rk, rv = ref.deinterleave(x, 2)
        assert_bits_equal(k, rk)
        assert_bits_equal(v, rv)
        assert_bits_equal(p, x)
    many = segment.deinterleave_many(xs, 2)
    for x, parts in zip(xs, many):
        for g, w in zip(parts, ref.deinterleave(x, 2)):
            assert_bits_equal(g, w)
