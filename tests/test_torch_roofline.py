"""Port parity for ``hw`` and ``roofline/analysis.py`` (the twin of
``tests/test_roofline.py``) on the CPU.

- ``collective_bytes`` from the port's collective records
  (``dist.sharding.CollectiveLog``) equals the reference's parse of HLO
  lines naming collectives of the same result shapes, per kind (a
  ``psum_scatter`` is recorded by its input and counted by its result);
- ``CostBundle`` arithmetic and ``roofline`` equal the reference's on
  the same numbers (the port's ``ChipSpec`` built from the reference's
  TPU v5e constants);
- ``active_param_count`` and ``model_flops`` equal the reference's for
  all ten archs, full and smoke, exactly (the port's ``init_params`` on
  fake tensors against ``jax.eval_shape`` of the reference's);
- ``bundle_from_trace`` counts a ``(1024, 2048) @ (2048, 512)`` bf16
  matmul on fake tensors as 2147483648 FLOPs and the bytes of its
  operands and result;
- the H100 constants.
"""
import dataclasses
import functools

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import hw as jhw
from repro.roofline import analysis as jan
from repro_torch import hw
from repro_torch.configs.base import ARCH_IDS
from repro_torch.dist.sharding import CollectiveLog
from repro_torch.roofline import analysis as an

#: HLO lines and the port's records of the same collectives: (op, the
#: tensor the port records, its result).
HLO = """
  %ag = bf16[32,256]{1,0} all-gather(%p0), dimensions={0}
  %ar = f32[1024]{0} all-reduce(%p1), to_apply=%sum
  %rs = f32[16,64]{1,0} reduce-scatter(%p2), dimensions={0}
  %cp = f32[4,4]{1,0} collective-permute(%p4), source_target_pairs={{0,1}}
  %ars = (f32[256]{0}, f32[128]{0}) all-reduce(%p5, %p6), to_apply=%sum
  %mx = s32[8]{0} all-reduce(%p7), to_apply=%max
  %unrelated = f32[999]{0} add(%p7, %p8)
  %async = f32[512]{0} all-gather-start(%p9), dimensions={0}
"""
RECORDS = (
    ("all_gather", (32, 256), torch.bfloat16, None),
    ("psum", (1024,), torch.float32, None),
    ("psum_scatter", (64, 64), torch.float32, (16, 64)),   # over 4 ranks
    ("ppermute", (4, 4), torch.float32, None),
    ("psum", (256,), torch.float32, None),
    ("psum", (128,), torch.float32, None),
    ("pmax", (8,), torch.int32, None),
    ("all_gather", (512,), torch.float32, None),
)


def _log() -> CollectiveLog:
    log = CollectiveLog()
    with FakeTensorMode():
        for op, shape, dtype, result in RECORDS:
            x = torch.empty(shape, dtype=dtype)
            log.add(op, x, 0.0, None if result is None
                    else torch.empty(result, dtype=dtype))
    return log


def test_collective_bytes_match_the_reference_parser():
    got = an.collective_bytes(_log())
    want = jan.collective_bytes(HLO)
    assert set(got) == set(want)
    for kind in want:
        assert got[kind] == want[kind], kind
    assert got["reduce-scatter"] == 16 * 64 * 4      # the result's bytes
    assert got["all-reduce"] == (1024 + 256 + 128 + 8) * 4 * 2
    assert got["all-to-all"] == 0.0
    # the counter alone gives the same
    assert an.collective_bytes(_log().results) == got


def test_bundle_arithmetic():
    for mod in (an, jan):
        a = mod.CostBundle(10.0, 100.0, 5.0, {"all-reduce": 5.0})
        b = mod.CostBundle(4.0, 40.0, 2.0, {"all-reduce": 2.0})
        body = a - b
        assert body.flops == 6.0
        tot = b.scaled_add(body, 3)
        assert tot.flops == 4.0 + 18.0
        assert tot.coll_breakdown["all-reduce"] == 2.0 + 9.0
        assert dataclasses.astuple(tot) == dataclasses.astuple(
            jan.CostBundle(22.0, 220.0, 11.0, {"all-reduce": 11.0}))


@pytest.mark.parametrize("chip", ("tpu_v5e", "h100_sxm"))
def test_roofline_terms_and_dominant(chip):
    """The reference's case on its TPU v5e constants, and on the H100's:
    the port's terms equal the reference's ``roofline`` on the same
    bundle and chip."""
    spec = (hw.ChipSpec(**dataclasses.asdict(jhw.TPU_V5E))
            if chip == "tpu_v5e" else hw.H100_SXM)
    jspec = jhw.ChipSpec(**dataclasses.asdict(spec))
    b = an.CostBundle(flops=spec.peak_bf16_flops,
                      bytes_accessed=spec.hbm_bandwidth * 2,
                      coll_bytes=spec.ici_link_bandwidth * 0.5,
                      coll_breakdown={})
    t = an.roofline(b, chips=256, model_flops=spec.peak_bf16_flops * 128,
                    chip=spec)
    assert t.dominant == "memory"
    assert abs(t.compute_s - 1.0) < 1e-9
    assert abs(t.memory_s - 2.0) < 1e-9
    assert abs(t.collective_s - 0.5) < 1e-9
    assert abs(t.useful_ratio - 0.5) < 1e-9
    jb = jan.CostBundle(b.flops, b.bytes_accessed, b.coll_bytes, {})
    assert t.as_dict() == jan.roofline(
        jb, chips=256, model_flops=spec.peak_bf16_flops * 128,
        chip=jspec).as_dict()


@functools.lru_cache(maxsize=None)
def _configs(arch):
    from repro.configs import get_arch as jget
    from repro_torch.configs import get_arch
    return ({"full": get_arch(arch).model, "smoke": get_arch(arch).smoke},
            {"full": jget(arch).model, "smoke": jget(arch).smoke})


@pytest.mark.parametrize("size", ("full", "smoke"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_match_reference(arch, size):
    port, ref = (c[size] for c in _configs(arch))
    n = an.active_param_count(port)
    assert n == jan.active_param_count(ref)
    for kind in ("train", "serve"):
        assert an.model_flops(port, tokens=4096, kind=kind) == \
            jan.model_flops(ref, tokens=4096, kind=kind)
    if port.moe is not None:
        total = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
            an.param_shapes(port)))
        assert n < total


def test_bundle_from_trace_counts_a_matmul():
    """2 FLOPs per multiply-add, and the operands' and the result's bytes
    (the transposed view feeding it moves nothing)."""
    with FakeTensorMode():
        a = torch.empty((1024, 2048), dtype=torch.bfloat16)
        b = torch.empty((512, 2048), dtype=torch.bfloat16)
        out, bundle = an.bundle_from_trace(lambda a, b: a @ b.t(), a, b)
    assert tuple(out.shape) == (1024, 512)
    assert bundle.flops == 2147483648
    assert bundle.bytes_accessed == 2 * (1024 * 2048 + 2048 * 512
                                         + 1024 * 512)
    assert bundle.coll_bytes == 0.0


def test_hw_h100_constants():
    c = hw.H100_SXM
    assert hw.DEFAULT_CHIP is c
    assert c.peak_bf16_flops == 989e12 and c.hbm_bandwidth == 3.35e12
    assert c.ici_link_bandwidth * c.ici_links == 450e9
    assert c.hbm_bytes == 80e9 and c.vmem_bytes == 232448
    assert [f.name for f in dataclasses.fields(hw.ChipSpec)] == \
        [f.name for f in dataclasses.fields(jhw.ChipSpec)]
