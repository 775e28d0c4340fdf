"""The new model families on the card (no JAX here: the card's machine has
none). The MoE layer on CUDA gives the same bits twice (the combine adds
in a fixed order, no atomics) and, in float32, the CPU's routing bit for
bit and its output within rtol 1e-4 / atol 1e-5 (cuBLAS and the CPU sum
the products in different orders). B1 and B6 split the GLU rows of
gemma3-12b (30720 lanes) and llava-next-mistral-7b (28672), too wide for
one row of the permuted copy's shared memory, in one launch each, bit
for bit against their plain versions; B2 and B7 pack rows of 30720
(bf16) and 24576 (float32) lanes, too wide for one row of the interleave
copy's, likewise. Each of the six families' smoke configs serves through
the paged ``Scheduler`` under ``ref``, ``kernel`` and ``kernel_dynamic``
with equal streams, the fused split launching once per decode step (B1
under ``kernel``, B6 under ``kernel_dynamic``; the pool is sized so that
every family's stack reaches the launch threshold). Skips without a
card."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, cuda_device  # noqa: F401
from repro_torch.configs.base import get_arch
from repro_torch.kernels import segment
from repro_torch.models import moe
from repro_torch.models.transformer import init_params
from repro_torch.serve.scheduler import Scheduler
from repro_torch.vx.policy import MIN_FUSED_ELEMS

pytestmark = pytest.mark.cuda

FAMILIES = ("gemma3-12b", "llava-next-mistral-7b", "granite-34b",
            "starcoder2-3b", "phi3.5-moe-42b-a6.6b", "qwen3-moe-30b-a3b")
SPEC = moe.MoESpec(n_experts=32, top_k=8, d_ff=256)
D = 512
SLOTS, MAX_LEN = 2, 256


def _moe_inputs(device, dtype):
    g = torch.Generator().manual_seed(0)
    params = moe.init_moe(D, SPEC, g, torch.float32, "cpu")
    params = {k: v.to(device=device,
                      dtype=torch.float32 if k == "router" else dtype)
              for k, v in params.items()}
    x = torch.randn((4, 16, D), generator=g).to(device=device, dtype=dtype)
    return params, x


def test_moe_layer_on_card_gives_the_same_bits_twice(cuda_device):
    params, x = _moe_inputs(cuda_device, torch.bfloat16)
    y1, aux1 = moe.moe_layer(params, x, SPEC, None)
    y2, aux2 = moe.moe_layer(params, x, SPEC, None)
    assert y1.dtype == torch.bfloat16 and bool(torch.isfinite(y1).all())
    assert_bits_equal(y1, y2)
    assert_bits_equal(aux1, aux2)


def test_moe_layer_on_card_matches_cpu(cuda_device):
    params, x = _moe_inputs(cuda_device, torch.float32)
    cparams, cx = _moe_inputs("cpu", torch.float32)
    flat, cflat = x.reshape(-1, D), cx.reshape(-1, D)
    r = moe.route(flat, params["router"], SPEC)
    cr = moe.route(cflat, cparams["router"], SPEC)
    for name in ("packed", "pv", "le", "order", "gs"):
        assert_bits_equal(getattr(r, name), getattr(cr, name))
    y, aux = moe.moe_layer(params, x, SPEC, None)
    cy, caux = moe.moe_layer(cparams, cx, SPEC, None)
    np.testing.assert_allclose(y.cpu().numpy(), cy.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(caux), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [30720, 28672])
def test_wide_glu_split_on_card(cuda_device, n, dtype):
    g = torch.Generator(cuda_device).manual_seed(n)
    x = torch.randn((3, 5, n), generator=g, device=cuda_device).to(dtype)
    for fn, plain in ((segment.deinterleave, segment.deinterleave_plain),
                      (segment.deinterleave_dynamic,
                       segment.deinterleave_dynamic_plain)):
        before = fn.launches
        got = fn(x, 2)
        assert fn.launches == before + 1
        for a, b in zip(got, plain(x, 2)):
            assert_bits_equal(a, b)


@pytest.mark.parametrize("n,dtype", [(30720, torch.bfloat16),
                                     (24576, torch.float32)])
def test_wide_interleave_on_card(cuda_device, n, dtype):
    g = torch.Generator(cuda_device).manual_seed(n)
    soa = [torch.randn((3, 5, n // 2), generator=g, device=cuda_device
                       ).to(dtype) for _ in range(2)]
    for fn, plain in ((segment.interleave, segment.interleave_plain),
                      (segment.interleave_dynamic,
                       segment.interleave_dynamic_plain)):
        before = fn.launches
        got = fn(soa)
        assert fn.launches == before + 1
        assert_bits_equal(got, plain(soa))


def _serve(cfg, params, impl, device):
    sched = Scheduler(dataclasses.replace(cfg, kernel_impl=impl), params,
                      slots=SLOTS, max_len=MAX_LEN, page_size=4,
                      device=device)
    rng = np.random.default_rng(3)
    reqs = [sched.submit(rng.integers(0, cfg.vocab, 20 + 3 * i).tolist(),
                         max_new_tokens=6) for i in range(3)]
    plain_step, splits = sched.step, []

    def counted_step():
        d0 = (segment.deinterleave.launches,
              segment.deinterleave_dynamic.launches)
        out = plain_step()
        splits.append((segment.deinterleave.launches - d0[0],
                       segment.deinterleave_dynamic.launches - d0[1]))
        return out

    sched.step = counted_step
    for _ in range(400):
        sched.tick()
        if sched.drained():
            break
    assert sched.drained()
    assert all(r.state.value == "finished" for r in reqs)
    return [r.tokens for r in reqs], splits


@pytest.mark.parametrize("name", FAMILIES)
def test_families_serve_on_card(cuda_device, name):
    cfg = get_arch(name).smoke
    assert cfg.n_layers * SLOTS * MAX_LEN * cfg.n_kv_heads * 2 * cfg.hd \
        >= MIN_FUSED_ELEMS
    params = init_params(cfg, 0, device=cuda_device)
    want, ref_splits = _serve(cfg, params, "ref", cuda_device)
    assert set(ref_splits) == {(0, 0)}
    for impl, split in (("kernel", (1, 0)), ("kernel_dynamic", (0, 1))):
        got, splits = _serve(cfg, params, impl, cuda_device)
        assert got == want, impl
        assert splits and set(splits) == {split}, (impl, splits)
