"""Speculative decode on the card (no JAX here: the card's machine has
none), at smoke size: a K=4 speculative scheduler on CUDA under ``kernel``
and ``kernel_dynamic`` gives the CPU run's streams and speculative stats,
both equal to the plain scheduler's streams; each verify step launches
the fused split once plus the per-layer beat split and re-pack (8 KV heads
of 128: the (B, K) beats reach the launch threshold), as the code
predicts; ``vx.scatter_many`` on the card is one launch and equals its
plain version bit for bit.  Skips without a card."""
import dataclasses

import pytest
import torch

from _torch_bridge import cuda_device  # noqa: F401
from repro_torch import vx
from repro_torch.configs.qwen3_0_6b import smoke_config
from repro_torch.kernels import ref, segment
from repro_torch.models import decode as dec
from repro_torch.models.transformer import init_params
from repro_torch.serve.scheduler import Scheduler

pytestmark = pytest.mark.cuda

K = 4
GEOM = dict(slots=4, max_len=64, page_size=8)
PROMPTS = [[3, 5, 7, 11, 13, 17, 19, 23, 29], [2, 4],
           [31, 37, 41, 43, 47, 53, 59, 61, 67, 71, 73, 79, 83, 89],
           [97, 101, 103]]


def _cfg(impl):
    # 8 KV heads of 128: B*K*n_kv*2*hd = 4*4*8*256 = 32768 elements, the
    # launch threshold, so each layer's beat split and re-pack launch
    return dataclasses.replace(smoke_config(), n_heads=8, n_kv_heads=8,
                               head_dim=128, kernel_impl=impl)


def _params(seed, device):
    """Seeded weights drawn on the CPU, then moved (the card's generator
    draws other numbers)."""
    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        return tree.to(device)
    return to(init_params(_cfg("ref"), seed, device="cpu"))


def _run(impl, device, draft_seed, spec=True):
    cfg = _cfg(impl)
    kw = dict(GEOM, device=device, debug_invariants=True)
    if spec:
        kw.update(speculate=K, draft_cfg=cfg,
                  draft_params=_params(draft_seed, device))
    sched = Scheduler(cfg, _params(0, device), **kw)
    per_verify = []
    real = dec.paged_verify_step

    def counted(*a, **k):
        names = [f.__name__ for f in segment.KERNELS + segment.DYNAMIC]
        before = [f.launches for f in segment.KERNELS + segment.DYNAMIC]
        out = real(*a, **k)
        after = [f.launches for f in segment.KERNELS + segment.DYNAMIC]
        per_verify.append({n: b - a_ for n, a_, b in
                           zip(names, before, after) if b != a_})
        return out
    dec.paged_verify_step = counted
    try:
        reqs = [sched.submit(p, max_new_tokens=12) for p in PROMPTS]
        for _ in range(400):
            sched.tick()
            if sched.drained():
                break
    finally:
        dec.paged_verify_step = real
    assert sched.drained() and all(r.state.value == "finished"
                                   for r in reqs)
    st = sched.stats().get("speculative")
    return [r.tokens for r in reqs], st, per_verify


@pytest.mark.parametrize("impl,split,pack", [
    ("kernel", "deinterleave", "interleave"),
    ("kernel_dynamic", "deinterleave_dynamic", "interleave_dynamic")])
@pytest.mark.parametrize("draft_seed", [0, 1])
def test_speculative_scheduler_on_card_equals_cpu(cuda_device, impl, split,
                                                  pack, draft_seed):
    got, gst, per_verify = _run(impl, cuda_device, draft_seed)
    want, wst, _ = _run("ref", torch.device("cpu"), draft_seed)
    plain, _, _ = _run("ref", torch.device("cpu"), draft_seed, spec=False)
    assert got == want == plain
    assert gst == wst and gst["verify_steps"] == len(per_verify) > 0
    layers = _cfg(impl).n_layers
    assert all(n == {split: 1 + layers, pack: layers} for n in per_verify), \
        per_verify
    if draft_seed == 0:              # the target drafts for itself
        assert gst["acceptance"] == 1.0


@pytest.mark.parametrize("impl,fn", [("kernel", "interleave"),
                                     ("kernel_dynamic",
                                      "interleave_dynamic")])
def test_scatter_many_on_card_is_one_launch(cuda_device, impl, fn):
    g = torch.Generator().manual_seed(3)
    groups = [[torch.randn((4, 64, 8, 128), generator=g).to(
        torch.bfloat16).to(cuda_device) for _ in range(2)]
        for _ in range(6)]
    spec = vx.Segment(n=256, fields=2)
    segment.reset_counts()
    out = vx.scatter_many(spec, groups, policy=impl)
    torch.cuda.synchronize()
    assert getattr(segment, fn).launches == 1
    for o, grp in zip(out, groups):
        assert torch.equal(o.view(torch.int16),
                           ref.interleave(grp).view(torch.int16))
