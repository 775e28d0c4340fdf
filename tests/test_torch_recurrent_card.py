"""The recurrent and hybrid models on the card (no JAX here: the card's
machine has none).  A Mamba layer's forward carries on into its decode
steps: in float32 the forward's final state and conv window equal the
state of decode steps from zero over the same tokens within 1e-4 of their
largest magnitudes (cuBLAS sums the forward's and the steps' matmuls in
different orders).  jamba-smoke and xlstm-smoke serve through the paged
``Scheduler`` under ``ref``, ``kernel`` and ``kernel_dynamic`` with equal
streams: jamba's attention layer splits its pages once per decode step
(B1 under ``kernel``, B6 under ``kernel_dynamic``), xlstm launches no
segment kernel.  Skips without a card."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_bridge import cuda_device  # noqa: F401
from repro_torch.configs.base import get_arch
from repro_torch.kernels import segment
from repro_torch.models import ssm
from repro_torch.models.transformer import init_params
from repro_torch.serve.scheduler import Scheduler

pytestmark = pytest.mark.cuda

SLOTS, MAX_LEN, PAGE, GEN = 2, 128, 16, 8


def test_mamba_forward_against_steps_on_card(cuda_device):
    spec = ssm.MambaSpec(d_model=1024)
    g = torch.Generator(cuda_device).manual_seed(0)
    p = ssm.init_mamba(spec, g, torch.float32, cuda_device)
    x = torch.randn((2, 256, spec.d_model), generator=g, device=cuda_device)
    _, fwd = ssm.mamba_forward(p, x, spec)
    c = ssm.init_mamba_cache(2, spec, torch.float32, cuda_device)
    for t in range(x.shape[1]):
        _, c = ssm.mamba_decode_step(p, x[:, t], c, spec)
    for a, b in ((fwd.h, c.h), (fwd.conv, c.conv)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _serve(cfg, params, impl, prompts, device):
    sched = Scheduler(dataclasses.replace(cfg, kernel_impl=impl), params,
                      slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
                      device=device)
    reqs = [sched.submit(p, max_new_tokens=GEN) for p in prompts]
    while not sched.drained():
        sched.tick()
    splits = (segment.deinterleave.launches,
              segment.deinterleave_dynamic.launches)
    steps = sched.stats()["decode_steps"]
    assert all(r.state.value == "finished" for r in reqs)
    return [r.tokens for r in reqs], splits, steps


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_recurrent_streams_equal_across_policies_on_card(cuda_device, name):
    cfg = get_arch(name).smoke
    params = init_params(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in (20, 33, 41)]
    runs = {}
    for impl in ("ref", "kernel", "kernel_dynamic"):
        segment.reset_counts()
        runs[impl] = _serve(cfg, params, impl, prompts, cuda_device)
    assert runs["kernel"][0] == runs["ref"][0] == runs["kernel_dynamic"][0]
    assert runs["ref"][1] == (0, 0)
    if "attn" in cfg.block_pattern:
        # one fused split a decode step, more in the prefill chunks
        (b1, b6), steps = runs["kernel"][1:]
        assert b1 >= steps > 0 and b6 == 0
        (b1, b6), steps = runs["kernel_dynamic"][1:]
        assert b6 >= steps > 0 and b1 == 0
    else:
        assert runs["kernel"][1] == runs["kernel_dynamic"][1] == (0, 0)
