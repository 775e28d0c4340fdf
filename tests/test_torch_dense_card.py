"""The dense serving path on the card (no JAX here: the card's machine
has none): under ``kernel`` and ``kernel_dynamic`` the forward prefill
launches the beat split and re-pack kernels (B1 and B2, or B6 and B7) and
the GLU split, each fused dense decode step launches exactly one split
(B1 or B6), the streams equal those under ``ref``, and the dense step
equals the paged step bit for bit, fused and per-access.  Skips without a
card."""
import dataclasses

import pytest
import torch

from _torch_bridge import assert_bits_equal, cuda_device  # noqa: F401
from repro_torch.kernels import segment
from repro_torch.models import decode as dec
from repro_torch.models.transformer import ModelConfig, forward, init_params

pytestmark = pytest.mark.cuda


def _cfg(impl):
    return ModelConfig(name="dense-card", d_model=256, n_layers=2,
                       n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                       vocab=1000, qk_norm=True, kernel_impl=impl,
                       compute_dtype="bfloat16", remat="none")


def _counts():
    return {f.__name__: f.launches for f in segment.KERNELS + segment.DYNAMIC}


@pytest.mark.parametrize("impl,split,pack", [
    ("kernel", "deinterleave", "interleave"),
    ("kernel_dynamic", "deinterleave_dynamic", "interleave_dynamic")])
def test_dense_serving_launches_and_streams_on_card(cuda_device, impl,
                                                    split, pack):
    params = init_params(_cfg("ref"), 0, device=cuda_device)
    toks = torch.randint(0, 1000, (4, 48), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    streams = {}
    for pol in ("ref", impl):
        cfg = _cfg(pol)
        segment.reset_counts()
        logits, _, states = forward(params, {"tokens": toks}, cfg,
                                    mode="prefill")
        torch.cuda.synchronize()
        counts = _counts()
        if pol == "ref":
            assert not any(counts.values()), counts
        else:
            # per layer: the K/V beat split and the GLU split, one re-pack
            assert counts[split] == 2 * cfg.n_layers, counts
            assert counts[pack] == cfg.n_layers, counts
            assert sum(counts.values()) == 3 * cfg.n_layers, counts
        cache = dec.cache_from_prefill(cfg, states, 48, 64, torch.bfloat16)
        tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)
        out = [tok]
        for _ in range(6):
            segment.reset_counts()
            logits, cache = dec.decode_step(params, cache, tok, cfg,
                                            fuse=True)
            torch.cuda.synchronize()
            want = {k: int(pol != "ref" and k == split) for k in _counts()}
            assert _counts() == want
            tok = torch.argmax(logits.float(), -1).to(torch.int32)
            out.append(tok)
        streams[pol] = torch.stack(out, 1).tolist()
    assert streams[impl] == streams["ref"]


def test_dense_step_equals_paged_step_on_card(cuda_device):
    cfg = dataclasses.replace(_cfg("kernel"), compute_dtype="float32")
    params = init_params(cfg, 0, device=cuda_device)
    caches = [dec.init_cache(cfg, 4, 64, device=cuda_device),
              dec.init_cache(cfg, 4, 64, device=cuda_device),
              dec.init_paged_cache(cfg, 4, 64, 16, device=cuda_device),
              dec.init_paged_cache(cfg, 4, 64, 16, device=cuda_device)]
    steps = [lambda c, t: dec.decode_step(params, c, t, cfg, fuse=True),
             lambda c, t: dec.decode_step(params, c, t, cfg, fuse=False),
             lambda c, t: dec.paged_decode_step(params, c, t, cfg,
                                                fuse=True),
             lambda c, t: dec.paged_decode_step(params, c, t, cfg,
                                                fuse=False)]
    tok = torch.tensor([3, 7, 11, 13], dtype=torch.int32, device=cuda_device)
    for _ in range(6):
        outs = []
        for j, fn in enumerate(steps):
            lg, caches[j] = fn(caches[j], tok)
            outs.append(lg)
        for lg in outs[1:]:
            assert_bits_equal(lg, outs[0])
        tok = torch.argmax(outs[0].float(), dim=-1).to(torch.int32)
