"""The quantized page pool and prefix sharing on the card (no JAX here: the
card's machine has none).  The quantized ``vx`` gather and scatter on
CUDA equal the same calls on the CPU bit for bit, at int8 and fp8, with
duplicate pages and dropped rows; the copy-on-write fork copies the
page's scale on the card; the donor's shared pages hold the same bytes
after a borrower decodes; the quantized fused step makes exactly one
split launch (B1 under ``kernel``, B6 under ``kernel_dynamic``) with the
``ref`` policy's greedy tokens.  Skips without a card."""
import pytest
import torch

from _torch_bridge import assert_bits_equal, cuda_device  # noqa: F401
from repro_torch import vx
from repro_torch.core import quant
from repro_torch.kernels import segment
from repro_torch.models import decode as dec
from repro_torch.models.transformer import ModelConfig, init_params
from repro_torch.serve.scheduler import Scheduler

pytestmark = pytest.mark.cuda

SHARED = [3, 5, 7, 9, 2, 4, 6, 8, 1, 3, 5, 7]


def _cfg(impl="kernel"):
    return ModelConfig(name="quant-card", d_model=256, n_layers=2,
                       n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                       vocab=1000, qk_norm=True, kernel_impl=impl,
                       remat="none")


@pytest.mark.parametrize("dt", ["int8", "fp8"])
def test_quantized_gather_scatter_card_equals_cpu(cuda_device, dt):
    g = torch.Generator().manual_seed(0)
    ps, pages, P, K, D = 16, 4, 12, 8, 256
    spec = vx.Paged(page_size=ps, pages=pages, trail=2)
    pools = {d: torch.zeros((P, ps, K, D), dtype=quant.pool_dtype(dt),
                            device=d) for d in ("cpu", cuda_device)}
    scales = {d: torch.zeros((P, K), device=d) for d in pools}
    table = torch.tensor([[1, 4, -1, -1], [3, 0, 7, -1], [-1, -1, -1, -1],
                          [1, 4, -1, -1], [9, 2, 5, 6]], dtype=torch.int32)
    for step in range(6):
        pos = torch.tensor([step, 20 + step, 3, step + 1, 70 - step],
                           dtype=torch.int32)
        vals = torch.randn((5, K, D), generator=g) * (step + 1)
        if step % 2:
            vals = vals.to(torch.bfloat16)
        for d in pools:
            vx.scatter(spec, pools[d], vals.to(d), table=table.to(d),
                       pos=pos.to(d), scales=scales[d])
        assert_bits_equal(quant.raw(pools[cuda_device]),
                          quant.raw(pools["cpu"]))
        assert_bits_equal(scales[cuda_device], scales["cpu"])
        outs = {d: vx.gather(spec, pools[d], table=table.to(d),
                             scales=scales[d]) for d in pools}
        assert_bits_equal(outs[cuda_device], outs["cpu"])


def test_fork_copies_scale_on_card(cuda_device):
    cfg = _cfg()
    params = init_params(cfg, 0, device=cuda_device)
    cache = dec.init_paged_cache(cfg, 2, 64, 16, quantize="int8",
                                 device=cuda_device)
    tok = torch.tensor([3, 5], dtype=torch.int32, device=cuda_device)
    for _ in range(5):
        _, cache = dec.paged_decode_step(params, cache, tok, cfg)
    src = int(cache["table"][0, 0])
    cache = dec.paged_fork_page(cfg, cache, 1, 0, src, pos_to=5)
    dst = int(cache["table"][1, 0])
    for i in range(cfg.sb_len):
        assert torch.equal(cache["blocks"][f"scl{i}"][:, dst],
                           cache["blocks"][f"scl{i}"][:, src])
        assert torch.equal(cache["blocks"][f"pos{i}"][:, dst, :5],
                           cache["blocks"][f"pos{i}"][:, src, :5])
    before = {k: v[:, src].clone() for k, v in cache["blocks"].items()}
    _, cache = dec.paged_decode_step(
        params, cache, tok, cfg,
        active=torch.tensor([False, True], device=cuda_device))
    for k, v in cache["blocks"].items():
        assert torch.equal(v[:, src], before[k]), k


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_donor_pages_unchanged_after_borrower_decode_on_card(cuda_device,
                                                             kv_quant):
    cfg = _cfg()
    params = init_params(cfg, 0, device=cuda_device)
    sched = Scheduler(cfg, params, slots=2, max_len=64, page_size=4,
                      num_pages=32, kv_quant=kv_quant, prefix_cache=True,
                      debug_invariants=True, device=cuda_device)
    sched.add_request(SHARED + [11, 13])
    donor = [int(p) for p in sched.cache.table_row(0)[:3]]
    before = {k: quant.raw(v)[:, donor].clone()
              for k, v in sched.cache.state["blocks"].items()}
    sched.add_request(SHARED[:10] + [9, 9, 12])
    assert sched.cache.forks == 1
    for _ in range(8):
        sched.step()
    for k, v in sched.cache.state["blocks"].items():
        assert torch.equal(quant.raw(v)[:, donor], before[k]), k


@pytest.mark.parametrize("impl,split", [("kernel", "deinterleave"),
                                        ("kernel_dynamic",
                                         "deinterleave_dynamic")])
def test_quantized_step_one_split_launch_on_card(cuda_device, impl, split):
    """The fused quantized step splits the float32 dequantized stack in
    one launch; its greedy tokens equal the ref policy's."""
    params = init_params(_cfg("ref"), 0, device=cuda_device)
    caches = {p: dec.init_paged_cache(_cfg(p), 4, 128, 16, quantize="int8",
                                      device=cuda_device)
              for p in (impl, "ref")}
    tok = torch.arange(4, dtype=torch.int32, device=cuda_device)
    for _ in range(4):
        out = {}
        for p in (impl, "ref"):
            segment.reset_counts()
            out[p], caches[p] = dec.paged_decode_step(params, caches[p], tok,
                                                      _cfg(p), fuse=True)
            torch.cuda.synchronize()
            counts = {f.__name__: f.launches
                      for f in segment.KERNELS + segment.DYNAMIC}
            want = {k: int(p != "ref" and k == split) for k in counts}
            assert counts == want, (p, counts)
        tok = torch.argmax(out["ref"], -1).to(torch.int32)
        assert torch.equal(torch.argmax(out[impl], -1).to(torch.int32), tok)
