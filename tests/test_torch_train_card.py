"""Training on the card (no JAX here: the card's machine has none).

- The flash attention backward (the reference's ``_flash_bwd`` as a
  ``torch.autograd.Function``) against autograd through the plain,
  unchunked softmax attention in float32: causal GQA, a sliding window
  and the encoder's non-causal ragged shape, each ``dq`` / ``dk`` / ``dv``
  within 1e-4 of its largest magnitude (cuBLAS sums the tiles and the
  whole in different orders).
- The card against the CPU: qwen3-0.6b-smoke and whisper-tiny-smoke in
  float32, the port's loss and gradients on the card within 1e-4
  (relative to the largest magnitude of each leaf) of its own
  ``device="cpu"`` run from the same weights and batch.
- Under ``kernel`` a training forward with gradients on raises at the
  first ``vx`` verb; under ``ref`` one train step runs.

Skips without a card."""
import dataclasses

import pytest
import torch

from _torch_bridge import cuda_device  # noqa: F401
from repro_torch.configs.base import get_arch, train_batch
from repro_torch.models import attention
from repro_torch.models.transformer import init_params, loss_fn, tree_map
from repro_torch.train import step as tstep
from repro_torch.train.state import init_train_state

pytestmark = pytest.mark.cuda


def plain_attention(q, k, v, *, causal, window):
    """Unchunked softmax attention, float32, for autograd to differentiate."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qt = q.reshape(B, Sq, K, H // K, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qt, k) * D ** -0.5
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qp >= kp)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


@pytest.mark.parametrize("shape", [
    # (Sq, H, K, D, causal, window, chunk)
    (512, 16, 8, 128, True, None, 128),
    (512, 4, 2, 64, True, 96, 128),
    (300, 6, 6, 64, False, None, 128),
])
def test_flash_backward_against_autograd_on_card(cuda_device, shape):
    S, H, K, D, causal, window, chunk = shape
    g = torch.Generator(cuda_device).manual_seed(S + H)
    q = torch.randn((1, S, H, D), generator=g, device=cuda_device)
    k, v = (torch.randn((1, S, K, D), generator=g, device=cuda_device)
            for _ in range(2))
    dout = torch.randn((1, S, H, D), generator=g, device=cuda_device)
    got = torch.autograd.grad(attention.flash_attention(
        *(t.requires_grad_() for t in (q, k, v)), causal=causal,
        window=window, q_chunk=chunk, kv_chunk=chunk), (q, k, v), dout)
    want = torch.autograd.grad(plain_attention(
        q, k, v, causal=causal, window=window), (q, k, v), dout)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("name", ["qwen3-0.6b", "whisper-tiny"])
def test_loss_and_grads_card_against_cpu(cuda_device, name):
    cfg = dataclasses.replace(get_arch(name).smoke, kernel_impl="ref")
    params = init_params(cfg, 0, device="cpu")
    batch = train_batch(cfg, 32, 2, specs=False, device="cpu")
    cpu = tstep._loss_and_grads(params, batch, cfg, None)
    card = tstep._loss_and_grads(
        tree_map(lambda t: t.to(cuda_device), params),
        {k: v.to(cuda_device) for k, v in batch.items()}, cfg, None)
    assert abs(float(card[0]) - float(cpu[0])) <= 1e-4 * abs(float(cpu[0]))

    def walk(a, b):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k])
            return
        assert float((a.cpu() - b).abs().max()) <= \
            1e-4 * float(b.abs().max()) + 1e-12

    walk(card[2], cpu[2])


def test_kernel_training_forward_refuses_on_card(cuda_device):
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke,
                              kernel_impl="kernel")
    params = init_params(cfg, 0, device=cuda_device)
    batch = train_batch(cfg, 32, 2, specs=False, device=cuda_device)
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    with pytest.raises(RuntimeError, match="no backward"):
        loss_fn(leaves, batch, cfg)
    with torch.no_grad():
        loss, _ = loss_fn(leaves, batch, cfg)
    assert bool(torch.isfinite(loss))
    ref = dataclasses.replace(cfg, kernel_impl="ref")
    state, m = tstep.make_train_step(ref, tstep.TrainConfig(), None)(
        init_train_state(params), batch)
    assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0
