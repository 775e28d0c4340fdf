"""Port parity for the training loss and its gradients: ``loss_fn`` on the
reference's own batches (``train_batch(cfg, 32, 2)``, random normal loss
weights included) for all ten smoke archs, and the gradients of
``loss.backward()`` against ``jax.value_and_grad`` for qwen3, whisper,
jamba, xlstm and qwen3-moe at the smoke size, with the reference's
weights.  The reference runs under ``vx.use("ref")``: it cannot
differentiate its Pallas path, and under the kernel policies neither
package differentiates (both refusals are held here, on qwen3's cached
reference, as is one train step of each package under ``ref``).

Tolerances: loss (and the MoE aux) within rtol = atol = 2e-5; each
gradient leaf within 2e-5 of the largest magnitude among the reference's
gradients of that leaf.  xlstm's gradients within 2e-3 of it: its blocks
amplify XLA's and torch's ulp-level ``exp`` differences (ROADMAP.md C),
as its forward does (tests/test_torch_xlstm.py holds that at 2e-3 too).
xlstm is held to the reference's loss values, not to the reference's own
red smoke assertion (``test_train_step_decreases_loss_direction
[xlstm-125m]``).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import jax_tree_to_np
from repro import vx as jvx
from repro.configs import base as jbase
from repro.models import transformer as jtf
from repro_torch import vx
from repro_torch.configs import base
from repro_torch.kernels._common import tree_leaves
from repro_torch.models import transformer as tf
from repro_torch.train import state as tstate
from repro_torch.train import step as tstep

RTOL = ATOL = 2e-5
GRAD_ARCHS = ("qwen3-0.6b", "whisper-tiny", "jamba-1.5-large-398b",
              "xlstm-125m", "qwen3-moe-30b-a3b")
# 32 tokens: past gemma3's 16-token smoke window, so its local layers mask
SEQ, BATCH = 32, 2


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The reference's params, batch, loss, aux and (for GRAD_ARCHS) its
    gradients, under ``ref``; one compiled function per arch."""
    cfg = jbase.get_arch(name).smoke
    params = jtf.init_params(cfg, jax.random.key(0))
    batch = jbase.train_batch(cfg, SEQ, BATCH, specs=False)
    with jvx.use("ref"):
        if name in GRAD_ARCHS:
            (loss, m), grads = jax.jit(jax.value_and_grad(
                lambda p, b: jtf.loss_fn(p, b, cfg, None), has_aux=True))(
                    params, batch)
            grads = jax_tree_to_np(grads)
        else:
            loss, m = jax.jit(lambda p, b: jtf.loss_fn(p, b, cfg, None))(
                params, batch)
            grads = None
    return (jax_tree_to_np(params), jax_tree_to_np(batch), float(loss),
            float(m["aux"]), grads)


def _port(name, impl=None):
    params, batch, *_ = _jax(name)
    cfg = dataclasses.replace(base.get_arch(name).smoke, kernel_impl=impl)
    return (cfg, tf.params_from_jax(params, cfg, device="cpu"),
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


@pytest.mark.parametrize("name", jbase.ARCH_IDS)
def test_loss_matches_reference(name):
    _, _, want, want_aux, _ = _jax(name)
    cfg, params, batch = _port(name)
    with torch.no_grad():
        loss, m = tf.loss_fn(params, batch, cfg)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(float(loss), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(m["aux"]), want_aux, rtol=RTOL,
                               atol=ATOL)
    if cfg.moe is not None:
        assert want_aux > 0


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_gradients_match_reference(name):
    *_, want, want_aux, jgrads = _jax(name)
    cfg, params, batch = _port(name)
    loss, m, grads = tstep._loss_and_grads(params, batch, cfg, None)
    np.testing.assert_allclose(float(loss), want, rtol=RTOL, atol=ATOL)
    tol = 2e-3 if name == "xlstm-125m" else 2e-5

    def walk(got, ref, path):
        if isinstance(ref, dict):
            assert sorted(got) == sorted(ref), path
            for k in ref:
                walk(got[k], ref[k], f"{path}/{k}")
            return
        assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
        scale = max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tol * scale, err_msg=path)

    walk(grads, jgrads, "")
    gnorm = float(torch.sqrt(sum(torch.sum(g ** 2)
                                 for g in tree_leaves(grads))))
    assert np.isfinite(gnorm) and gnorm > 0


# ---------------------------------------------------------------------------
# the refusal under the kernel policies, and training under ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "kernel_dynamic"])
def test_both_packages_refuse_to_differentiate_kernels(impl):
    """The reference cannot linearize its Pallas path; the port refuses at
    the first vx verb that would reach a hand-written kernel, before its
    CPU route, and names the reason."""
    jp, jb, *_ = _jax("qwen3-0.6b")
    jimpl = {"kernel": "pallas", "kernel_dynamic": "pallas_dynamic"}[impl]
    jcfg = dataclasses.replace(jbase.get_arch("qwen3-0.6b").smoke,
                               kernel_impl=jimpl)
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.value_and_grad(lambda p: jtf.loss_fn(p, jb, jcfg, None)[0])(jp)
    cfg, params, batch = _port("qwen3-0.6b", impl)
    step = tstep.make_train_step(cfg, tstep.TrainConfig(), None)
    with pytest.raises(RuntimeError, match="no backward"):
        step(tstate.init_train_state(params), batch)
    kv = torch.zeros((2, 3, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="Pallas path either"):
        vx.transpose(vx.Segment(n=8, fields=2), kv, policy=impl)
    with torch.no_grad():          # serving: no operand wants a gradient
        k, v = vx.transpose(vx.Segment(n=8, fields=2), kv, policy=impl)
    assert not k.requires_grad
    vx.transpose(vx.Segment(n=8, fields=2), kv.detach(), policy=impl)
    logits, _, _ = tf.forward(params, batch, cfg)    # no grad wanted
    assert not logits.requires_grad


def test_both_packages_train_under_ref():
    """One train step of the port under ``ref`` from the reference's
    weights and batch: its loss and grad norm are the reference's (which
    ``value_and_grad`` computed under ``ref``); a second step under the
    ambient policy ``vx.use("ref")`` trains too."""
    *_, want, _, jgrads = _jax("qwen3-0.6b")
    cfg, params, batch = _port("qwen3-0.6b", "ref")
    state = tstate.init_train_state(params)
    step = tstep.make_train_step(cfg, tstep.TrainConfig(), None)
    state, m = step(state, batch)
    np.testing.assert_allclose(float(m["loss"]), want, rtol=RTOL)
    wnorm = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                        for g in jax.tree.leaves(jgrads)))
    np.testing.assert_allclose(float(m["grad_norm"]), wnorm, rtol=1e-5)
    assert int(state["opt"]["step"]) == 1
    with vx.use("ref"):            # the ambient policy, as in the reference
        c = dataclasses.replace(cfg, kernel_impl=None)
        state, m = tstep.make_train_step(c, tstep.TrainConfig(), None)(
            state, batch)
    assert int(state["opt"]["step"]) == 2 and np.isfinite(float(m["loss"]))
