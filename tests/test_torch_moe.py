"""Port parity for ``models/moe.py`` against ``repro.models.moe`` on the CPU.

The reference's own case (``tests/test_step_fusion.py``'s
``test_moe_earth_dispatch_still_matches_argsort``: d 32, 4 experts, top-2,
64 tokens, float32) with the reference's weights and ``jax.random``
tokens, at one shard and, as ``moe_ffn_local`` allows without a model
axis, at 2 shards and at 4 shards with a capacity slack of 0.5 (units
dropped), under both dispatches:

- routing bit for bit: the compacted ids, their validity, each unit's
  local expert, the stable sort by expert and the group sizes equal the
  reference's;
- ``y`` within rtol 1e-5 / atol 1e-5 and the aux loss within rtol 1e-5
  (float32; XLA and torch sum the products in different orders);
- ``earth`` against ``sort`` in the port: ``y`` and aux bit for bit (the
  invalid units add zero either way).

The deterministic combine equals the reference's serial
``zeros.at[tok].add(contrib)`` bit for bit in bfloat16 and float32, dropped
rows included; ``_top_k`` takes equal values lower index first, as
``lax.top_k``; ``_capacity`` equals the reference's; a one-rank mesh gives
the one-device bits.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, to_torch
from repro.models import moe as jmoe
from repro_torch.models import moe

D, E, K, T, F = 32, 4, 2, 64, 64
CASES = {"one-shard": (1, 2.0), "two-shards": (2, 2.0),
         "four-shards-drops": (4, 0.5)}


@functools.lru_cache(maxsize=None)
def _jax_params():
    params = jmoe.init_moe(jax.random.key(0), D,
                           jmoe.MoESpec(n_experts=E, top_k=K, d_ff=F),
                           jnp.float32)
    x = jax.random.normal(jax.random.key(1), (T, D))
    return params, x


def _spec(mod, case, dispatch):
    return mod.MoESpec(n_experts=E, top_k=K, d_ff=F,
                       capacity_slack=CASES[case][1], dispatch=dispatch)


@functools.lru_cache(maxsize=None)
def _jax_run(case, dispatch):
    """The reference's ``moe_ffn_local`` and, by its own lines, its
    routing: (y, aux, packed, pv, le, order, gs, units of this shard)."""
    params, x = _jax_params()
    spec = _spec(jmoe, case, dispatch)
    n_shards = CASES[case][0]
    e_loc = E // n_shards
    y, aux = jax.jit(lambda p, x: jmoe.moe_ffn_local(
        p["router"], p["wg"][:e_loc], p["wu"][:e_loc], p["wo"][:e_loc], x,
        spec, model_axis=None, data_axes=(), n_shards=n_shards))(params, x)

    logits = (x @ params["router"].astype(x.dtype)).astype(jnp.float32)
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    expert = topi.reshape(-1).astype(jnp.int32)
    mine = (expert >= 0) & (expert < e_loc)
    cap = jmoe._capacity(T, K, n_shards, spec.capacity_slack)
    packed, pv = jmoe._compact_ids(mine, cap, dispatch)
    le = jnp.where(pv, jnp.take(expert, packed), e_loc)
    order = jnp.argsort(le, stable=True)
    gs = jnp.bincount(jnp.take(le, order), length=e_loc + 1)[:e_loc]
    return tuple(np.asarray(a) for a in (y, aux, packed, pv, le, order,
                                         gs, mine.sum()))


def _port_inputs(case="one-shard"):
    """The reference's weights as torch tensors, the experts cut to the
    shard's first ``E / n_shards`` (what this device holds)."""
    params, x = _jax_params()
    e_loc = E // CASES[case][0]
    return ({k: to_torch(v if k == "router" else v[:e_loc])
             for k, v in params.items()}, to_torch(x))


@pytest.mark.parametrize("dispatch", ["earth", "sort"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_routing_matches_reference_bit_for_bit(case, dispatch):
    params, x = _port_inputs(case)
    r = moe.route(x, params["router"], _spec(moe, case, dispatch),
                  CASES[case][0])
    _, _, packed, pv, le, order, gs, units = _jax_run(case, dispatch)
    assert_bits_equal(r.packed, packed)
    assert np.array_equal(r.pv.numpy(), pv)
    assert np.array_equal(r.le.numpy(), le)
    assert np.array_equal(r.order.numpy(), order)
    assert np.array_equal(r.gs.numpy(), gs)
    if case == "four-shards-drops":     # more units than the capacity
        assert int(units) > len(pv) == int(pv.sum()) == int(gs.sum())


@pytest.mark.parametrize("dispatch", ["earth", "sort"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_local_matches_reference(case, dispatch):
    params, x = _port_inputs(case)
    y, aux = moe.moe_ffn_local(params["router"], params["wg"],
                               params["wu"], params["wo"], x,
                               _spec(moe, case, dispatch),
                               n_shards=CASES[case][0])
    want_y, want_aux = _jax_run(case, dispatch)[:2]
    assert y.dtype == torch.float32 and tuple(y.shape) == (T, D)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_earth_dispatch_matches_argsort_bit_for_bit(case):
    params, x = _port_inputs(case)
    outs = [moe.moe_ffn_local(params["router"], params["wg"], params["wu"],
                              params["wo"], x, _spec(moe, case, dispatch),
                              n_shards=CASES[case][0])
            for dispatch in ("earth", "sort")]
    assert_bits_equal(outs[0][0], outs[1][0])
    assert_bits_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_combine_is_the_serial_scatter_add(dtype):
    """Units in expert-sorted order, each token's top-k slots scattered
    through them, a few rows invalid (zero contributions): the port's
    combine against the reference's scatter-add, bit for bit."""
    rng = np.random.default_rng(5)
    n_tok, k, d = 40, 4, 24
    tok = np.repeat(np.arange(n_tok), k)[rng.permutation(n_tok * k)]
    valid = rng.random(n_tok * k) > 0.1
    contrib = (rng.normal(size=(n_tok * k, d)) * valid[:, None]).astype(
        np.float32)
    jc = jnp.asarray(contrib, getattr(jnp, dtype))
    want = jnp.zeros((n_tok, d), jc.dtype).at[jnp.asarray(tok)].add(jc)
    got = moe._combine(to_torch(jc), torch.from_numpy(tok),
                       torch.from_numpy(valid), n_tok, k)
    assert_bits_equal(got, want)


def test_top_k_takes_ties_lower_index_first():
    probs = np.array([[0.25, 0.25, 0.1, 0.25, 0.15],
                      [0.2, 0.2, 0.2, 0.2, 0.2],
                      [0.1, 0.3, 0.3, 0.0, 0.3]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(probs), 3)
    gv, gi = moe._top_k(torch.from_numpy(probs), 3)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert_bits_equal(gv, wv)


def test_capacity_matches_reference():
    for T_, k, n_shards, slack in ((1, 2, 1, 2.0), (3, 2, 1, 2.0),
                                   (4, 8, 1, 2.0), (64, 2, 4, 0.5),
                                   (5, 3, 2, 1.25), (2048, 8, 16, 2.0)):
        assert moe._capacity(T_, k, n_shards, slack) == \
            jmoe._capacity(T_, k, n_shards, slack)


def test_sharded_moe_is_refused():
    """Expert parallelism no longer waits (item 9h's serving half; 8 ranks
    in tests/test_torch_dist.py): on a one-rank ("data", "model") mesh the
    layer gives the one-device layer's bits, and a mesh-less context is
    the one-device layer."""
    from _torch_dist_run import one_rank_group
    from repro_torch.dist.sharding import (ShardCtx, full_tensor, local_ctx,
                                           make_mesh)
    params, x = _port_inputs()
    spec = _spec(moe, "one-shard", "earth")
    want, want_aux = moe.moe_layer(params, x[None], spec, None)
    got, aux = moe.moe_layer(params, x[None], spec, local_ctx())
    assert_bits_equal(got, want)
    with one_rank_group():
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        ctx = ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model")
        got, aux = moe.moe_layer(params, x[None], spec, ctx)
        got = full_tensor(got)        # placed on (data, model): a DTensor
    assert_bits_equal(got, want)
    assert_bits_equal(aux, want_aux)
