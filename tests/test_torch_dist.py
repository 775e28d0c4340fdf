"""The reference's seven distributed SERVING checks (``tests/_dist_checks.py``)
held against the port run as 8 ``gloo`` ranks on the CPU.

The reference side runs here, in this process, on one device: its
replicated ``vx`` lowering and its unsharded / unfused decode steps, the
oracles its own checks hold its sharded results to.  The port side runs
in ``tests/_torch_dist_run.py`` (no JAX): ONE spawn of 8 ranks for all
seven checks, inputs and outputs through ``.npz`` files, the reference's
mesh layouts ``(8,)``, ``(2, 4)`` and ``(4, 2)``.

- ``sharded_vx_property``: the lane-sharded strided gather / scatter
  (strides of either sign) and the outer-sharded segment transposition
  equal the reference's replicated lowering bit for bit, under ``ref`` and
  under ``kernel`` (the CPU takes each kernel's plain route; the kernel
  wrappers' call counts show the route); a ``DTensor`` placed on another
  axis is refused;
- ``paged_pool_shard`` / ``quantized_pool_shard``: the page gather of a
  pool sharded on its page axis (full, partial and unallocated tables,
  the fused two-pool form, float and int8 with scales) bit for bit; no
  collective of a pool-sized operand; five paged decode steps with
  ``pool_shard`` bit for bit against the replicated step, over the
  replicated pool and over a pool really sharded (a ``DTensor``: each
  rank holds 1/8 of it and appends only the beats of its own pages), the
  pools equal after;
- ``seq_parallel_decode`` / ``longctx_fused_decode``: the sequence-sharded
  long-context step on ``(2, 4)`` within 3e-3 of the reference's
  unsharded step; fused == per-access bit for bit, caches included; no
  collective of a cache-leaf-sized operand;
- ``longctx_launch_gate``: on each rank, ``2 * fused <= per-access`` for
  the kernel calls and for the routing-table operands;
- ``moe_ep_equivalence``: expert-parallel MoE on ``(2, 4)`` within 2e-4
  of the reference's one-device layer, its aux within rtol 0.1.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist_run import LAYOUTS, STRIDED
from repro import vx as jvx

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CHECKS = ("sharded_vx_property", "paged_pool_shard", "quantized_pool_shard",
          "seq_parallel_decode", "longctx_fused_decode",
          "longctx_launch_gate", "moe_ep_equivalence")
IMPLS = ("ref", "kernel")


# ---------------------------------------------------------------------------
# The reference side (inputs from the reference's seeds, and its oracles)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _vx_property():
    """Inputs drawn in the reference check's order, and the reference's
    replicated results."""
    rng = np.random.default_rng(0)
    inp, want = {}, {}
    for li, _ in enumerate(LAYOUTS):
        w = np.asarray(rng.normal(size=(3, 64)), np.float32)
        inp[f"L{li}/w"] = w
        for j, (s, o) in enumerate(STRIDED):
            spec = jvx.Strided(n=64, stride=s, offset=o, vl=8)
            vals = np.asarray(rng.normal(size=(3, 8)), np.float32)
            inp[f"L{li}/v{j}"] = vals
            want[f"L{li}/g{j}"] = np.asarray(jvx.gather(
                spec, jnp.asarray(w), policy="ref"))
            want[f"L{li}/s{j}"] = np.asarray(jvx.scatter(
                spec, jnp.asarray(w), jnp.asarray(vals), policy="ref"))
        for fields in (2, 4):
            aos = np.asarray(rng.normal(size=(2, 16, 8 * fields)),
                             np.float32)
            inp[f"L{li}/aos{fields}"] = aos
            got = jvx.transpose(jvx.Segment(n=8 * fields, fields=fields),
                                jnp.asarray(aos), policy="ref")
            for f, g in enumerate(got):
                want[f"L{li}/t{fields}/{f}"] = np.asarray(g)
            want[f"L{li}/back{fields}"] = aos
    return inp, want


def _tables(rng) -> np.ndarray:
    tables = np.full((3, 6), -1, np.int32)
    tables[0, :6] = rng.permutation(16)[:6]                  # full
    tables[1, :3] = [15, 0, 7]                               # partial
    return tables                                            # row 2 unset


@functools.lru_cache(maxsize=None)
def _paged():
    rng = np.random.default_rng(0)
    pool = np.asarray(rng.normal(size=(2, 16, 4, 2, 8)), np.float32)
    table = _tables(rng)
    spec = jvx.Paged(page_size=4, pages=6, trail=2)
    want = np.asarray(jvx.gather(spec, jnp.asarray(pool),
                                 table=jnp.asarray(table), policy="ref"))
    return {"pool": pool, "table": table}, want


@functools.lru_cache(maxsize=None)
def _quantized():
    rng = np.random.default_rng(0)
    pool = np.asarray(rng.integers(-127, 128, (2, 16, 4, 2, 8)), np.int8)
    scales = np.asarray(rng.uniform(0.01, 2.0, (2, 16, 2)), np.float32)
    table = _tables(rng)
    spec = jvx.Paged(page_size=4, pages=6, trail=2)
    want = np.asarray(jvx.gather(spec, jnp.asarray(pool),
                                 table=jnp.asarray(table),
                                 scales=jnp.asarray(scales), policy="ref"))
    return {"pool": pool, "scales": scales, "table": table}, want


@functools.lru_cache(maxsize=None)
def _longctx():
    """The reference check's smoke qwen3 weights, its seeded noise cache
    (seq 32, batch 8, len 16) and token; its unsharded fused and unfused
    logits."""
    from repro.configs import get_arch
    from repro.configs.base import decode_inputs
    from repro.models import decode as dec
    from repro.models.transformer import init_params
    cfg = get_arch("qwen3-0.6b").smoke
    params = init_params(cfg, jax.random.key(0))
    cache, token = decode_inputs(cfg, seq=32, batch=8, specs=False,
                                 cache_dtype=jnp.float32)
    cache["len"] = jnp.asarray(16, jnp.int32)
    cache["blocks"] = jax.tree.map(
        lambda a: jax.random.normal(jax.random.key(2), a.shape, a.dtype)
        if a.dtype != jnp.int32 else a, cache["blocks"])
    want = {fuse: np.asarray(jax.jit(
        lambda p, c, t, f=fuse: dec.decode_step(p, c, t, cfg, None,
                                                fuse=f))(
        params, cache, token)[0]) for fuse in (True, False)}
    inp = {"len": np.asarray(16), "token": np.asarray(token)}
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    for kp, leaf in flat:
        inp["params/" + "/".join(k.key for k in kp)] = np.asarray(leaf)
    for k, v in cache["blocks"].items():
        inp[f"blocks/{k}"] = np.asarray(v)
    return inp, want


@functools.lru_cache(maxsize=None)
def _moe():
    from repro.models.moe import MoESpec, init_moe, moe_layer
    spec = MoESpec(n_experts=8, top_k=2, d_ff=96, capacity_slack=8.0)
    params = init_moe(jax.random.key(0), 64, spec, jnp.float32)
    x = jax.random.normal(jax.random.key(1), (4, 16, 64))
    y, aux = jax.jit(lambda p, x: moe_layer(p, x, spec, None))(params, x)
    inp = {k: np.asarray(v) for k, v in params.items()}
    inp["x"] = np.asarray(x)
    return inp, (np.asarray(y), float(aux))


# ---------------------------------------------------------------------------
# The port side: one spawn of 8 ranks for every check
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    inp = {}
    for name, (i, _) in (("sharded_vx_property", _vx_property()),
                         ("paged_pool_shard", _paged()),
                         ("quantized_pool_shard", _quantized()),
                         ("seq_parallel_decode", _longctx()),
                         ("longctx_fused_decode", _longctx()),
                         ("longctx_launch_gate", _longctx()),
                         ("moe_ep_equivalence", _moe())):
        inp.update({f"{name}/{k}": v for k, v in i.items()})
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")])
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_dist_run.py"),
         ",".join(CHECKS), str(d / "in.npz"), str(d / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-6000:]
    with np.load(d / "out.npz") as f:
        return dict(f)


def _out(port, check: str) -> dict:
    return {k.split("/", 1)[1]: v for k, v in port.items()
            if k.startswith(check + "/")}


@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_vx_property(port, impl):
    got = _out(port, "sharded_vx_property")
    _, want = _vx_property()
    for key, w in want.items():
        np.testing.assert_array_equal(got[f"{impl}/{key}"], w, err_msg=key)
    for li, _ in enumerate(LAYOUTS):
        # rank 0's calls of B3 / B5 (its rebased sub-accesses, the
        # Reverser's included) and B1 / B2 (the 2 + 2 transpositions);
        # none under ref
        b3, b5, b1, b2 = got[f"{impl}/L{li}/calls"]
        if impl == "kernel":
            assert b3 > 0 and b5 > 0 and (b1, b2) == (2, 2), (li, b3, b5)
        else:
            assert (b3, b5, b1, b2) == (0, 0, 0, 0), li


def test_sharded_vx_refuses_misplaced_operand(port):
    got = _out(port, "sharded_vx_property")
    assert [int(got[f"L{li}/refused"]) for li, _ in enumerate(LAYOUTS)] == \
        [1] * len(LAYOUTS)


@pytest.mark.parametrize("impl", IMPLS)
def test_paged_pool_shard(port, impl):
    got = _out(port, "paged_pool_shard")
    _, want = _paged()
    for li, _ in enumerate(LAYOUTS):
        for key in ("one", "placed", "many0"):
            np.testing.assert_array_equal(got[f"{impl}/L{li}/{key}"], want)
        np.testing.assert_array_equal(got[f"{impl}/L{li}/many1"], want * 2)
        # the one merge is (3, 2, 24, 2, 8): no pool-sized collective
        assert 2 * 16 * 4 * 2 * 8 not in set(got[f"L{li}/collective_numels"])


@pytest.mark.parametrize("check", ("paged_pool_shard",
                                   "quantized_pool_shard"))
def test_pool_shard_serving(port, check):
    """Five paged decode steps with ``pool_shard``: over the replicated
    pool and over pools placed as ``DTensor`` s, bit for bit against the
    replicated step; the owner-local appends leave the placed pools equal
    to the replicated ones, and each rank holds 1/8 of their bytes."""
    got = _out(port, check)
    rep = got["serve/logits/rep"]
    np.testing.assert_array_equal(got["serve/logits/shd"], rep)
    np.testing.assert_array_equal(got["serve/logits/placed"], rep)
    keys = {k.rsplit("/", 1)[1] for k in got if k.startswith("serve/rep/")}
    assert any(k.startswith("pos") for k in keys)
    assert any(k.startswith("scl") for k in keys) == \
        (check == "quantized_pool_shard")
    for k in keys:
        np.testing.assert_array_equal(got[f"serve/placed/{k}"],
                                      got[f"serve/rep/{k}"], err_msg=k)
    whole, mine = got["serve/bytes"]
    assert mine * 8 == whole, (whole, mine)


@pytest.mark.parametrize("impl", IMPLS)
def test_quantized_pool_shard(port, impl):
    got = _out(port, "quantized_pool_shard")
    _, want = _quantized()
    for li, _ in enumerate(LAYOUTS):
        np.testing.assert_array_equal(got[f"{impl}/L{li}"], want)


def test_seq_parallel_decode(port):
    got = _out(port, "seq_parallel_decode")
    _, want = _longctx()
    np.testing.assert_allclose(got["logits"], want[True], rtol=3e-3,
                               atol=3e-3)


def test_longctx_fused_decode(port):
    """Fused == per-access on one placement, bit for bit (logits and every
    cache leaf, each a ``DTensor`` sharded on its sequence); both within
    3e-3 of the reference's unsharded unfused step."""
    got = _out(port, "longctx_fused_decode")
    _, want = _longctx()
    np.testing.assert_array_equal(got["fused/logits"], got["per/logits"])
    leaves = [k.split("/", 2)[2] for k in got if k.startswith("fused/cache/")]
    assert leaves
    for k in leaves:
        np.testing.assert_array_equal(got[f"fused/cache/{k}"],
                                      got[f"per/cache/{k}"], err_msg=k)
        assert bool(got[f"fused/placed/{k}"]), k
    assert int(got["fused/len"]) == int(got["per/len"]) == 17
    np.testing.assert_allclose(got["fused/logits"], want[False], rtol=3e-3,
                               atol=3e-3)


def test_longctx_no_cache_sized_collective(port):
    """No collective of either step carries a cache leaf, one of its split
    halves, a layer of either or a rank's block of any of these: the
    collectives are the softmax merges and the weights' layer gathers."""
    got = _out(port, "longctx_fused_decode")
    inp, _ = _longctx()
    cache_like = set()
    for k, v in inp.items():
        if k.startswith("blocks/"):
            ns, b, s, kh, d2 = v.shape
            for last in (d2, d2 // 2):
                for seq in (s, s // 8):
                    cache_like |= {(ns, b, seq, kh, last), (b, seq, kh, last)}
    cache_like = {",".join(map(str, sh)) for sh in cache_like}
    for tag in ("fused", "per"):
        shapes = set(got[f"{tag}/collective_shapes"].tolist())
        assert int(got[f"{tag}/collectives"]) > 0 and shapes
        assert not shapes & cache_like, (tag, sorted(shapes & cache_like))


def test_longctx_launch_gate(port):
    got = _out(port, "longctx_launch_gate")
    assert int(got["nshards"]) == 8
    counts = got["counts"]
    assert counts.shape == (8, 4)
    for lf, mf, lp, mp in counts:
        assert lf >= 1 and mf >= 1, counts
        assert 2 * lf <= lp and 2 * mf <= mp, counts


def test_moe_ep_equivalence(port):
    got = _out(port, "moe_ep_equivalence")
    _, (y, aux) = _moe()
    np.testing.assert_allclose(got["y"], y, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(got["aux"]), aux, rtol=0.1)
