"""The twins of the reference's ``examples/*.py`` (``examples_torch/``)
against the reference examples, run here on the CPU.

* ``quickstart``: the reference's script through ``runpy`` (its
  module globals), the twin's ``main(device="cpu")`` values name by name,
  exactly: the LSDO transaction counts, ``dense``, ``out``, ``back``,
  ``fields``, the compaction ids, the runtime-stride gather, the kernel
  deinterleave, the AoS record and its unpack.
* ``moe_dispatch_demo``: the twin on the reference's params and ``x``
  (converted): the top-2 routing, the compacted unit ids, the
  conflict-free flag and ``packed`` exactly; ``|y|`` and ``aux`` of both
  dispatches within 1e-5.
* ``serve_batch``: pages at peak and after finish and each slot's token
  count equal to the reference's run; sampling draws from torch
  generators, so the twin's streams are held equal across two runs of it,
  not against JAX's.
* ``train_100m``: ``build_cfg()`` field for field, and one short
  ``--device cpu`` run (finite losses, a verdict).

The reference's runs are shared through ``functools.lru_cache``.
"""
import contextlib
import functools
import io
import json
import os
import re
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _path(where: str, name: str) -> str:
    return os.path.join(ROOT, where, f"{name}.py")


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """The reference example's module globals after a run as a script
    (its printout kept), or, for a script whose work is in ``main()``,
    that call's printout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(_path("examples", name))
        if name == "serve_batch":
            g["main"]()
    return g, buf.getvalue()


@functools.lru_cache(maxsize=None)
def _twin(name: str):
    """The twin's module globals (its ``main`` not yet called)."""
    return runpy.run_path(_path("examples_torch", name))


def _quiet(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        return fn(*a, **kw), buf.getvalue()


def _eq(got, want, what: str) -> None:
    np.testing.assert_array_equal(np.asarray(got.detach().cpu()
                                             if torch.is_tensor(got)
                                             else got),
                                  np.asarray(want), err_msg=what)


def test_quickstart_matches_reference():
    g, _ = _reference("quickstart")
    out, text = _quiet(_twin("quickstart")["main"], device="cpu")
    from repro import vx as jvx
    assert out["plan"] == (g["plan"].num_transactions,
                           g["plan"].element_wise_transactions)
    for name in ("dense", "out", "back"):
        _eq(out[name], g[name], name)
    assert len(out["fields"]) == len(g["fields"])
    for a, b in zip(out["fields"], g["fields"]):
        _eq(a, b, "fields")
    _eq(out["ids"], jvx.compact(jvx.Compact(n=8, cap=4), g["mask"]), "ids")
    rt = jvx.Strided(n=32, stride=jvx.BANK, offset=2, vl=8)
    _eq(out["rt"], jvx.gather(rt, g["x"][None, :],
                              stride=jnp.int32(3))[0], "runtime stride")
    _eq(out["deint"], g["fast"](jnp.arange(64.0)[None, :])[0], "deint")
    _eq(out["record"], g["record"], "record")
    assert sorted(out["batch"]) == sorted(g["batch"])
    for k in g["batch"]:
        _eq(out["batch"][k], g["batch"][k], k)
    assert "kernel deinterleave ok: [0. 2. 4. 6.]" in text


def test_moe_dispatch_demo_matches_reference():
    g, _ = _reference("moe_dispatch_demo")
    params = {k: torch.from_numpy(np.array(v))
              for k, v in g["params"].items()}
    x = torch.from_numpy(np.array(g["x"]))
    out, text = _quiet(_twin("moe_dispatch_demo")["main"], params, x,
                       device="cpu")
    _eq(out["topi"], g["topi"], "topi")
    n0 = g["n0"]
    _eq(out["compacted"], g["res"].payload[:n0], "compacted ids")
    assert out["conflict_free"] is (not bool(g["res"].conflict)) is True
    _eq(out["packed"], g["packed"], "packed")
    assert out["agrees"] is True
    for dispatch in ("earth", "sort"):
        spec = g["MoESpec"](n_experts=g["E"], top_k=g["k"], d_ff=64,
                            dispatch=dispatch)
        y, aux = g["moe_ffn_local"](
            g["params"]["router"], g["params"]["wg"], g["params"]["wu"],
            g["params"]["wo"], g["x"], spec, model_axis=None, data_axes=(),
            n_shards=1)
        norm, a = out[dispatch]
        np.testing.assert_allclose(norm, float(jnp.linalg.norm(y)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a, float(aux), rtol=1e-5, atol=1e-5)
    assert "conflict-free routing: True" in text
    assert "vx.compact agrees: True" in text


def _serve_numbers(text: str) -> dict:
    peak, pages = map(int, re.search(
        r"pages in use at peak load: (\d+) of (\d+)", text).groups())
    in_use, free = map(int, re.search(
        r"pages after finish: (\d+) in use, (\d+) free", text).groups())
    counts = [len(json.loads(m)) for m in re.findall(r"slot \d+: (\[.*\])",
                                                     text)]
    return {"peak": peak, "num_pages": pages, "in_use": in_use,
            "free": free, "counts": counts}


def test_serve_batch_matches_reference():
    _, text = _reference("serve_batch")
    want = _serve_numbers(text)
    main = _twin("serve_batch")["main"]
    (a, text_a), (b, _) = (_quiet(main, device="cpu") for _ in range(2))
    got = _serve_numbers(text_a)
    assert got == want, (got, want)
    assert (a["peak"], a["num_pages"], a["in_use"], a["free"]) == \
        (want["peak"], want["num_pages"], want["in_use"], want["free"])
    assert [len(v) for v in a["outputs"].values()] == want["counts"]
    assert a["in_use"] == 0 and a["free"] == a["num_pages"]
    assert a["outputs"] == b["outputs"]
    assert "tok/s (CPU)" in text_a


def test_train_100m_build_cfg_matches_reference():
    from test_torch_families import _norm
    g = runpy.run_path(_path("examples", "train_100m"))
    assert _norm(_twin("train_100m")["build_cfg"]()) == _norm(g["build_cfg"]())


@functools.lru_cache(maxsize=None)
def _train_run(ckpt: str):
    """One short ``--device cpu`` run of the twin, its checkpoint cadence
    cut to its last step (the example's is 100)."""
    return _quiet(_twin("train_100m")["main"],
                  ["--device", "cpu", "--steps", "2", "--batch", "2",
                   "--seq", "32", "--ckpt", ckpt, "--ckpt-every", "2"])


def test_train_100m_runs_on_cpu(tmp_path_factory):
    out, text = _train_run(str(tmp_path_factory.getbasetemp() / "ck100m"))
    assert out["finite"] and len(out["losses"]) == 2
    assert out["verdict"] in ("LEARNING", "check setup")
    assert re.search(r"model: qwen3-100m params=\d+\.\dM", text)
    assert re.search(r"loss \d+\.\d{3} -> \d+\.\d{3} \((LEARNING|check "
                     r"setup\))", text)


def test_train_100m_restores_its_last_checkpoint(tmp_path_factory):
    """The twin restores the checkpoint of its last step and holds it
    against the live state, bit for bit."""
    out, text = _train_run(str(tmp_path_factory.getbasetemp() / "ck100m"))
    assert out["restored_equal"] is True, text
    assert "checkpoint step 2 restored bit for bit: True" in text


TWINS = ("quickstart", "moe_dispatch_demo", "serve_batch", "train_100m")
_PROBE = r"""
import runpy, sys
for path in sys.argv[1:]:
    runpy.run_path(path)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(";".join(bad))
"""


def test_twins_import_no_jax_and_no_reference():
    """The twins and ``tools/mem_rank_torch.py`` load with neither JAX nor
    any module of the reference package."""
    import subprocess
    import sys
    paths = [_path("examples_torch", n) for n in TWINS] + [
        os.path.join(ROOT, "tools", "mem_rank_torch.py")]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE, *paths], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "", f"imported {out.stdout.strip()}"


@pytest.mark.parametrize("name", TWINS)
def test_twins_run_on_cuda_unless_told_cpu(name):
    """Without ``--device cpu`` a twin takes the card, and here, with no
    GPU, it raises the port's device error before any work."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    main = _twin(name)["main"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([]) if name == "train_100m" else main()
