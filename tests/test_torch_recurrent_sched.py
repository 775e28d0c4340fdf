"""Port parity for the recurrent and hybrid models through the serving
layers above the step: jamba-smoke (Mamba and attention, MoE) and
xlstm-smoke (mLSTM and sLSTM, no attention), against ``repro`` with the
reference's weights, on the CPU (the forward and the caches:
tests/test_torch_recurrent_serve.py).

- The scheduler: greedy streams of both archs under ``ref`` and
  ``kernel`` exactly the reference's (three requests on two slots, so a
  released slot is reused); a released slot holds the reference's initial
  recurrent state bit for bit and streams as a fresh one.
- ``PagedCache`` bytes: ``page_bytes``, ``used_cache_bytes`` and
  ``total_cache_bytes`` equal the reference's tick by tick on the stream
  runs (xlstm-smoke, jamba-smoke; qwen3 at int8), and xlstm-125m at 4 slots, ``max_len`` 512
  and page 16 holds 94 717 056 bytes with no page.
- The CLI for both archs: the reference CLI's streams and its page and
  request lines (the page line carries ``used_cache_bytes``).
"""
import dataclasses
import functools
import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_bridge import assert_bits_equal, jax_tree_to_np
from repro.configs import base as jbase
from repro.models import decode as jdec
from repro.models import transformer as jtf
from repro.serve.paged_cache import PagedCache as JPagedCache
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch.configs import base
from repro_torch.launch import serve as cli
from repro_torch.models import transformer as tf
from repro_torch.serve.paged_cache import PagedCache
from repro_torch.serve.scheduler import Scheduler
from test_torch_engine import _reference_cli, _reference_prompts

JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-125m"
ARCHS = (JAMBA, XLSTM)
SLOTS, PROMPT_LEN, GEN, MAX_LEN, PAGE = 2, 20, 6, 64, 4


@functools.lru_cache(maxsize=None)
def _jax(name):
    cfg = jbase.get_arch(name).smoke
    return cfg, jtf.init_params(cfg, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _port(name, impl="ref"):
    _, jparams = _jax(name)
    cfg = dataclasses.replace(base.get_arch(name).smoke, kernel_impl=impl)
    return cfg, tf.params_from_jax(jax_tree_to_np(jparams), cfg,
                                   device="cpu")


def _tree_bits(got, want):
    """Leaf by leaf, the recurrent NamedTuples by their fields."""
    if isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__
        for a, b in zip(got, want):
            _tree_bits(a, b)
    else:
        assert_bits_equal(got.reshape(-1), np.asarray(want).reshape(-1))


def _prompts(vocab, n=SLOTS + 1):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, PROMPT_LEN + 3 * i).tolist()
            for i in range(n)]


def _bytes(cache):
    return (cache.page_bytes(), cache.used_cache_bytes(),
            cache.total_cache_bytes(), cache.pages_in_use())


def _serve(sched, prompts):
    """Greedy streams of ``prompts`` and the cache's bytes after every
    tick."""
    reqs = [sched.submit(p, max_new_tokens=GEN) for p in prompts]
    seen = []
    for _ in range(400):
        sched.tick()
        seen.append(_bytes(sched.cache))
        if sched.drained():
            break
    assert sched.drained()
    assert all(r.state.value == "finished" for r in reqs)
    return [r.tokens for r in reqs], seen


@functools.lru_cache(maxsize=None)
def _jax_run(name, quant):
    jcfg, jparams = _jax(name)
    return _serve(JScheduler(jcfg, jparams, slots=SLOTS, max_len=MAX_LEN,
                             page_size=PAGE, kv_quant=quant),
                  _prompts(jcfg.vocab))


@functools.lru_cache(maxsize=None)
def _port_run(name, impl, quant):
    cfg, params = _port(name, impl)
    return _serve(Scheduler(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                            page_size=PAGE, kv_quant=quant, device="cpu"),
                  _prompts(cfg.vocab))


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("name", ARCHS)
def test_scheduler_streams_match_reference(name, impl):
    """Three requests on two slots: the third waits for a released slot,
    whose recurrent state must start again from init."""
    assert _port_run(name, impl, None)[0] == _jax_run(name, None)[0]


@pytest.mark.parametrize("name", ARCHS)
def test_released_slot_is_reset_and_reused(name):
    """A finished request's slot holds the reference's initial recurrent
    state bit for bit, and the next request on it streams as it does on a
    fresh scheduler."""
    jcfg, _ = _jax(name)
    cfg, params = _port(name)
    first, second = _prompts(cfg.vocab, 2)
    sched = Scheduler(cfg, params, slots=1, max_len=MAX_LEN, page_size=PAGE,
                      device="cpu")
    _serve(sched, [first])
    init = jdec.init_paged_cache(jcfg, 1, MAX_LEN, PAGE, jnp.float32)
    for i, kind in enumerate(cfg.block_pattern):
        if kind != "attn":
            _tree_bits(sched.cache.state["blocks"][f"pos{i}"],
                       init["blocks"][f"pos{i}"])
    reused = _serve(sched, [second])[0]
    fresh = _serve(Scheduler(cfg, params, slots=1, max_len=MAX_LEN,
                             page_size=PAGE, device="cpu"), [second])[0]
    assert reused == fresh


# ---------------------------------------------------------------------------
# cache bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,quant", [(XLSTM, None), (JAMBA, None),
                                        ("qwen3-0.6b", "int8")])
def test_cache_bytes_match_reference(name, quant):
    """``page_bytes``, ``used_cache_bytes``, ``total_cache_bytes`` and the
    pages in use after every tick of the same traffic on the port's and
    the reference's schedulers (the runs the stream test holds)."""
    got, want = _port_run(name, "ref", quant)[1], _jax_run(name, quant)[1]
    assert got == want
    pages = {b[3] for b in got}
    assert (len(pages) > 1) == ("attn" in base.get_arch(name).smoke
                                .block_pattern)


def test_xlstm_125m_cache_bytes_at_the_serve_size():
    """xlstm-125m at 4 slots, max_len 512, page 16: 94 716 544 bytes of
    recurrent state and a 512-byte table, no page; the reference's
    numbers."""
    name = XLSTM
    got = PagedCache(base.get_arch(name).model, 4, 512, 16, device="cpu")
    want = JPagedCache(jbase.get_arch(name).model, 4, 512, 16)
    assert (got.page_bytes(), got.used_cache_bytes()) == (0, 94_717_056)
    assert _bytes(got) == _bytes(want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_cli_matches_reference_cli(monkeypatch, name):
    """The reference's params and prompts through ``run``: the reference
    CLI's greedy streams and its page and request lines (the page line
    carries ``used_cache_bytes``, recurrent state included)."""
    flags = ["--arch", name, "--smoke", "--requests", "3", "--prompt-len",
             "10", "--gen", "6", "--max-len", "32", "--page-size", "4"]
    want_lines, want_streams = _reference_cli(monkeypatch, base=flags)
    cfg, params = _port(name)
    args = cli.parser().parse_args(flags + ["--device", "cpu"])
    out = io.StringIO()
    with redirect_stdout(out):
        reqs = cli.run(args, params=params,
                       prompts=_reference_prompts(cfg.vocab, n=3, length=10))
    got_lines = out.getvalue().splitlines()
    assert [r.tokens for r in reqs] == want_streams
    assert all(r.state.value == "finished" for r in reqs)

    def keep(lines):
        return [re.sub(r"^req \d+:", "req:", ln) for ln in lines
                if ln.startswith(("pages:", "req "))]
    assert keep(got_lines) == keep(want_lines)
    assert len(keep(got_lines)) == 4
