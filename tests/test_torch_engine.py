"""Port parity for the serving entry points: serve/engine.py (jit_prefill,
jit_decode_step, BatchedServer) and the serve CLI (launch/serve.py)
against repro's, with the reference's weights and prompts, on the CPU.

Tolerances: greedy token streams are equal, and so are the CLI's printed
page and request lines, and its fleet and chaos lines (chaos on one
scheduler and on a fleet, a fleet with a replica killed, a fleet at int8)
but for their wall times.  The dense steps' logits agree within rtol 1e-5 /
atol 1e-5 (float32 matmuls summed in another order).  The scheduler's
step watchdog sees every decode step.
"""
import dataclasses
import functools
import io
import os
import re
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import jax_tree_to_np, to_torch
from repro.configs import get_arch as jget_arch
from repro.dist.sharding import local_ctx
from repro.models import decode as jdec
from repro.models.transformer import init_params as jinit
from repro.serve import engine as jengine
from repro_torch.configs.base import get_arch
from repro_torch.ft.straggler import StepWatchdog
from repro_torch.launch import serve as cli
from repro_torch.models import decode as dec
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve import engine
from repro_torch.serve.scheduler import Scheduler

SRC = Path(__file__).resolve().parents[1] / "src"
RTOL = ATOL = 1e-5
N_REQ, PROMPT_LEN, GEN, MAX_LEN = 3, 8, 6, 64
CLI_ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--requests", str(N_REQ),
            "--prompt-len", str(PROMPT_LEN), "--gen", str(GEN),
            "--max-len", str(MAX_LEN)]


@functools.lru_cache(maxsize=None)
def _jax():
    cfg = jget_arch("qwen3-0.6b").smoke
    return cfg, jinit(cfg, jax.random.key(0))


def _port(impl="ref"):
    jcfg, jparams = _jax()
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke, kernel_impl=impl)
    return cfg, params_from_jax(jax_tree_to_np(jparams), cfg, device="cpu")


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, PROMPT_LEN).tolist() for _ in range(N_REQ)]


def _drain(server, prompts):
    reqs = [server.submit(p, max_new_tokens=GEN) for p in prompts]
    for _ in range(200):
        server.tick()
        if server.scheduler.drained():
            break
    assert server.scheduler.drained()
    return [r.tokens for r in reqs]


# ---------------------------------------------------------------------------
# serve/engine.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fuse_step", [True, False])
def test_batched_server_streams_match_reference(fuse_step):
    jcfg, jparams = _jax()
    cfg, params = _port()
    prompts = _prompts()
    want = _drain(jengine.BatchedServer(jcfg, jparams, slots=N_REQ,
                                        max_len=MAX_LEN, fuse_step=fuse_step),
                  prompts)
    got = _drain(engine.BatchedServer(cfg, params, slots=N_REQ,
                                      max_len=MAX_LEN, fuse_step=fuse_step,
                                      device="cpu"), prompts)
    assert got == want
    assert all(len(t) == PROMPT_LEN + GEN for t in got)


def test_batched_server_legacy_surface_matches_reference():
    """add_request (a prompt list and a single token) / step / finish, and
    the legacy ``cache`` view."""
    jcfg, jparams = _jax()
    cfg, params = _port()
    js = jengine.BatchedServer(jcfg, jparams, slots=2, max_len=32,
                               page_size=4)
    ts = engine.BatchedServer(cfg, params, slots=2, max_len=32, page_size=4,
                              device="cpu")
    prompt = _prompts(1)[0]
    for s in (js, ts):
        assert s.add_request(prompt=prompt) == 0
        assert s.add_request(17) == 1
    for _ in range(5):
        assert ts.step() == js.step()
    assert ts.tokens == js.tokens and ts.active == js.active
    assert int(ts.cache["len"]) == int(js.cache["len"])
    assert sorted(ts.cache["blocks"]) == sorted(js.cache["blocks"])
    assert ts.finish(0) == js.finish(0)
    assert ts.finish(0) == js.finish(0) == []
    with pytest.raises(ValueError):
        ts.add_request()


@pytest.mark.parametrize("fuse", [True, False])
def test_jit_prefill_and_decode_step_match_reference(fuse):
    jcfg, jparams = _jax()
    cfg, params = _port()
    scfg_j = jengine.ServeConfig(max_len=24, step_fusion=fuse)
    scfg = engine.ServeConfig(max_len=24, step_fusion=fuse)
    toks = np.random.default_rng(3).integers(0, 512, (2, 10)).astype(
        np.int32)
    ctx = local_ctx()
    jpre = jengine.jit_prefill(jcfg, ctx, jparams,
                               {"tokens": jnp.asarray(toks)})
    tpre = engine.jit_prefill(cfg, None, device="cpu")
    want, wstates = jpre(jparams, {"tokens": jnp.asarray(toks)})
    got, states = tpre(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(states["pos0"].numpy(),
                               np.asarray(wstates["pos0"]), rtol=RTOL,
                               atol=ATOL)
    jc = jdec.cache_from_prefill(jcfg, wstates, 10, 24, jnp.float32)
    tc = dec.cache_from_prefill(
        cfg, {k: to_torch(np.asarray(v)) for k, v in wstates.items()}, 10,
        24)
    jstep = jengine.jit_decode_step(jcfg, ctx, scfg_j, jparams, jc)
    tstep = engine.jit_decode_step(cfg, None, scfg, device="cpu")
    tok = np.argmax(np.asarray(want)[:, -1], -1).astype(np.int32)
    for _ in range(4):
        want, jc = jstep(jparams, jc, jnp.asarray(tok))
        got, tc = tstep(params, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), tok)


def test_engine_refuses_what_waits():
    cfg, _ = _port()
    mesh = types.SimpleNamespace(mesh=object())
    no_mesh = types.SimpleNamespace(mesh=None)
    scfg = engine.ServeConfig(max_len=16)
    assert scfg.cache_dtype == "bfloat16" and scfg.step_fusion
    assert engine.cache_specs(cfg, None, scfg, {}) is None
    assert engine.cache_specs(cfg, no_mesh, scfg, {}) is None
    assert engine.serve_param_shardings({}, cfg, no_mesh) is None
    for call in (lambda: engine.cache_specs(cfg, mesh, scfg, {}),
                 lambda: engine.serve_param_shardings({}, cfg, mesh),
                 lambda: engine.jit_prefill(cfg, mesh, device="cpu"),
                 lambda: engine.jit_decode_step(cfg, mesh, scfg,
                                                device="cpu"),
                 lambda: engine.jit_decode_step(
                     cfg, None, dataclasses.replace(scfg, long_context=True),
                     device="cpu")):
        with pytest.raises(NotImplementedError, match="dist"):
            call()
    # make_fleet(replicas=1) is one BatchedServer's scheduler behind a
    # router: the same streams
    cfg, params = _port()
    prompts = _prompts(4)
    want = _drain(engine.BatchedServer(cfg, params, slots=N_REQ,
                                       max_len=MAX_LEN, device="cpu"),
                  prompts)
    fleet = engine.make_fleet(cfg, params, replicas=1, slots=N_REQ,
                              max_len=MAX_LEN, device="cpu")
    reqs = [fleet.submit(p, max_new_tokens=GEN) for p in prompts]
    while not fleet.drained():
        fleet.tick()
        fleet.audit()
    assert [r.tokens for r in reqs] == want


def test_scheduler_feeds_the_watchdog():
    cfg, params = _port()
    wd = StepWatchdog()
    sched = Scheduler(cfg, params, slots=2, max_len=MAX_LEN, device="cpu",
                      watchdog=wd)
    reqs = [sched.submit(p, max_new_tokens=GEN) for p in _prompts(2)[:2]]
    while not sched.drained():
        sched.tick()
    assert all(r.generated == GEN for r in reqs)
    assert wd.observations == sched.decode_steps > 0
    assert sched.stats()["watchdog_breaches"] == wd.breaches
    assert "watchdog_breaches" not in Scheduler(
        cfg, params, slots=1, max_len=16, device="cpu").stats()


# ---------------------------------------------------------------------------
# launch/serve.py
# ---------------------------------------------------------------------------

def _reference_cli(monkeypatch, extra=(), base=CLI_ARGS):
    """The reference CLI's printed lines and its requests' full streams
    (every request a scheduler or the fleet router registered, in request
    id order, which is submission order)."""
    from repro.launch import serve as jserve
    servers = []

    class Recording(jengine.BatchedServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self.scheduler)

    def recording_fleet(*a, **kw):
        servers.append(jmake_fleet(*a, **kw))
        return servers[-1]

    jmake_fleet = jengine.make_fleet
    monkeypatch.setattr(jserve, "BatchedServer", Recording)
    monkeypatch.setattr(jengine, "make_fleet", recording_fleet)
    monkeypatch.setattr(sys, "argv", ["serve"] + list(base) + list(extra))
    out = io.StringIO()
    with redirect_stdout(out):
        try:
            jserve.main()
        except SystemExit as e:
            assert e.code in (None, 0), out.getvalue()
    reqs = sorted(servers[0].requests.values(), key=lambda r: r.rid)
    return out.getvalue().splitlines(), [r.tokens for r in reqs]


def _reference_prompts(vocab, prefix_cache=False, n=N_REQ,
                       length=PROMPT_LEN):
    """The reference CLI's prompts (launch/serve.py: jax.random, key 42
    folded with the request index; with --prefix-cache a shared system
    prefix of half the prompt length, key 42 folded with 999983)."""
    key = jax.random.key(42)
    sys_prefix = []
    if prefix_cache:
        sys_prefix = [int(t) for t in jax.random.randint(
            jax.random.fold_in(key, 999983), (length // 2,), 0, vocab)]
    return [sys_prefix + [int(t) for t in jax.random.randint(
        jax.random.fold_in(key, r), (length - len(sys_prefix),), 0,
        vocab)] for r in range(n)]


def test_cli_matches_reference_cli(monkeypatch):
    """The reference's params and prompts through ``run``: the reference
    CLI's greedy streams and its page and request lines."""
    want_lines, want_streams = _reference_cli(monkeypatch)
    cfg, params = _port()
    args = cli.parser().parse_args(CLI_ARGS + ["--device", "cpu"])
    out = io.StringIO()
    with redirect_stdout(out):
        reqs = cli.run(args, params=params,
                       prompts=_reference_prompts(cfg.vocab))
    got_lines = out.getvalue().splitlines()
    assert [r.tokens for r in reqs] == want_streams
    assert all(r.state.value == "finished" for r in reqs)

    def keep(lines):
        # request ids count up per process: drop them
        return [re.sub(r"^req \d+:", "req:", ln) for ln in lines
                if ln.startswith(("pages:", "req "))]
    assert keep(got_lines) == keep(want_lines)
    assert len(keep(got_lines)) == N_REQ + 1
    assert "tok/s on CPU" in got_lines[-1]
    assert "watchdog_breaches=" in got_lines[-1]


def test_cli_subprocess_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *CLI_ARGS,
         "--device", "cpu", "--stats"], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum("finished" in ln for ln in lines) == N_REQ
    assert any("tok/s on CPU" in ln for ln in lines)
    assert lines[-1].startswith("latency:")


@functools.lru_cache(maxsize=None)
def _draft():
    """The reference CLI's draft weights (the target's smoke arch, seed 1)
    as the port's."""
    jcfg, _ = _jax()
    cfg, _ = _port()
    return params_from_jax(jax_tree_to_np(jinit(jcfg, jax.random.key(1))),
                           cfg, device="cpu")


SPEC_LINES = ("pages:", "req ", "speculative:")


@pytest.mark.parametrize("flags,item", [
    (["--speculate", "2"], "item 7")])
def test_cli_flags_that_wait_exit_with_their_item(monkeypatch, flags, item):
    """The flag that waited for queue A ``item`` runs now: with the
    reference's params, draft and prompts, the reference CLI's streams and
    its page, request and ``speculative:`` lines."""
    flags = flags + ["--stats"]
    want_lines, want_streams = _reference_cli(monkeypatch, flags)
    cfg, params = _port()
    args = cli.parser().parse_args(CLI_ARGS + ["--device", "cpu"] + flags)
    out = io.StringIO()
    with redirect_stdout(out):
        reqs = cli.run(args, params=params, draft_params=_draft(),
                       prompts=_reference_prompts(cfg.vocab))
    got_lines = out.getvalue().splitlines()
    assert [r.tokens for r in reqs] == want_streams, item

    def keep(lines):
        return [re.sub(r"^req \d+:", "req:", ln) for ln in lines
                if ln.startswith(SPEC_LINES)]
    assert keep(got_lines) == keep(want_lines)
    assert got_lines[-1].startswith("speculative: K=2 ")


@pytest.mark.parametrize("flags", [["--speculate", "4", "--stats"],
                                   ["--speculate", "4", "--stats",
                                    "--kv-dtype", "int8"]])
def test_cli_speculative_matches_reference_cli(monkeypatch, flags):
    """``--speculate 4 --stats`` (float32 and int8 pools): the reference
    CLI's streams and its page, request and acceptance lines."""
    want_lines, want_streams = _reference_cli(monkeypatch, flags)
    cfg, params = _port()
    args = cli.parser().parse_args(CLI_ARGS + ["--device", "cpu"] + flags)
    out = io.StringIO()
    with redirect_stdout(out):
        reqs = cli.run(args, params=params, draft_params=_draft(),
                       prompts=_reference_prompts(cfg.vocab))
    got_lines = out.getvalue().splitlines()
    assert [r.tokens for r in reqs] == want_streams
    assert all(r.state.value == "finished" for r in reqs)

    def keep(lines):
        return [re.sub(r"^req \d+:", "req:", ln) for ln in lines
                if ln.startswith(SPEC_LINES)]
    assert keep(got_lines) == keep(want_lines)
    assert len(keep(got_lines)) == N_REQ + 2


def test_cli_speculate_refuses_sampling():
    with pytest.raises(SystemExit, match="greedy"):
        cli.main(CLI_ARGS + ["--device", "cpu", "--speculate", "4",
                             "--temperature", "0.8"])


# the four fault-tolerance runs of chip_smoke.py phase 9, at smoke size
FAULT_RUNS = {
    "chaos-single": "--chaos 5 --requests 6 --gen 6 --check-invariants "
                    "--prefix-cache --chunk-pages 2",
    "fleet-kill": "--replicas 3 --kill-replica 4 --requests 4 --prompt-len 6 "
                  "--gen 8 --max-len 32 --page-size 4",
    "fleet-chaos": "--replicas 3 --chaos 0 --requests 6 --gen 6 --max-len 32 "
                   "--page-size 4",
    "fleet-chaos-int8": "--replicas 2 --chaos 7 --requests 6 --gen 6 "
                        "--max-len 32 --page-size 4 --kv-dtype int8",
    # ci.yml's speculative fleet chaos smoke
    "fleet-chaos-int8-speculative": "--replicas 3 --chaos 0 --requests 6 "
                                    "--gen 6 --max-len 32 --page-size 4 "
                                    "--kv-dtype int8 --speculate 4 --stats"}
FAULT_LINES = ("req ", "fleet:", "  r", "killing replica", "chaos seed",
               "fleet chaos seed", "fleet prefix cache:", "every request",
               "speculative:")


@pytest.mark.parametrize("name", sorted(FAULT_RUNS))
def test_cli_fault_runs_match_reference_cli(monkeypatch, name):
    """Chaos on one scheduler and on a fleet, a fleet with replica 0
    killed, and fleet chaos at int8: with the reference's params (and its
    prompts where the run does not draw them from the plan), the reference
    CLI's streams and its request, fleet, replica and chaos lines, wall
    times aside."""
    flags = FAULT_RUNS[name].split()
    base = ["--arch", "qwen3-0.6b", "--smoke"]
    want_lines, want_streams = _reference_cli(monkeypatch, flags, base)
    cfg, params = _port()
    args = cli.parser().parse_args(base + flags + ["--device", "cpu"])
    prompts = None
    if args.chaos is None:
        prompts = _reference_prompts(cfg.vocab, n=args.requests,
                                     length=args.prompt_len)
    out = io.StringIO()
    with redirect_stdout(out):
        reqs = cli.run(args, params=params, prompts=prompts,
                       draft_params=_draft() if args.speculate > 1 else None)
    got_lines = out.getvalue().splitlines()
    assert [r.tokens for r in reqs] == want_streams
    assert all(r.terminal for r in reqs)

    def keep(lines):
        lines = [ln for ln in lines if ln.startswith(FAULT_LINES)]
        lines = [re.sub(r"^req \d+:", "req:", ln) for ln in lines]
        return [re.sub(r" in [0-9.]+s( \([^)]*\))?", "", ln)
                for ln in lines]
    assert keep(got_lines) == keep(want_lines)
    if args.speculate > 1:
        assert got_lines[-1].startswith("speculative: K=4 ")
    elif args.chaos is not None:
        assert got_lines[-1].startswith(
            "every request reached a terminal typed state")
    else:
        assert any(ln.startswith("fleet:") and "deaths=1 " in ln
                   for ln in got_lines)


@pytest.mark.parametrize("flags", [
    ["--prefix-cache", "--chunk-pages", "2", "--check-invariants"],
    ["--kv-dtype", "int8"], ["--kv-dtype", "fp8"]])
def test_cli_quant_and_prefix_flags_match_reference_cli(monkeypatch, flags):
    """The quantized pools and the prefix cache through the CLI: with the
    reference's params and prompts, the reference CLI's streams and its
    page, request and prefix-cache lines."""
    want_lines, want_streams = _reference_cli(monkeypatch, flags)
    cfg, params = _port()
    args = cli.parser().parse_args(CLI_ARGS + ["--device", "cpu"] + flags)
    out = io.StringIO()
    with redirect_stdout(out):
        reqs = cli.run(args, params=params, prompts=_reference_prompts(
            cfg.vocab, "--prefix-cache" in flags))
    got_lines = out.getvalue().splitlines()
    assert [r.tokens for r in reqs] == want_streams
    assert all(r.state.value == "finished" for r in reqs)

    def keep(lines):
        return [re.sub(r"^req \d+:", "req:", ln) for ln in lines
                if ln.startswith(("pages:", "req ", "prefix cache:"))]
    assert keep(got_lines) == keep(want_lines)
    assert len(keep(got_lines)) == N_REQ + 1 + ("--prefix-cache" in flags)
