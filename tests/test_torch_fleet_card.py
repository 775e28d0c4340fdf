"""The replica fleet and the chaos harness on the card (no JAX here: the
card's machine has none), at smoke size: a fleet chaos run on CUDA under
``kernel`` and ``kernel_dynamic`` gives the CPU run's report and its
states and streams request by request, with exactly one fused split (B1,
or B6) in every decode step of every replica, dead ones included; no
replica dies but those the plan kills or hangs; ``memory_allocated`` does
not grow across kill / respawn cycles; and every replica reads the one
weight copy the router cast.  Skips without a card."""
import dataclasses

import pytest
import torch

from _torch_bridge import cuda_device  # noqa: F401
from repro_torch.configs.qwen3_0_6b import smoke_config
from repro_torch.kernels import segment
from repro_torch.models.transformer import init_params
from repro_torch.serve.chaos import (FleetChaosConfig, FleetFaultPlan,
                                     StepClock, run_fleet_plan)
from repro_torch.serve.fleet import FleetRouter

pytestmark = pytest.mark.cuda

GEOM = dict(replicas=3, slots=2, max_len=16, page_size=4, num_pages=6,
            queue_depth=3, guard_nan=True, hard_breach_limit=1,
            heartbeat_ticks=4, watchdog_hard_limit=30.0)
PLAN = dict(seed=0, requests=8, steps=32, max_ticks=512)


def _params(device):
    """The seeded weights drawn on the CPU, then moved: init_params draws
    from a generator on its device, and the card's draws differ."""
    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        return tree.to(device)
    return to(init_params(_cfg("ref"), 0, device="cpu"))


def _cfg(impl, dtype="float32"):
    # 4 KV heads of 64: the fused split of a step over 2 slots x 16 beats
    # reaches the policy's launch threshold (2 x 2 x 16 x 4 x 128 elements)
    return dataclasses.replace(smoke_config(), n_kv_heads=4, head_dim=64,
                               kernel_impl=impl, compute_dtype=dtype)


def _counted_fleet(cfg, params, device):
    """A fleet whose every replica, respawns included, records the fused
    split launches of each of its decode steps."""
    fl = FleetRouter(cfg, params, clock=StepClock(), device=device, **GEOM)
    steps = []
    spawn = fl._spawn

    def counted_spawn(idx, generation):
        rep = spawn(idx, generation)
        plain = rep.sched.step

        def step():
            d0 = (segment.deinterleave.launches,
                  segment.deinterleave_dynamic.launches)
            out = plain()
            steps.append((segment.deinterleave.launches - d0[0],
                          segment.deinterleave_dynamic.launches - d0[1]))
            return out
        rep.sched.step = step
        return rep

    fl._spawn = counted_spawn
    fl.replicas = [counted_spawn(i, 0) for i in range(GEOM["replicas"])]
    return fl, steps


def _run(impl, device):
    params = _params(device)
    fl, steps = _counted_fleet(_cfg(impl), params, device)
    rep = run_fleet_plan(fl, FleetFaultPlan(FleetChaosConfig(**PLAN)))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return fl, rep, steps


@pytest.mark.parametrize("impl,split", [("kernel", (1, 0)),
                                        ("kernel_dynamic", (0, 1))])
def test_fleet_chaos_on_card_equals_cpu(cuda_device, impl, split):
    fl, got, steps = _run(impl, cuda_device)
    _, want, _ = _run("ref", torch.device("cpu"))
    fields = ("ticks", "states", "deaths", "respawns", "migrated", "drains",
              "backpressured", "audits", "recovered")
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert [(r.state.value, r.tokens) for r in got.submitted] == \
        [(r.state.value, r.tokens) for r in want.submitted]
    assert got.all_terminal and got.audits == got.ticks and fl.drained()
    assert steps and all(n == split for n in steps), steps
    assert not any((r.death_reason or "").startswith("tick crashed")
                   for r in fl.replicas)


def test_memory_does_not_grow_across_respawns(cuda_device):
    params = _params(cuda_device)
    fl = FleetRouter(_cfg("kernel", "bfloat16"), params, replicas=2,
                     slots=2, max_len=32, page_size=4, device=cuda_device)
    reqs = [fl.submit([3 + i, 5, 7, 9], max_new_tokens=12)
            for i in range(4)]
    for _ in range(3):
        fl.tick()
    torch.cuda.synchronize()
    marks = [torch.cuda.memory_allocated()]
    for _ in range(2):
        fl.kill_replica(0)
        fl.tick()                           # respawn with an empty pool
        fl.audit()
        torch.cuda.synchronize()
        marks.append(torch.cuda.memory_allocated())
    while not all(r.terminal for r in reqs):
        fl.tick()
    assert all(r.state.value == "finished" for r in reqs)
    assert fl.respawns == 2
    assert marks[1] <= marks[0] and marks[2] <= marks[0], marks


def test_replicas_share_one_weight_copy_on_card(cuda_device):
    params = _params(cuda_device)
    fl = FleetRouter(_cfg("kernel", "bfloat16"), params, replicas=3,
                     slots=2, max_len=16, page_size=4, device=cuda_device)
    fl.kill_replica(2)
    fl.tick()

    def ptrs(tree):
        if isinstance(tree, dict):
            return [p for v in tree.values() for p in ptrs(v)]
        return [tree.data_ptr()]

    base = ptrs(fl.params)
    assert all(ptrs(rep.sched.params) == base for rep in fl.replicas)
    assert all(rep.sched.cache.state["table"].is_cuda
               for rep in fl.replicas)
