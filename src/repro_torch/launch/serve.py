"""Serving CLI: paged continuous batching (chunked prefill + decode +
sampling) through the request lifecycle (typed requests, deadlines,
preemption-and-restore) and the step watchdog, an optional in-process
replica FLEET (least-loaded routing, health tracking, replay-based
failover), and chaos modes for both.

Port of ``repro``'s ``launch/serve.py``, plain path.  On the card
(qwen3-0.6b at full width, seeded random weights):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --requests 4 --prompt-len 64 --gen 16 --max-len 512

On the CPU (reduced geometry):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu --requests 3 --prompt-len 8 --gen 6 --max-len 64

``--arch`` takes every arch of the registry that the port runs:
qwen3-0.6b, gemma3-12b, llava-next-mistral-7b, granite-34b,
starcoder2-3b, phi3.5-moe-42b-a6.6b, qwen3-moe-30b-a3b, the hybrid
jamba-1.5-large-398b and the recurrent xlstm-125m.  whisper-tiny exits
with the reference's ``SystemExit("use whisper example for enc-dec
serving")``: the paged scheduler serves decoders only, and whisper serves
through ``serve.engine.jit_prefill`` / ``jit_decode_step``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
      --smoke --device cpu --requests 3 --prompt-len 8 --gen 6 --max-len 64

``--kv-dtype int8`` / ``fp8`` serves from the quantized page pool;
``--prefix-cache`` shares prompt-prefix pages through the radix trie, and
every prompt then opens with the same seeded system prefix (half the
prompt length), so that the hit rate it prints means something:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu --kv-dtype int8 --prefix-cache --chunk-pages 2 \\
      --check-invariants

Fleet failover (3 replicas, replica 0 killed at fleet tick 4, its work
migrates and resumes elsewhere):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu --replicas 3 --kill-replica 4 --requests 4 \\
      --prompt-len 6 --gen 8 --max-len 32 --page-size 4

Chaos (a seeded fault plan, the pool invariants audited every tick; with
``--replicas > 1`` the plan adds replica kills, hangs and admission storms
and the fleet residency audit).  ``--chaos`` turns on ``--guard-nan``.  The
CLI exits 2 when an audit trips, the fleet never drains, or a request ends
outside a terminal typed state:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu --chaos 0 --requests 6 --gen 6 [--replicas 3 \\
      --max-len 32 --page-size 4]

Speculative decode (``--speculate K``, greedy only): a draft model
(``--draft ARCH``, by default the target's arch with weights from seed 1)
proposes K-1 tokens and the target verifies all K in one fused page
gather per step; ``--stats`` then prints the acceptance line:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu --speculate 4 --stats

``--device`` defaults to CUDA and follows the port's rule: without a GPU
the CLI raises unless ``--device cpu`` is given.  Params come from the
port's seeded ``init_params`` and prompts from a seeded generator (the
reference draws both from ``jax.random``); :func:`run` takes the target's
and the draft's params and the prompts as arguments so that a caller can
feed it the reference's.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs.base import get_arch
from repro_torch.device import resolve as resolve_device
from repro_torch.ft.straggler import StepWatchdog
from repro_torch.models.transformer import init_params
from repro_torch.serve.chaos import (ChaosConfig, FaultPlan,
                                     FleetChaosConfig, FleetFaultPlan,
                                     StepClock, run_fleet_plan, run_plan)
from repro_torch.serve.engine import BatchedServer, make_fleet
from repro_torch.serve.fleet import FleetAuditError
from repro_torch.serve.lifecycle import (LifecycleError, RequestState,
                                         TERMINAL_STATES)
from repro_torch.serve.paged_cache import InvariantViolation

EXIT_CHAOS = 2          # audit tripped / non-typed termination / livelock


def _check_typed(requests) -> list[str]:
    """Every request must sit in a TERMINAL typed state, and FAILED ones
    must carry an error string — anything else is a lifecycle escape."""
    problems = []
    for r in requests:
        if r.state not in TERMINAL_STATES:
            problems.append(f"req {r.rid} non-terminal: {r.state.value}")
        elif r.state is RequestState.FAILED and not r.error:
            problems.append(f"req {r.rid} FAILED without a typed error")
    return problems


def _print_stats(stats: dict) -> None:
    """--stats: latency percentiles and speculation acceptance."""
    lat = stats.get("latency") or {}
    if lat:
        print(f"latency: ttft p50={lat.get('ttft_p50_s', 0.0):.4f}s "
              f"p99={lat.get('ttft_p99_s', 0.0):.4f}s; "
              f"inter-token p50={lat.get('itl_p50_s', 0.0):.5f}s "
              f"p99={lat.get('itl_p99_s', 0.0):.5f}s")
    else:
        print("latency: no samples recorded")
    sp = stats.get("speculative")
    if sp:
        print(f"speculative: K={sp.get('k', '?')} "
              f"acceptance={sp['acceptance']:.2f} "
              f"({sp['accepted']}/{sp['proposed']} drafts accepted)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "GPU unless 'cpu' is given)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--kv-dtype", choices=("float32", "int8", "fp8"),
                    default="float32",
                    help="page-pool element type; int8/fp8 store "
                         "quantized pages with per-page scales, the "
                         "dequant inside the one page gather")
    ap.add_argument("--speculate", type=int, default=1, metavar="K",
                    help="speculative decode width: a draft model proposes "
                         "K-1 tokens and the target verifies all K in one "
                         "fused page gather per step (greedy sampling "
                         "only)")
    ap.add_argument("--draft", default=None, metavar="ARCH",
                    help="draft model arch for --speculate (defaults to "
                         "--arch; must be attention-only)")
    ap.add_argument("--stats", action="store_true",
                    help="print latency percentiles (TTFT / inter-token "
                         "p50/p99) and speculation acceptance after the "
                         "run")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (default)")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request TTL in seconds (TIMED_OUT beyond)")
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="admission queue bound (backpressure beyond)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix KV pages through the radix "
                         "trie (attention-only stacks); every prompt opens "
                         "with one seeded system prefix")
    ap.add_argument("--chunk-pages", type=int, default=1,
                    help="prefill chunk budget per tick, in pages")
    ap.add_argument("--check-invariants", action="store_true",
                    help="audit the page pool after every mutation")
    ap.add_argument("--guard-nan", action="store_true",
                    help="fail (only) slots producing non-finite logits")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="run a seeded fault plan instead of clean "
                         "serving (fleet faults when --replicas > 1); "
                         "exits 2 on an audit trip or a non-typed end")
    ap.add_argument("--replicas", type=int, default=1,
                    help="in-process scheduler replicas behind the fleet "
                         "router (least-loaded admission, health-checked "
                         "failover)")
    ap.add_argument("--kill-replica", type=int, default=None,
                    metavar="TICK",
                    help="kill replica 0 at this fleet tick; its work "
                         "migrates and resumes elsewhere (needs "
                         "--replicas > 1)")
    return ap


def _refuse(args) -> None:
    """Exit for a combination the reference CLI refuses."""
    if args.speculate > 1 and args.temperature > 0.0:
        raise SystemExit("--speculate requires greedy sampling "
                         "(drop --temperature)")
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if args.kill_replica is not None and args.replicas < 2:
        raise SystemExit("--kill-replica needs --replicas > 1 "
                         "(killing the only replica strands the work)")


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type.upper()


def seeded_prompts(n: int, length: int, vocab: int, seed: int = 42, *,
                   shared_prefix: bool = False) -> list[list[int]]:
    """``n`` seeded prompts of ``length`` tokens; with ``shared_prefix``
    each opens with the same system prefix of ``length // 2`` tokens."""
    g = torch.Generator().manual_seed(seed)
    sys_prefix = (torch.randint(0, vocab, (length // 2,), generator=g)
                  .tolist() if shared_prefix else [])
    n_tail = max(length - len(sys_prefix), 1)
    return [sys_prefix + torch.randint(0, vocab, (n_tail,),
                                       generator=g).tolist()
            for _ in range(n)]


def _wall(t0: float, device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time() - t0


def _run_chaos_single(sched, args, device) -> list:
    plan = FaultPlan(ChaosConfig(seed=args.chaos, requests=args.requests,
                                 max_prompt=min(args.prompt_len,
                                                args.max_len // 2),
                                 max_new_tokens=args.gen))
    t0 = time.time()
    try:
        rep = run_plan(sched, plan)
    except (InvariantViolation, LifecycleError) as e:
        print(f"CHAOS FAIL: audit tripped: {type(e).__name__}: {e}")
        raise SystemExit(EXIT_CHAOS)
    dt = _wall(t0, device)
    print(f"chaos seed {args.chaos}: {rep.ticks} ticks in {dt:.2f}s — "
          f"states={rep.states} preemptions={rep.preemptions} "
          f"nan_failures={rep.nan_failures} "
          f"invariant_checks={rep.invariant_checks} "
          f"backpressured={rep.backpressured}")
    problems = _check_typed(rep.submitted)
    if problems:
        print("CHAOS FAIL: " + "; ".join(problems))
        raise SystemExit(EXIT_CHAOS)
    print("every request reached a terminal typed state; "
          "invariants never tripped")
    if args.stats:
        _print_stats(sched.stats())
    return rep.submitted


def _run_chaos_fleet(router, args, device) -> list:
    plan = FleetFaultPlan(FleetChaosConfig(
        seed=args.chaos, replicas=args.replicas, requests=args.requests,
        max_prompt=min(args.prompt_len, args.max_len // 2),
        max_new_tokens=args.gen))
    t0 = time.time()
    try:
        rep = run_fleet_plan(router, plan)
    except (FleetAuditError, InvariantViolation, LifecycleError) as e:
        print(f"FLEET CHAOS FAIL: audit tripped: "
              f"{type(e).__name__}: {e}")
        raise SystemExit(EXIT_CHAOS)
    dt = _wall(t0, device)
    print(f"fleet chaos seed {args.chaos}: {rep.ticks} ticks in "
          f"{dt:.2f}s — states={rep.states} deaths={rep.deaths} "
          f"respawns={rep.respawns} migrated={rep.migrated} "
          f"drains={rep.drains} recovered={rep.recovered} "
          f"audits={rep.audits} backpressured={rep.backpressured}")
    if rep.ticks >= plan.cfg.max_ticks:
        print("FLEET CHAOS FAIL: fleet never drained (livelock)")
        raise SystemExit(EXIT_CHAOS)
    problems = _check_typed(rep.submitted)
    if problems:
        print("FLEET CHAOS FAIL: " + "; ".join(problems))
        raise SystemExit(EXIT_CHAOS)
    print("every request reached a terminal typed state; the fleet "
          "audit held every tick")
    if args.stats:
        _print_stats(router.stats())
    return rep.submitted


def _run_fleet(router, args, prompts, device) -> list:
    reqs = [router.submit(p, max_new_tokens=args.gen, ttl=args.deadline)
            for p in prompts]
    t0 = time.time()
    cap = 8 * (args.gen + args.requests)
    while not (router.drained() and all(r.terminal for r in reqs)) \
            and router.tick_no < cap:
        if args.kill_replica is not None and \
                router.tick_no + 1 == args.kill_replica:
            print(f"killing replica 0 at tick {args.kill_replica}")
            router.kill_replica(0, reason="--kill-replica")
        router.tick()
        router.audit()
    dt = _wall(t0, device)
    for r in reqs:
        print(f"req {r.rid}: {r.state.value:>9} on r{r.replica} "
              f"(migrations={r.migrations}) {r.tokens[:12]} ...")
    stats = router.stats()
    generated = sum(r.generated for r in reqs)
    recovered = sum(1 for r in reqs if r.migrations > 0
                    and r.state is RequestState.FINISHED)
    print(f"fleet: {stats['ticks']} ticks, {generated} tokens in "
          f"{dt:.2f}s ({generated / max(dt, 1e-9):.1f} tok/s on "
          f"{device_name(device)}); "
          f"deaths={stats['deaths']} respawns={stats['respawns']} "
          f"migrated={stats['migrated']} recovered={recovered} "
          f"drains={stats['drains']} rejoins={stats['rejoins']}")
    for idx, rs in stats["replicas"].items():
        print(f"  r{idx}: {rs['state']:>8} gen={rs['generation']} "
              f"load={rs['load']} hard_breaches={rs['hard_breaches']} "
              f"pages_in_use={rs['pages_in_use']}")
    if "prefix_hit_rate" in stats:
        print(f"fleet prefix cache: hit_rate={stats['prefix_hit_rate']:.2f} "
              f"({stats['prefix_hits']}/"
              f"{stats['prefix_hits'] + stats['prefix_misses']}), "
              f"{stats['prefix_tokens_reused']} tokens reused, "
              f"{stats['shared_pages']} shared pages fleet-wide")
    if args.stats:
        _print_stats(stats)
    problems = _check_typed(reqs)
    if problems:
        print("FLEET FAIL: " + "; ".join(problems))
        raise SystemExit(EXIT_CHAOS)
    return reqs


def run(args, *, params=None, prompts=None, draft_params=None) -> list:
    """Serve ``args.requests`` requests and print the reference CLI's
    lines: clean serving on one scheduler, a replica fleet
    (``--replicas > 1``), or a chaos plan over either (``--chaos``, whose
    plan draws its own prompts).  ``params`` (on the run's device),
    ``draft_params`` (with ``--speculate > 1``) and ``prompts`` (token
    lists) default to seeded ones: seed 0 for the target, seed 1 for the
    draft.  Returns the requests; raises ``SystemExit(2)`` when an audit
    trips, the fleet never drains, or a request ends outside a terminal
    typed state."""
    _refuse(args)
    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.model
    if cfg.encoder is not None:
        raise SystemExit("use whisper example for enc-dec serving")
    device = resolve_device(args.device)
    if params is None:
        params = init_params(cfg, 0, device=device)
    spec_kw = {}
    if args.speculate > 1:
        draft_arch = get_arch(args.draft or args.arch)
        draft_cfg = draft_arch.smoke if args.smoke else draft_arch.model
        if draft_params is None:
            draft_params = init_params(draft_cfg, 1, device=device)
        spec_kw = dict(speculate=args.speculate, draft_cfg=draft_cfg,
                       draft_params=draft_params)
    if prompts is None and args.chaos is None:
        prompts = seeded_prompts(args.requests, args.prompt_len, cfg.vocab,
                                 shared_prefix=args.prefix_cache)
    knobs = dict(temperature=args.temperature, top_k=args.top_k,
                 queue_depth=args.queue_depth,
                 guard_nan=args.guard_nan or args.chaos is not None,
                 debug_invariants=args.check_invariants,
                 prefix_cache=args.prefix_cache,
                 chunk_pages=args.chunk_pages,
                 kv_quant=(None if args.kv_dtype == "float32"
                           else args.kv_dtype), device=device, **spec_kw)
    if args.replicas > 1:
        if args.chaos is not None:
            # a quantized clock and a hard limit it dwarfs: determinism
            knobs.update(clock=StepClock(), watchdog_hard_limit=30.0,
                         hard_breach_limit=1)
        router = make_fleet(cfg, params, replicas=args.replicas,
                            slots=args.requests, max_len=args.max_len,
                            page_size=args.page_size, **knobs)
        if args.chaos is not None:
            return _run_chaos_fleet(router, args, device)
        return _run_fleet(router, args, prompts, device)
    server = BatchedServer(cfg, params, slots=args.requests,
                           max_len=args.max_len, page_size=args.page_size,
                           watchdog=StepWatchdog(), **knobs)
    sched = server.scheduler
    if args.chaos is not None:
        return _run_chaos_single(sched, args, device)
    reqs = [server.submit(p, max_new_tokens=args.gen, ttl=args.deadline)
            for p in prompts]

    t0 = time.time()
    steps = 0
    while not sched.drained() and steps < 4 * (args.gen + args.requests):
        server.tick()
        steps += 1
    dt = _wall(t0, device)
    generated = sum(r.generated for r in reqs)
    cache = sched.cache
    print(f"pages: {cache.pages_in_use()} in use of {cache.num_pages} "
          f"({cache.used_cache_bytes()} cache bytes backing live "
          f"requests)")
    for r in reqs:
        print(f"req {r.rid}: {r.state.value:>9} {r.tokens[:12]} ...")
    stats = sched.stats()
    print(f"{steps} ticks, {generated} tokens in {dt:.2f}s "
          f"({generated / max(dt, 1e-9):.1f} tok/s on "
          f"{device_name(device)}); "
          f"preemptions={stats['preemptions']} "
          f"prefill_chunks={stats['prefill_chunks']} "
          f"watchdog_breaches={stats.get('watchdog_breaches', 0)}")
    if "prefix" in stats:
        px = stats["prefix"]
        print(f"prefix cache: hit_rate={px['hit_rate']:.2f} "
              f"({px['hits']}/{px['hits'] + px['misses']}), "
              f"{px['tokens_reused']} tokens reused, "
              f"{stats['shared_pages']} shared pages, "
              f"{px['pages']} trie pages ({px['evicted']} evicted)")
    if args.stats:
        _print_stats(stats)
    return reqs


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
