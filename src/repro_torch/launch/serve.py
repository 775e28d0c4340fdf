"""Serving CLI: paged continuous batching (chunked prefill + decode +
sampling) through the request lifecycle (typed requests, deadlines,
preemption-and-restore) and the step watchdog.

Port of ``repro``'s ``launch/serve.py``, plain path.  On the card
(qwen3-0.6b at full width, seeded random weights):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --requests 4 --prompt-len 64 --gen 16 --max-len 512

On the CPU (reduced geometry):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu --requests 3 --prompt-len 8 --gen 6 --max-len 64

``--device`` defaults to CUDA and follows the port's rule: without a GPU
the CLI raises unless ``--device cpu`` is given.  Params come from the
port's seeded ``init_params`` and prompts from a seeded generator (the
reference draws both from ``jax.random``); :func:`run` takes both as
arguments so that a caller can feed it the reference's.  The flags of the
chaos harness, the replica fleet, speculative decode, the prefix cache and
the quantized pool are kept and exit with a message naming the ROADMAP.md
queue A item they wait for.
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
from repro_torch.serve.engine import BatchedServer


def _print_stats(stats: dict) -> None:
    """--stats: latency percentiles."""
    lat = stats.get("latency") or {}
    if lat:
        print(f"latency: ttft p50={lat.get('ttft_p50_s', 0.0):.4f}s "
              f"p99={lat.get('ttft_p99_s', 0.0):.4f}s; "
              f"inter-token p50={lat.get('itl_p50_s', 0.0):.5f}s "
              f"p99={lat.get('itl_p99_s', 0.0):.5f}s")
    else:
        print("latency: no samples recorded")


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
                    help="page-pool element type (int8/fp8: queue A item 3)")
    ap.add_argument("--speculate", type=int, default=1, metavar="K",
                    help="speculative decode width (queue A item 7)")
    ap.add_argument("--draft", default=None, metavar="ARCH",
                    help="draft model arch for --speculate")
    ap.add_argument("--stats", action="store_true",
                    help="print latency percentiles (TTFT / inter-token "
                         "p50/p99) after the run")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (default)")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request TTL in seconds (TIMED_OUT beyond)")
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="admission queue bound (backpressure beyond)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix KV pages (queue A item 4)")
    ap.add_argument("--chunk-pages", type=int, default=1,
                    help="prefill chunk budget per tick, in pages")
    ap.add_argument("--check-invariants", action="store_true",
                    help="audit the page pool after every mutation")
    ap.add_argument("--guard-nan", action="store_true",
                    help="fail slots producing non-finite logits (queue A "
                         "item 5)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="seeded fault plan (queue A item 5)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="scheduler replicas behind the fleet router "
                         "(queue A item 6)")
    ap.add_argument("--kill-replica", type=int, default=None,
                    metavar="TICK", help="kill replica 0 at this fleet tick "
                                         "(queue A item 6)")
    return ap


def _refuse_waiting(args) -> None:
    """Exit with a message for a flag whose feature the port lacks yet."""
    waiting = [
        (args.replicas > 1, "--replicas > 1", "6 (the replica fleet)"),
        (args.kill_replica is not None, "--kill-replica",
         "6 (the replica fleet)"),
        (args.chaos is not None, "--chaos", "5 (chaos)"),
        (args.guard_nan, "--guard-nan", "5 (chaos)"),
        (args.speculate > 1, "--speculate > 1", "7 (speculative decode)"),
        (args.prefix_cache, "--prefix-cache", "4 (prefix sharing)"),
        (args.kv_dtype != "float32", f"--kv-dtype {args.kv_dtype}",
         "3 (the quantized pool)"),
    ]
    for on, flag, item in waiting:
        if on:
            raise SystemExit(f"{flag} waits for ROADMAP.md queue A item "
                             f"{item} of the port")
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type.upper()


def seeded_prompts(n: int, length: int, vocab: int,
                   seed: int = 42) -> list[list[int]]:
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, vocab, (max(length, 1),), generator=g).tolist()
            for _ in range(n)]


def run(args, *, params=None, prompts=None) -> list:
    """Serve ``args.requests`` requests and print the reference CLI's
    lines.  ``params`` (on the run's device) and ``prompts`` (token lists)
    default to seeded ones.  Returns the requests."""
    _refuse_waiting(args)
    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.model
    if params is None:
        params = init_params(cfg, 0, device=device)
    if prompts is None:
        prompts = seeded_prompts(args.requests, args.prompt_len, cfg.vocab)
    server = BatchedServer(cfg, params, slots=args.requests,
                           max_len=args.max_len, page_size=args.page_size,
                           temperature=args.temperature, top_k=args.top_k,
                           queue_depth=args.queue_depth,
                           debug_invariants=args.check_invariants,
                           chunk_pages=args.chunk_pages,
                           watchdog=StepWatchdog(), device=device)
    sched = server.scheduler
    reqs = [server.submit(p, max_new_tokens=args.gen, ttl=args.deadline)
            for p in prompts]

    t0 = time.time()
    steps = 0
    while not sched.drained() and steps < 4 * (args.gen + args.requests):
        server.tick()
        steps += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
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
    if args.stats:
        _print_stats(stats)
    return reqs


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
