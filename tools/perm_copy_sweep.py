#!/usr/bin/env python3
"""Launch-shape sweep of the port's permuted copy (B6 / B8) on one card.

Run from the repository root on a machine with a CUDA card:

    python3 tools/perm_copy_sweep.py

B6 (``segment.deinterleave_dynamic``) and B8
(``strided.gather_strided_dynamic``) are a derive kernel plus a persistent
permuted copy (``src/repro_torch/csrc/perm_copy.cuh``).  This script times
them, in turns and twice (forward then reverse order), over the copy's
shared-memory budget per block (``_common.COPY_SMEM``) and blocks per SM
(``_common.min_blocks``), both set here for the run only: on qwen3-0.6b's
decode KV stack ``(28, 4, 512, 8, 256)`` bf16 (B6's FIELD=2 split, B8 at
(2, 1)) and on Fig. 12 windows of 256 MiB at strides 2, 16 and 64.  Then
the derive kernel alone (device time through a CUDA graph, beside the same
calls timed with events, which a host-bound call inflates), B6 and B8
through a graph, and two yardsticks: B6's library call and a plain
``clone()`` of the stack (the same bytes as B6, no permutation).
"""
from __future__ import annotations

import functools
import sys
from pathlib import Path

CONFIGS = ((96, 2), (64, 3), (48, 4), (72, 3), (32, 6), (112, 2), (96, 1),
           (200, 1))        # (KB of shared memory a block, blocks per SM)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("perm_copy_sweep: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    from chip_smoke import card_line, graph_ms, time_ms
    from repro_torch.kernels import _common, segment, strided
    events = functools.partial(time_ms, iters=20)
    graph = functools.partial(graph_ms, iters=20)
    print(f"card: {card_line()}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    kv = torch.randn((28, 4, 512, 8, 256), generator=g,
                     device=dev).to(torch.bfloat16)
    wins = {s: torch.randn(((1 << 28) // (128 * s), 64 * s), generator=g,
                           device=dev).to(torch.bfloat16)
            for s in (2, 16, 64)}

    def b6():
        return segment.deinterleave(kv, 2, fused=False)

    def b8():
        return strided.gather_strided(kv, 2, 1, 128, compiled=False)

    budget, blocks = _common.COPY_SMEM, _common.min_blocks
    for order in (CONFIGS, CONFIGS[::-1]):
        for kb, per_sm in order:
            _common.COPY_SMEM = kb * 1024
            _common.min_blocks = lambda d, k=per_sm: k * sms
            line = [f"smem {kb}K x{per_sm}/SM: B6 {events(b6):.4f}",
                    f"B8 {events(b8):.4f}"]
            for s, w in wins.items():
                ms = events(lambda: strided.gather_strided(
                    w, s, 0, 64, compiled=False))
                line.append(f"fig12 s={s} {ms:.4f}")
            print(" ".join(line) + " (ms)", flush=True)
    _common.COPY_SMEM, _common.min_blocks = budget, blocks
    for s in wins:
        n = 64 * s

        def derive():
            return strided.dynamic_sources(n, s, 0, 64, device=dev)

        print(f"derive n={n} (stride {s}, vl 64): graph "
              f"{graph(derive):.4f} ms, events {events(derive):.4f} ms")
    b8_table = graph(lambda: strided.dynamic_sources(256, 2, 1, 128,
                                                     device=dev))
    b6_tables = graph(lambda: segment.deinterleave_sources(256, 2,
                                                           device=dev))
    print(f"derive n=256 (2, 1), vl 128: graph {b8_table:.4f} ms; B6 "
          f"tables n=256: graph {b6_tables:.4f} ms")
    print(f"graph: B6 {graph(b6):.4f} ms, B8 {graph(b8):.4f} ms")
    R = kv.numel() // 256
    library = events(lambda: kv.view(R, 128, 2).permute(2, 0, 1)
                     .contiguous())
    print(f"yardsticks: B6 library {library:.4f} ms, clone of the stack "
          f"{events(lambda: kv.clone()):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
