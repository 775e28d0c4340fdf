#!/usr/bin/env python3
"""Time kernels B7 and B11-B14 of one checkout of the port on one card,
so that two commits can be compared in one call (parent, change, change,
parent).

    python3 tools/kernel_ab.py [--root DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels there, holds each timed output bit for bit against the plain
version, and prints one line per measurement, each with the card's
``nvidia-smi`` name and power limit on the first line:

* B7, ``segment.interleave(fused=False)``, at the 16-token prefill re-pack
  ``(1, 16, 8, 128)`` x2 bf16: CUDA-event time at the host's launch rate
  (``chip_smoke.time_ms``) and device time alone (a CUDA graph of 20
  calls, ``chip_smoke.graph_ms``), beside ``torch.stack(..., -1)
  .flatten(-2)``;
* B7 at the decode stack ``(28, 4, 512, 8, 128)`` x2 bf16;
* B14, ``shift_scatter.shift_scatter`` with tensor counts, and B13,
  ``shift_scatter.shift_scatter_static`` on the plan of the same counts
  as host data, on the KV stack ``(28, 4, 512, 8, 256)`` bf16 (values
  zero-padded from 128 lanes) with ``scg.scatter_counts(256, 2, 1,
  128)``, each beside ``torch.gather`` by the plan's source index plus a
  ``where``;
* B12, ``shift_gather.shift_gather`` with tensor counts, on the same
  stack with ``scg.gather_counts(256, 2, 1, 128)``, beside the same
  library call on its plan, and its derive kernel alone
  (``_indexed.dyn_sources(gsn=True)``, CUDA graph) at n = 256;
* B11, ``shift_gather.shift_gather_static`` on the plan of the same
  counts as host data, on the same stack;
* the Indexed gather's static-routing arm, ``vx.gather(Indexed(n,
  routing=...))`` on the same counts (torch ops, no kernel), on the same
  stack.

Exits non-zero without a card.  Seeded; nothing is written.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default="", help="name printed on each line")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from chip_smoke import card_line, graph_ms, same_bits, time_ms
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.core import scg
    from repro_torch.kernels import _common, _indexed, segment, \
        shift_gather, shift_scatter
    _common.build_all(_common.SOURCES)
    tag = f"ab[{args.label or args.root}]"
    print(f"{tag} card: {card_line()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def bf16(shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def held(run, plain, what):
        got, want = run(), plain()
        got = got if isinstance(got, (list, tuple)) else [got]
        want = want if isinstance(want, (list, tuple)) else [want]
        torch.cuda.synchronize()
        if not all(same_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{what} differs from its plain version")

    k, v = bf16((1, 16, 8, 128)), bf16((1, 16, 8, 128))
    b7 = (lambda: segment.interleave([k, v], fused=False))
    lib = (lambda: torch.stack([k, v], dim=-1).flatten(-2))
    held(b7, lambda: segment.interleave_dynamic_plain([k, v]), "B7")
    print(f"{tag} B7 [1, 16, 8, 128, 'x2']: host rate {time_ms(b7, 20):.4f} "
          f"ms, device alone {graph_ms(b7, 20):.4f} ms; library host rate "
          f"{time_ms(lib, 20):.4f} ms, device alone {graph_ms(lib, 20):.4f} "
          f"ms")
    kb, vb = bf16((28, 4, 512, 8, 128)), bf16((28, 4, 512, 8, 128))
    b7s = (lambda: segment.interleave([kb, vb], fused=False))
    held(b7s, lambda: segment.interleave([kb, vb]), "B7 at the stack")
    print(f"{tag} B7 [28, 4, 512, 8, 128, 'x2']: {time_ms(b7s, 20):.4f} ms; "
          f"B2 {time_ms(lambda: segment.interleave([kb, vb]), 20):.4f} ms")
    del kb, vb
    n, vl = 256, 128
    x = torch.nn.functional.pad(bf16((28, 4, 512, 8, vl)), (0, n - vl))
    ss, sv = scg.scatter_counts(n, 2, 1, vl, device=dev)
    b14 = (lambda: list(shift_scatter.shift_scatter(x, ss, sv)))
    held(b14, lambda: list(shift_scatter.shift_scatter_plain(x, ss, sv)),
         "B14")
    hs, hv = ss.cpu().numpy(), sv.cpu().numpy()
    plan = shift_gather.host_plan(hs, hv, gather=False)

    def library(x, plan):
        src = torch.from_numpy(plan.source).to(dev).clamp(min=0).expand(
            x.shape)
        keep = torch.from_numpy(plan.valid).to(dev)
        return lambda: torch.where(keep, torch.gather(x, -1, src), 0)

    print(f"{tag} B14 [28, 4, 512, 8, 256, 'tensor counts (2,1) vl 128']: "
          f"{time_ms(b14, 20):.4f} ms; library "
          f"{time_ms(library(x, plan), 20):.4f} ms")
    b13 = (lambda: list(shift_scatter.shift_scatter_static(x, plan)))
    held(b13, lambda: list(shift_scatter.shift_scatter_static_plain(x, plan)),
         "B13")
    print(f"{tag} B13 [28, 4, 512, 8, 256, 'host counts (2,1) vl 128']: "
          f"{time_ms(b13, 20):.4f} ms")
    del x
    kv = bf16((28, 4, 512, 8, n))
    gs, gv = scg.gather_counts(n, 2, 1, vl, device=dev)
    gplan = shift_gather.host_plan(gs.cpu().numpy(), gv.cpu().numpy(),
                                   gather=True)
    b12 = (lambda: shift_gather.shift_gather(kv, gs, gv))
    held(b12, lambda: shift_gather.shift_gather_plain(kv, gs, gv), "B12")
    gs32, gv32 = gs.to(torch.int32), gv.to(torch.int32)
    derive = graph_ms(lambda: _indexed.dyn_sources(
        gs32, gv32, gsn=True, elem=2, unit=16), 20)
    print(f"{tag} B12 [28, 4, 512, 8, 256, 'tensor counts (2,1) vl 128']: "
          f"{time_ms(b12, 20):.4f} ms; library "
          f"{time_ms(library(kv, gplan), 20):.4f} ms; GSN derivation alone "
          f"{derive:.4f} ms")
    b11 = (lambda: shift_gather.shift_gather_static(kv, gplan))
    held(b11, lambda: shift_gather.shift_gather_static_plain(kv, gplan),
         "B11")
    print(f"{tag} B11 [28, 4, 512, 8, 256, 'host counts (2,1) vl 128']: "
          f"{time_ms(b11, 20):.4f} ms")
    from repro_torch import vx
    ix = vx.Indexed(n=n, routing=(
        tuple(int(s) for s in gs.cpu().numpy().reshape(-1)),
        tuple(bool(v) for v in gv.cpu().numpy().reshape(-1))))
    arm = (lambda: vx.gather(ix, kv, policy="kernel"))
    held(arm, lambda: shift_gather.shift_gather_static_plain(kv, gplan),
         "vx.gather(Indexed routing)")
    print(f"{tag} vx.gather[Indexed routing] [28, 4, 512, 8, 256, 'host "
          f"counts (2,1) vl 128']: {time_ms(arm, 10):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
