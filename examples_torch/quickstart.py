"""Quickstart: the EARTH data-movement core through the port's `vx` API.

The PyTorch / CUDA twin of ``examples/quickstart.py``.  One spec type,
four verbs, one policy: every vector memory access goes through
`repro_torch.vx`:
  1. LSDO   — coalesced strided load (plan + shift-network gather),
  2. vx     — declarative gather/scatter/transpose/compact verbs,
  3. Policy — scoped lowering control (no per-call impl strings),
then uses them for a real task: unpacking an AoS training record.

On a GPU the default policy is ``kernel``: the strided gather and
scatter, the segment transposition and the AoS pack / unpack launch the
hand-written CUDA kernels (B3, B5, B1, B2).

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import vx
from repro_torch.core import lsdo
from repro_torch.data import aos
from repro_torch.device import resolve


def _np(x):
    return np.asarray(x.detach().cpu())


def main(device=None) -> dict:
    """Print the walk-through; return the values it prints."""
    dev = resolve(device)
    out = {}

    # --- 1. LSDO: strided access with transaction coalescing ----------------
    buf = torch.arange(1024, dtype=torch.float32, device=dev)
    plan = lsdo.plan_strided(base=8, stride=6, vl=40, mlen=128)
    print(f"strided vl=40 stride=6: {plan.num_transactions} coalesced "
          f"transactions instead of {plan.element_wise_transactions} "
          f"({plan.coalescing_factor:.1f}x)")
    out["plan"] = (plan.num_transactions, plan.element_wise_transactions)
    out["dense"] = dense = lsdo.load_strided(buf, plan)
    print("loaded:", _np(dense[:8]), "...")

    # --- 2. vx verbs: one declarative API for every access pattern -----------
    x = torch.arange(32, dtype=torch.float32, device=dev) * 10
    spec = vx.Strided(n=32, stride=4, offset=2, vl=8)
    out["out"] = g = vx.gather(spec, x[None, :])[0]
    print("gathered every 4th from offset 2:", _np(g))
    out["back"] = back = vx.scatter(
        spec, torch.zeros((1, 32), device=dev), g[None, :])[0]
    print("scattered back:", _np(back[:12]), "...")

    # segment access (AoS <-> SoA) is a transpose over a Segment spec
    out["fields"] = fields = vx.transpose(
        vx.Segment(n=24, fields=3),
        torch.arange(24, dtype=torch.float32, device=dev)[None, :])
    print("AoS [x0,y0,z0,x1,...] -> SoA:",
          [list(map(int, f[0])) for f in fields])

    # masked compaction (the MoE dispatch primitive)
    mask = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0], dtype=torch.bool,
                        device=dev)
    out["ids"] = ids = vx.compact(vx.Compact(n=8, cap=4), mask)
    print("packed indices of set bits:", _np(ids))

    # runtime stride (a tensor): the plan bank picks a compiled plan
    rt = vx.Strided(n=32, stride=vx.BANK, offset=2, vl=8)
    out["rt"] = r = vx.gather(rt, x[None, :],
                              stride=torch.tensor(3, dtype=torch.int32,
                                                  device=dev))[0]
    print("runtime stride 3:", _np(r))

    # --- 3. Policy: scoped lowering, no per-call impl strings ----------------
    # default: REPRO_TORCH_VX_IMPL env var, else kernel on a GPU, ref off it
    print("default policy:", vx.Policy.default())
    with vx.use("kernel"):       # CUDA kernels for CUDA tensors in scope
        out["deint"] = d = vx.transpose(
            vx.Segment(n=64, fields=2),
            torch.arange(64.0, device=dev)[None, :])[0]
        print("kernel deinterleave ok:", _np(d[0, :4]))

    # --- 4. All together: the AoS training-record pipeline -------------------
    tokens = torch.tensor([[5, 6, 7, 8]], dtype=torch.int32, device=dev)
    labels = torch.tensor([[6, 7, 8, 9]], dtype=torch.int32, device=dev)
    w = torch.ones((1, 4), device=dev)
    docs = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    out["record"] = record = aos.pack_records(tokens, labels, w, docs)
    print("AoS record:", _np(record[0]))
    out["batch"] = batch = aos.unpack_records(record)
    print("unpacked tokens:", _np(batch["tokens"][0]), "labels:",
          _np(batch["labels"][0]))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "GPU unless 'cpu' is given)")
    main(ap.parse_args().device)
