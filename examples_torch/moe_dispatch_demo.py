"""EARTH MoE dispatch, visualized: routing -> compaction -> grouped GEMM.

The PyTorch / CUDA twin of ``examples/moe_dispatch_demo.py``.  Shows the
shift-network token compaction (the paper's GSN with prefix-sum SCG)
packing each expert's tokens, and verifies against argsort dispatch.

Run:  PYTHONPATH=src python examples_torch/moe_dispatch_demo.py \\
          [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import vx
from repro_torch.core import scg, shiftnet
from repro_torch.device import resolve
from repro_torch.models.moe import MoESpec, init_moe, moe_ffn_local

T, d, E, k = 16, 32, 4, 2


def main(params=None, x=None, device=None) -> dict:
    """Print the walk-through; return the values it prints.  ``params``
    (the ``init_moe`` leaves) and ``x`` (T, d) default to seeded ones
    (generators 0 and 1)."""
    dev = resolve(device)
    if params is None:
        params = init_moe(d, MoESpec(n_experts=E, top_k=k, d_ff=64),
                          torch.Generator(dev).manual_seed(0),
                          torch.float32, dev)
    if x is None:
        x = torch.randn((T, d), generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    params = {n: v.to(dev) for n, v in params.items()}
    x = x.to(dev)
    out = {}

    # --- routing -------------------------------------------------------------
    logits = x @ params["router"]
    topw, topi = torch.topk(torch.softmax(logits, -1), k)
    out["topi"] = topi
    print("expert assignment per token (top-2):")
    print(np.asarray(topi.cpu()).T)

    # --- EARTH compaction for expert 0 ---------------------------------------
    units = topi.reshape(-1)
    mine = units == 0
    shift, valid = scg.compaction_counts(mine)
    ids = torch.arange(T * k, dtype=torch.int32, device=dev)
    res = shiftnet.gather_network(ids, shift, valid)
    n0 = int(mine.sum())
    out["compacted"] = res.payload[:n0]
    print(f"\nexpert 0 owns {n0} (token,slot) units; "
          f"compacted unit ids: {np.asarray(res.payload[:n0].cpu())}")
    out["conflict_free"] = not bool(res.conflict)
    print("conflict-free routing:", out["conflict_free"])

    # the same compaction through the public vx API (what moe.py calls)
    out["packed"] = packed = vx.compact(vx.Compact(n=T * k, cap=T * k), mine)
    out["agrees"] = bool(torch.all(packed[:n0] == res.payload[:n0]))
    print("vx.compact agrees:", out["agrees"])

    # --- full MoE layer: earth vs argsort dispatch ---------------------------
    for dispatch in ("earth", "sort"):
        spec = MoESpec(n_experts=E, top_k=k, d_ff=64, dispatch=dispatch)
        y, aux = moe_ffn_local(params["router"], params["wg"], params["wu"],
                               params["wo"], x, spec, model_axis=None,
                               data_axes=(), n_shards=1)
        out[dispatch] = (float(torch.linalg.norm(y)), float(aux))
        print(f"{dispatch:6s}: |y|={out[dispatch][0]:.4f} "
              f"aux={out[dispatch][1]:.4f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "GPU unless 'cpu' is given)")
    main(device=ap.parse_args().device)
