"""Which ops ``gloo`` takes for a hand-off of CUDA tensors between ranks
on one card: point-to-point sends (``batch_isend_irecv``) and
``all_to_all_single`` with every split empty but one peer's (the op
``repro_torch.dist.sharding.ppermute`` uses).

    python3 tools/gloo_p2p_probe.py [--ranks 2]

Each op runs in a spawn of its own (every rank on ``cuda:0``, one
``gloo`` group over localhost), because a refused send can abort the
process from ``gloo``'s own thread.  Prints one JSON line per op: ``ok``
(the peer's data arrived, and the mean ms of three 32 MiB bf16
hand-offs), or the error, or the spawn's exit.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import sys
import time

OPS = ("batch_isend_irecv", "all_to_all_single")


def _rank(rank: int, world: int, port: int, op: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=30))
    peer, src = (rank + 1) % world, (rank - 1) % world

    def hand_off(x):
        r = torch.empty_like(x)
        if op == "batch_isend_irecv":
            for q in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                             dist.P2POp(dist.irecv, r, src)]):
                q.wait()
        else:
            ins, outs = [0] * world, [0] * world
            ins[peer], outs[src] = x.numel(), x.numel()
            dist.all_to_all_single(r, x, outs, ins)
        torch.cuda.synchronize()
        return r

    try:
        x = torch.full((1024,), float(rank + 1), device="cuda")
        res = {"op": op, "result": "ok" if float(hand_off(x)[0]) == src + 1
               else "wrong data"}
        big = torch.ones((16 << 20,), dtype=torch.bfloat16, device="cuda")
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            hand_off(big)
        res["ms_32MiB"] = (time.perf_counter() - t0) / 3 * 1e3
    except (RuntimeError, ValueError) as e:
        res = {"op": op, "result": f"{type(e).__name__}: "
               f"{str(e).splitlines()[0][:160]}"}
    if rank == 0:
        with open(os.path.join(out_dir, "r0.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def main() -> int:
    import tempfile
    import torch
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_p2p_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    for op in OPS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with tempfile.TemporaryDirectory() as d:
            try:
                mp.spawn(_rank, args=(args.ranks, port, op, d),
                         nprocs=args.ranks, join=True)
                with open(os.path.join(d, "r0.json")) as f:
                    print(json.dumps(json.load(f)))
            except Exception as e:  # noqa: BLE001 - a rank aborted
                print(json.dumps({"op": op, "result": f"spawn failed: "
                                  f"{type(e).__name__}: {str(e)[:160]}"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
