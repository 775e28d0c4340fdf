"""Serving example: continuous batching over the PAGED KV runtime.

The PyTorch / CUDA twin of ``examples/serve_batch.py``.  Multi-token
prompts prefill into whole pages, requests join and leave slots
mid-flight (pages reclaimed on finish), and sampling is seeded per slot
(torch generators) — the EARTH access machinery handles the page gathers
and the KV interleave/split (on a GPU the hand-written kernels B1 / B2
under the default ``kernel`` policy).

Run:  PYTHONPATH=src python examples_torch/serve_batch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve
from repro_torch.models.transformer import init_params
from repro_torch.serve import BatchedServer


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device=None) -> dict:
    """Print the run; return what it prints: the slots' outputs, the
    pages in use at peak and after finish, and the pool's size."""
    dev = resolve(device)
    cfg = get_arch("qwen3-0.6b").smoke
    params = init_params(cfg, 0, device=dev)
    server = BatchedServer(cfg, params, slots=4, max_len=64, page_size=16,
                           temperature=0.8, top_k=40, seed=7, device=dev)

    # requests arrive at different times with different prompt lengths
    # (continuous batching over per-slot positions)
    s0 = server.add_request(prompt=[11, 12, 13, 14, 15])
    s1 = server.add_request(22)
    for _ in range(4):
        server.step()
    s2 = server.add_request(prompt=[33, 34, 35])   # joins mid-flight
    _sync(dev)
    t0 = time.time()
    for _ in range(8):
        server.step()
    _sync(dev)
    dt = time.time() - t0
    cache = server.scheduler.cache
    out = {"peak": cache.pages_in_use(), "num_pages": cache.num_pages}
    print(f"slot outputs after 12/8 steps ({dt*1e3:.0f} ms):")
    print(f"pages in use at peak load: {out['peak']} of {cache.num_pages}")
    out["outputs"] = {}
    for s in (s0, s1, s2):
        out["outputs"][s] = server.finish(s)
        print(f"  slot {s}: {out['outputs'][s]}")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print("throughput:", f"{3*8/dt:.1f} tok/s ({name})")
    out["in_use"], out["free"] = cache.pages_in_use(), cache.free_pages()
    print(f"pages after finish: {out['in_use']} in use, "
          f"{out['free']} free")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "GPU unless 'cpu' is given)")
    main(ap.parse_args().device)
