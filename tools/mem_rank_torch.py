"""Dev tool: rank the largest per-device tensors of one dry-run cell.

The port's counterpart of ``tools/mem_rank.py``: it traces the cell's real
step on fake tensors on torch's ``fake`` process group of 256 ranks
(``repro_torch.launch.dryrun``), as the dry run does, and ranks rank 0's
tensors of at least ``threshold_gib`` GiB that the step makes, largest
first: ``dtype[shape] = GiB``, how many the step made, and the aten ops
that made them.  It first prints the cell's argument and temporary bytes
(the temporaries at the peak of the live bytes).  CPU only; no card.

Usage: PYTHONPATH=src python tools/mem_rank_torch.py <arch> <shape> \\
           [threshold_gib] [--smoke]

``--smoke`` traces the arch's reduced geometry (seconds, not minutes).
"""
import os
import sys
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.launch.dryrun import fake_world, rank_tensors  # noqa: E402

#: HLO's short names, as the reference's tool prints them.
SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
         torch.float64: "f64", torch.int32: "s32", torch.int64: "s64",
         torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


def key(dtype, shape, nbytes) -> str:
    dims = ",".join(map(str, shape))
    return f"{SHORT.get(dtype, str(dtype))}[{dims}] = {nbytes / 2**30:.2f}G"


def main(argv: list) -> int:
    warnings.filterwarnings("ignore", category=FutureWarning)
    smoke = "--smoke" in argv
    argv = [a for a in argv if a != "--smoke"]
    arch, shape = argv[0], argv[1]
    thresh = float(argv[2]) if len(argv) > 2 else 1.0
    with fake_world(256):
        r = rank_tensors(arch, shape, int(thresh * 2**30),
                         cfg_override=get_arch(arch).smoke if smoke
                         else None)
    print(f"args={r['arguments'] / 2**30:.2f}G "
          f"temp={r['temp'] / 2**30:.2f}G")
    for dtype, dims, nbytes, count, ops in r["ranking"][:20]:
        print(f"{count:5d}x {key(dtype, dims, nbytes)}  ops={ops[:6]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
