#!/usr/bin/env python3
"""A/B of the copy behind kernel B12 (``shift_gather`` with tensor counts)
on one card: the staged copy it launches (``csrc/perm_copy.cuh``'s
``staged_copy_kernel``, which waits for the derive kernel's unit list
before it stages anything) against the permuted copy
(``perm_copy_kernel``, which stages its first tile before it waits on the
derive kernel, but reads whole rows at every stride).

    python3 tools/b12_copy_ab.py

Both follow the same derive kernel (``shift_sources_kernel`` on the GSN,
under Programmatic Dependent Launch).  The permuted variant is compiled
here from the repository's own ``csrc/indexed.cu`` plus one extra C entry
point, into ``build/``; the staged one is the port's wrapper.  Each output
is held bit for bit against ``shift_gather_plain``, then both are timed in
turns (staged, permuted, permuted, staged; CUDA events, 20 calls each) on

* the KV stack ``(28, 4, 512, 8, 256)`` bf16 with ``scg.gather_counts(256,
  2, 1, 128)`` (the sources touch every sector: both read whole rows);
* 256 MiB of bf16 rows of 4096 lanes with ``gather_counts(4096, 64, 0,
  64)`` (the staged copy reads one 16-byte unit in 64).

Prints the card's ``nvidia-smi`` name and power limit first.  Exits
non-zero without a card.  Seeded; nothing is written outside ``build/``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

EXTRA = r'''
#include "indexed.cu"

// B12's derive kernel, then the permuted copy through its (n,) table
// under PDL (the first tile staged before the wait), `unit`-byte units.
extern "C" int shift_gather_dyn_perm(int elem, const void* x, void* out,
                                     long long R, int n, const void* shift,
                                     const void* valid, void* work, int rows,
                                     int blocks, int unit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* tab = static_cast<int*>(work);
  cudaError_t e = launch_shift_sources(
      1, n, static_cast<const int*>(shift), static_cast<const int*>(valid),
      elem, unit, tab, tab + n, tab + 2 * n, tab + 2 * n + 1, s);
  if (e != cudaSuccess) return e;
  Ptrs outs;
  outs.p[0] = out;
  switch (elem) {
    case 1: return launch_perm_copy<uint8_t>(x, outs, R, n, 1, n, tab, rows, blocks, unit, true, s);
    case 2: return launch_perm_copy<uint16_t>(x, outs, R, n, 1, n, tab, rows, blocks, unit, true, s);
    case 4: return launch_perm_copy<uint32_t>(x, outs, R, n, 1, n, tab, rows, blocks, unit, true, s);
    case 8: return launch_perm_copy<unsigned long long>(x, outs, R, n, 1, n, tab, rows, blocks, unit, true, s);
    default: return cudaErrorInvalidValue;
  }
}
'''


def build_variant(common) -> ctypes.CDLL:
    """Compile ``csrc/indexed.cu`` with the permuted entry point into
    ``build/`` and load it."""
    common.BUILD.mkdir(parents=True, exist_ok=True)
    src = common.BUILD / "b12_perm_variant.cu"
    out = common.BUILD / "libb12_perm_variant.so"
    src.write_text(EXTRA)
    subprocess.run([common.nvcc(), *common.NVCC_FLAGS, "-I",
                    str(common.CSRC), "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.shift_gather_dyn_perm.argtypes = [I, P, P, LL, I, P, P, P, I, I, I,
                                          P]
    lib.shift_gather_dyn_perm.restype = I
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("b12_copy_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "src"))
    from chip_smoke import card_line, same_bits, time_ms
    from repro_torch.core import scg
    from repro_torch.kernels import _common, shift_gather
    _common.build_all(_common.SOURCES)
    lib = build_variant(_common)
    print(f"b12 copy A/B card: {card_line()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def perm(x, shift, valid):
        flat = x.reshape(-1, x.shape[-1])
        R, n = flat.shape
        elem = flat.element_size()
        out = torch.empty_like(flat)
        unit = _common.copy_unit(n * elem, flat.data_ptr(), out.data_ptr())
        blocks = _common.min_blocks(dev)
        rows = _common.copy_tile_rows(R, n, n, 1, elem, blocks)
        work = torch.empty((3 * n + 1,), dtype=torch.int32, device=dev)
        status = lib.shift_gather_dyn_perm(
            elem, flat.data_ptr(), out.data_ptr(), R, n, shift.data_ptr(),
            valid.data_ptr(), work.data_ptr(), rows, blocks, unit,
            _common.cuda_stream(flat))
        if status:
            raise RuntimeError(f"permuted variant failed: CUDA error "
                               f"{status}")
        return out.reshape(x.shape)

    for shape, (n, st, off, vl) in (((28, 4, 512, 8, 256), (256, 2, 1, 128)),
                                    ((32768, 4096), (4096, 64, 0, 64))):
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        shift, valid = (t.to(torch.int32).contiguous() for t in
                        scg.gather_counts(n, st, off, vl, device=dev))
        want = shift_gather.shift_gather_plain(x, shift, valid)
        runs = {"staged": lambda: shift_gather.shift_gather(x, shift, valid),
                "permuted": lambda: perm(x, shift, valid)}
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            if not same_bits(got, want):
                raise AssertionError(f"{name} copy != plain at {shape}")
        del want
        ms = {k: [] for k in runs}
        for name in ("staged", "permuted", "permuted", "staged"):
            ms[name].append(time_ms(runs[name], 20))
        print(f"b12 copy A/B {list(shape)} gather_counts({n}, {st}, {off}, "
              f"{vl}): staged {ms['staged'][0]:.4f} / {ms['staged'][1]:.4f} "
              f"ms, permuted {ms['permuted'][0]:.4f} / "
              f"{ms['permuted'][1]:.4f} ms (staged, permuted, permuted, "
              f"staged), permuted / staged "
              f"{sum(ms['permuted']) / sum(ms['staged']):.3f}")
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
