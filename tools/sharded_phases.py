#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s sharded phases alone on one card: phases 16
and 17 in one spawn of 4 ranks (``chip_smoke.sharded_phase``), then
phase 18's dry-run cell in a subprocess (``run_dryrun`` /
``report_dryrun``), with their lines and gates as in the whole script.

    python3 tools/sharded_phases.py

Builds the kernels first (phase 16a runs them).  Prints ``SHARDED_OK``
last when every gate held.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402


def main() -> int:
    from repro_torch.kernels import _common
    _common.build_all(_common.SOURCES)
    t0 = time.perf_counter()
    chip_smoke.sharded_phase(chip_smoke.card_line())
    print(f"phases 16-17 alone: {time.perf_counter() - t0:.1f} s",
          flush=True)
    chip_smoke.report_dryrun(chip_smoke.run_dryrun())
    print("SHARDED_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
