"""Hardware constants for the roofline target: one NVIDIA H100 SXM.

Port of ``repro``'s ``hw.py``.  :class:`ChipSpec` keeps the reference's
field names, so a reader finds the counterpart; the comment beside each
field says what it means on this card.  The reference's target is a TPU
v5e, whose constants stay in the reference (the parity tests build a
port ``ChipSpec`` from them); the port's one target is :data:`H100_SXM`
(NVIDIA's H100 SXM data sheet: dense bf16 tensor-core peak, HBM3 rate,
NVLink 4 at 18 links of 25 GB/s each way, 80 GB).

The reference's ``LANES`` / ``SUBLANES`` (the TPU MXU's tiling: 128
lanes by 8 sublanes) are read by no reference module and have no
counterpart on this card; they are left out.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float      # FLOP/s: dense bf16 tensor-core peak
    hbm_bandwidth: float        # bytes/s: HBM3 read + write rate
    ici_link_bandwidth: float   # bytes/s per NVLink link, one direction
    ici_links: int              # NVLink links per GPU
    hbm_bytes: int              # device memory (HBM3) per GPU
    vmem_bytes: int             # shared memory one thread block may use


H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_bf16_flops=989e12,
    hbm_bandwidth=3.35e12,
    ici_link_bandwidth=25e9,
    ici_links=18,
    hbm_bytes=80 * 10**9,
    vmem_bytes=232448,
)

# The roofline's collective term divides wire bytes by one link's rate
# (the reference's convention, single-link and conservative).
DEFAULT_CHIP = H100_SXM
