"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

The port mirrors ``repro``'s module layout and names; ``repro`` stays the
reference.  It imports ``torch`` and ``numpy`` only — never ``jax`` and
never anything under ``repro``.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit device they raise
(:func:`repro_torch.device.resolve`).  Kernel wrappers launch their CUDA
kernel for CUDA tensors and take their plain PyTorch version only for CPU
tensors.

Ported so far: the paged, decoder-only serving path (kernels/segment,
CUDA kernels B1 and B2; the plan compiler; the vx layer for Segment and
Paged specs; step fusion; the dense decoder model; paged decode; the plain
greedy scheduler), EARTH's strided arm (kernels/strided, CUDA kernels
B3, B4 and B5; core/scg and the dynamic shift networks; vx Strided specs
and the runtime-stride plan bank; the strided step-fusion group;
core/lsdo), and the ``kernel_dynamic`` policy through both (CUDA kernels
B6 and B7 in kernels/segment, B8 and B9 in kernels/strided: the
dynamic-count networks, derived on the card by ``csrc/route_dyn.cuh``),
the vx Indexed / Compact accesses (kernels/moe_compact, B10 row
routing; kernels/shift_gather, B11 and B12; kernels/shift_scatter, B13
and B14; the compaction counts, row routing and compact_indices), and
dense serving (the forward pass with flash attention, the dense decode
cache and step, serve/engine, the serve CLI in launch/serve and the step
watchdog in ft/straggler).  ROADMAP.md lists what waits.
"""
