"""Shared plumbing for the port's kernels: plan operands and the CUDA build.

Port of ``repro``'s ``kernels/_common.py``: ``stack_plan_masks``,
``plan_operands``, ``flatten_rows`` and ``pytree_nbytes``.  The TPU row
tiling and interpret-mode switch (``interpret_mode``, ``tile_rows``,
``ROW_TILE``) do not carry over: a CUDA kernel sizes its own row tiles.

New here: :func:`library` builds ``csrc/*.cu`` with ``nvcc`` for
``sm_90a`` into ``build/`` at the repository root on first use and loads
the shared library with ``ctypes`` (a plain C interface; no PyTorch
headers, so the build takes seconds); :func:`build_all` builds several
sources in parallel (:data:`SOURCES` lists them all).  A missing ``nvcc``
or a failed build raises; nothing falls back to a plain version.  The CUDA launch helpers shared by the
kernel wrappers (:func:`rows_per_block`, :func:`dyn_net_bytes`,
:func:`check_cuda`, :func:`cuda_stream`, :func:`layer_table`) live here
too.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import shiftnet

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: Every kernel source in ``csrc/``: ``build_all(SOURCES)`` builds them
#: all, one nvcc each, in parallel.
SOURCES = ("segment", "strided", "indexed")


def flatten_rows(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """(..., n) -> (R, n) plus the leading shape for unflattening."""
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, x.shape[-1]), lead


def stack_plan_masks(plans) -> tuple[np.ndarray, list]:
    """Concat several plans' mask rows into ONE (S, n) int32 array plus
    per-plan row spans (the single mask upload of a fused call)."""
    rows, spans = [], []
    for p in plans:
        r = shiftnet.plan_mask_stack(p)
        spans.append((len(rows), len(rows) + r.shape[0]))
        rows.extend(r)
    if not rows:
        return np.zeros((1, plans[0].n), np.int32), spans
    return np.stack(rows).astype(np.int32), spans


def plan_operands(plan):
    """(masks, valid, S) host operands for a compiled ShiftPlan: masks
    (S, plan.n) int32 padded to one dummy row for empty plans, valid
    (1, plan.n) int32 occupancy."""
    masks = shiftnet.plan_mask_stack(plan).astype(np.int32)
    if not masks.shape[0]:
        masks = np.zeros((1, plan.n), np.int32)
    valid = plan.valid.astype(np.int32).reshape(1, plan.n)
    return masks, valid, masks.shape[0]


def pack_bits(rows: np.ndarray) -> np.ndarray:
    """(S, W) 0/1 rows -> (S, ceil(W/32)) uint32 words, lane ``32w + b``
    in bit ``b`` of word ``w`` (the kernels' mask layout)."""
    rows = np.asarray(rows).astype(bool)
    S, W = rows.shape
    words = -(-W // 32)
    padded = np.zeros((S, words * 32), bool)
    padded[:, :W] = rows
    bits = padded.reshape(S, words, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def pytree_nbytes(tree) -> int:
    """Total payload bytes of a nested dict/list of tensors."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# CUDA build and load
# ---------------------------------------------------------------------------

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "src/repro_torch/csrc at first use and need the "
                           "CUDA toolkit")
    return path


def _digest(src: Path) -> str:
    """Hash of the source and every shared header in ``csrc/``, so an
    edited source or header never loads a stale library."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:12]


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    return src, BUILD / f"lib{name}-{_digest(src)}.so"


def build_all(names) -> list[Path]:
    """Compile ``csrc/<name>.cu`` for each of ``names`` into
    ``build/lib<name>-<hash>.so``: one nvcc process per source not built
    yet, all started together, then waited for.  Returns the library
    paths; raises with nvcc's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    done = [(src, tmp, out, proc, *proc.communicate())
            for src, tmp, out, proc in jobs]          # wait for every job
    for src, tmp, out, proc, stdout, stderr in done:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:"
                               f"\n{stdout}\n{stderr}")
        os.replace(tmp, out)
    return [_target(name)[1] for name in names]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (see :func:`build_all`)."""
    return build_all([name])[0]


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu`` (built on first
    use, once per process)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib


# ---------------------------------------------------------------------------
# Launch helpers shared by the kernel wrappers
# ---------------------------------------------------------------------------

#: Shared-memory budget a block aims for (the card allows 227 KB per block
#: and 228 KB per SM): 24 KB lets eight 256-thread blocks share an SM.
SMEM_BUDGET = 24 * 1024
SMEM_LIMIT = 232448


def rows_per_block(R: int, width: int, elem: int, mask_bytes: int,
                   min_blocks: int = 1, buffers: int = 3) -> int:
    """Row-tile height: ``buffers`` (rows, width) shared buffers plus the
    packed masks within :data:`SMEM_BUDGET` (one row at least, if it fits
    the card's 227 KB at all; raises beyond that), and low enough that
    the grid has ``min_blocks`` blocks when ``R`` allows it."""
    mb = -(-mask_bytes // 16) * 16
    per_row = buffers * width * elem
    if mb + per_row > SMEM_LIMIT:
        raise ValueError(
            f"tile of width {width} x {elem} B x {buffers} buffers does not "
            f"fit shared memory ({mb + per_row} B > {SMEM_LIMIT} B)")
    return max(1, min(R, (SMEM_BUDGET - mb) // per_row,
                      -(-R // max(1, min_blocks))))


def dyn_net_bytes(n: int) -> int:
    """Shared memory of one dynamic-count network over ``n`` lanes, as
    ``dyn_bytes`` in ``csrc/route_dyn.cuh`` carves it: the derived
    take-masks (one packed row per layer), the final occupancy, the layer
    records, and the count and validity scratch (two of each), rounded up
    to 16 bytes.  At n = 4096 that is 40640 bytes, most of it counts."""
    words = -(-n // 32)
    layers = shiftnet._num_layers(n)
    b = 4 * (layers * words + words + 4 * layers + 2 * n + 2 * words)
    return -(-b // 16) * 16


@functools.lru_cache(maxsize=None)
def min_blocks(device: torch.device) -> int:
    """Two blocks per SM: a small call still spreads over the whole card."""
    return 2 * torch.cuda.get_device_properties(device).multi_processor_count


def check_cuda(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of 1/2/4/8-byte
    elements (what the kernels take)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}, want cuda or cpu")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the kernel takes contiguous tensors")
    if t.element_size() not in (1, 2, 4, 8):
        raise ValueError(f"{what}: element size {t.element_size()} "
                         f"not in (1, 2, 4, 8)")


def cuda_stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s card (the kernels
    launch on it)."""
    return torch.cuda.current_stream(t.device).cuda_stream


def layer_table(plans, spans, *, relative: bool) -> tuple[list, list]:
    """The kernels' layer records ``(shifts, s0, s1, mask_row)`` for
    ``plans`` in order, and each plan's first record (``plan_lo``, one
    entry more than plans).  ``mask_row`` indexes the stacked mask rows of
    :func:`stack_plan_masks`, or with ``relative`` the plan's own rows."""
    layers, plan_lo = [], [0]
    for p, plan in enumerate(plans):
        row = 0 if relative else spans[p][0]
        for layer in plan.layers:
            ns = len(layer.shifts)
            if ns not in (1, 2):
                raise NotImplementedError(
                    f"plan kernels take 1- or 2-shift layers, got {ns}")
            s1 = layer.shifts[1] if ns == 2 else 0
            layers.append((ns, layer.shifts[0], s1, row))
            row += ns
        plan_lo.append(len(layers))
    if not layers:
        layers.append((1, 0, 0, 0))            # never read: empty plans
    return layers, plan_lo
