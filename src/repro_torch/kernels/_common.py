"""Shared plumbing for the port's kernels: plan operands and the CUDA build.

Port of ``repro``'s ``kernels/_common.py``: ``stack_plan_masks``,
``plan_operands``, ``flatten_rows`` and ``pytree_nbytes``.  The TPU row
tiling and interpret-mode switch (``interpret_mode``, ``tile_rows``,
``ROW_TILE``) do not carry over: a CUDA kernel sizes its own row tiles.

New here: :func:`library` builds ``csrc/*.cu`` with ``nvcc`` for
``sm_90a`` into ``build/`` at the repository root on first use and loads
the shared library with ``ctypes`` (a plain C interface; no PyTorch
headers, so the build takes seconds).  A missing ``nvcc`` or a failed
build raises; nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
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


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>-<hash>.so`` (the
    hash of the source, so an edited source never loads a stale library).
    Returns the library path; raises with nvcc's output on failure."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = BUILD / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) for {src}:\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu`` (built on first
    use, once per process)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib

