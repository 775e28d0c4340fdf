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
or a failed build raises; nothing falls back to a plain version.  The
CUDA launch helpers shared by the kernel wrappers
(:func:`rows_per_block`, :func:`copy_tile_rows`,
:func:`merge_tile_rows`, :func:`interleave_tile_rows`,
:func:`copy_unit`, :func:`check_cuda`,
:func:`cuda_stream`) live here too, with
:func:`dyn_sources_plain`, the torch-ops twin of the source table that
B6, B7, B8, B9, B12 and B14 derive on the card; :func:`merge_pairs` /
:func:`merge_copy_plain`, the list of occupied lanes the merge copy walks
(derived on the card for B9, from the host plan for B5) and that copy as
torch ops; and :func:`staged_units` /
:func:`staged_copy_plain`, the staged-unit list and remapped table that
B3, B4, B11 and B13 take from the host plan (B12 and B14 from their derive
kernel), and their composition as torch ops.
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
    the grid has ``min_blocks`` blocks when ``R`` allows it.  The sizing
    of the layer-loop kernels; no wrapper calls it since the last of them
    became a staged copy."""
    mb = -(-mask_bytes // 16) * 16
    per_row = buffers * width * elem
    if mb + per_row > SMEM_LIMIT:
        raise ValueError(
            f"tile of width {width} x {elem} B x {buffers} buffers does not "
            f"fit shared memory ({mb + per_row} B > {SMEM_LIMIT} B)")
    return max(1, min(R, (SMEM_BUDGET - mb) // per_row,
                      -(-R // max(1, min_blocks))))


#: Shared memory of one block of the copies in ``csrc/perm_copy.cuh`` (the
#: permuted copy of B1, B6 and B8, the staged copy of B3, B4 and B11-B14,
#: the merge copy of B5 and B9, the interleave copy of B2 and B7): two
#: blocks share an SM, each with two staged input tiles of about 32 KB at
#: the main shape.
COPY_SMEM = 96 * 1024


def _copy_smem(n: int, nout: int, parts: int, elem: int, units: int,
               occupancy: bool) -> tuple:
    """(fixed bytes, bytes a row) of the copy's shared memory, as
    :func:`copy_tile_rows` lays it out."""
    fixed = (-(-nout * 4 // 16) * 16 + -(-units * 4 // 16) * 16
             + 16 * (2 + parts + occupancy))
    return fixed, (2 * n + nout) * elem + (nout if occupancy else 0)


def copy_row_fits(n: int, nout: int, parts: int, elem: int) -> bool:
    """Whether one row of the permuted copy fits the card's shared memory
    (:func:`copy_tile_rows` raises otherwise)."""
    return sum(_copy_smem(n, nout, parts, elem, 0, False)) <= SMEM_LIMIT


def copy_tile_rows(R: int, n: int, nout: int, parts: int, elem: int,
                   blocks: int, *, units: int = 0,
                   occupancy: bool = False) -> int:
    """Row-tile height of the permuted copy: the source table (``nout``
    int32), two staged (rows, n) input tiles and the ``parts`` blocks of
    the (rows, nout) output tile, each rounded up to 16 bytes, within
    :data:`COPY_SMEM` (one row at least, if that fits the card's 227 KB at
    all; raises beyond that), and low enough that ``blocks`` blocks share
    the ``R`` rows when ``R`` allows it.  ``n`` is the lanes staged per
    row: the whole row for B6 / B8, and for B12 / B14 (whose list is known
    only on the card); for B3 / B4 / B13 (the staged copy through host
    operands) the lanes of the listed units only.  The staged copy's list
    of ``units`` int32 entries sits beside the table.  With ``occupancy``
    (B13, B14) the (rows, nout) tile of occupancy bytes sits beside the
    output tile."""
    fixed, per_row = _copy_smem(n, nout, parts, elem, units, occupancy)
    if fixed + per_row > SMEM_LIMIT:
        raise ValueError(
            f"permuted copy of {n} lanes x {elem} B does not fit shared "
            f"memory ({fixed + per_row} B > {SMEM_LIMIT} B)")
    return max(1, min(R, (COPY_SMEM - fixed) // per_row,
                      -(-R // max(1, blocks))))


def merge_tile_rows(R: int, n: int, vl: int, kmax: int, elem: int,
                    blocks: int) -> int:
    """Row-tile height of the merge copy (B9): the list of ``kmax`` (lane,
    source) pairs, two staged (rows, n) window tiles and two (rows, vl)
    value tiles, each rounded up to 16 bytes, within :data:`COPY_SMEM`
    (one row at least, if that fits the card's 227 KB at all; raises
    beyond that), and low enough that ``blocks`` blocks share the ``R``
    rows when ``R`` allows it.  The window tile is merged in place, so
    there is no output tile: at n = 4096, vl = 64 in bf16 a tile holds 5
    rows."""
    fixed = -(-kmax * 8 // 16) * 16 + 16 * 4
    per_row = 2 * (n + vl) * elem
    if fixed + per_row > SMEM_LIMIT:
        raise ValueError(
            f"merge copy of {n} + {vl} lanes x {elem} B does not fit shared "
            f"memory ({fixed + per_row} B > {SMEM_LIMIT} B)")
    return max(1, min(R, (COPY_SMEM - fixed) // per_row,
                      -(-R // max(1, blocks))))


def _pad(b: int, to: int) -> int:
    return -(-b // to) * to


def interleave_skew(fields: int, elem: int) -> int:
    """Bytes between the banks of consecutive field tiles in the
    interleave copy (``interleave_skew`` in ``csrc/perm_copy.cuh``): a
    warp's loads of one row take about ``1/fields`` of one 128-byte
    wavefront from each field, so field f's tile starts ``f`` times this
    many bytes further round the banks (16-byte aligned, for cp.async)."""
    return _pad(-(-min(32 * elem, 128) // fields), 16)


def interleave_smem(n: int, fields: int, rows: int, elem: int) -> int:
    """Shared memory of one block of the interleave copy (B2, B7), as
    ``interleave_copy_smem`` in ``csrc/perm_copy.cuh`` carves it: the
    table (``n`` uint16), two staged input tiles of ``fields`` field tiles
    each (``(rows, m)``, padded to 128 bytes plus the bank skew) and the
    ``(rows, n)`` output tile."""
    m = n // fields
    return (_pad(2 * n, 16) + 2 * fields * (
        _pad(rows * m * elem, 128) + interleave_skew(fields, elem))
        + _pad(rows * n * elem, 16))


def interleave_tile_rows(R: int, n: int, fields: int, elem: int,
                         blocks: int) -> int:
    """Row-tile height of the interleave copy (B2, B7): the most rows whose
    :func:`interleave_smem` fits :data:`COPY_SMEM` (one row at least, if
    that fits the card's 227 KB at all; raises beyond that), and low
    enough that ``blocks`` blocks share the ``R`` rows when ``R`` allows
    it.  The table is uint16, so at n = 6144 in bf16 a tile holds 2
    rows."""
    if interleave_smem(n, fields, 1, elem) > SMEM_LIMIT:
        raise ValueError(
            f"interleave copy of {n} lanes x {elem} B does not fit shared "
            f"memory ({interleave_smem(n, fields, 1, elem)} B > "
            f"{SMEM_LIMIT} B)")
    rows = max(1, (COPY_SMEM - interleave_smem(n, fields, 0, elem))
               // (3 * n * elem))
    while rows > 1 and interleave_smem(n, fields, rows, elem) > COPY_SMEM:
        rows -= 1
    return max(1, min(R, rows, -(-R // max(1, blocks))))


def copy_unit(nbytes: int, *ptrs: int) -> int:
    """The widest copy unit (16, 8, 4, 2 or 1 bytes) that divides a row of
    ``nbytes`` and every pointer."""
    for u in (16, 8, 4, 2):
        if nbytes % u == 0 and all(p % u == 0 for p in ptrs):
            return u
    return 1


def staged_units(source, n: int, per_unit: int,
                 elem: int) -> tuple[np.ndarray, np.ndarray]:
    """What the staged copy (B3 / B4, and B13 over its occupied lanes)
    loads of an ``n``-lane row of ``elem``-byte lanes, from a static
    source table: ``source`` gives each output lane's input lane (all >=
    0), and a copy unit holds ``per_unit`` lanes.  Returns ``units``, the
    staged-unit list, and ``pos``, each output lane's position in the row
    compacted to those units (the remapped table), both int32.  The list
    is the sorted distinct units that hold a source lane, or every unit of
    the row when those units touch every 32-byte sector of it (counted
    from the row's start): the same sectors move either way, and a whole
    row stages as one contiguous chunk."""
    src = np.asarray(source, np.int64)
    if src.size and src.min() < 0:
        raise ValueError("staged copy: every output lane needs a source lane")
    sector = 32 // elem                               # lanes of a sector
    if len(np.unique(src // sector)) == -(-n // sector):
        return (np.arange(n // per_unit, dtype=np.int32),
                src.astype(np.int32))
    unit = src // per_unit
    units = np.unique(unit)
    pos = np.searchsorted(units, unit) * per_unit + src % per_unit
    return units.astype(np.int32), pos.astype(np.int32)


def staged_copy_plain(x: torch.Tensor, units, pos,
                      per_unit: int) -> torch.Tensor:
    """The staged copy as torch ops (the twin of ``staged_copy_kernel`` in
    ``csrc/perm_copy.cuh``): each row of the ``(R, n)`` tensor ``x`` is
    compacted to its listed units of ``per_unit`` lanes, then read through
    the remapped table, ``out[r, j] = staged[r, pos[j]]``.  The CPU check
    of the composition; no wrapper takes it on the card."""
    R, n = x.shape
    units = torch.as_tensor(np.asarray(units), dtype=torch.int64,
                            device=x.device)
    pos = torch.as_tensor(np.asarray(pos), dtype=torch.int64,
                          device=x.device)
    staged = x.reshape(R, n // per_unit, per_unit)[:, units].reshape(R, -1)
    return staged[:, pos]


def dyn_sources_plain(shift: torch.Tensor, valid: torch.Tensor, *,
                      gsn: bool) -> torch.Tensor:
    """The source table of the dynamic network on these counts, as torch
    ops (the twin of ``dyn_sources`` in ``csrc/route_dyn.cuh``): ``(n,)``
    int32, lane c's input lane through the GSN (``gsn``) or the SSN, or -1
    where the final occupancy is clear.  Walks the take-masks of
    ``shiftnet.layer_masks`` backwards: lane c's value after layer i came
    from c + d_i where layer i's mask is set at c."""
    masks, occ = shiftnet.layer_masks(shift, valid, toward_zero=gsn,
                                      lsb_first=gsn)
    n = shift.shape[-1]
    L = masks.shape[0]
    src = torch.arange(n, device=shift.device)
    for i in range(L - 1, -1, -1):
        d = 1 << i if gsn else -(1 << (L - 1 - i))
        src = torch.where(masks[i][src], src + d, src)
    return torch.where(occ, src, -1).to(torch.int32)


def merge_pairs(table: torch.Tensor) -> torch.Tensor:
    """The list the merge copy walks, from an ``(n,)`` scatter source
    table (B9's ``dyn_sources_plain(..., gsn=False)``, or B5's host plan
    table, ``ShiftPlan.source`` under ``.valid``): ``(K, 2)`` int32, the
    occupied lanes in lane order beside the values lane each takes (the
    list B9's derive kernel compacts on the card and B5's wrapper uploads,
    without its leading count)."""
    lanes = torch.nonzero(table >= 0)[:, 0]
    return torch.stack([lanes, table[lanes].long()], dim=1).to(torch.int32)


def merge_copy_plain(window: torch.Tensor, values: torch.Tensor,
                     pairs: torch.Tensor) -> torch.Tensor:
    """The merge copy as torch ops (the twin of ``merge_copy_kernel`` in
    ``csrc/perm_copy.cuh``): the ``(..., n)`` window with lane ``pairs[k,
    0]`` of every row replaced by lane ``pairs[k, 1]`` of the ``(...,
    vl)`` values.  The CPU check of the composition; no wrapper takes it
    on the card."""
    pairs = pairs.to(device=window.device, dtype=torch.int64)
    out = window.clone()
    out[..., pairs[:, 0]] = values[..., pairs[:, 1]]
    return out


@functools.lru_cache(maxsize=None)
def min_blocks(device: torch.device) -> int:
    """Two blocks per SM: a small call still spreads over the whole card."""
    return 2 * torch.cuda.get_device_properties(device).multi_processor_count


def check_cuda(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` as the kernels read it: raise unless it is a CUDA tensor of
    1/2/4/8-byte elements, and return it contiguous.  The kernels read
    ``data_ptr()`` as dense rows; a view the reference takes (a transpose,
    a last-dim slice of a wider tensor) comes back as a contiguous copy,
    and a contiguous tensor as itself."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}, want cuda or cpu")
    if t.element_size() not in (1, 2, 4, 8):
        raise ValueError(f"{what}: element size {t.element_size()} "
                         f"not in (1, 2, 4, 8)")
    return t.contiguous()


def cuda_stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s card (the kernels
    launch on it), read without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)

