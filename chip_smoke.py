#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``); it builds the port's kernels
from ``src/repro_torch/csrc`` into ``build/`` (one nvcc per source, all
started together) and exits non-zero, with no result line, when there is
no card or no port beside it.

Phases, in order (any failure raises and exits non-zero):

1. the card's ``name, power.limit`` (nvidia-smi), the torch version, and
   the kernels' build time;
2. every kernel against its plain PyTorch version on the card, bit for bit
   (``torch.equal`` on integer views), dtypes float32/bfloat16/int32/int8:
   segment B1/B2 at FIELD 2/3/4/8, widths 256 and 6144, ragged row counts,
   both plan modes (the cost model's pick and the fused Benes plan,
   forced); strided B3/B5 at (stride, offset) (1,0) (2,0) (2,1) (3,1)
   (4,2) (7,5) (16,3) (64,0), windows of 96, 256 and 4096 lanes with the
   largest vl that fits, 7 and 1001 rows, and B4 with 2, 4 and 8 accesses
   of different (stride, offset); then the dynamic-count kernels on the
   same grids (bfloat16 with -0.0 and NaN lanes), each against its plain
   version AND its plan twin: B6/B7 (also at 96 lanes) against B1/B2,
   B8/B9 against B3/B5, the dynamic fused gather (one B8 per access)
   against B4; the device derivation of the dynamic network against
   ``shiftnet.layer_masks``; the source tables that B6, B7, B8 and B9
   derive once per launch (``strided.dynamic_sources``, with the SSN's,
   ``segment.deinterleave_sources`` and ``segment.interleave_sources``)
   against their torch-ops twin ``_common.dyn_sources_plain``, B7's merged
   table (read off B7 on numbered fields) against
   ``segment.interleave_dynamic_table``, and B9's list of occupied lanes
   (``strided.dynamic_merge_list``) against ``_common.merge_pairs``; and
   every kernel wrapper (B1-B14) and the ``vx`` Strided and Segment verbs
   on a transposed view and on a last-dim slice of a wider tensor, against
   the plain version (or the ``ref`` policy) on contiguous copies;
3. timings at the main path's shapes: kernel, plain version, one PyTorch
   library call computing the same function (timed here only, never used
   by the port), and the bound (bytes that must move / 3.35 TB/s).  Each
   timed call is first held bit for bit against its plain version.  B1 and
   B6 run the fused FIELD=2 KV split of qwen3-0.6b's full-width decode KV
   stack ``(28, 4, 512, 8, 256)`` bf16, B2 and B7 a 16-token prefill
   chunk's K/V beat re-pack ``(1, 16, 8, 128)`` x2 bf16 (each also its
   device time alone, in a CUDA graph, beside the library call's, its host
   path split into the ctypes call, the allocations and Python, and its
   time at the stack's bytes, B2 beside B1 and B7 beside B2; B2 and B7 of
   B1's split must give the stack back bit for bit).  The strided kernels run on that KV stack (B4's ``(2,0),
   (2,1)`` split must equal B1's FIELD=2 split bit for bit; B3, B5, B8 and
   B9 at (2,1), vl 128), then over the Fig. 12 sweep of
   benchmarks/bench_strided.py at card size (MLEN 128, vl 64, offset 0,
   stride 2..64, n = 64*stride, 256 MiB windows): B3 (with the bytes of a
   row it stages, only the 16-byte units that hold an output lane, over
   the row's bytes), B5, B8, B9 (with its SSN derivation's own time), and
   B8's derive kernel alone (one derivation per launch) with its share of
   B8's time, and a line ``fig12 s=...`` with B3 beside B8 and its bound,
   B9 and B5 over their bounds and library calls, and B5 / B9. B1 is one
   permuted copy through the table composed from the host plan, B2 one
   interleave copy through the table composed from the host plan, B3 and B4
   one staged copy each through tables composed from the host plan, B5 one
   merge copy through the list composed from the host plan; B6 and B8 a
   derive kernel and a permuted copy, B7 a derive kernel and B2's
   interleave copy, B9 a derive kernel and a merge copy;
4. qwen3-0.6b at full width (28 layers, d_model 1024, vocab 151936, seeded
   random weights) served through the port's ``Scheduler``: 4 requests of
   40-100 prompt tokens, 16 greedy tokens each, under the policies
   ``kernel``, ``ref``, ``kernel_dynamic``, ``kernel_dynamic``, ``ref``,
   ``kernel`` in that order.  The token streams must be equal; ``kernel``
   must launch B1 and B2 and no dynamic kernel, ``kernel_dynamic`` B6 and
   B7 and no plan kernel, ``ref`` none; the fused KV split must launch
   exactly once per decode step (B1 under ``kernel``, B6 under
   ``kernel_dynamic``);
5. the strided path through the port's entry points, under ``kernel``,
   ``ref`` and ``kernel_dynamic`` with every output equal: ``vx.gather`` /
   ``vx.scatter`` with a ``Strided`` spec on the KV stack, ``vx.gather_many``
   with 4 heterogeneous specs, a ``StepScheduler`` group of 4
   ``gather_strided`` requests (exactly one B4 launch under ``kernel``,
   four B8 launches under ``kernel_dynamic``), the runtime-stride bank at
   strides 3, -2 and 11 (outside the bank: the dynamic network; torch ops
   under every policy), and ``lsdo.load_strided_many`` over a 256 MiB
   buffer.  ``ref`` launches no strided kernel; ``kernel`` launches each of
   B3, B4 and B5 and no dynamic kernel; ``kernel_dynamic`` B8 and B9 and no
   plan kernel;
6. the Indexed / Compact path (kernels B10-B14, ``csrc/indexed.cu``):
   B10 (row routing) against its plain version over n 1, 2, 96, 4096 and
   16384 rows, densities 0 / 0.25 / 1, 1/2/4/8-byte rows, both directions
   (n = 1: no layer, no launch); B11-B14 against their plain versions over
   the counts of ``scg.gather_counts`` / ``scatter_counts`` at (96, 3, 1),
   (256, 2, 1), (100, 7, 5), (4095, 64, 0) and (1, 1, 0) and of
   ``compaction_counts`` / ``expansion_counts`` of random masks, and B12
   / B14 against their plan twins B11 / B13, also on random operand
   counts (where B11 must refuse the gather plans with conflicts, as the
   reference does), and B12's and B14's device source tables and unit
   lists (the derive kernel alone, on the GSN and the SSN) against
   ``_common.dyn_sources_plain`` and ``_indexed.staged_units_plain``; on
   the KV stack of phase 5 with the counts of ``gather_counts(256, 2, 1,
   128)`` / ``scatter_counts``, B12 and B11 must equal B3 on lanes [0,
   128) and 0 beyond, and ``where(occ, payload, window)`` of B14 and B13
   must equal B5, and each is timed (library call: ``torch.gather`` with
   the plan's source index plus a ``where``; B12 and B14 beside their
   derivation alone at n = 256 and 4095, a derive kernel that also lists
   the input units holding a source lane, before a staged copy that reads
   only those (B14: and also writes the occupancy); B11 and B13 beside
   the units their host operands list, one staged copy each, B13's with
   the occupancy); the Indexed gather's static-routing arm
   (``vx.gather(Indexed(n, routing=...))``, torch ops: one take through
   the plan's table and a select) must equal B11 and the layer-mask form
   there, and is timed beside that form and the library call; at
   qwen3-moe-30b-a3b's width (d_model
   2048, 128 experts, top-8; 2048- and 512-token chunks, n = 16384 and
   4096 units, one shard of 4-way expert parallelism set) ``vx.compact``
   then ``vx.scatter(Compact)`` must give ``where(mask, rows, 0)`` and the
   compact ids ``nonzero(mask)[:cap]``, and B10 is timed (library call: a
   stable sort of ``~mask``, an index and a ``where``); then the path
   through ``vx`` under ``kernel``, ``ref`` and ``kernel_dynamic`` (line
   ``indexed path: ...``): outputs equal, and per call one B12 for the
   tensor-count Indexed gather, none for the numpy-count one (plan
   stage), one B14 / B13 for the tensor- / numpy-count Indexed scatter,
   one B10 each for ``compact`` and ``scatter(Compact)``, none for the
   compact ids, plus one B11 for the direct ``kernels.shift_gather`` call
   with numpy counts; ``ref`` launches none;
7. dense serving of qwen3-0.6b at full width (weights cast once to bf16):
   (a) ``serve.engine.jit_prefill`` over 4 numpy-seeded prompts of 64
   tokens (one warm-up call, then the timed one), ``cache_from_prefill``
   into 512 bf16 beats, then 16 greedy ``jit_decode_step`` steps with
   ``ServeConfig(step_fusion=True)``, under ``kernel``, ``ref``,
   ``kernel_dynamic``, ``kernel_dynamic``, ``ref``, ``kernel``: the token
   streams must be equal, each prefill must launch B1 and B2 under
   ``kernel`` and B6 and B7 under ``kernel_dynamic`` (and nothing else),
   each decode step exactly one B1 under ``kernel``, one B6 under
   ``kernel_dynamic``, none under ``ref`` (counts zeroed just before the
   prefill and each step, read just after); the prefill ms, the median
   decode step ms and the decode tokens/s are printed with the card's
   line; (b) from empty caches, 8 steps of one numpy-seeded forced token
   stream through ``models.decode.decode_step`` and ``paged_decode_step``,
   each fused and per-access, under ``kernel`` (slots 4, page_size 16):
   every step's logits must equal the fused dense step's bit for bit; (c)
   ``python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 4
   --prompt-len 64 --gen 16 --max-len 512`` in a subprocess must exit 0,
   with every request finished and its tok/s line naming the card.

The line before the last is the kernels' JSON record, fourteen kernels
(launches: the serve runs' for B1/B2 under ``kernel`` and B6/B7 under
``kernel_dynamic``, the strided path's for B3/B4/B5 under ``kernel`` and
B8/B9 under ``kernel_dynamic``, the indexed path's under ``kernel`` for
B10-B14; phase 7 prints its own launches per prefill and per decode
step); the last line is ``{"ok": true, "device": {...}}``.  ``--profile`` adds, after phase 4, one
torch.profiler-traced serve run per policy and the operators whose host
and device times differ most between the ``kernel`` and ``ref`` runs,
and after phase 7a the same for one traced dense prefill and its 16
decode steps per policy.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
SOURCES = {"deinterleave": "src/repro_torch/csrc/segment.cu",
           "interleave": "src/repro_torch/csrc/segment.cu",
           "gather_strided": "src/repro_torch/csrc/strided.cu",
           "gather_strided_fused": "src/repro_torch/csrc/strided.cu",
           "scatter_strided": "src/repro_torch/csrc/strided.cu",
           "deinterleave_dynamic": "src/repro_torch/csrc/segment.cu",
           "interleave_dynamic": "src/repro_torch/csrc/segment.cu",
           "gather_strided_dynamic": "src/repro_torch/csrc/strided.cu",
           "scatter_strided_dynamic": "src/repro_torch/csrc/strided.cu",
           "route_rows": "src/repro_torch/csrc/indexed.cu",
           "shift_gather_static": "src/repro_torch/csrc/indexed.cu",
           "shift_gather": "src/repro_torch/csrc/indexed.cu",
           "shift_scatter_static": "src/repro_torch/csrc/indexed.cu",
           "shift_scatter": "src/repro_torch/csrc/indexed.cu"}
REPLACES = {"deinterleave": "src/repro/kernels/segment.py:85",
            "interleave": "src/repro/kernels/segment.py:156",
            "gather_strided": "src/repro/kernels/strided.py:27",
            "gather_strided_fused": "src/repro/kernels/strided.py:73",
            "scatter_strided": "src/repro/kernels/strided.py:132",
            "deinterleave_dynamic": "src/repro/kernels/segment.py:93",
            "interleave_dynamic": "src/repro/kernels/segment.py:164",
            "gather_strided_dynamic": "src/repro/kernels/strided.py:33",
            "scatter_strided_dynamic": "src/repro/kernels/strided.py:143",
            "route_rows": "src/repro/kernels/moe_compact.py:32",
            "shift_gather_static": "src/repro/kernels/shift_gather.py:30",
            "shift_gather": "src/repro/kernels/shift_gather.py:22",
            "shift_scatter_static": "src/repro/kernels/shift_scatter.py:20",
            "shift_scatter": "src/repro/kernels/shift_scatter.py:51"}
STRIDED_SO = ((1, 0), (2, 0), (2, 1), (3, 1), (4, 2), (7, 5), (16, 3),
              (64, 0))
HETERO = ((2, 0), (3, 1), (7, 5), (4, 2))
WINDOW_BYTES = 1 << 28      # a Fig. 12 window, and the LSDO buffer: 256 MiB
# (n, stride, offset) of the B11-B14 grid: widths that are not powers of
# two, a 4095-lane network of 12 layers, and one lane (no layer)
INDEXED_GEOM = ((96, 3, 1), (256, 2, 1), (100, 7, 5), (4095, 64, 0),
                (1, 1, 0))
# qwen3-moe-30b-a3b (src/repro/configs/qwen3_moe_30b.py): d_model 2048,
# 128 experts, top-8; one shard of 4-way expert parallelism
MOE_D, MOE_EXPERTS, MOE_TOP_K, MOE_SHARDS = 2048, 128, 8, 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def int_view(t):
    import torch
    return t.contiguous().view({1: torch.int8, 2: torch.int16,
                                4: torch.int32,
                                8: torch.int64}[t.element_size()])


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(int_view(a), int_view(b))


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph, so that a call shorter than its host dispatch is timed on the
    device and not at the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev) -> int:
    import torch
    from repro_torch.core import shiftplan
    from repro_torch.kernels import segment
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def rand(shape, dtype):
        if dtype in (torch.int32, torch.int8):
            return torch.randint(-100, 100, shape, generator=g, device=dev,
                                 dtype=dtype)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int8):
        for fields in (2, 3, 4, 8):
            for rows, width in ((7, 6144), (1001, 256)):
                m = width // fields          # fields=3 at 256 lanes: 255
                n = fields * m
                for mode in ("picked", "fused"):
                    dp = ip = None
                    if mode == "fused":
                        dp = ("fused", (shiftplan.deinterleave_plan(n,
                                                                    fields),))
                        ip = ("fused", (shiftplan.interleave_plan(n,
                                                                  fields),))
                    aos = rand((rows, n), dtype)
                    got = segment.deinterleave(aos, fields, plans=dp)
                    want = segment.deinterleave_plain(aos, fields, plans=dp)
                    torch.cuda.synchronize()
                    soa = [rand((rows, m), dtype) for _ in range(fields)]
                    got_i = segment.interleave(soa, plans=ip)
                    want_i = segment.interleave_plain(soa, plans=ip)
                    torch.cuda.synchronize()
                    where = f"{dtype} fields={fields} n={n} rows={rows} {mode}"
                    if not all(same_bits(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"B1 deinterleave != plain: "
                                             f"{where}")
                    if not same_bits(got_i, want_i):
                        raise AssertionError(f"B2 interleave != plain: "
                                             f"{where}")
                    cases += 1
    return cases


def check_strided(dev) -> int:
    """B3, B4 and B5 against their plain versions over the strided grid."""
    import torch
    from repro_torch.kernels import strided
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)

    def rand(shape, dtype):
        if dtype in (torch.int32, torch.int8):
            return torch.randint(-100, 100, shape, generator=g, device=dev,
                                 dtype=dtype)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int8):
        for n in (96, 256, 4096):
            for rows in (7, 1001):
                where = f"{dtype} n={n} rows={rows}"
                win = rand((rows, n), dtype)
                for s, o in STRIDED_SO:
                    vl = (n - 1 - o) // s + 1       # the largest that fits
                    vals = rand((rows, vl), dtype)
                    got = strided.gather_strided(win, s, o, vl)
                    want = strided.gather_strided_plain(win, s, o, vl)
                    got_s = strided.scatter_strided(win, vals, s, o)
                    want_s = strided.scatter_strided_plain(win, vals, s, o)
                    torch.cuda.synchronize()
                    if not same_bits(got, want):
                        raise AssertionError(f"B3 gather_strided != plain: "
                                             f"{where} ({s}, {o}) vl={vl}")
                    if not same_bits(got_s, want_s):
                        raise AssertionError(f"B5 scatter_strided != plain: "
                                             f"{where} ({s}, {o}) vl={vl}")
                    cases += 1
                for A in (2, 4, 8):
                    pairs = [STRIDED_SO[(a * 3 + A) % len(STRIDED_SO)]
                             for a in range(A)]
                    vl = min((n - 1 - o) // s + 1 for s, o in pairs)
                    wins = rand((A, rows, n), dtype)
                    got = strided.gather_strided_fused(wins, pairs, vl)
                    want = strided.gather_strided_fused_plain(wins, pairs, vl)
                    torch.cuda.synchronize()
                    if not same_bits(got, want):
                        raise AssertionError(f"B4 gather_strided_fused != "
                                             f"plain: {where} {pairs}")
                    cases += 1
    return cases


def check_dynamic(dev) -> int:
    """B6-B9 against their plain versions and their plan twins (B1/B2,
    B3/B5, B4 for the dynamic fused gather), bit for bit, the device
    derivation against ``shiftnet.layer_masks``, and the device source
    tables of B6 and B8 against ``_common.dyn_sources_plain``."""
    import numpy as np
    import torch
    from repro_torch.core import scg, shiftnet
    from repro_torch.kernels import _common, segment, strided
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 6)

    def rand(shape, dtype):
        if dtype in (torch.int32, torch.int8):
            return torch.randint(-100, 100, shape, generator=g, device=dev,
                                 dtype=dtype)
        x = torch.randn(shape, generator=g, device=dev)
        x.view(-1)[::7] = -0.0
        x.view(-1)[3::11] = float("nan")
        return x.to(dtype)

    def held(got, plain, twin, what):
        torch.cuda.synchronize()
        for name, want in (("plain", plain), ("plan twin", twin)):
            want = want if isinstance(want, list) else [want]
            got_l = got if isinstance(got, list) else [got]
            if len(got_l) != len(want) or not all(
                    same_bits(a, b) for a, b in zip(got_l, want)):
                raise AssertionError(f"{what} != {name}")

    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int8):
        for fields in (2, 3, 4, 8):
            for rows, width in ((7, 6144), (1001, 256), (5, 96)):
                m = width // fields
                n = fields * m
                where = f"{dtype} fields={fields} n={n} rows={rows}"
                aos = rand((rows, n), dtype)
                held(segment.deinterleave(aos, fields, fused=False),
                     segment.deinterleave_dynamic_plain(aos, fields),
                     segment.deinterleave(aos, fields), f"B6 {where}")
                soa = [rand((rows, m), dtype) for _ in range(fields)]
                held(segment.interleave(soa, fused=False),
                     segment.interleave_dynamic_plain(soa),
                     segment.interleave(soa), f"B7 {where}")
                cases += 1
        for n in (96, 256, 4096):
            for rows in (7, 1001):
                win = rand((rows, n), dtype)
                for s, o in STRIDED_SO:
                    vl = (n - 1 - o) // s + 1
                    where = f"{dtype} n={n} rows={rows} ({s}, {o}) vl={vl}"
                    held(strided.gather_strided(win, s, o, vl,
                                                compiled=False),
                         strided.gather_strided_dynamic_plain(win, s, o, vl),
                         strided.gather_strided(win, s, o, vl),
                         f"B8 {where}")
                    vals = rand((rows, vl), dtype)
                    held(strided.scatter_strided(win, vals, s, o,
                                                 compiled=False),
                         strided.scatter_strided_dynamic_plain(win, vals, s,
                                                               o),
                         strided.scatter_strided(win, vals, s, o),
                         f"B9 {where}")
                    cases += 1
                pairs = HETERO
                vl = min((n - 1 - o) // s + 1 for s, o in pairs)
                wins = rand((len(pairs), rows, n), dtype)
                got = strided.gather_strided_fused(wins, pairs, vl,
                                                   compiled=False)
                held(got, torch.stack([strided.gather_strided_dynamic_plain(
                    wins[a], s, o, vl) for a, (s, o) in enumerate(pairs)]),
                    strided.gather_strided_fused(wins, pairs, vl),
                    f"B8 x{len(pairs)} {dtype} n={n} rows={rows}")
                cases += 1
    for n, s, o in ((96, 3, 1), (256, 2, 1), (4096, 64, 0), (1, 1, 0)):
        vl = (n - 1 - o) // s + 1
        for gather in (True, False):
            masks, occ = strided.dynamic_masks(n, s, o, vl, gather=gather,
                                               blocks=3, device=dev)
            counts = scg.gather_counts if gather else scg.scatter_counts
            shift, valid = counts(n, s, o, vl)
            want, want_occ = shiftnet.layer_masks(
                shift, valid, toward_zero=gather, lsb_first=gather)
            packed = (_common.pack_bits(want.numpy()).view(np.int32)
                      if want.shape[0] else
                      np.zeros((0, -(-n // 32)), np.int32))
            if not (np.array_equal(masks.cpu().numpy(), packed)
                    and np.array_equal(occ.cpu().numpy(), _common.pack_bits(
                        want_occ.numpy()[None]).view(np.int32)[0])):
                raise AssertionError(f"device derivation != layer_masks: "
                                     f"n={n} ({s}, {o}) gather={gather}")
            cases += 1
    # the source tables B6, B8 and B9 derive once per launch, and B9's list
    # of occupied lanes
    for n in (1, 96, 256, 4096):
        for s, o in STRIDED_SO:
            if o >= n:
                continue
            vl = (n - 1 - o) // s + 1
            for gather in (True, False):
                counts = scg.gather_counts if gather else scg.scatter_counts
                want = _common.dyn_sources_plain(*counts(n, s, o, vl),
                                                 gsn=gather)
                got = strided.dynamic_sources(n, s, o, vl, gather=gather,
                                              device=dev)
                if not torch.equal(got.cpu(), want[:vl] if gather else want):
                    raise AssertionError(f"device source table != twin: "
                                         f"n={n} ({s}, {o}) gather={gather}")
                cases += 1
            table, raw = strided.dynamic_merge_list(n, s, o, vl, device=dev)
            raw = raw.cpu()
            k = int(raw[0])
            if not (torch.equal(table.cpu(), want) and k == vl and
                    torch.equal(raw[1:1 + 2 * k].view(k, 2),
                                _common.merge_pairs(want))):
                raise AssertionError(f"B9 device list != merge_pairs: n={n} "
                                     f"({s}, {o}) vl={vl}")
            cases += 1
    for width in (6144, 256, 96):
        for fields in (2, 3, 4, 8):
            m = width // fields
            n = fields * m
            want = torch.stack([_common.dyn_sources_plain(
                *scg.gather_counts(n, fields, f, m), gsn=True)[:m]
                for f in range(fields)])
            if not torch.equal(segment.deinterleave_sources(
                    n, fields, device=dev).cpu(), want):
                raise AssertionError(f"B6 source tables != twin: n={n} "
                                     f"fields={fields}")
            # B7: the fields' SSN tables, and the merged table its copy
            # composes, read off B7 on fields numbered 1 + f*m + j
            want = torch.stack([_common.dyn_sources_plain(
                *scg.scatter_counts(n, fields, f, m), gsn=False)
                for f in range(fields)])
            ids = [torch.arange(1 + f * m, 1 + (f + 1) * m, device=dev,
                                dtype=torch.int32).expand(3, m).contiguous()
                   for f in range(fields)]
            merged = segment.interleave(ids, fused=False).cpu() - 1
            if not (torch.equal(segment.interleave_sources(
                    n, fields, device=dev).cpu(), want) and torch.equal(
                    merged, torch.from_numpy(segment.interleave_dynamic_table(
                        n, fields)).expand(3, n))):
                raise AssertionError(f"B7 source tables != twin: n={n} "
                                     f"fields={fields}")
            cases += 2
    return cases


def check_views(dev) -> int:
    """Every kernel wrapper (B1-B14) and the ``vx`` Strided and Segment
    verbs on non-contiguous CUDA operands (a transposed view, and the
    first lanes of a tensor 24 lanes wider), held bit for bit against the
    plain version (or the ``ref`` policy) on ``.contiguous()`` copies."""
    import numpy as np
    import torch
    from repro_torch import vx
    from repro_torch.core import scg, shiftnet
    from repro_torch.kernels import (moe_compact, segment, shift_gather,
                                     shift_scatter, strided)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    dt, R, n = torch.bfloat16, 300, 256
    vl = n // 2

    def view(kind, shape):
        if kind == "transposed":
            return torch.randn(shape[:-2] + (shape[-1], shape[-2]),
                               generator=g, device=dev).to(dt) \
                .transpose(-1, -2)
        return torch.randn(shape[:-1] + (shape[-1] + 24,), generator=g,
                           device=dev).to(dt)[..., :shape[-1]]

    gs, gv = scg.gather_counts(n, 2, 1, vl)
    ss, sv = scg.scatter_counts(n, 2, 1, vl)
    gplan = shift_gather.host_plan(gs.numpy(), gv.numpy(), gather=True)
    splan = shift_gather.host_plan(ss.numpy(), sv.numpy(), gather=False)
    gs, gv, ss, sv = (t.to(dev) for t in (gs, gv, ss, sv))
    mask = torch.from_numpy(np.random.default_rng(SEED).random(96) < 0.4)
    masks, _ = shiftnet.layer_masks(*scg.compaction_counts(mask),
                                    toward_zero=True, lsb_first=True)
    masks = masks.to(dev)
    keep = (torch.arange(96) < int(mask.sum())).to(dev)
    spec = vx.Strided(n=n, stride=2, offset=1, vl=vl)
    seg = vx.Segment(n=n, fields=2)
    cases = 0
    for kind in ("transposed", "sliced"):
        x, vals, rows = view(kind, (R, n)), view(kind, (R, vl)), \
            view(kind, (96, 64))
        half = [view(kind, (R, vl)) for _ in range(2)]
        wins = view(kind, (2, R, n))
        for t in (x, vals, rows, wins, *half):
            if t.is_contiguous():
                raise AssertionError(f"{kind} view is contiguous")
        xc, valsc, halfc = x.contiguous(), vals.contiguous(), \
            [h.contiguous() for h in half]
        pairs = ((2, 0), (2, 1))
        b13, p13 = shift_scatter.shift_scatter_static(x, splan), \
            shift_scatter.shift_scatter_static_plain(xc, splan)
        b14, p14 = shift_scatter.shift_scatter(x, ss, sv), \
            shift_scatter.shift_scatter_plain(xc, ss, sv)
        checks = [
            ("B1", segment.deinterleave(x, 2),
             segment.deinterleave_plain(xc, 2)),
            ("B6", segment.deinterleave(x, 2, fused=False),
             segment.deinterleave_dynamic_plain(xc, 2)),
            ("B2", segment.interleave(half), segment.interleave_plain(halfc)),
            ("B7", segment.interleave(half, fused=False),
             segment.interleave_dynamic_plain(halfc)),
            ("B3", strided.gather_strided(x, 2, 1, vl),
             strided.gather_strided_plain(xc, 2, 1, vl)),
            ("B4", strided.gather_strided_fused(wins, pairs, vl),
             strided.gather_strided_fused_plain(wins.contiguous(), pairs,
                                                vl)),
            ("B5", strided.scatter_strided(x, vals, 2, 1),
             strided.scatter_strided_plain(xc, valsc, 2, 1)),
            ("B8", strided.gather_strided(x, 2, 1, vl, compiled=False),
             strided.gather_strided_dynamic_plain(xc, 2, 1, vl)),
            ("B9", strided.scatter_strided(x, vals, 2, 1, compiled=False),
             strided.scatter_strided_dynamic_plain(xc, valsc, 2, 1)),
            ("B10", moe_compact.route_rows(rows, masks, keep,
                                           toward_zero=True, lsb_first=True),
             moe_compact.route_rows_plain(rows.contiguous(), masks, keep,
                                          toward_zero=True, lsb_first=True)),
            ("B11", shift_gather.shift_gather_static(x, gplan),
             shift_gather.shift_gather_static_plain(xc, gplan)),
            ("B12", shift_gather.shift_gather(x, gs, gv),
             shift_gather.shift_gather_plain(xc, gs, gv)),
            ("B13", list(b13), list(p13)),
            ("B14", list(b14), list(p14)),
            ("vx.gather(Strided)", vx.gather(spec, x, policy="kernel"),
             vx.gather(spec, xc, policy="ref")),
            ("vx.scatter(Strided)", vx.scatter(spec, x, vals,
                                               policy="kernel"),
             vx.scatter(spec, xc, valsc, policy="ref")),
            ("vx.transpose(Segment) deinterleave",
             vx.transpose(seg, x, policy="kernel"),
             vx.transpose(seg, xc, policy="ref")),
            ("vx.transpose(Segment) interleave",
             vx.transpose(seg, half, policy="kernel"),
             vx.transpose(seg, halfc, policy="ref")),
        ]
        torch.cuda.synchronize()
        for name, got, want in checks:
            got = list(got) if isinstance(got, (list, tuple)) else [got]
            want = list(want) if isinstance(want, (list, tuple)) else [want]
            if len(got) != len(want) or not all(
                    same_bits(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} on a {kind} view != plain on "
                                     f"a contiguous copy")
            cases += 1
    return cases


# ---------------------------------------------------------------------------
# Phase 3: timings at the main path's shapes
# ---------------------------------------------------------------------------

def record(name, run, plain, library, bound_bytes, shape, note="") -> dict:
    """Hold ``run()`` bit for bit against ``plain()``, then time the
    kernel, the plain version and the library call (CUDA events); the
    bound is ``bound_bytes`` over the card's memory rate.  ``note`` ends
    the printed line."""
    import torch
    got, want = run(), plain()
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    torch.cuda.synchronize()
    if len(got) != len(want):
        raise AssertionError(f"{name} {shape}: {len(got)} outputs, plain "
                             f"version has {len(want)}")
    for f, (a, b) in enumerate(zip(got, want)):
        if not same_bits(a, b):
            raise AssertionError(f"{name} {shape}: output {f} differs "
                                 f"from the plain version")
    del got, want
    err = 0.0                       # bit-equal outputs: no error at all
    iters = 20
    ms, plain_ms, lib_ms = (time_ms(f, iters) for f in (run, plain, library))
    bound = bound_bytes / HBM_BYTES_PER_S * 1e3
    print(f"time {name} {shape}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
          f"{bound:.4f} ms (bytes), max_abs_err {err}{note}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "max_abs_err": err, "shape": shape}


def gather_bytes(R: int, n: int, vl: int, stride: int, e: int) -> int:
    """Least bytes of a strided gather: the 32-byte sectors its reads must
    touch (the whole window while stride * e <= 32, else one sector per
    element) plus the output written once."""
    read = R * n * e if stride * e <= 32 else R * vl * 32
    return read + R * vl * e


def staged_row_bytes(n: int, stride: int, offset: int, vl: int,
                     e: int) -> int:
    """Bytes of a row that B3 stages: the 16-byte units that hold an
    output lane, or the whole row where those touch every sector
    (``strided.staged_operands``, the unit a 16-byte-aligned window row of
    ``n * e`` bytes takes)."""
    import numpy as np
    from repro_torch.kernels import strided
    src = offset + stride * np.arange(vl)
    return strided.staged_operands(src[None], n, 16 // e, e)["kmax"] * 16


def lane_bytes(R: int, lanes, e: int) -> int:
    """Least bytes that reading ``lanes`` of each of R rows of ``e``-byte
    elements moves: the distinct 32-byte sectors those lanes touch (each
    row starting on a sector)."""
    import numpy as np
    return R * 32 * len(np.unique(np.asarray(lanes).reshape(-1) * e // 32))


def time_kernels(dev, full_cfg, slots: int, max_len: int) -> dict:
    import torch
    from repro_torch.kernels import segment
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    K, hd = full_cfg.n_kv_heads, full_cfg.hd
    out = {}

    # B1 main path: the fused FIELD=2 KV split of one decode step, every
    # layer's gathered pages at once: (NS, slots, max_len, K, 2*hd) bf16
    kv = torch.randn((full_cfg.n_superblocks, slots, max_len, K, 2 * hd),
                     generator=g, device=dev).to(torch.bfloat16)
    R = kv.numel() // (2 * hd)
    out["deinterleave"] = record(
        "deinterleave", lambda: segment.deinterleave(kv, 2),
        lambda: segment.deinterleave_plain(kv, 2),
        lambda: kv.view(R, hd, 2).permute(2, 0, 1).contiguous(),
        2 * kv.numel() * kv.element_size(), list(kv.shape))
    # B6: the same split through the dynamic-count networks (the fused KV
    # split under kernel_dynamic); bound and library call are B1's
    out["deinterleave_dynamic"] = record(
        "deinterleave_dynamic",
        lambda: segment.deinterleave(kv, 2, fused=False),
        lambda: segment.deinterleave_dynamic_plain(kv, 2),
        lambda: kv.view(R, hd, 2).permute(2, 0, 1).contiguous(),
        2 * kv.numel() * kv.element_size(), list(kv.shape))
    # B1 on the prefill GLU split (16 tokens x 2*d_ff), printed only
    gu = torch.randn((1, 16, 2 * full_cfg.d_ff), generator=g,
                     device=dev).to(torch.bfloat16)
    record("deinterleave[glu]", lambda: segment.deinterleave(gu, 2),
           lambda: segment.deinterleave_plain(gu, 2),
           lambda: gu.view(16, full_cfg.d_ff, 2).permute(2, 0, 1)
           .contiguous(), 2 * gu.numel() * gu.element_size(),
           list(gu.shape))
    # B2 main path: the post-RoPE K/V beat re-pack of a 16-token prefill
    # chunk, (1, 16, K, hd) x 2 -> (1, 16, K, 2*hd) bf16
    k = torch.randn((1, 16, K, hd), generator=g,
                    device=dev).to(torch.bfloat16)
    v = torch.randn((1, 16, K, hd), generator=g,
                    device=dev).to(torch.bfloat16)
    out["interleave"] = record(
        "interleave", lambda: segment.interleave([k, v]),
        lambda: segment.interleave_plain([k, v]),
        lambda: torch.stack([k, v], dim=-1).flatten(-2),
        4 * k.numel() * k.element_size(), list(k.shape) + ["x2"])
    # B2's device time alone at that shape, apart from its host path: the
    # calls captured in one CUDA graph
    dev_ms = graph_ms(lambda: segment.interleave([k, v]), 20)
    lib_dev = graph_ms(lambda: torch.stack([k, v], dim=-1).flatten(-2), 20)
    print(f"time interleave device-only {list(k.shape) + ['x2']}: kernel "
          f"{dev_ms:.4f} ms, library {lib_dev:.4f} ms (CUDA graph of 20 "
          f"calls); at the host's launch rate kernel "
          f"{out['interleave']['ms']:.4f} ms, library "
          f"{out['interleave']['library_ms']:.4f} ms")
    host_path(k, v, dynamic=False)
    out["interleave_dynamic"] = record(
        "interleave_dynamic", lambda: segment.interleave([k, v], fused=False),
        lambda: segment.interleave_dynamic_plain([k, v]),
        lambda: torch.stack([k, v], dim=-1).flatten(-2),
        4 * k.numel() * k.element_size(), list(k.shape) + ["x2"])
    # B7's device time alone (derive kernel + interleave copy under PDL)
    dev7 = graph_ms(lambda: segment.interleave([k, v], fused=False), 20)
    print(f"time interleave_dynamic device-only {list(k.shape) + ['x2']}: "
          f"kernel {dev7:.4f} ms (derive kernel + interleave copy), B2 "
          f"{dev_ms:.4f} ms, library {lib_dev:.4f} ms (CUDA graph of 20 "
          f"calls); at the host's launch rate kernel "
          f"{out['interleave_dynamic']['ms']:.4f} ms, library "
          f"{out['interleave_dynamic']['library_ms']:.4f} ms")
    host_path(k, v, dynamic=True)
    # B2 at a decode-step-sized stack (printed only; the main path keeps
    # single-token beats below the launch threshold)
    kb = kv[..., :hd].contiguous()
    vb = kv[..., hd:].contiguous()
    b1 = out["deinterleave"]["ms"]
    stack = record("interleave[stack]", lambda: segment.interleave([kb, vb]),
                   lambda: segment.interleave_plain([kb, vb]),
                   lambda: torch.stack([kb, vb], dim=-1).flatten(-2),
                   4 * kb.numel() * kb.element_size(),
                   list(kb.shape) + ["x2"],
                   f"; B1 on the same bytes {b1:.4f} ms")
    print(f"interleave[stack] / deinterleave (B2 / B1, the same bytes): "
          f"{stack['ms'] / b1:.4f}")
    # B7 on the same bytes: the derivation at n = 256 under the copy's
    # first tile loads
    stack7 = record("interleave_dynamic[stack]",
                    lambda: segment.interleave([kb, vb], fused=False),
                    lambda: segment.interleave_dynamic_plain([kb, vb]),
                    lambda: torch.stack([kb, vb], dim=-1).flatten(-2),
                    4 * kb.numel() * kb.element_size(),
                    list(kb.shape) + ["x2"],
                    f"; B2 on the same bytes {stack['ms']:.4f} ms")
    print(f"interleave_dynamic[stack] / interleave[stack] (B7 / B2, the same "
          f"bytes): {stack7['ms'] / stack['ms']:.4f}")
    del kb, vb
    split = segment.deinterleave(kv, 2)
    if not (same_bits(segment.interleave(split), kv) and
            same_bits(segment.interleave(split, fused=False), kv)):
        raise AssertionError("B2 or B7 does not invert B1 on the KV stack")
    print(f"B2(B1(kv)) == B7(B1(kv)) == kv on {list(kv.shape)}, bit for bit")
    out.update(time_strided(dev, kv, split))
    del kv
    torch.cuda.empty_cache()
    time_fig12(dev)
    return out


def host_path(k, v, *, dynamic: bool) -> None:
    """Where B2's (or with ``dynamic`` B7's) time at a launch-sized shape
    goes on the host: the wrapper's host-clock time per call over 2000
    back-to-back calls, beside its parts run alone the same way (the
    allocations: the output, and for B7 its tables' workspace; the ctypes
    call of the entry point with the entry's arguments, which holds the
    CUDA launches), and the library call's (printed)."""
    import ctypes
    import torch
    from repro_torch.kernels import _common, segment

    def per_call(fn, iters=2000):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    m = k.shape[-1]
    R = k.numel() // m
    call = (lambda: segment.interleave([k, v], fused=not dynamic))
    out = call()
    if dynamic:
        ent = segment._interleave_dyn_launch(2 * m, 2, k.device)
        table = torch.empty((2, 2 * m), dtype=torch.int32, device=k.device)
        table_ptr = table.data_ptr()

        def allocate():
            k.new_empty(k.shape[:-1] + (2 * m,))
            torch.empty((2, 2 * m), dtype=torch.int32, device=k.device)
    else:
        ent = segment._interleave_launch(2 * m, 2, None, k.device)
        table_ptr = ent["table_ptr"]

        def allocate():
            k.new_empty(k.shape[:-1] + (2 * m,))
    args = (k.element_size(), (ctypes.c_void_p * 2)(k.data_ptr(),
                                                     v.data_ptr()),
            out.data_ptr(), 2, R, m, table_ptr,
            ent["rows"][R, k.element_size()], ent["blocks"],
            _common.cuda_stream(k))
    wrapper = per_call(call)
    launch = per_call(lambda: ent["fn"](*args))
    alloc = per_call(allocate)
    library = per_call(lambda: torch.stack([k, v], dim=-1).flatten(-2))
    name = "interleave_dynamic" if dynamic else "interleave"
    what = ("the ctypes call with its two CUDA launches (derive kernel, "
            "copy)" if dynamic else "the ctypes call with its CUDA launch")
    allocs = ("the output's and the tables' allocations" if dynamic else
              "the output's allocation")
    print(f"host path {name} {list(k.shape) + ['x2']}: wrapper "
          f"{wrapper:.4f} ms a call (host clock, 2000 calls), of which "
          f"{what} {launch:.4f}, {allocs} {alloc:.4f}, the rest (Python: "
          f"checks, launch-entry lookup, pointers, stream) "
          f"{wrapper - launch - alloc:.4f}; library call {library:.4f} ms a "
          f"call")


def time_strided(dev, kv, split) -> dict:
    """B3, B4 and B5 on the decode KV stack, bf16, each beat ``2*hd``
    lanes.  B4 runs the FIELD=2 split as two strided accesses through
    ``vx.gather_many``; it must equal B1's ``split`` bit for bit."""
    import torch
    from repro_torch import vx
    from repro_torch.kernels import strided
    n, e = kv.shape[-1], kv.element_size()
    R = kv.numel() // n
    vl = n // 2
    pairs = ((2, 0), (2, 1))
    both = vx.gather_many([vx.Strided(n=n, stride=s, offset=o, vl=vl)
                           for s, o in pairs], [kv, kv], policy="kernel")
    torch.cuda.synchronize()
    if not all(same_bits(both[f], split[f]) for f in range(2)):
        raise AssertionError("B4 (2,0),(2,1) split != B1 deinterleave")
    print(f"B4 (2,0),(2,1) on {list(kv.shape)} == B1 FIELD=2 split, bit "
          f"for bit")
    del both, split
    out = {}
    wins = torch.stack([kv, kv])
    out["gather_strided_fused"] = record(
        "gather_strided_fused",
        lambda: strided.gather_strided_fused(wins, pairs, vl),
        lambda: strided.gather_strided_fused_plain(wins, pairs, vl),
        lambda: torch.stack([kv[..., o:o + (vl - 1) * s + 1:s]
                             for s, o in pairs]),
        sum(gather_bytes(R, n, vl, s, e) for s, o in pairs),
        ["x2"] + list(kv.shape) + [str(pairs)])
    del wins
    s, o = 2, 1
    out["gather_strided"] = record(
        "gather_strided", lambda: strided.gather_strided(kv, s, o, vl),
        lambda: strided.gather_strided_plain(kv, s, o, vl),
        lambda: kv[..., o:o + (vl - 1) * s + 1:s].contiguous(),
        gather_bytes(R, n, vl, s, e), list(kv.shape) + [str((s, o))])
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    vals = torch.randn(kv.shape[:-1] + (vl,), generator=g,
                       device=dev).to(kv.dtype)

    def library():
        w = kv.clone()
        w[..., o:o + (vl - 1) * s + 1:s] = vals
        return w

    out["scatter_strided"] = record(
        "scatter_strided", lambda: strided.scatter_strided(kv, vals, s, o),
        lambda: strided.scatter_strided_plain(kv, vals, s, o), library,
        R * (2 * n + vl) * e, list(kv.shape) + [str((s, o)), "v" + str(vl)])
    # B8 / B9: the same two functions through the dynamic-count networks
    out["gather_strided_dynamic"] = record(
        "gather_strided_dynamic",
        lambda: strided.gather_strided(kv, s, o, vl, compiled=False),
        lambda: strided.gather_strided_dynamic_plain(kv, s, o, vl),
        lambda: kv[..., o:o + (vl - 1) * s + 1:s].contiguous(),
        gather_bytes(R, n, vl, s, e), list(kv.shape) + [str((s, o))])
    derive = graph_ms(lambda: strided.dynamic_merge_list(n, s, o, vl,
                                                         device=dev), 20)
    out["scatter_strided_dynamic"] = record(
        "scatter_strided_dynamic",
        lambda: strided.scatter_strided(kv, vals, s, o, compiled=False),
        lambda: strided.scatter_strided_dynamic_plain(kv, vals, s, o),
        library, R * (2 * n + vl) * e,
        list(kv.shape) + [str((s, o)), "v" + str(vl)],
        f"; SSN derivation alone {derive:.4f} ms")
    return out


def time_fig12(dev) -> None:
    """The Fig. 12 sweep of benchmarks/bench_strided.py at card size: MLEN
    128, vl = 64, offset 0, n = 64 * stride, bf16, R = 2**27 / n rows so
    that every window is 256 MiB (:data:`WINDOW_BYTES`).  B3, B5, B8 and
    B9 at each stride (B9's line with its SSN derivation alone: the table
    and the list of occupied lanes, device time in a CUDA graph), and B8's
    derive kernel alone, the one derivation per launch, beside B8's time
    (printed)."""
    import torch
    from repro_torch.kernels import strided
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    vl, e = 64, 2
    for s in (2, 4, 8, 16, 32, 64):
        n = vl * s
        R = WINDOW_BYTES // (n * e)
        win = torch.randn((R, n), generator=g, device=dev).to(torch.bfloat16)
        vals = torch.randn((R, vl), generator=g,
                           device=dev).to(torch.bfloat16)

        def library():
            w = win.clone()
            w[:, 0:(vl - 1) * s + 1:s] = vals
            return w

        staged = staged_row_bytes(n, s, 0, vl, e)
        b3 = record(f"fig12 gather_strided s={s}",
                    lambda: strided.gather_strided(win, s, 0, vl),
                    lambda: strided.gather_strided_plain(win, s, 0, vl),
                    lambda: win[:, 0:(vl - 1) * s + 1:s].contiguous(),
                    gather_bytes(R, n, vl, s, e), [R, n],
                    f"; staged {staged} of {n * e} bytes a row "
                    f"({staged / (n * e):.4f})")
        b5 = record(f"fig12 scatter_strided s={s}",
                    lambda: strided.scatter_strided(win, vals, s, 0),
                    lambda: strided.scatter_strided_plain(win, vals, s, 0),
                    library, R * (2 * n + vl) * e, [R, n])
        dyn = record(f"fig12 gather_strided_dynamic s={s}",
                     lambda: strided.gather_strided(win, s, 0, vl,
                                                    compiled=False),
                     lambda: strided.gather_strided_dynamic_plain(win, s, 0,
                                                                  vl),
                     lambda: win[:, 0:(vl - 1) * s + 1:s].contiguous(),
                     gather_bytes(R, n, vl, s, e), [R, n])
        derive9 = graph_ms(lambda: strided.dynamic_merge_list(
            n, s, 0, vl, device=dev), 20)
        b9 = record(f"fig12 scatter_strided_dynamic s={s}",
                    lambda: strided.scatter_strided(win, vals, s, 0,
                                                    compiled=False),
                    lambda: strided.scatter_strided_dynamic_plain(win, vals,
                                                                  s, 0),
                    library, R * (2 * n + vl) * e, [R, n],
                    f"; SSN derivation alone {derive9:.4f} ms (one block: "
                    f"the {n}-entry table and the list of {vl} occupied "
                    f"lanes; device time, CUDA graph)")
        derive = graph_ms(lambda: strided.dynamic_sources(
            n, s, 0, vl, device=dev), 20)
        print(f"time fig12 derive s={s} [{R}, {n}]: {derive:.4f} ms for "
              f"B8's derive kernel alone (one block: the GSN derivation "
              f"and its {vl}-entry source table, once per launch; device "
              f"time, CUDA graph), {derive / dyn['ms']:.4f} of B8's time")
        print(f"fig12 s={s}: B3 {b3['ms']:.4f} ms, B8 {dyn['ms']:.4f} ms, "
              f"B3/B8 {b3['ms'] / dyn['ms']:.4f}; B3 over its bound "
              f"{b3['ms'] / b3['bound_ms']:.4f}; B9 {b9['ms']:.4f} ms, over "
              f"its bound {b9['ms'] / b9['bound_ms']:.4f}, over its library "
              f"call {b9['ms'] / b9['library_ms']:.4f}; B5 {b5['ms']:.4f} "
              f"ms, over its bound {b5['ms'] / b5['bound_ms']:.4f}, over its "
              f"library call {b5['ms'] / b5['library_ms']:.4f}, B5/B9 "
              f"{b5['ms'] / b9['ms']:.4f}")
        del win, vals
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4: serve qwen3-0.6b at full width through the port
# ---------------------------------------------------------------------------

def serve(dev, cfg, params, impl: str, prompts, gen: int, slots: int,
          max_len: int, page_size: int, profiled: bool = False) -> dict:
    """One serve run under policy ``impl``; with ``profiled`` the run is
    traced by torch.profiler (host and device) and the trace returned."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import segment
    from repro_torch.serve.scheduler import Scheduler
    sched = Scheduler(dataclasses.replace(cfg, kernel_impl=impl), params,
                      slots=slots, max_len=max_len, page_size=page_size,
                      cache_dtype=torch.bfloat16, device=dev)
    step_launches, step_ms, step_tokens = [], [], []
    plain_step = sched.step

    def counted_step():
        torch.cuda.synchronize()
        d0 = (segment.deinterleave.launches,
              segment.deinterleave_dynamic.launches)
        t0 = time.perf_counter()
        out = plain_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_launches.append(
            (segment.deinterleave.launches - d0[0],
             segment.deinterleave_dynamic.launches - d0[1]))
        step_tokens.append(sum(1 for t in out if t >= 0))
        return out

    sched.step = counted_step
    reqs = [sched.submit(p, max_new_tokens=gen) for p in prompts]
    torch.cuda.synchronize()
    tracer = (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext())
    segment.reset_counts()                  # counts from here: main path
    with tracer as prof:
        t0 = time.perf_counter()
        for _ in range(10 * (gen + max_len)):
            sched.tick()
            if sched.drained():
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches
                for f in segment.KERNELS + segment.DYNAMIC}
    if not sched.drained():
        raise AssertionError(f"{impl}: the scheduler never drained")
    logits = sched.last_logits
    if logits is None or tuple(logits.shape) != (slots, cfg.vocab) or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{impl}: last logits not finite of shape "
                             f"({slots}, {cfg.vocab})")
    streams = [r.tokens for r in reqs]
    for r in reqs:
        if r.state.value != "finished" or r.generated != gen or \
                not all(0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"{impl}: request {r.rid} ended "
                                 f"{r.state.value} with {r.generated} tokens")
    stats = sched.stats()
    del sched
    torch.cuda.empty_cache()
    return {"streams": streams, "launches": launches,
            "step_launches": step_launches, "step_ms": step_ms,
            "step_tokens": step_tokens,
            "wall_s": wall, "tokens": gen * len(prompts),
            "prefill_chunks": stats["prefill_chunks"],
            "decode_steps": stats["decode_steps"], "prof": prof}


# ---------------------------------------------------------------------------
# Phase 5: the strided path through the port's entry points
# ---------------------------------------------------------------------------

def strided_path(dev, kv_shape, impl: str) -> dict:
    """One run of the strided path under policy ``impl``: the strided
    kernels' counts are set to 0 just before it and read just after.
    Returns every output, the launches, and the StepScheduler group's
    launches (B4's and B8's)."""
    import torch
    from repro_torch import vx
    from repro_torch.core import accessfuse, lsdo
    from repro_torch.kernels import strided
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)
    kv = torch.randn(kv_shape, generator=g, device=dev).to(torch.bfloat16)
    n = kv.shape[-1]
    vals = torch.randn(kv.shape[:-1] + (n // 2,), generator=g,
                       device=dev).to(torch.bfloat16)
    N = WINDOW_BYTES // 2
    buf = torch.randn((N,), generator=g, device=dev).to(torch.bfloat16)
    plans = [lsdo.plan_strided(0, 2, 4096, 128),
             lsdo.plan_strided(N // 11, 3, 4096, 128),
             lsdo.plan_strided(N // 2, 4, 2048, 128),
             lsdo.plan_strided(N - 1, -5, 2048, 128)]
    vl4 = min((n - 1 - o) // s + 1 for s, o in HETERO)
    bank = vx.Strided(n=n, stride=vx.BANK, vl=12, offset=128)
    torch.cuda.synchronize()
    strided.reset_counts()                  # counts from here: the path
    outs = {}
    with vx.use(impl):
        spec = vx.Strided(n=n, stride=2, offset=1, vl=n // 2)
        outs["gather"] = vx.gather(spec, kv)
        outs["scatter"] = vx.scatter(spec, kv, vals)
        outs["gather_many"] = vx.gather_many(
            [vx.Strided(n=n, stride=s, offset=o, vl=vl4) for s, o in HETERO],
            [kv] * len(HETERO))
        sched = accessfuse.StepScheduler()
        f0 = (strided.gather_strided_fused.launches,
              strided.gather_strided_dynamic.launches)
        hs = [sched.gather_strided(kv[a], s, o, vl4)
              for a, (s, o) in enumerate(HETERO)]
        sched.flush()
        group = {"gather_strided_fused":
                 strided.gather_strided_fused.launches - f0[0],
                 "gather_strided_dynamic":
                 strided.gather_strided_dynamic.launches - f0[1]}
        outs["step_group"] = torch.stack([h.value for h in hs])
        for st in (3, -2, 11):
            outs[f"bank[{st}]"] = vx.gather(
                bank, kv, stride=torch.tensor(st, device=dev))
        for i, o in enumerate(lsdo.load_strided_many(buf, plans)):
            outs[f"lsdo[{i}]"] = o
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches
                for f in strided.KERNELS + strided.DYNAMIC}
    # the same function by plain indexing, as a yardstick for both runs
    want = {"gather": kv[..., 1::2],
            "gather_many": torch.stack([kv[..., o:o + (vl4 - 1) * s + 1:s]
                                        for s, o in HETERO]),
            "step_group": torch.stack([kv[a][..., o:o + (vl4 - 1) * s + 1:s]
                                       for a, (s, o) in enumerate(HETERO)])}
    want["scatter"] = kv.clone()
    want["scatter"][..., 1::2] = vals
    for st in (3, -2, 11):
        want[f"bank[{st}]"] = kv[..., 128 + st * torch.arange(12, device=dev)]
    for i, p in enumerate(plans):
        idx = p.base + p.stride * torch.arange(p.vl, device=dev)
        want[f"lsdo[{i}]"] = buf[idx]
    for k, w in want.items():
        if not same_bits(outs[k], w.contiguous()):
            raise AssertionError(f"strided path [{impl}] {k}: differs from "
                                 f"plain indexing")
    return {"outs": outs, "launches": launches, "group": group}


# ---------------------------------------------------------------------------
# Phase 6: the Indexed / Compact path (kernels B10-B14)
# ---------------------------------------------------------------------------

def moe_mask(tokens: int, seed: int):
    """The units one shard of 4-way expert parallelism keeps, as
    ``moe_ffn_local``'s ``mine`` (token-major, TOP_K units a token): each
    token picks TOP_K distinct experts of MOE_EXPERTS (numpy-seeded), and a
    unit is set when its expert is one of the shard's first
    MOE_EXPERTS / MOE_SHARDS.  Density about 0.25."""
    import numpy as np
    rng = np.random.default_rng(seed)
    experts = np.argsort(rng.random((tokens, MOE_EXPERTS)),
                         axis=1)[:, :MOE_TOP_K]
    return (experts < MOE_EXPERTS // MOE_SHARDS).reshape(-1)


def moe_capacity(tokens: int) -> int:
    """``models/moe._capacity`` of the reference at slack 2.0."""
    import math
    cap = int(math.ceil(tokens * MOE_TOP_K / MOE_SHARDS * 2.0))
    cap = min(max(cap, 8), tokens * MOE_TOP_K)
    return ((cap + 7) // 8) * 8 if cap % 8 else cap


def check_indexed(dev) -> int:
    """B10 against its plain version over n in (1, 2, 96, 4096, 16384),
    densities 0 / 0.25 / 1 and 1/2/4/8-byte rows, both directions (n = 1:
    no layer, no launch); B11-B14 against their plain versions over the
    counts of ``scg.gather_counts`` / ``scatter_counts`` at several (n,
    stride, offset, vl) and of ``compaction_counts`` / ``expansion_counts``
    of random masks, and B12 / B14 against their plan twins B11 / B13; B12
    and B14 also on random operand counts, with the derive kernel's source
    tables (the GSN's and the SSN's) against ``_common.dyn_sources_plain``
    and the staged copy's operands it composes against
    ``_indexed.staged_units_plain``; there B11 takes the gather plans
    without conflicts and refuses the others (``AssertionError``, as the
    reference's plan body does), before any launch."""
    import numpy as np
    import torch
    from repro_torch.core import scg, shiftnet
    from repro_torch.kernels import (_common, _indexed, moe_compact,
                                     shift_gather, shift_scatter)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)

    def rand(shape, dtype):
        if not dtype.is_floating_point:
            return torch.randint(-100, 100, shape, generator=g, device=dev,
                                 dtype=dtype)
        x = torch.randn(shape, generator=g, device=dev)
        x.view(-1)[::7] = -0.0
        x.view(-1)[3::11] = float("nan")
        return x.to(dtype)

    cases = 0
    dtypes = (torch.int8, torch.bfloat16, torch.float32, torch.int64)
    for dtype in dtypes:
        for n in (1, 2, 96, 4096, 16384):
            for density in (0.0, 0.25, 1.0):
                mask = torch.rand(n, generator=g, device=dev) < density
                for d in (3, 40):
                    rows = rand((n, d), dtype)
                    for counts, tz, keep in (
                            (scg.compaction_counts, True,
                             torch.arange(n, device=dev) < mask.sum()),
                            (scg.expansion_counts, False, mask)):
                        where = f"B10 {dtype} n={n} d={d} density={density}"
                        s, v = counts(mask)
                        masks, _ = shiftnet.layer_masks(
                            s, v, toward_zero=tz, lsb_first=tz)
                        before = moe_compact.route_rows.launches
                        if masks.shape[0]:
                            got = moe_compact.route_rows(
                                rows, masks, keep, toward_zero=tz,
                                lsb_first=tz)
                            want = moe_compact.route_rows_plain(
                                rows, masks, keep, toward_zero=tz,
                                lsb_first=tz)
                            launched = 1
                        else:
                            got = moe_compact._route_rows(
                                rows, s, v, keep, toward_zero=tz,
                                lsb_first=tz)
                            want = torch.where(keep[:, None], rows,
                                               torch.zeros_like(rows))
                            launched = 0
                        torch.cuda.synchronize()
                        if moe_compact.route_rows.launches - before != \
                                launched:
                            raise AssertionError(f"{where}: launches")
                        if not same_bits(got, want):
                            raise AssertionError(f"{where} != plain")
                    cases += 1
    for dtype in dtypes:
        for n, st, off in INDEXED_GEOM:
            vl = (n - 1 - off) // st + 1
            for rows in (7, 1001):
                x = rand((rows, n), dtype)
                mask = torch.rand(n, generator=g, device=dev) < 0.4
                gathers = (("gather", scg.gather_counts(n, st, off, vl,
                                                        device=dev)),
                           ("compact", scg.compaction_counts(mask)))
                scatters = (("scatter", scg.scatter_counts(n, st, off, vl,
                                                           device=dev)),
                            ("expand", scg.expansion_counts(mask)))
                for kind, (sh, va) in gathers:
                    where = f"{dtype} n={n} ({st}, {off}) rows={rows} {kind}"
                    hs, hv = sh.cpu().numpy(), va.cpu().numpy()
                    plan = shift_gather.host_plan(hs, hv, gather=True)
                    dyn = shift_gather.shift_gather(x, sh, va)
                    twin = shift_gather.shift_gather(x, hs, hv)
                    torch.cuda.synchronize()
                    if not same_bits(dyn, shift_gather.shift_gather_plain(
                            x, sh, va)):
                        raise AssertionError(f"B12 != plain: {where}")
                    if not same_bits(twin,
                                     shift_gather.shift_gather_static_plain(
                                         x, plan)):
                        raise AssertionError(f"B11 != plain: {where}")
                    if not same_bits(dyn, twin):
                        raise AssertionError(f"B12 != B11: {where}")
                    cases += 1
                for kind, (sh, va) in scatters:
                    where = f"{dtype} n={n} ({st}, {off}) rows={rows} {kind}"
                    hs, hv = sh.cpu().numpy(), va.cpu().numpy()
                    plan = shift_gather.host_plan(hs, hv, gather=False)
                    dp, do = shift_scatter.shift_scatter(x, sh, va)
                    tp, to = shift_scatter.shift_scatter(x, hs, hv)
                    torch.cuda.synchronize()
                    wp, wo = shift_scatter.shift_scatter_plain(x, sh, va)
                    if not (same_bits(dp, wp) and torch.equal(do, wo)):
                        raise AssertionError(f"B14 != plain: {where}")
                    wp, wo = shift_scatter.shift_scatter_static_plain(x, plan)
                    if not (same_bits(tp, wp) and torch.equal(to, wo)):
                        raise AssertionError(f"B13 != plain: {where}")
                    if not (same_bits(dp, tp) and torch.equal(do, to)):
                        raise AssertionError(f"B14 != B13: {where}")
                    cases += 1
    # B12 and B14 on random operand counts (uniform, short, negative and
    # out-of-range shifts; B13 routes their collisions as B14 does), and
    # the derive kernel's tables against their twins
    rng = np.random.default_rng(SEED + 7)
    refused = 0
    for n, _, _ in INDEXED_GEOM:
        for lo, hi, density in ((0, n, 0.5), (0, 8, 0.8), (-n, 2 * n + 1,
                                                            0.6)):
            sh = torch.from_numpy(rng.integers(lo, max(hi, lo + 1), n)
                                  .astype(np.int32))
            va = torch.from_numpy((rng.random(n) < density).astype(np.int32))
            # the derive kernel's table and the staged copy's operands on
            # B12's GSN and B14's SSN, 1/2/4/8-byte lanes
            for gsn, what in ((True, "B12"), (False, "B14")):
                want = _common.dyn_sources_plain(sh, va, gsn=gsn)
                for elem in (1, 2, 4, 8):
                    unit = _common.copy_unit(n * elem, 0)
                    table, pos, units = _indexed.dyn_sources(
                        sh.to(dev), va.to(dev), gsn=gsn, elem=elem,
                        unit=unit)
                    units = units.cpu().numpy()
                    wu, wp = _indexed.staged_units_plain(want.numpy(), n,
                                                         unit // elem, elem)
                    if not (torch.equal(table.cpu(), want) and np.array_equal(
                            pos.cpu().numpy(), wp) and np.array_equal(
                            units[1:1 + units[0]], wu)):
                        raise AssertionError(
                            f"{what} staged units != twin: n={n} elem "
                            f"{elem} shifts in [{lo}, {hi})")
            hs, hv = sh.numpy(), va.numpy()
            gplan = shift_gather.host_plan(hs, hv, gather=True)
            sh, va = sh.to(dev), va.to(dev)
            for dtype in dtypes:
                x = rand((1001, n), dtype)
                dp, do = shift_scatter.shift_scatter(x, sh, va)
                tp, to = shift_scatter.shift_scatter(x, hs, hv)
                wp, wo = shift_scatter.shift_scatter_plain(x, sh, va)
                gd = shift_gather.shift_gather(x, sh, va)
                gw = shift_gather.shift_gather_plain(x, sh, va)
                before = shift_gather.shift_gather_static.launches
                if gplan.conflict:       # refused, as the reference does
                    gt = gd
                    try:
                        shift_gather.shift_gather(x, hs, hv)
                    except AssertionError as err:
                        if "conflicting plan" not in str(err):
                            raise
                    else:
                        raise AssertionError(f"B11 took a conflicting plan: "
                                             f"n={n} shifts in [{lo}, {hi})")
                    if shift_gather.shift_gather_static.launches != before:
                        raise AssertionError("B11 launched on a conflicting "
                                             "plan")
                    refused += 1
                else:
                    gt = shift_gather.shift_gather(x, hs, hv)
                torch.cuda.synchronize()
                if not (same_bits(dp, wp) and torch.equal(do, wo)
                        and same_bits(dp, tp) and torch.equal(do, to)):
                    raise AssertionError(f"B14 != plain / B13: {dtype} n={n} "
                                         f"shifts in [{lo}, {hi})")
                if not (same_bits(gd, gw) and same_bits(gd, gt)):
                    raise AssertionError(f"B12 != plain / B11: {dtype} n={n} "
                                         f"shifts in [{lo}, {hi})")
            cases += 1
    print(f"B11 refused {refused} conflicting gather plans of the random "
          f"operand counts (AssertionError before any launch, as the "
          f"reference's plan body)")
    return cases


def kv_indexed_operands(dev, kv_shape, seed: int) -> dict:
    """The KV stack (bf16, seeded) and the Indexed operands of the (2,1)
    access over its 256-lane beats: the counts of ``scg.gather_counts(n,
    2, 1, n/2)`` / ``scatter_counts`` as tensors on the card and as numpy
    arrays, the n/2 values of the store and the same values zero-padded to
    n lanes (the raw scatter's input)."""
    import torch
    from repro_torch.core import scg
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    kv = torch.randn(kv_shape, generator=g, device=dev).to(torch.bfloat16)
    n = kv.shape[-1]
    st, off, vl = 2, 1, n // 2
    gs, gv = scg.gather_counts(n, st, off, vl, device=dev)
    ss, sv = scg.scatter_counts(n, st, off, vl, device=dev)
    vals = torch.randn(kv.shape[:-1] + (vl,), generator=g,
                       device=dev).to(torch.bfloat16)
    return {"kv": kv, "n": n, "st": st, "off": off, "vl": vl,
            "gs": gs, "gv": gv, "ss": ss, "sv": sv,
            "hgs": gs.cpu().numpy(), "hgv": gv.cpu().numpy(),
            "hss": ss.cpu().numpy(), "hsv": sv.cpu().numpy(), "vals": vals,
            "padded": torch.nn.functional.pad(vals, (0, n - vl))}


def time_routing_arm(kv, gs, gv, hgs, hgv, gplan, library) -> None:
    """The Indexed gather's static-routing arm (``vx.gather(Indexed(n,
    routing=...))``, torch ops under every policy, no kernel) on the KV
    stack: one take through the plan's table and a select.  Held bit for
    bit against B11 and against the layer-mask form (``layer_masks`` +
    ``apply_layer_masks`` + ``where``, every layer of the network), and
    timed beside that form and the library call."""
    import torch
    from repro_torch import vx
    from repro_torch.core import shiftnet
    from repro_torch.kernels import shift_gather
    routing = (tuple(int(s) for s in hgs.reshape(-1)),
               tuple(bool(v) for v in hgv.reshape(-1)))
    ix = vx.Indexed(n=kv.shape[-1], routing=routing)
    masks, occ = shiftnet.layer_masks(gs.to(torch.int32), gv.bool(),
                                      toward_zero=True, lsb_first=True)

    def arm():
        return vx.gather(ix, kv, policy="kernel")

    def layered():
        return torch.where(occ, shiftnet.apply_layer_masks(
            kv, masks, axis=-1, toward_zero=True, lsb_first=True), 0)

    before = [f.launches for f in shift_gather.KERNELS]
    got = arm()
    if [f.launches for f in shift_gather.KERNELS] != before:
        raise AssertionError("the static-routing arm launched a kernel")
    b11 = shift_gather.shift_gather_static(kv, gplan)
    torch.cuda.synchronize()
    if not (same_bits(got, b11) and same_bits(layered(), b11)):
        raise AssertionError("vx.gather(Indexed routing) != B11 / the "
                             "layer-mask form on the KV stack")
    del got, b11
    shape = list(kv.shape) + ["host counts (2,1) vl 128"]
    print(f"time vx.gather[Indexed routing] {shape}: "
          f"{time_ms(arm, 20):.4f} ms (one take through the plan's table "
          f"and a select; torch ops, no launch); layer-mask form "
          f"{time_ms(layered, 10):.4f} ms ({masks.shape[0]} layers and a "
          f"select); library {time_ms(library, 20):.4f} ms; all == B11, "
          f"bit for bit")


def time_indexed(dev, kv_shape) -> dict:
    """B11-B14 on the decode KV stack (bf16, 256-lane beats) with the
    counts of ``scg.gather_counts(256, 2, 1, 128)`` /
    ``scatter_counts(256, 2, 1, 128)``, cross-checked against the strided
    kernels: B12's and B11's lanes [0, 128) equal B3's output and the rest
    are 0; ``where(occ, payload, window)`` of B14 and B13 on the values
    zero-padded to 256 lanes equals B5's output.  Then each is timed
    (``record``); the library call is ``torch.gather`` along the lanes with
    the plan's precomputed source index, plus a ``where``.  Beside them:
    the units of a row B13's host operands list, and the derive kernel
    alone (CUDA graph) on B12's GSN and B14's SSN at n = 256 and 4095,
    with the units it lists."""
    import torch
    from repro_torch.core import scg
    from repro_torch.kernels import (_common, _indexed, shift_gather,
                                     shift_scatter, strided)
    ops = kv_indexed_operands(dev, kv_shape, SEED + 8)
    kv, n, st, off, vl = (ops[k] for k in ("kv", "n", "st", "off", "vl"))
    e = kv.element_size()
    R = kv.numel() // n
    gs, gv, ss, sv, vals, padded = (
        ops[k] for k in ("gs", "gv", "ss", "sv", "vals", "padded"))
    hgs, hgv, hss, hsv = (ops[k] for k in ("hgs", "hgv", "hss", "hsv"))
    b3 = strided.gather_strided(kv, st, off, vl)
    for name, out in (("B12", shift_gather.shift_gather(kv, gs, gv)),
                      ("B11", shift_gather.shift_gather(kv, hgs, hgv))):
        torch.cuda.synchronize()
        if not (same_bits(out[..., :vl].contiguous(), b3)
                and not bool(out[..., vl:].view(torch.int16).any())):
            raise AssertionError(f"{name} on the KV stack != B3 (lanes "
                                 f"[0, {vl})) and 0 (the rest)")
    del b3
    b5 = strided.scatter_strided(kv, vals, st, off)
    for name, (p, occ) in (
            ("B14", shift_scatter.shift_scatter(padded, ss, sv)),
            ("B13", shift_scatter.shift_scatter(padded, hss, hsv))):
        torch.cuda.synchronize()
        if not same_bits(torch.where(occ, p, kv), b5):
            raise AssertionError(f"where(occ, {name}, window) on the KV "
                                 f"stack != B5")
        del p, occ
    del b5
    print(f"indexed on the KV stack {list(kv.shape)}: B12 and B11 lanes "
          f"[0, {vl}) == B3 at ({st}, {off}) and the rest 0; where(occ, "
          f"B14 / B13 payload, window) == B5, bit for bit")
    gplan = shift_gather.host_plan(hgs, hgv, gather=True)
    splan = shift_gather.host_plan(hss, hsv, gather=False)

    def library(x, plan):
        src = torch.from_numpy(plan.source).to(dev).clamp(min=0).expand(
            x.shape)
        keep = torch.from_numpy(plan.valid).to(dev)
        return lambda: torch.where(keep, torch.gather(x, -1, src), 0)

    # least bytes: the input lanes that can reach the output, read once
    # (the gather's valid lanes' sources, the scatter's valid lanes; in
    # 32-byte sectors), the payload written once, and for the scatter one
    # occupancy byte per element; the count operands' few KiB left out
    gather_move = lane_bytes(R, gplan.source.reshape(-1)[
        gplan.valid.reshape(-1).astype(bool)], e) + R * n * e
    scatter_move = lane_bytes(R, hsv.reshape(-1).nonzero()[0], e) \
        + R * n * e + R * n
    shape = list(kv.shape)
    out = {}
    # B11's and B13's staged copies list the units their host plan's table
    # reads: no derivation on the card
    gunit = _common.copy_unit(n * e, kv.data_ptr())
    gst = _indexed.plan_staged(gplan, gunit // e, e)
    out["shift_gather_static"] = record(
        "shift_gather_static",
        lambda: shift_gather.shift_gather_static(kv, gplan),
        lambda: shift_gather.shift_gather_static_plain(kv, gplan),
        library(kv, gplan), gather_move,
        shape + ["host counts (2,1) vl 128"],
        f"; {int(gst['nunits'][0])} of {n * e // gunit} {gunit}-byte units "
        f"of a row listed by the host plan's table (one staged copy, no "
        f"derive kernel)")
    time_routing_arm(kv, gs, gv, hgs, hgv, gplan, library(kv, gplan))
    sunit = _common.copy_unit(n * e, padded.data_ptr())
    st = _indexed.plan_staged(splan, sunit // e, e)
    print(f"shift_scatter_static units: {int(st['nunits'][0])} of "
          f"{n * e // sunit} {sunit}-byte units of a row listed by the host "
          f"plan's table (one staged copy with the occupancy, no derive "
          f"kernel)")
    out["shift_scatter_static"] = record(
        "shift_scatter_static",
        lambda: list(shift_scatter.shift_scatter_static(padded, splan)),
        lambda: list(shift_scatter.shift_scatter_static_plain(padded,
                                                              splan)),
        library(padded, splan), scatter_move,
        shape + ["host counts (2,1) vl 128"])
    # the derive kernel alone (one block: the GSN for B12, the SSN for B14,
    # on the operand counts; the table and the staged copy's unit list for
    # bf16 rows) at the stack's n = 256 and on the 12-layer network at
    # n = 4095
    derive = {}
    for gsn, name, what, counts in (
            (True, "shift_gather", "B12", scg.gather_counts),
            (False, "shift_scatter", "B14", scg.scatter_counts)):
        dsn = (gs, gv) if gsn else (ss, sv)
        for dn, (dss, dsv) in ((n, dsn), (4095, counts(4095, 64, 0, 64,
                                                       device=dev))):
            dss, dsv = dss.to(torch.int32), dsv.to(torch.int32)
            unit = _common.copy_unit(dn * e, 0)
            derive[what, dn] = graph_ms(lambda: _indexed.dyn_sources(
                dss, dsv, gsn=gsn, elem=e, unit=unit), 20)
            listed = int(_indexed.dyn_sources(dss, dsv, gsn=gsn, elem=e,
                                              unit=unit)[2][0])
            print(f"time {name} derive n={dn}: {derive[what, dn]:.4f} ms for "
                  f"{what}'s derive kernel alone (one block: the "
                  f"{'GSN' if gsn else 'SSN'} on the operand counts, the "
                  f"{dn}-entry table and the unit list, {listed} of "
                  f"{dn * e // unit} {unit}-byte units of a row; device "
                  f"time, CUDA graph)")

    def note(what, net):
        return (f"; {net} derivation alone {derive[what, n]:.4f} ms (n = "
                f"{n}), {derive[what, 4095]:.4f} ms (n = 4095)")

    out["shift_gather"] = record(
        "shift_gather", lambda: shift_gather.shift_gather(kv, gs, gv),
        lambda: shift_gather.shift_gather_plain(kv, gs, gv),
        library(kv, gplan), gather_move,
        shape + ["tensor counts (2,1) vl 128"], note("B12", "GSN"))
    out["shift_scatter"] = record(
        "shift_scatter",
        lambda: list(shift_scatter.shift_scatter(padded, ss, sv)),
        lambda: list(shift_scatter.shift_scatter_plain(padded, ss, sv)),
        library(padded, splan), scatter_move,
        shape + ["tensor counts (2,1) vl 128"], note("B14", "SSN"))
    return out


def moe_compact_phase(dev) -> dict:
    """Compact at qwen3-moe-30b-a3b's width (d_model 2048, 128 experts,
    top-8): a 2048-token and a 512-token prefill chunk (n = 16384 and
    4096 routed units of 2048 bf16), the units of one shard of 4-way
    expert parallelism set (:func:`moe_mask`).  ``vx.compact`` then
    ``vx.scatter(Compact)`` must give ``where(mask, rows, 0)``, and the ids
    of ``vx.compact(Compact(n, cap), mask)`` must be
    ``torch.nonzero(mask)[:cap]`` on the set units.  Then B10 is timed at
    n = 16384 in the compact direction (the JSON record) and the expand
    direction (printed); the library call is ``index_select`` of each
    output row's source row (walked through the precomputed masks once)
    plus a ``where``, the kernel's own function.  The entry points
    ``compact_rows`` / ``expand_rows`` (counts, masks and one B10) are also
    timed beside ``kernels/ref.py``'s stable sort, index and ``where``."""
    import torch
    from repro_torch import vx
    from repro_torch.core import scg, shiftnet
    from repro_torch.kernels import moe_compact, ref
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 10)
    out = {}
    for tokens in (2048, 512):
        n = tokens * MOE_TOP_K
        rows = torch.randn((n, MOE_D), generator=g,
                           device=dev).to(torch.bfloat16)
        mask = torch.from_numpy(moe_mask(tokens, SEED + tokens)).to(dev)
        spec = vx.Compact(n=n)
        packed, pv = vx.compact(spec, mask, rows, policy="kernel")
        back = vx.scatter(spec, mask, packed, policy="kernel")
        cap = moe_capacity(tokens)
        ids = vx.compact(vx.Compact(n=n, cap=cap), mask, policy="kernel")
        nz = torch.nonzero(mask)[:cap, 0]
        torch.cuda.synchronize()
        if not same_bits(back, torch.where(mask[:, None], rows,
                                           torch.zeros_like(rows))):
            raise AssertionError(f"MoE n={n}: compact then expand != "
                                 f"where(mask, rows, 0)")
        if ids.shape != (cap,) or not torch.equal(ids[:nz.numel()].long(),
                                                  nz):
            raise AssertionError(f"MoE n={n}: compact ids != nonzero(mask)")
        count = int(mask.sum())
        print(f"moe compact n={n} ({tokens} tokens x top-{MOE_TOP_K}, "
              f"d {MOE_D} bf16): {count} units set (density "
              f"{count / n:.4f}); compact -> expand == where(mask, rows, 0) "
              f"and ids == nonzero(mask)[:{cap}], bit for bit")
        row_bytes = MOE_D * rows.element_size()
        for direction, counts, tz, keep in (
                ("compact", scg.compaction_counts, True, pv),
                ("expand", scg.expansion_counts, False, mask)):
            s, v = counts(mask)
            masks, _ = shiftnet.layer_masks(s, v, toward_zero=tz,
                                            lsb_first=tz)
            x = rows if direction == "compact" else packed
            # the library call of the same function, the masks precomputed:
            # each output row's source row (walked through the masks once,
            # here) by index_select, then a where
            ids = moe_compact.route_rows_plain(
                torch.arange(1, n + 1, device=dev)[:, None], masks,
                torch.ones(n, dtype=torch.bool, device=dev),
                toward_zero=tz, lsb_first=tz)[:, 0] - 1
            src, take = ids.clamp(min=0), (keep & (ids >= 0))[:, None]
            lib = (lambda: torch.where(take, x.index_select(0, src), 0))
            if not same_bits(lib(), moe_compact.route_rows_plain(
                    x, masks, keep, toward_zero=tz, lsb_first=tz)):
                raise AssertionError(f"B10 library call n={n} {direction} "
                                     f"!= the plain version")
            # least bytes: the rows that land in a valid slot read once,
            # every output row written once, the masks and out_valid read
            bound = (count + n) * row_bytes + masks.numel() + n
            r = record(
                f"route_rows[{direction}] n={n}",
                lambda: moe_compact.route_rows(x, masks, keep,
                                               toward_zero=tz, lsb_first=tz),
                lambda: moe_compact.route_rows_plain(
                    x, masks, keep, toward_zero=tz, lsb_first=tz),
                lib, bound, [n, MOE_D, f"density {count / n:.4f}"])
            if tokens == 2048 and direction == "compact":
                out["route_rows"] = r
            # the whole entry point, counts and masks included, beside the
            # library sequence of kernels/ref.py (stable sort, index, where)
            port, lib_e2e = ((lambda: moe_compact.compact_rows(rows, mask),
                              lambda: ref.compact_rows(rows, mask))
                             if direction == "compact" else
                             (lambda: moe_compact.expand_rows(packed, mask),
                              lambda: ref.expand_rows(packed, mask)))
            print(f"time {direction}_rows end to end n={n}: port "
                  f"{time_ms(port, 20):.4f} ms (counts, masks, one B10), "
                  f"library {time_ms(lib_e2e, 20):.4f} ms (kernels/ref.py)")
        del rows, packed, back
        torch.cuda.empty_cache()
    return out


def indexed_path(dev, kv_shape, impl: str) -> dict:
    """One run of the Indexed / Compact path under policy ``impl``: the
    counts of B10-B14 are set to 0 just before it and read just after.
    Through ``vx``: the Indexed gather with tensor counts (B12 under either
    kernel policy) and with numpy counts (the plan stage, no kernel), the
    Indexed scatter with tensor counts (B14) and numpy counts (B13) on the
    KV stack; ``vx.compact`` with rows and ``vx.scatter(Compact)`` (one B10
    each) and the compact ids (no kernel) at the MoE width.  Under a kernel
    policy the run also calls ``kernels.shift_gather.shift_gather`` with
    numpy counts, the entry point that reaches B11 (the reference reaches
    that body only by a direct call).  Returns the outputs, the launches
    of the whole run and of each call."""
    import torch
    from repro_torch import vx
    from repro_torch.kernels import moe_compact, shift_gather, shift_scatter
    ops = kv_indexed_operands(dev, kv_shape, SEED + 9)
    kv, n, st, off, vl = (ops[k] for k in ("kv", "n", "st", "off", "vl"))
    gs, gv, ss, sv, vals, padded = (
        ops[k] for k in ("gs", "gv", "ss", "sv", "vals", "padded"))
    hgs, hgv, hss, hsv = (ops[k] for k in ("hgs", "hgv", "hss", "hsv"))
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 12)
    tokens = 2048
    N = tokens * MOE_TOP_K
    rows = torch.randn((N, MOE_D), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.from_numpy(moe_mask(tokens, SEED + 11)).to(dev)
    cap = moe_capacity(tokens)
    wrappers = (moe_compact.KERNELS + shift_gather.KERNELS
                + shift_scatter.KERNELS)

    def launches():
        return {f.__name__: f.launches for f in wrappers}

    outs, per_call = {}, {}

    def step(name, fn):
        before = launches()
        outs[name] = fn()
        after = launches()
        per_call[name] = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}

    torch.cuda.synchronize()
    for mod in (moe_compact, shift_gather, shift_scatter):
        mod.reset_counts()                  # counts from here: the path
    with vx.use(impl):
        ix = vx.Indexed(n=n)
        step("gather[tensor]", lambda: vx.gather(ix, kv, shift=gs, valid=gv))
        step("gather[numpy]", lambda: vx.gather(ix, kv, shift=hgs,
                                                valid=hgv))
        step("scatter[tensor]", lambda: vx.scatter(ix, None, padded,
                                                   shift=ss, valid=sv))
        step("scatter[numpy]", lambda: vx.scatter(ix, None, padded,
                                                  shift=hss, valid=hsv))
        step("compact", lambda: vx.compact(vx.Compact(n=N), mask, rows))
        step("expand", lambda: vx.scatter(vx.Compact(n=N), mask,
                                          outs["compact"][0]))
        step("ids", lambda: vx.compact(vx.Compact(n=N, cap=cap), mask))
        if impl != "ref":
            step("shift_gather[numpy]",
                 lambda: shift_gather.shift_gather(kv, hgs, hgv))
    torch.cuda.synchronize()
    total = launches()
    # the same functions by plain indexing, as a yardstick for every run
    gather_want = torch.zeros_like(kv)
    gather_want[..., :vl] = kv[..., off::st]
    scatter_want = kv.clone()
    scatter_want[..., off::st] = vals
    checks = {"gather[tensor]": outs["gather[tensor]"],
              "gather[numpy]": outs["gather[numpy]"]}
    if "shift_gather[numpy]" in outs:
        checks["shift_gather[numpy]"] = outs["shift_gather[numpy]"]
    for k, got in checks.items():
        if not same_bits(got, gather_want):
            raise AssertionError(f"indexed path [{impl}] {k} differs from "
                                 f"plain indexing")
    for k in ("scatter[tensor]", "scatter[numpy]"):
        p, occ = outs[k]
        if not same_bits(torch.where(occ, p, kv), scatter_want):
            raise AssertionError(f"indexed path [{impl}] {k} differs from "
                                 f"plain indexing")
    if not same_bits(outs["expand"], torch.where(mask[:, None], rows,
                                                 torch.zeros_like(rows))):
        raise AssertionError(f"indexed path [{impl}] compact -> expand != "
                             f"where(mask, rows, 0)")
    nz = torch.nonzero(mask)[:cap, 0]
    if not torch.equal(outs["ids"][:nz.numel()].long(), nz):
        raise AssertionError(f"indexed path [{impl}] ids != nonzero(mask)")
    return {"outs": outs, "launches": total, "per_call": per_call}


def indexed_phase(dev, kv_shape, timing: dict) -> dict:
    """Phase 6: B10-B14 against their plain versions (and plan twins),
    the KV-stack cross-checks and times of B11-B14, the MoE-width compact
    round trip and B10's times (``timing`` gains the five records), then
    the Indexed / Compact path under ``kernel``, ``ref`` and
    ``kernel_dynamic``: outputs equal bit for bit, the launches of each
    call as stated in :func:`indexed_path`.  Returns the ``kernel`` run's
    launches."""
    import torch
    t0 = time.perf_counter()
    cases = check_indexed(dev)
    print(f"indexed kernels == plain: {cases} cases (B10 both directions; "
          f"B12 == B11 and B14 == B13 on the same counts, also on random "
          f"operand counts, with B12's and B14's device source tables == "
          f"dyn_sources_plain and their unit lists == staged_units_plain) "
          f"bit-exact ({time.perf_counter() - t0:.1f} s)")
    timing.update(time_indexed(dev, kv_shape))
    torch.cuda.empty_cache()
    timing.update(moe_compact_phase(dev))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    path = {}
    for impl in ("kernel", "ref", "kernel_dynamic"):
        path[impl] = indexed_path(dev, kv_shape, impl)
        torch.cuda.empty_cache()
    ref = path["ref"]
    for impl in ("kernel", "kernel_dynamic"):
        for key, out in path[impl]["outs"].items():
            want = ref["outs"].get(key, path["kernel"]["outs"][key])
            out = out if isinstance(out, tuple) else (out,)
            want = want if isinstance(want, tuple) else (want,)
            if not all(same_bits(a, b) for a, b in zip(out, want)):
                raise AssertionError(f"indexed path: {key} differs between "
                                     f"{impl} and ref")
    if any(ref["launches"].values()):
        raise AssertionError(f"ref policy launched indexed kernels: "
                             f"{ref['launches']}")
    want_calls = {"gather[tensor]": {"shift_gather": 1},
                  "gather[numpy]": {},
                  "scatter[tensor]": {"shift_scatter": 1},
                  "scatter[numpy]": {"shift_scatter_static": 1},
                  "compact": {"route_rows": 1},
                  "expand": {"route_rows": 1},
                  "ids": {},
                  "shift_gather[numpy]": {"shift_gather_static": 1}}
    for impl in ("kernel", "kernel_dynamic"):
        if path[impl]["per_call"] != want_calls:
            raise AssertionError(f"indexed path [{impl}] launches per call: "
                                 f"{path[impl]['per_call']}")
    print(f"indexed path: outputs equal under kernel, ref and kernel_dynamic "
          f"and to plain indexing; launches per call under kernel and "
          f"kernel_dynamic {path['kernel']['per_call']}; whole run kernel "
          f"{path['kernel']['launches']}, kernel_dynamic "
          f"{path['kernel_dynamic']['launches']}, ref {ref['launches']} "
          f"({time.perf_counter() - t0:.1f} s)")
    return path["kernel"]["launches"]


# ---------------------------------------------------------------------------
# Phase 7: dense serving (forward prefill, dense decode) and the serve CLI
# ---------------------------------------------------------------------------

DENSE_PROMPT, DENSE_STEPS, DENSE_MAX_LEN = 64, 16, 512
ORACLE_STEPS = 8
CLI_ARGS = ("--arch", "qwen3-0.6b", "--requests", "4", "--prompt-len", "64",
            "--gen", "16", "--max-len", "512")


def segment_counts() -> dict:
    from repro_torch.kernels import segment
    return {f.__name__: f.launches for f in segment.KERNELS + segment.DYNAMIC}


def dense_serve(dev, cfg, params, impl: str, tokens,
                profiled: bool = False) -> dict:
    """Phase 7a under policy ``impl``: ``jit_prefill`` over ``tokens``
    (one warm-up call, then the timed one), ``cache_from_prefill`` into
    ``DENSE_MAX_LEN`` bf16 beats, then ``DENSE_STEPS`` greedy fused
    ``jit_decode_step`` steps.  The counts are zeroed just before the timed
    prefill and before each step, and read just after.  With ``profiled``
    the timed prefill and the steps are traced by torch.profiler (host and
    device) and the trace returned."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import segment
    from repro_torch.models import decode as dec
    from repro_torch.serve.engine import (ServeConfig, jit_decode_step,
                                          jit_prefill)
    cfg = dataclasses.replace(cfg, kernel_impl=impl)
    prefill = jit_prefill(cfg, None, device=dev)
    step = jit_decode_step(cfg, None, ServeConfig(max_len=DENSE_MAX_LEN,
                                                  step_fusion=True),
                           device=dev)
    prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    tracer = (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext())
    tracer.__enter__()
    wall0 = time.perf_counter()
    segment.reset_counts()
    t0 = time.perf_counter()
    logits, states = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = segment_counts()
    B, S = tokens.shape
    if tuple(logits.shape) != (B, 1, cfg.vocab) or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"dense [{impl}]: prefill logits not finite of "
                             f"shape ({B}, 1, {cfg.vocab})")
    cache = dec.cache_from_prefill(cfg, states, S, DENSE_MAX_LEN,
                                   torch.bfloat16)
    del states
    tok = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)
    stream = [tok]
    step_ms, step_launches = [], []
    for _ in range(DENSE_STEPS):
        torch.cuda.synchronize()
        segment.reset_counts()
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tok)
        tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_launches.append(segment_counts())
        stream.append(tok)
    wall = time.perf_counter() - wall0
    tracer.__exit__(None, None, None)
    if tuple(logits.shape) != (B, cfg.vocab) or \
            not bool(torch.isfinite(logits.float()).all()) or \
            int(cache["len"]) != S + DENSE_STEPS:
        raise AssertionError(f"dense [{impl}]: decode logits not finite of "
                             f"shape ({B}, {cfg.vocab}), or the cache's "
                             f"length is not {S + DENSE_STEPS}")
    del cache
    torch.cuda.empty_cache()
    return {"streams": torch.stack(stream, 1).cpu().tolist(),
            "prefill_ms": prefill_ms, "prefill_launches": prefill_launches,
            "step_ms": step_ms, "step_launches": step_launches,
            "wall_s": wall, "prof": tracer if profiled else None,
            "label": f"dense: 1 prefill of {B}x{S} tokens + {DENSE_STEPS} "
                     f"decode steps"}


def dense_vs_paged(dev, cfg, params, slots: int, page_size: int) -> list:
    """Phase 7b: from empty caches, the same forced token stream for
    ``ORACLE_STEPS`` steps through the dense step and the paged step,
    each fused and per-access, under ``kernel``; every step's logits must
    equal the fused dense step's bit for bit.  Returns, per pair, the
    steps that differed and the largest difference."""
    import numpy as np
    import torch
    from repro_torch.models import decode as dec
    cfg = dataclasses.replace(cfg, kernel_impl="kernel")
    forced = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab, (ORACLE_STEPS, slots)).astype(np.int32)).to(dev)
    caches = {"dense fused": dec.init_cache(cfg, slots, DENSE_MAX_LEN,
                                            torch.bfloat16, device=dev),
              "dense per-access": dec.init_cache(cfg, slots, DENSE_MAX_LEN,
                                                 torch.bfloat16, device=dev),
              "paged fused": dec.init_paged_cache(
                  cfg, slots, DENSE_MAX_LEN, page_size, torch.bfloat16,
                  device=dev),
              "paged per-access": dec.init_paged_cache(
                  cfg, slots, DENSE_MAX_LEN, page_size, torch.bfloat16,
                  device=dev)}
    steps = {"dense fused": lambda c, t: dec.decode_step(
                 params, c, t, cfg, fuse=True),
             "dense per-access": lambda c, t: dec.decode_step(
                 params, c, t, cfg, fuse=False),
             "paged fused": lambda c, t: dec.paged_decode_step(
                 params, c, t, cfg, fuse=True),
             "paged per-access": lambda c, t: dec.paged_decode_step(
                 params, c, t, cfg, fuse=False)}
    diffs = {k: [0, 0.0] for k in steps if k != "dense fused"}
    for t in range(ORACLE_STEPS):
        out = {}
        for name, fn in steps.items():
            out[name], caches[name] = fn(caches[name], forced[t])
        base = out["dense fused"]
        for name in diffs:
            if not same_bits(out[name], base):
                diffs[name][0] += 1
                diffs[name][1] = max(diffs[name][1], float(
                    (out[name].float() - base.float()).abs().max()))
    del caches
    torch.cuda.empty_cache()
    return diffs


def run_cli(card: str) -> dict:
    """Phase 7c: the port's serve CLI at full width in a subprocess."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *CLI_ARGS], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"serve CLI exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    lines = out.stdout.splitlines()
    reqs = [ln for ln in lines if ln.startswith("req ")]
    tok_line = [ln for ln in lines if "tok/s on " in ln]
    name = card.split(",")[0].strip()
    if len(reqs) != 4 or not all(" finished " in ln for ln in reqs) or \
            len(tok_line) != 1 or name not in tok_line[0]:
        raise AssertionError(f"serve CLI output: every request must be "
                             f"finished and the tok/s line must name "
                             f"{name}:\n{out.stdout[-3000:]}")
    return {"lines": lines, "wall_s": wall}


def dense_phase(dev, cfg, card: str, slots: int, page_size: int) -> None:
    """Phase 7: dense serving under ``kernel``, ``ref``,
    ``kernel_dynamic``, ``kernel_dynamic``, ``ref``, ``kernel`` (streams
    equal; prefill launches B1 and B2 or B6 and B7; every decode step
    exactly one fused split, B1 or B6, none under ``ref``), the dense step
    against the paged step, and the CLI."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import cast_params, init_params
    t0 = time.perf_counter()
    params = cast_params(init_params(cfg, SEED, device=dev), cfg)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab, (slots, DENSE_PROMPT)).astype(np.int32)).to(dev)
    # the host clock drifts within a call: phase 4's order puts every
    # policy at the same mean position
    order = ("kernel", "ref", "kernel_dynamic", "kernel_dynamic", "ref",
             "kernel")
    runs = [(impl, dense_serve(dev, cfg, params, impl, tokens))
            for impl in order]
    want_step = {"kernel": "deinterleave",
                 "kernel_dynamic": "deinterleave_dynamic", "ref": None}
    want_prefill = {"kernel": ("deinterleave", "interleave"),
                    "kernel_dynamic": ("deinterleave_dynamic",
                                       "interleave_dynamic"), "ref": ()}
    for impl, r in runs:
        if r["streams"] != runs[0][1]["streams"]:
            raise AssertionError(f"dense [{impl}]: other token streams than "
                                 f"under kernel")
        pre = r["prefill_launches"]
        if any((pre[k] > 0) != (k in want_prefill[impl]) for k in pre):
            raise AssertionError(f"dense [{impl}]: prefill launches {pre}")
        for n in r["step_launches"]:
            want = {k: int(k == want_step[impl]) for k in n}
            if n != want:
                raise AssertionError(f"dense [{impl}]: decode step launches "
                                     f"{n}, want {want}")
        decode_s = sum(r["step_ms"]) / 1e3
        print(f"dense serve[{impl}] {cfg.name} on {card}: prefill "
              f"{slots}x{DENSE_PROMPT} tokens {r['prefill_ms']:.3f} ms "
              f"(launches per prefill {pre}); median decode step "
              f"{statistics.median(r['step_ms']):.3f} ms over "
              f"{DENSE_STEPS} steps; decode tokens/s "
              f"{slots * DENSE_STEPS / decode_s:.2f}; launches per decode "
              f"step {r['step_launches'][0]}")
    print(f"dense streams equal under kernel, ref and kernel_dynamic in "
          f"{len(runs)} runs ({slots} x {DENSE_STEPS + 1} tokens); one fused "
          f"split launch "
          f"in each decode step (B1 under kernel, B6 under kernel_dynamic, "
          f"none under ref) ({time.perf_counter() - t0:.1f} s)")
    if "--profile" in sys.argv[1:]:
        profile_policies({impl: dense_serve(dev, cfg, params, impl, tokens,
                                            profiled=True)
                          for impl in ("kernel", "ref")})
    t0 = time.perf_counter()
    diffs = dense_vs_paged(dev, cfg, params, slots, page_size)
    print(f"dense step vs paged step under kernel, {ORACLE_STEPS} forced "
          f"steps, slots {slots}, page_size {page_size}: steps differing "
          f"from the fused dense step's logits, and the largest difference "
          f"{diffs} ({time.perf_counter() - t0:.1f} s)")
    if any(n for n, _ in diffs.values()):
        raise AssertionError(f"dense step vs paged step: logits differ "
                             f"{diffs}")
    del params
    torch.cuda.empty_cache()
    cli = run_cli(card)
    tail = [ln for ln in cli["lines"] if "tok/s on " in ln][0]
    print(f"serve CLI ({' '.join(CLI_ARGS)}): exit 0, every request "
          f"finished, {cli['wall_s']:.1f} s of wall time: {tail}")


def profile_policies(runs: dict) -> None:
    """``--profile``: where each policy's serve run spends its time, from
    torch.profiler traces of one whole run (prefill and decode) per policy.
    Prints each run's host wall time, device busy time (device events only:
    an operator's row repeats its kernels' time), host time inside
    operators, and kernel launches; then the operators whose host and
    device times differ most between the ``kernel`` and ``ref`` runs."""
    from torch.autograd import DeviceType
    host, device = {}, {}
    for impl, r in runs.items():
        ka = r["prof"].key_averages()
        device[impl] = {e.key: e.self_device_time_total / 1e3 for e in ka
                        if e.device_type == DeviceType.CUDA}
        host[impl] = {e.key: e.self_cpu_time_total / 1e3 for e in ka
                      if e.device_type == DeviceType.CPU}
        wall_ms = r["wall_s"] * 1e3
        dev_ms = sum(device[impl].values())
        op_ms = sum(host[impl].values())
        launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
        what = r.get("label") or (f"{r['prefill_chunks']} prefill chunks "
                                  f"+ {r['decode_steps']} decode steps")
        print(f"profile[{impl}]: {what} in {wall_ms:.3f} ms (host "
              f"clock, traced); device busy {dev_ms:.3f} ms = "
              f"{dev_ms / wall_ms:.4f} of the run; host self time in "
              f"operators {op_ms:.3f} ms, outside them {wall_ms - op_ms:.3f} "
              f"ms; {launches} cudaLaunchKernel")
    for kind, table in (("host", host), ("device", device)):
        k, rf = table["kernel"], table["ref"]
        keys = sorted(set(k) | set(rf),
                      key=lambda x: -abs(k.get(x, 0.0) - rf.get(x, 0.0)))
        for key in keys[:12]:
            a, b = k.get(key, 0.0), rf.get(key, 0.0)
            print(f"  {kind} {key[:72]}: kernel {a:.3f} ms, ref {b:.3f} ms,"
                  f" kernel-ref {a - b:+.3f} ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.qwen3_0_6b import config
    from repro_torch.kernels import _common, strided
    from repro_torch.models.transformer import init_params

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _common.build_all(_common.SOURCES)
    print(f"build: {', '.join(f'{s}.cu' for s in _common.SOURCES)} (with "
          f"the shared headers route_plan.cuh, route_dyn.cuh and "
          f"perm_copy.cuh) in parallel in "
          f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    cases = check_kernels(dev)
    print(f"kernels == plain: {cases} cases x 2 segment kernels bit-exact "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cases = check_strided(dev)
    print(f"kernels == plain: {cases} strided cases (B3 and B5 together, "
          f"B4 alone) bit-exact ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cases = check_views(dev)
    print(f"kernels on views == plain: {cases} cases (B1-B14 and the vx "
          f"Strided / Segment verbs, each on a transposed view and on a "
          f"last-dim slice of a wider tensor, against contiguous copies) "
          f"bit-exact ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cases = check_dynamic(dev)
    print(f"dynamic kernels == plain == plan twin: {cases} cases (B6 and B7 "
          f"together, B8 and B9 together, B8 x4 against B4, the derivation "
          f"against layer_masks, B6's, B7's, B8's and B9's device source "
          f"tables against dyn_sources_plain, B7's merged table against "
          f"interleave_dynamic_table, B9's device list against "
          f"merge_pairs) bit-exact ({time.perf_counter() - t0:.1f} s)")

    cfg = config()
    slots, max_len, page_size, gen = 4, 512, 16, 16
    timing = time_kernels(dev, cfg, slots, max_len)

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(40, 101, slots)]
    params = init_params(cfg, SEED, device=dev)
    # the host clock drifts within a call, and this order puts every
    # policy at the same mean position
    order = ("kernel", "ref", "kernel_dynamic", "kernel_dynamic", "ref",
             "kernel")
    runs = [(impl, serve(dev, cfg, params, impl, prompts, gen, slots,
                         max_len, page_size)) for impl in order]
    for impl, r in runs:
        decode_s = sum(r["step_ms"]) / 1e3
        print(f"serve[{impl}] {cfg.name} on {card}: generated tokens/s over "
              f"the whole run (prefill included) "
              f"{r['tokens'] / r['wall_s']:.2f} ({r['tokens']} tokens in "
              f"{r['wall_s']:.3f} s); decode-step tokens/s "
              f"{sum(r['step_tokens']) / decode_s:.2f} "
              f"({sum(r['step_tokens'])} tokens in {decode_s:.3f} s of "
              f"decode steps); median decode step "
              f"{statistics.median(r['step_ms']):.3f} ms over "
              f"{r['decode_steps']} steps; {r['prefill_chunks']} prefill "
              f"chunks; launches {r['launches']}")
    kr = runs[0][1]
    dr = runs[2][1]
    for impl, r in runs[1:]:
        if r["streams"] != kr["streams"]:
            raise AssertionError(f"{impl} gave other token streams than the "
                                 f"first kernel run")
    plan = ("deinterleave", "interleave")
    dynamic = ("deinterleave_dynamic", "interleave_dynamic")
    for impl, r in runs:
        mine, other, split = {"kernel": (plan, dynamic, (1, 0)),
                              "kernel_dynamic": (dynamic, plan, (0, 1)),
                              "ref": ((), plan + dynamic, None)}[impl]
        if any(r["launches"][k] <= 0 for k in mine):
            raise AssertionError(f"{impl}: a kernel never launched on the "
                                 f"main path: {r['launches']}")
        if any(r["launches"][k] != 0 for k in other):
            raise AssertionError(f"{impl} launched another policy's "
                                 f"kernels: {r['launches']}")
        if split and any(n != split for n in r["step_launches"]):
            raise AssertionError(f"{impl}: fused split launches (B1, B6) per "
                                 f"decode step: {r['step_launches']}")
        first = kr if impl == "kernel" else dr
        if impl != "ref" and r["launches"] != first["launches"]:
            raise AssertionError(f"{impl} runs launched differently: "
                                 f"{r['launches']} vs {first['launches']}")
    print(f"streams equal under kernel, ref and kernel_dynamic; one fused "
          f"split launch in each of {len(kr['step_launches'])} decode steps "
          f"(B1 under kernel, B6 under kernel_dynamic)")
    if "--profile" in sys.argv[1:]:
        profile_policies({impl: serve(dev, cfg, params, impl, prompts, gen,
                                      slots, max_len, page_size,
                                      profiled=True)
                          for impl in ("kernel", "ref")})
    del params
    torch.cuda.empty_cache()

    kv_shape = (cfg.n_superblocks, slots, max_len, cfg.n_kv_heads,
                2 * cfg.hd)
    t0 = time.perf_counter()
    path = {impl: strided_path(dev, kv_shape, impl)
            for impl in ("kernel", "ref", "kernel_dynamic")}
    for impl in ("kernel", "kernel_dynamic"):
        for key, out in path[impl]["outs"].items():
            if not same_bits(out, path["ref"]["outs"][key]):
                raise AssertionError(f"strided path: {key} differs between "
                                     f"{impl} and ref")
    pk, pr, pd = path["kernel"], path["ref"], path["kernel_dynamic"]
    splan = tuple(f.__name__ for f in strided.KERNELS)
    sdyn = tuple(f.__name__ for f in strided.DYNAMIC)
    if max(pr["launches"].values()) != 0 or max(pr["group"].values()) != 0:
        raise AssertionError(f"ref policy launched strided kernels: "
                             f"{pr['launches']}")
    for impl, p, mine, other in (("kernel", pk, splan, sdyn),
                                 ("kernel_dynamic", pd, sdyn, splan)):
        if any(p["launches"][k] <= 0 for k in mine):
            raise AssertionError(f"{impl}: a strided kernel never launched "
                                 f"on the strided path: {p['launches']}")
        if any(p["launches"][k] != 0 for k in other):
            raise AssertionError(f"{impl} launched another policy's strided "
                                 f"kernels: {p['launches']}")
    if pk["group"] != {"gather_strided_fused": 1,
                       "gather_strided_dynamic": 0}:
        raise AssertionError(f"StepScheduler strided group under kernel: "
                             f"{pk['group']}, want one B4 launch")
    if pd["group"] != {"gather_strided_fused": 0,
                       "gather_strided_dynamic": len(HETERO)}:
        raise AssertionError(f"StepScheduler strided group under "
                             f"kernel_dynamic: {pd['group']}, want "
                             f"{len(HETERO)} B8 launches")
    print(f"strided path: {len(pk['outs'])} outputs equal under kernel, ref "
          f"and kernel_dynamic and to plain indexing; launches kernel "
          f"{pk['launches']}, kernel_dynamic {pd['launches']}, ref "
          f"{pr['launches']}; the 4-request StepScheduler group made one B4 "
          f"launch under kernel and {len(HETERO)} B8 launches under "
          f"kernel_dynamic ({time.perf_counter() - t0:.1f} s)")

    ipk = indexed_phase(dev, kv_shape, timing)
    dense_phase(dev, cfg, card, slots, page_size)

    launches = {k: kr["launches"][k] for k in plan}
    launches.update({k: dr["launches"][k] for k in dynamic})
    launches.update({k: pk["launches"][k] for k in splan})
    launches.update({k: pd["launches"][k] for k in sdyn})
    launches.update(ipk)
    kernels = []
    for name in REPLACES:
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
