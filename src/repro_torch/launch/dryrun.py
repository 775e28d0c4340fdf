"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake ranks.

Port of ``repro``'s ``launch/dryrun.py`` (its ``run_cell``,
``save_artifact`` and ``main``, flag for flag).  The reference fakes 512
host devices, lowers each real step with full shardings on
``ShapeDtypeStruct`` s and compiles it.  The port has no compiler to ask;
for each cell this driver, in one process:

  1. starts torch's ``fake`` process group at world 256 (single pod) or
     512 (multi-pod) and builds the production mesh on it
     (``launch/mesh.make_production_mesh``): this process is rank 0, and
     every collective returns at once;
  2. builds the inputs as fake tensors (``FakeTensorMode``: shapes and
     dtypes, nothing allocated) from ``configs.base.train_batch`` /
     ``prefill_batch`` / ``decode_inputs(specs=True)``, and places the
     state or params and the cache as the real launchers would (each
     rank's blocks: ``train/step.full_state_shardings``,
     ``serve/engine.serve_param_shardings`` and ``cache_specs``);
  3. runs the port's REAL step eagerly on them
     (``train/step.make_train_step(ctx)``, ``serve/engine.jit_prefill``,
     ``jit_decode_step``), under ``roofline.bundle_from_trace`` and a
     dispatch mode that tracks the bytes of the tensors the step keeps
     alive: a placement mismatch, a missing collective or a shape error
     fails the cell;
  4. records rank 0's bytes per device (its argument blocks, the output,
     the temporaries at the peak), whether they fit the card's HBM
     (``hw.DEFAULT_CHIP``), the traced FLOPs, bytes and collective bytes
     (``raw``), and the roofline against the H100;
  5. writes one JSON artifact per cell under ``experiments/artifacts_torch``
     (never the reference's directory).

The eager trace runs every superblock and every microbatch, where XLA's
cost analysis counts a scanned body once: ``corrected`` is the direct
count, and its ``method`` says so.  The reference's 1- and 2-superblock
probes stay available (``run_cell(probes=True)``, unrolled configs of 1
and 2 superblocks) as a check of that linearity.

Two things the trace cannot run as the card does, recorded in each
artifact (``policy``, ``moe``):

* the ``vx`` access layer runs its ``ref`` lowering (torch ops): the
  hand-written kernels launch through ctypes on device pointers, which a
  fake tensor does not have;
* a MoE layer's run lengths per expert are data (one host read a layer
  on the card): the grouped GEMMs are counted as the reference's
  ``lax.ragged_dot`` computes them, each a product over the whole
  capacity buffer (``models/moe._grouped_ffn``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--both-meshes]
      [--no-probes] [--skip-existing] [--out DIR]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import time
import traceback
import warnings
import weakref

import torch

from repro_torch import hw

ARTIFACT_DIR = "experiments/artifacts_torch"
#: What the artifacts record of the two things the trace runs otherwise
#: than the card.
POLICY = ("ref: the vx layer's torch-op lowering (the CUDA kernels need "
          "device pointers, which fake tensors lack)")
MOE_METHOD = ("grouped GEMMs counted as ragged_dot over the capacity "
              "buffer: each of the three products one (cap, d) x (d, f) "
              "matmul (the run lengths per expert are data)")
#: The escalation's threshold: the reference's 15.5 / 16 of the card's
#: HBM.
FIT_FRACTION = 15.5 / 16

# Converged adaptive-microbatch values (the reference's hint cache, not a
# config: removing an entry re-enables escalation).
MB_HINTS = {
    "granite-34b": 2,
    "gemma3-12b": 4,
    "qwen3-0.6b": 1,
    "starcoder2-3b": 1,
    "jamba-1.5-large-398b": 8,
    "whisper-tiny": 2,
    "llava-next-mistral-7b": 1,
    "phi3.5-moe-42b-a6.6b": 2,
    "qwen3-moe-30b-a3b": 4,
    "xlstm-125m": 1,
}


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int):
    """torch's ``fake`` default process group of ``world`` ranks, this
    process rank 0 (every collective returns at once), destroyed on
    exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _fake(tree):
    """A tree of ``meta`` tensors (the input builders' specs) as fake CPU
    tensors of the same shapes and dtypes (call under the fake mode)."""
    from repro_torch.dist import sharding
    return sharding.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="cpu"), tree)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class LiveBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """Tracks the bytes of the tensors the traced step allocates and keeps
    alive (an operator's fresh outputs, freed when the last reference
    goes): ``peak`` is their most at once, ``live`` what is left.  With
    ``threshold`` (bytes) it also counts every such tensor of at least
    that size by dtype and shape, with the aten ops that made it
    (:meth:`ranking`)."""

    def __init__(self, threshold: int | None = None):
        super().__init__()
        self.live = self.peak = 0
        self.threshold = threshold
        self.sizes: collections.Counter = collections.Counter()
        self.ops: dict = collections.defaultdict(set)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(r.alias_info is not None for r in func._schema.returns):
            return out           # a view, or written in place
        for t in _tensors(out):
            if t.device.type == "meta":
                continue         # shapes only, never memory
            n = t.numel() * t.element_size()
            self.live += n
            weakref.finalize(t, self._free, n)
            if self.threshold is not None and n >= self.threshold:
                key = (t.dtype, tuple(t.shape))
                self.sizes[key] += 1
                self.ops[key].add(func.__name__)
        self.peak = max(self.peak, self.live)
        return out

    def ranking(self) -> list:
        """``(dtype, shape, bytes, count, ops)`` of the tensors at or above
        the threshold, largest first (then the most made)."""
        rows = [(dt, sh, math.prod(sh) * dt.itemsize, c, sorted(self.ops[(
            dt, sh)])) for (dt, sh), c in self.sizes.items()]
        return sorted(rows, key=lambda r: (-r[2], -r[3], str(r[0]), r[1]))


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _total_params(cfg) -> int:
    from repro_torch.roofline.analysis import param_shapes
    return sum(t.numel() for t in _tensors(param_shapes(cfg)))


def _serve_param_ctx(cfg, ctx):
    """2D (data x model) weight sharding for models whose bf16 weights
    exceed ~4 GiB/device under TP-only (e.g. Jamba-398B)."""
    if ctx.mesh is None:
        return None
    bf16_bytes = 2 * _total_params(cfg)
    if bf16_bytes / max(ctx.model_size, 1) <= 4 * 2**30:
        return None
    from repro_torch.launch.mesh import make_ctx
    return make_ctx(ctx.mesh, fsdp=True)


def _bf16_params(cfg):
    """The seeded params' shapes (fake tensors), floating leaves bf16."""
    from repro_torch.dist import sharding
    from repro_torch.models.transformer import init_params
    return sharding.tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t,
        init_params(cfg, 0, device="cpu"))


def _trace_cell(cfg, shape, ctx, *, tcfg=None, pctx=None, live=None):
    """(arguments' bytes on rank 0, the output's, the temporaries' at the
    peak, the CostBundle, trace seconds) of one step (under the fake
    mode, the world up); ``pctx`` places a serving cell's weights,
    ``live`` is the :class:`LiveBytes` to track them with."""
    from repro_torch.configs.base import (decode_inputs, prefill_batch,
                                          train_batch)
    from repro_torch.dist import sharding
    from repro_torch.roofline.analysis import bundle_from_trace
    from repro_torch.serve.engine import (ServeConfig, cache_specs,
                                          jit_decode_step, jit_prefill,
                                          serve_param_shardings)
    from repro_torch.train.step import (TrainConfig, full_state_shardings,
                                        init_full_state, make_train_step)
    data = ctx.data_size
    if shape.kind == "train":
        tcfg = tcfg or TrainConfig()
        state = init_full_state(cfg, tcfg, 0, device="cpu")
        sh = full_state_shardings(state, ctx, tcfg)
        state = {k: sharding.place_tree(v, sh[k]) for k, v in state.items()}
        batch = _fake(train_batch(cfg, shape.seq_len, shape.global_batch,
                                  specs=True))
        args = (sharding.local_nbytes(state)
                + sharding.local_nbytes(batch) // data)
        fn, call = make_train_step(cfg, tcfg, ctx), (state, batch)
    elif shape.kind == "prefill":
        params = _bf16_params(cfg)
        params = sharding.place_tree(
            params, serve_param_shardings(params, cfg, pctx or ctx))
        batch = _fake(prefill_batch(cfg, shape.seq_len, shape.global_batch,
                                    specs=True))
        args = (sharding.local_nbytes(params)
                + sharding.local_nbytes(batch) // data)
        fn = jit_prefill(cfg, ctx, param_ctx=pctx, device="cpu")
        call = (params, batch)
    else:  # decode
        params = _bf16_params(cfg)
        params = sharding.place_tree(
            params, serve_param_shardings(params, cfg, pctx or ctx))
        cache, token = decode_inputs(cfg, shape.seq_len, shape.global_batch,
                                     specs=True)
        cache, token = _fake(cache), _fake(token)
        scfg = ServeConfig(max_len=shape.seq_len,
                           long_context=shape.name == "long_500k")
        cache = sharding.place_tree(cache, sharding.spec_tree_shardings(
            cache_specs(cfg, ctx, scfg, cache), ctx))
        batch_axes = 1 if scfg.long_context else data
        args = (sharding.local_nbytes(params) + sharding.local_nbytes(cache)
                + sharding.local_nbytes(token) // batch_axes)
        fn = jit_decode_step(cfg, ctx, scfg, param_ctx=pctx, device="cpu")
        call = (params, cache, token)
    held = {id(t) for t in _tensors(call)} | {
        id(t.to_local()) for t in _tensors(call) if sharding.is_dtensor(t)}
    live = live or LiveBytes()
    t0 = time.time()
    with live:
        out, bundle = bundle_from_trace(fn, *call)
    seconds = time.time() - t0
    output = sum(sharding.local_nbytes(t) for t in _tensors(out)
                 if id(t) not in held and not (
                     sharding.is_dtensor(t) and id(t.to_local()) in held))
    temp = max(live.peak - output, 0)
    return args, output, temp, bundle, seconds


def _cell(arch_name: str, shape_name: str, multi_pod: bool,
          cfg_override=None, ctx_override=None) -> tuple:
    """``(cfg, shape, ctx)`` of a cell on the production mesh (the fake
    world up)."""
    from repro_torch.configs.base import get_arch, shape_by_name
    from repro_torch.launch.mesh import make_ctx, make_production_mesh
    cfg = dataclasses.replace(cfg_override or get_arch(arch_name).model,
                              kernel_impl="ref")
    shape = shape_by_name(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    # FSDP for training when the fp32 master copy would not fit TP-only
    # (> 8B params on a 16-way model axis ~ >2 GiB/device just for params)
    fsdp = shape.kind == "train" and _total_params(cfg) > 8e9
    ctx = ctx_override or make_ctx(
        mesh, long_context=shape.name == "long_500k", fsdp=fsdp)
    return cfg, shape, ctx


def rank_tensors(arch_name: str, shape_name: str, threshold: int, *,
                 multi_pod: bool = False, cfg_override=None) -> dict:
    """Rank 0's tensors of one cell's traced step (the fake world already
    up) at or above ``threshold`` bytes, largest first
    (:meth:`LiveBytes.ranking`), with the cell's argument, output and
    temporary bytes; a train cell runs at its ``MB_HINTS`` microbatches
    (1 without a hint)."""
    from repro_torch.train.step import TrainConfig
    cfg, shape, ctx = _cell(arch_name, shape_name, multi_pod, cfg_override)
    tcfg = (TrainConfig(microbatches=MB_HINTS.get(arch_name, 1))
            if shape.kind == "train" else None)
    pctx = _serve_param_ctx(cfg, ctx) if shape.kind != "train" else None
    live = LiveBytes(threshold)
    with _fake_mode():
        args, output, temp, _, _ = _trace_cell(cfg, shape, ctx, tcfg=tcfg,
                                               pctx=pctx, live=live)
    gc.collect()
    return {"arguments": args, "output": output, "temp": temp,
            "ranking": live.ranking()}


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
             cfg_override=None, tcfg=None, probes: bool = True,
             ctx_override=None) -> dict:
    """One cell on the fake world already up (``fake_world(256 or 512)``):
    the artifact's dict."""
    from repro_torch.roofline.analysis import (CostBundle, model_flops,
                                               roofline)
    from repro_torch.train.step import TrainConfig
    cfg, shape, ctx = _cell(arch_name, shape_name, multi_pod, cfg_override,
                            ctx_override)
    chips = 512 if multi_pod else 256

    result = {"arch": arch_name, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
              "status": "ok", "policy": POLICY}
    if cfg.moe is not None:
        result["moe"] = MOE_METHOD
    # adaptive microbatching: escalate until the train step fits HBM
    # (what the production launcher does on real fleets); MB_HINTS record
    # the converged values to skip re-escalation
    if shape.kind == "train" and tcfg is None:
        hint = MB_HINTS.get(arch_name)
        mb_plan = [hint] if hint else [1, 2, 4, 8]
    else:
        mb_plan = [None]
    pctx = _serve_param_ctx(cfg, ctx) if shape.kind != "train" else None
    limit = FIT_FRACTION * hw.DEFAULT_CHIP.hbm_bytes
    for mb in mb_plan:
        if mb is not None:
            tcfg = TrainConfig(microbatches=mb)
        with _fake_mode():
            args, output, temp, full, t_trace = _trace_cell(
                cfg, shape, ctx, tcfg=tcfg, pctx=pctx)
        gc.collect()
        if args + temp + output < limit or mb == mb_plan[-1]:
            result["microbatches"] = mb or (tcfg.microbatches if tcfg
                                            else 1)
            break
    result.update({
        "trace_s": round(t_trace, 1),
        "bytes_per_device": {
            "arguments": args, "output": output, "temp": temp,
            "peak_est": args + output + temp,
        },
        "fits_hbm": args + temp + output < hw.DEFAULT_CHIP.hbm_bytes,
        "raw": {"flops_per_dev": full.flops,
                "bytes_per_dev": full.bytes_accessed,
                "coll_bytes_per_dev": full.coll_bytes,
                "coll_breakdown": full.coll_breakdown},
    })
    corrected = full
    result["corrected"] = {
        "flops_per_dev": corrected.flops,
        "bytes_per_dev": corrected.bytes_accessed,
        "coll_bytes_per_dev": corrected.coll_bytes,
        "coll_breakdown": corrected.coll_breakdown,
        "method": (f"direct: the eager trace runs all {cfg.n_superblocks} "
                   f"superblocks and every microbatch (no scan body is "
                   f"counted once)"),
    }
    if probes:
        # the reference's scan-body probes (1 and 2 superblocks): fixed +
        # NS * body, beside the direct count
        sb = cfg.sb_len
        bundles = []
        for n in (sb, 2 * sb):
            ck = dataclasses.replace(cfg, n_layers=n, scan_layers=False)
            with _fake_mode():
                bundles.append(_trace_cell(ck, shape, ctx, tcfg=tcfg,
                                           pctx=pctx)[3])
            gc.collect()
        body = bundles[1] - bundles[0]
        fixed = bundles[0] - body
        probe = fixed.scaled_add(body, cfg.n_superblocks)
        result["probes"] = {
            "flops_per_dev": probe.flops,
            "bytes_per_dev": probe.bytes_accessed,
            "coll_bytes_per_dev": probe.coll_bytes,
            "method": (f"fixed + {cfg.n_superblocks} * body (1/2-superblock "
                       f"probes)"),
        }
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    mf = model_flops(cfg, tokens=tokens,
                     kind="train" if shape.kind == "train" else "serve")
    terms = roofline(CostBundle(corrected.flops, corrected.bytes_accessed,
                                corrected.coll_bytes,
                                corrected.coll_breakdown),
                     chips=chips, model_flops=mf)
    result["roofline"] = terms.as_dict()
    return result


def save_artifact(result: dict, out_dir: str = ARTIFACT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    name = (f"{result['arch']}__{result['shape']}__"
            f"{result['mesh'].replace('x', '_')}.json")
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return path


def run_cells(cells, *, probes: bool, out: str | None = ARTIFACT_DIR,
              cfg_override=None) -> list:
    """``(arch, shape, multi_pod)`` cells, each mesh's on its own fake
    world; prints one line a cell and returns ``(tag, result or the
    exception)`` pairs.  Probes run on the single-pod mesh only (the
    roofline table is single-pod; multi-pod proves the pod axis)."""
    done = []
    for mp in (False, True):
        mine = [c for c in cells if c[2] == mp]
        if not mine:
            continue
        with fake_world(512 if mp else 256):
            for a, s, _ in mine:
                tag = f"{a} x {s} x {'2x16x16' if mp else '16x16'}"
                t0 = time.time()
                try:
                    res = run_cell(a, s, multi_pod=mp,
                                   probes=probes and not mp,
                                   cfg_override=cfg_override)
                    path = save_artifact(res, out) if out else "-"
                    r = res["roofline"]
                    print(f"[ok]   {tag}: peak/dev="
                          f"{res['bytes_per_device']['peak_est'] / 2**30:.2f}"
                          f"GiB fits={res['fits_hbm']} "
                          f"dominant={r['dominant']} "
                          f"({time.time() - t0:.0f}s) -> {path}", flush=True)
                    done.append((tag, res))
                except Exception as e:  # noqa: BLE001
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                          flush=True)
                    traceback.print_exc()
                    done.append((tag, e))
                gc.collect()
    return done


def main() -> None:
    from repro_torch.configs.base import ARCH_IDS, cells_for
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args()
    # newer torch names all_gather_into_tensor / reduce_scatter_tensor
    # deprecated; the card's torch has only these
    warnings.filterwarnings("ignore", category=FutureWarning)

    cells: list[tuple[str, str, bool]] = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        for mp in meshes:           # single-pod pass first (roofline table)
            for a in ARCH_IDS:
                for s in cells_for(a):
                    cells.append((a, s.name, mp))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))
    if args.skip_existing:
        def done(a, s, mp):
            name = f"{a}__{s}__{'2_16_16' if mp else '16_16'}.json"
            return os.path.exists(os.path.join(args.out, name))
        cells = [c for c in cells if not done(*c)]

    results = run_cells(cells, probes=not args.no_probes, out=args.out)
    failures = sum(isinstance(r, Exception) for _, r in results)
    print(f"done: {len(cells) - failures}/{len(cells)} cells ok", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
