"""Roofline terms from a traced step (port of ``repro``'s
``roofline/analysis.py``; target :data:`repro_torch.hw.DEFAULT_CHIP`, one
H100).

Three terms per (arch x shape x mesh), in seconds per step per device:

    compute    = FLOPs / peak_bf16_flops
    memory     = bytes accessed / hbm_bandwidth
    collective = wire bytes / ici_link_bandwidth   (one NVLink link)

The reference reads XLA's ``cost_analysis()`` and parses collective
bytes out of the compiled HLO text (``bundle_from_compiled``).  The port
has neither; :func:`bundle_from_trace` runs the step eagerly (on fake
tensors, nothing allocated) and counts:

* FLOPs with ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions and attention: 2 per multiply-add, as XLA counts them);
* bytes accessed as the sum of every aten operator's input and output
  bytes (views excepted: they move nothing), from a ``TorchDispatchMode``;
* collective wire bytes from the port's own records
  (``dist.sharding.LOG``): :func:`collective_bytes`.

Costs are per device (each rank's blocks), as the reference's post-SPMD
shapes are.  An eager trace runs every superblock, where XLA's cost
analysis counts a scanned loop body once, so the trace's count needs no
scan-body correction.  Wire factors are the reference's: an all-reduce
counts 2x its bytes (reduce-scatter + all-gather phases), the others 1x.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import hw

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
#: The port's collectives (``dist.sharding``) by the HLO kind the
#: reference's program lowers them to.
_KIND = {"psum": "all-reduce", "pmax": "all-reduce",
         "all_gather": "all-gather", "psum_scatter": "reduce-scatter",
         "all_to_all": "all-to-all", "ppermute": "collective-permute"}


def _dtype_bytes(dtype: str) -> int:
    """Bytes of one element of a dtype as ``str(torch.dtype)`` writes
    it (``"torch.bfloat16"``)."""
    return getattr(torch, dtype.split(".")[-1]).itemsize


def collective_bytes(log) -> dict[str, float]:
    """Wire bytes per collective kind (the reference's names) from the
    port's records: ``log`` is a ``dist.sharding.CollectiveLog`` (its
    ``results``: each collective by its result, as an HLO line names it;
    its ``counts`` record a ``psum_scatter`` by its input, the result's
    group-size multiple) or such a ``results`` counter."""
    results = getattr(log, "results", log)
    out = {k: 0.0 for k in _COLL_OPS}
    for (op, shape, dtype), n in results.items():
        kind = _KIND[op]
        out[kind] += (n * math.prod(shape) * _dtype_bytes(dtype)
                      * _WIRE_FACTOR[kind])
    return out


@dataclasses.dataclass
class CostBundle:
    flops: float            # per device
    bytes_accessed: float   # per device
    coll_bytes: float       # per device wire bytes
    coll_breakdown: dict[str, float]

    def __sub__(self, o: "CostBundle") -> "CostBundle":
        return CostBundle(
            self.flops - o.flops, self.bytes_accessed - o.bytes_accessed,
            self.coll_bytes - o.coll_bytes,
            {k: self.coll_breakdown.get(k, 0) - o.coll_breakdown.get(k, 0)
             for k in set(self.coll_breakdown) | set(o.coll_breakdown)})

    def scaled_add(self, o: "CostBundle", k: float) -> "CostBundle":
        return CostBundle(
            self.flops + k * o.flops,
            self.bytes_accessed + k * o.bytes_accessed,
            self.coll_bytes + k * o.coll_bytes,
            {key: self.coll_breakdown.get(key, 0)
             + k * o.coll_breakdown.get(key, 0)
             for key in set(self.coll_breakdown) | set(o.coll_breakdown)})


def _nbytes(tree) -> int:
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


class _BytesMode(torch.utils._python_dispatch.TorchDispatchMode):
    """Sums every aten operator's input and output bytes.  A view (an
    output aliasing an input) moves nothing and is skipped, as is an
    operator that returns no tensor (a metadata query)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        returns = func._schema.returns
        moved = _nbytes(out)
        if moved and not any(r.alias_info is not None
                             and not r.alias_info.is_write
                             for r in returns):
            self.bytes += _nbytes(args) + _nbytes(kwargs or {}) + moved
        return out


def bundle_from_trace(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), CostBundle)``: the counterpart of the
    reference's ``bundle_from_compiled``.  FLOPs from ``FlopCounterMode``,
    bytes accessed from every aten operator's operands and results, the
    collectives ``fn`` issues from ``dist.sharding.LOG`` (reset first).
    Run it under ``FakeTensorMode`` on fake operands to cost a step
    without allocating it."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import sharding
    sharding.LOG.reset()
    flops = FlopCounterMode(display=False)
    nbytes = _BytesMode()
    with flops, nbytes:
        out = fn(*args, **kwargs)
    colls = collective_bytes(sharding.LOG)
    return out, CostBundle(
        flops=float(flops.get_total_flops()),
        bytes_accessed=float(nbytes.bytes),
        coll_bytes=float(sum(colls.values())), coll_breakdown=colls)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float          # analytic 6ND (train) / 2ND (serve), global
    hlo_flops_global: float     # the traced FLOPs, all devices
    useful_ratio: float         # model_flops / hlo_flops_global

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline(bundle: CostBundle, *, chips: int, model_flops: float,
             chip: hw.ChipSpec = hw.DEFAULT_CHIP) -> RooflineTerms:
    compute = bundle.flops / chip.peak_bf16_flops
    memory = bundle.bytes_accessed / chip.hbm_bandwidth
    coll = bundle.coll_bytes / chip.ici_link_bandwidth
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dominant = max(terms, key=terms.get)
    hlo_global = bundle.flops * chips
    return RooflineTerms(
        compute_s=compute, memory_s=memory, collective_s=coll,
        dominant=dominant, model_flops=model_flops,
        hlo_flops_global=hlo_global,
        useful_ratio=(model_flops / hlo_global) if hlo_global else 0.0)


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (6 N_active D for train, 2 N_active D for serving).
# ---------------------------------------------------------------------------

def param_shapes(cfg) -> dict:
    """The port's ``init_params`` tree for ``cfg`` as fake tensors (shapes
    and dtypes; nothing allocated, at any width)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import init_params
    with FakeTensorMode():
        return init_params(cfg, 0, device="cpu")


def active_param_count(cfg) -> int:
    """Parameters touched per token: MoE experts counted top_k/E; the
    embedding and the head left out (the reference's count)."""
    from repro_torch.dist.sharding import _leaves_with_path
    total = 0
    for path, leaf in _leaves_with_path(param_shapes(cfg)):
        path = "/".join(path)
        n = math.prod(leaf.shape)
        if "/moe/w" in path:   # expert weights: only top_k of n_experts run
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        if path.startswith("embed") or path.startswith("lm_head"):
            continue
        total += n
    return total


def model_flops(cfg, *, tokens: int, kind: str) -> float:
    n = active_param_count(cfg)
    per_token = 6 * n if kind == "train" else 2 * n
    return float(per_token) * tokens
