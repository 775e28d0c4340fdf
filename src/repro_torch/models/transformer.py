"""The transformer: config, parameters, the forward pass and the losses.

Port of ``repro``'s ``models/transformer.py``: :class:`ModelConfig` and
:class:`EncoderSpec` (the same fields), a seeded :func:`init_params` with
the reference's parameter layout, shapes and scales (leaves stacked over
superblocks, ``(NS, ...)``; an encoder config adds ``encoder`` and
``cross``), :func:`param_count`, :func:`cast_params`, the superblock
application (``_attn_apply``, ``_ffn_apply``, ``_position_apply``,
:func:`superblock_apply`, ``_ring_trim``), :func:`forward` in the modes
``train``, ``prefill`` and ``hidden`` (an encoder config dispatches to
models/encdec.py), the losses :func:`label_logprob_terms`,
:func:`chunked_xent` and :func:`loss_fn`, and :func:`params_from_jax`,
which turns the reference's ``init_params`` output (converted through
``np.asarray``) into the port's parameters.  Superblocks run in a Python
loop over the stacked leaves (the reference's ``lax.scan``;
``scan_layers`` gives the same result either way).

Covered: dense GQA / MQA attention, sliding-window:global patterns,
qk-norm, the VLM patch-embedding stub, Mamba blocks (models/ssm.py, the
hybrid jamba stack), xLSTM mLSTM / sLSTM blocks (models/xlstm.py), the
whisper encoder-decoder (models/encdec.py), and per position the
reference's three FFN arms: MoE (``p["moe"]``, models/moe.py; its aux loss
flows out of :func:`forward`), the SwiGLU (``p["ffn"]``) and the GELU MLP
(``p["mlp"]``).  In prefill mode a recurrent position's cache update is
its final state (a NamedTuple of ``(B, ...)`` leaves, stacked over
superblocks like the KV beats).  ``cfg.remat`` maps to
``torch.utils.checkpoint`` (non-reentrant) while gradients are on:
``"full"`` and ``"dots"`` around each superblock (``"dots"``, the
reference's matmul-saving policy, recomputes everything as ``"full"``
does), any remat around each position of a multi-position superblock,
and every :func:`chunked_xent` chunk.  :func:`superblock` gathers
weights placed on a mesh a layer at a time (the sharded decode steps).

Under a ``ShardCtx`` with a mesh, :func:`forward`, :func:`loss_fn` and
:func:`chunked_xent` run one SPMD program on every rank: each rank takes
its block of the batch over the data axes (a ``DTensor`` so placed, or a
plain full batch it slices) and runs the layers on a
``dist.sharding.RankLocal`` context (:func:`rank_ctx`).  The MoE expert
banks are never gathered: each rank keeps its block of experts over the
model axis, and the MoE layer runs expert-parallel (models/moe.py).

Tensor parallelism (a model axis of more than one rank, :func:`tp_on`):
each rank keeps the model-axis blocks the reference's rules placed
(:func:`tp_specs`; gathered over the data axes only, where FSDP splits
them) and computes Megatron's split of each layer: ``wq``
and the FFN's ``wi`` (``wg`` / ``wu``) column-parallel, ``wo`` and
``wkv`` row-parallel (the partial beat summed before its split), the
attention head-parallel on the rank's query heads (with their GQA
groups' KV heads; every head, the query columns gathered, where the
axis does not divide the heads), the embedding on its vocab rows, the
head's logits and the cross entropy vocab-parallel (``lse = m +
log(psum(sum(exp(logits - m))))``, ``m`` the ``pmax`` of the detached
logits, the label's logit a ``psum`` of the one-hot sum; no
whole-vocab gather).  Where the model axis divides the sequence the
residual stream is the rank's block of it between the layers (the
reference's Megatron-SP): a layer enters through
``sharding.gather_seq`` and leaves through ``scatter_seq``; else every
rank holds the whole stream and a layer leaves through ``all_sum``.  A
layer whose weights the rules did not place as its split needs (an odd
count of ``wi`` columns a rank, which would split a (gate, up) pair; an
xLSTM cell) takes them whole and runs on the whole sequence, keeping its
block of the output.  Mamba runs channel-parallel on its ``ed`` blocks
(models/ssm.py), its state the rank's block of the channels.  Whisper's
encoder (head-parallel, the frames sequence-sharded where the axis
divides them, its output gathered once) and decoder (the self-attention
and MLP as above, the cross-attention on its column blocks) run on the
rank's blocks too (models/encdec.py).  Every rank's cotangent is its
share (``dist/sharding.py``): a block's gradient is whole for the block,
a replicated leaf's is partial and the train step sums it over the model
axis (a replicated vector a layer cuts to its block,
``sharding.tp_block``, has a zero gradient outside it), and
:func:`rank_loss` passes each rank its share of the loss
(``sharding.share``).  The loss is the global ``psum(num) /
max(psum(den), 1)`` over the data axes; a rank's gradient is its data
block's share, which ``train/step.py`` sums over the data axes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve as resolve_device
from repro_torch.dist.sharding import meshed
from repro_torch.kernels._common import tree_leaves
from repro_torch.models import attention, layers
from repro_torch.models.moe import MoESpec, init_moe, moe_layer
from repro_torch.models.ssm import (MambaCache, MambaSpec, init_mamba,
                                    mamba_forward)
from repro_torch.models.xlstm import (XLSTMSpec, init_mlstm, init_slstm,
                                      mlstm_forward, slstm_forward)

RECURRENT = ("mamba", "mlstm", "slstm")
#: The dim of each field of a superblock's ``(B, ...)`` recurrent state
#: that a block-wise mixer (:func:`recurrent_blocks`) holds as this
#: rank's block over the model axis: Mamba's channels.
STATE_BLOCK_DIMS = {"mamba": MambaCache(conv=2, h=1)}


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    n_layers: int
    context: int          # encoder sequence length (e.g. whisper 1500 frames)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    block_pattern: tuple = ("attn",)       # kinds per superblock position
    window_pattern: tuple = (None,)        # sliding window per position
    moe_pattern: tuple = (False,)          # MoE FFN per position
    mlp: str = "swiglu"                    # "swiglu" | "mlp" | "none"
    fused_glu: bool = True                 # EARTH interleaved gate/up
    qk_norm: bool = False
    rope_theta: float = 1e4
    moe: MoESpec | None = None
    mamba: MambaSpec | None = None
    xlstm: XLSTMSpec | None = None
    encoder: EncoderSpec | None = None     # whisper
    vlm_patches: int = 0                   # llava stub: # patch embeddings
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "full"
    scan_layers: bool = True
    # EARTH access lowering in-model: an impl string ("ref" | "kernel" |
    # "kernel_dynamic") or a vx.Policy pins it; None defers to
    # vx.Policy.default()
    kernel_impl: Any = None
    step_fusion: bool = True               # whole-step access fusion
    ssm_chunk: int = 128

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sb_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_superblocks(self) -> int:
        assert self.n_layers % self.sb_len == 0, (self.name, self.n_layers,
                                                  self.sb_len)
        return self.n_layers // self.sb_len

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def vx_policy(self):
        """The access policy this model lowers through."""
        from repro_torch import vx
        return vx.resolve(self.kernel_impl)

    def pos_has_ffn(self, i: int) -> bool:
        kind = self.block_pattern[i]
        if kind in ("mlstm", "slstm"):
            return False
        return bool(self.moe_pattern[i]) or (self.mlp != "none"
                                             and self.d_ff > 0)


def check_supported(cfg: ModelConfig) -> None:
    """The port runs stacks of attention, Mamba and xLSTM blocks with any
    of the reference's FFN arms (SwiGLU, GELU MLP, MoE), and the whisper
    encoder-decoder; any other block kind is refused."""
    other = [k for k in cfg.block_pattern if k not in ("attn",) + RECURRENT]
    if other:
        raise ValueError(other[0])


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_pos(cfg: ModelConfig, i: int, g: torch.Generator, device) -> dict:
    kind = cfg.block_pattern[i]
    dt = cfg.pdtype
    d = cfg.d_model
    p: dict[str, Any] = {"ln1": torch.ones((d,), dtype=dt, device=device)}
    if kind == "attn":
        p["attn"] = attention.init_attention(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, g, qk_norm=cfg.qk_norm,
            dtype=dt, device=device)
    elif kind == "mamba":
        p["mamba"] = init_mamba(cfg.mamba, g, dt, device)
        # in_proj as (d, 2, ed): the reference's (x|z) sharding layout
        p["mamba"]["in_proj"] = p["mamba"]["in_proj"].reshape(
            d, 2, cfg.mamba.ed)
    elif kind == "mlstm":
        p["xl"] = init_mlstm(cfg.xlstm, g, dt, device)
        p["xl"]["up"] = p["xl"]["up"].reshape(d, 2, cfg.xlstm.m_inner)
    elif kind == "slstm":
        p["slstm"] = init_slstm(cfg.xlstm, g, dt, device)
    else:
        raise ValueError(kind)
    if cfg.pos_has_ffn(i):
        p["ln2"] = torch.ones((d,), dtype=dt, device=device)
        if cfg.moe_pattern[i]:
            p["moe"] = init_moe(d, cfg.moe, g, dt, device)
        elif cfg.mlp == "swiglu":
            p["ffn"] = layers.init_glu(d, cfg.d_ff, g, fused=cfg.fused_glu,
                                       dtype=dt, device=device)
        else:
            p["mlp"] = layers.init_mlp(d, cfg.d_ff, g, dt, device)
    return p


def _stack(trees: list):
    """Stack a list of like trees (dicts and NamedTuples of tensors) leaf
    by leaf on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(_stack(list(xs)) for xs in zip(*trees)))
    return torch.stack(trees)


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None) -> dict:
    """Seeded parameters with the reference's layout, shapes and scales
    (``embed * d**-0.5``, projections ``N(0,1) * fan_in**-0.5``, norms at
    one).  ``generator`` is a ``torch.Generator`` or an int seed (a
    generator on ``device`` is then made from it).  The draws differ from
    ``jax.random``'s; tests carry the reference's own weights through
    :func:`params_from_jax`."""
    check_supported(cfg)
    device = resolve_device(device)
    if isinstance(generator, int):
        seed = generator
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    dt = cfg.pdtype
    params: dict[str, Any] = {
        "embed": layers.normal((cfg.vocab, cfg.d_model),
                               cfg.d_model ** -0.5, generator, dt, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.normal((cfg.vocab, cfg.d_model),
                                          cfg.d_model ** -0.5, generator,
                                          dt, device)
    sbs = [{f"pos{i}": _init_pos(cfg, i, generator, device)
            for i in range(cfg.sb_len)} for _ in range(cfg.n_superblocks)]
    params["blocks"] = _stack(sbs)
    if cfg.encoder is not None:
        from repro_torch.models import encdec
        params["encoder"] = encdec.init_encoder(cfg, generator, device)
        params["cross"] = encdec.init_cross_stack(cfg, generator, device)
    return params


def _to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(np_tree, cfg: ModelConfig, device=None) -> dict:
    """The reference's ``init_params`` pytree (leaves converted with
    ``np.asarray``) as the port's parameters: the same nested dict, leaf
    for leaf."""
    check_supported(cfg)
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _to_torch(t, device)

    return conv(np_tree)


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def tree_map(fn, tree, *rest):
    """``jax.tree.map`` over dicts and NamedTuples of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def superblock(params_blocks: dict, sbi: int, ctx=None) -> dict:
    """Superblock ``sbi``'s parameters: views into the stacked leaves.
    Leaves placed on a mesh (``DTensor`` s, the sharded serve step's
    weights) are gathered here, a superblock at a time, when it runs:
    under a tensor-parallel ``RankLocal`` (``ctx.tp``) the leaves its
    layers take as blocks (the expert banks among them) stay this rank's
    model-axis blocks (:func:`tp_specs`), every other leaf whole."""
    from repro_torch.dist import sharding
    sb = tree_map(lambda a: sharding.select(a, sbi), params_blocks)
    tp = getattr(ctx, "tp", None)
    if tp is not None:
        local, specs = sharding.split_tree(sb)
        return sharding.gather_tree(local, tp_specs(local, specs,
                                                    tp.model_axis), tp.mesh)
    return sharding.full_tree(sb)


def _model_dim(x, spec, axis):
    from repro_torch.dist import sharding
    for d, e in enumerate(sharding._norm(spec, x.ndim)):
        if axis in sharding._names(e):
            return d
    return None


def tp_specs(tree, specs, axis: str):
    """``specs`` (each leaf's :class:`P`) with ``axis`` taken off the
    leaves the tensor-parallel layers take as this rank's blocks, so that
    gathered by them those leaves keep their model-axis block (and are
    gathered over the data axes only) and every other leaf comes whole.
    A layer takes its weights as blocks where the parameter rules placed
    them as its split needs, else all of them whole:

    * attention: ``wq`` on its columns, ``wo`` on its rows, ``wkv`` on
      its rows or unsplit;
    * the SwiGLU: ``wi`` on its columns with an even count of them (whole
      (gate, up) pairs of the interleaved beat) or ``wg`` / ``wu`` on
      theirs, ``wo`` on its rows; the GELU MLP: ``wi`` columns, ``wo``
      rows;
    * MoE: the banks on their expert dim, the router on its rows;
    * Mamba: ``in_proj``, ``conv_w``, ``dt_proj`` and ``A_log`` on
      ``ed``, ``x_proj`` and ``out_proj`` on their ``ed`` rows
      (channel-parallel; models/ssm.py);
    * whisper's cross-attention ``xattn``: ``wq`` on its columns,
      ``wkv`` on its columns, rows or unsplit, ``wo`` on its columns or
      rows, and its norm gain ``ln`` on its features (the rules read the
      stacked cross tree as unstacked);
    * the embedding and the untied head on their vocab rows.

    The xLSTM cells keep their weights whole.  The sLSTM's rules put
    ``r`` on its gate columns, which split each head's four gates across
    ranks, and its FFN's (gate, up) halves on column blocks that do not
    pair.  The mLSTM could run head-parallel on its blocks, but its
    row-parallel ``wi`` / ``wf`` / ``down`` sums change its output by an
    ulp, which xlstm amplifies (a one-ulp change moves xlstm-smoke's
    gradients by 1.8e-4 of their largest entries), and the mesh loss is
    held within 1e-5 of the one-process port's.  ``tree`` holds one
    superblock's leaves (no stacked dim) or the top-level leaves."""
    from repro_torch.dist import sharding
    pairs = {"/".join(p): xs for (p, _), xs in zip(
        sharding._leaves_with_path(tree), sharding._zip_leaves(tree, specs))}

    def md(path):
        return _model_dim(*pairs[path], axis) if path in pairs else None

    keep = set()
    for path in pairs:
        head, _, leaf = path.rpartition("/")
        pre = head + "/" if head else ""
        kind = head.rpartition("/")[2]
        if kind == "xattn" and leaf == "wq":
            # the reference's rules read the stacked cross tree as
            # unstacked: wq on its columns, wkv and wo on their columns
            # or rows, the norm gain on its features
            if md(path) == 1 and md(pre + "wkv") in (0, 1, None) and \
                    md(pre + "wo") in (0, 1):
                keep |= {path, pre + "wo"} | (
                    {pre + "wkv"} if md(pre + "wkv") is not None else set())
                ln = head.rpartition("/")[0]
                ln = (ln + "/" if ln else "") + "ln"
                if md(ln) == 0:
                    keep.add(ln)
        elif kind == "attn" and leaf == "wq":
            if md(path) == 1 and md(pre + "wo") == 0 and \
                    md(pre + "wkv") in (0, None):
                keep |= {path, pre + "wo"} | (
                    {pre + "wkv"} if md(pre + "wkv") == 0 else set())
        elif kind in ("ffn", "mlp") and leaf == "wo" and md(path) == 0:
            cols = [pre + k for k in ("wi", "wg", "wu") if pre + k in pairs]
            fused = kind == "ffn" and cols == [pre + "wi"]
            if cols and all(md(c) == 1 for c in cols) and not (
                    fused and pairs[cols[0]][0].shape[1] % 2):
                keep |= {path, *cols}
        elif kind == "moe" and md(path) == 0 and (
                leaf == "router" or sharding.is_expert_bank(path,
                                                            pairs[path][0]
                                                            .ndim)):
            keep.add(path)
        elif kind == "mamba" and leaf == "out_proj":
            want = {"in_proj": 2, "conv_w": 1, "x_proj": 0, "dt_proj": 1,
                    "A_log": 0, "out_proj": 0}
            if all(md(pre + k) == d for k, d in want.items()):
                keep |= {pre + k for k in want}
        elif not head and leaf in ("embed", "lm_head") and md(path) == 0:
            keep.add(path)

    def one(path, leaf):
        spec = pairs[path][1]
        if path not in keep:
            return spec
        rest = [tuple(a for a in sharding._names(e) if a != axis)
                for e in sharding._norm(spec, leaf.ndim)]
        return sharding.P(*[r if r else None for r in rest])

    return sharding.tree_paths(tree, one)


def tp_on(cfg, ctx) -> bool:
    """Whether the mesh forward and the sharded decode steps run
    tensor-parallel under ``ctx``: a model axis of more than one rank
    (every family; whisper's decode step takes its weights whole,
    models/encdec.py)."""
    from repro_torch.dist.sharding import meshed
    return meshed(ctx) and ctx.model_size > 1


def rank_ctx(ctx, cfg, seq_len: int):
    """The ``RankLocal`` the mesh forward and the sharded decode steps hand
    their layers: ``experts`` always the mesh's context; under tensor
    parallelism (:func:`tp_on`) ``tp`` too, and ``seq`` where the model
    axis divides the sequence (the residual stream then sequence-sharded
    between the layers, Megatron-SP)."""
    from repro_torch.dist.sharding import RankLocal
    if not tp_on(cfg, ctx):
        return RankLocal(mesh=None, experts=ctx)
    m = ctx.model_size
    return RankLocal(mesh=None, experts=ctx, tp=ctx,
                     seq=seq_len % m == 0 and seq_len >= m)


# ---------------------------------------------------------------------------
# Mixed precision and the FFN block
# ---------------------------------------------------------------------------

def cast_params(params, cfg: ModelConfig, ctx=None):
    """Compute in ``cfg.compute_dtype``: floating leaves are cast (router
    weights excepted, as in the reference).  Leaves already in the compute
    dtype are returned as they are, so a caller may cast once up front."""
    if cfg.cdtype == cfg.pdtype:
        return params

    from repro_torch.dist import sharding

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        if t.is_floating_point() and t.dtype != cfg.cdtype \
                and not path.endswith("router"):
            # a DTensor leaf casts its block
            return sharding.map_local(lambda a: a.to(cfg.cdtype), t)
        return t

    return walk(params, "")


def _tp(ctx):
    return getattr(ctx, "tp", None) is not None


def _ffn_apply(p, x, cfg: ModelConfig, ctx, i: int, *, policy=None):
    """``policy`` overrides cfg.vx_policy for the GLU field split (the step
    scheduler keeps single-token splits on the plain path).  Under a
    tensor-parallel ``RankLocal`` the FFN runs on the whole sequence
    (``sharding.tp_enter``): on its blocks of ``wi`` (or ``wg`` / ``wu``)
    columns and ``wo`` rows it computes a partial sum, which leaves
    through ``sharding.tp_leave``; on whole weights the whole output,
    of which it keeps its block."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not cfg.pos_has_ffn(i):
        return x, aux
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe_pattern[i]:
        y, aux = moe_layer(p["moe"], h, cfg.moe, ctx)
        return x + y, aux
    w = p["ffn"] if cfg.mlp == "swiglu" else p["mlp"]
    partial = _tp(ctx) and w["wo"].shape[0] != cfg.d_ff
    # a single position's part of the sum (the decode steps) in float32:
    # the sum then rounds once, as the one-device product does
    od = torch.float32 if partial and h.shape[1] == 1 else None
    if _tp(ctx):
        from repro_torch.dist.sharding import tp_enter, tp_leave
        h = tp_enter(h, ctx)
    if cfg.mlp == "swiglu":
        y = layers.glu_ffn(w, h, fused=cfg.fused_glu,
                           policy=policy if policy is not None
                           else cfg.vx_policy, out_dtype=od)
    else:
        y = layers.mlp_ffn(w, h, out_dtype=od)
    if _tp(ctx):
        y = tp_leave(y, ctx, partial=partial).to(x.dtype)
    return x + y, aux


# ---------------------------------------------------------------------------
# Superblock application and the forward pass
# ---------------------------------------------------------------------------

def _attn_apply(p, x, cfg: ModelConfig, ctx, i: int, positions,
                mode: str, cross_kv=None):
    """Returns (x, kv_beat or None).  ``cross_kv`` (k, v) adds
    cross-attention through ``p["cross"]`` after ``p["ln_cross"]``, as the
    reference's arm does (whisper's decoder runs models/encdec.py's own
    layer)."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if _tp(ctx):
        return _tp_attn(p, h, x, cfg, ctx, i, positions, mode)
    q, k, v, kv = attention.qkv_project(
        p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd, positions,
        cfg.rope_theta, policy=cfg.vx_policy)
    B, S = x.shape[:2]
    out = attention.flash_attention(q, k, v, causal=True,
                                    window=cfg.window_pattern[i],
                                    q_chunk=min(512, S),
                                    kv_chunk=min(512, S), ctx=ctx)
    x = x + out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
    if cross_kv is not None:
        ck, cv = cross_kv
        x = x + attention.cross_attention(p["cross"], layers.rms_norm(
            x, p["ln_cross"], cfg.norm_eps), ck, cv, cfg.n_heads,
            cfg.n_kv_heads, cfg.hd, ctx=ctx)
    return x, (kv if mode == "prefill" else None)


def _tp_attn(p, h, x, cfg: ModelConfig, rl, i: int, positions, mode: str):
    """:func:`_attn_apply` under a tensor-parallel ``RankLocal``: the
    whole sequence of ``h`` attended on this rank's heads
    (``attention.qkv_project_tp`` on its ``wq`` columns and ``wkv``
    rows), its ``wo`` rows a partial sum leaving through
    ``sharding.tp_leave``; on whole weights every head, of whose output
    the rank keeps its block.  A prefill's beats come back with every KV
    head."""
    from repro_torch.dist import sharding
    a = p["attn"]
    h = sharding.tp_enter(h, rl)
    B, S = h.shape[:2]
    block = a["wo"].shape[0] != cfg.n_heads * cfg.hd
    if block:
        q, k, v, kv = attention.qkv_project_tp(
            a, h, cfg.n_heads, cfg.n_kv_heads, cfg.hd, positions,
            cfg.rope_theta, rl, policy=cfg.vx_policy)
    else:
        q, k, v, kv = attention.qkv_project(
            a, h, cfg.n_heads, cfg.n_kv_heads, cfg.hd, positions,
            cfg.rope_theta, policy=cfg.vx_policy)
    out = attention.flash_attention(q, k, v, causal=True,
                                    window=cfg.window_pattern[i],
                                    q_chunk=min(512, S),
                                    kv_chunk=min(512, S))
    o = out.reshape(B, S, -1)
    if block:
        o = attention.tp_rows(o, a["wo"], rl)
    x = x + sharding.tp_leave(o @ a["wo"], rl, partial=block)
    if mode != "prefill":
        return x, None
    if kv.shape[2] != cfg.n_kv_heads:
        kv = sharding.all_gather(kv, rl.tp.mesh, rl.tp_axis, 2)
    return x, kv


def superblock_apply(sb_p, x, cfg: ModelConfig, ctx, positions, *,
                     mode: str = "train"):
    """Apply one superblock.  Returns (x, aux, cache_updates).  With
    gradients on, each position of a multi-position superblock runs under
    its own checkpoint unless ``cfg.remat == "none"``: only one position's
    residuals are live in its backward."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    updates = {}
    remat = (cfg.remat != "none" and cfg.sb_len > 1
             and torch.is_grad_enabled())
    for i, kind in enumerate(cfg.block_pattern):
        kw = dict(cfg=cfg, ctx=ctx, i=i, kind=kind, mode=mode)
        if remat:
            x, aux, upd = checkpoint(_position_apply, sb_p[f"pos{i}"], x,
                                     positions, use_reentrant=False, **kw)
        else:
            x, aux, upd = _position_apply(sb_p[f"pos{i}"], x, positions,
                                          **kw)
        aux_total = aux_total + aux
        if upd is not None:
            updates[f"pos{i}"] = upd
    return x, aux_total, updates


def _mixer_params(p, cfg: ModelConfig, kind: str) -> dict:
    """A recurrent position's block parameters with the fused input
    projection back in its ``(d, 2 * inner)`` matmul shape (a rank's
    Mamba block ``(d, 2, ed / m)`` as ``(d, 2 * ed / m)``: its x and z
    channels side by side)."""
    if kind == "mamba":
        pm = dict(p["mamba"])
        pm["in_proj"] = pm["in_proj"].reshape(cfg.d_model, -1)
        return pm
    if kind == "mlstm":
        px = dict(p["xl"])
        px["up"] = px["up"].reshape(cfg.d_model, 2 * cfg.xlstm.m_inner)
        return px
    return p["slstm"]


def recurrent_blocks(p, cfg: ModelConfig, kind: str) -> bool:
    """Whether a recurrent position's weights are this rank's model-axis
    blocks (:func:`tp_specs` kept them): Mamba channel-parallel; the
    xLSTM cells never."""
    return kind == "mamba" and \
        p["mamba"]["out_proj"].shape[0] != cfg.mamba.ed


def _recurrent_forward(p, h, cfg: ModelConfig, kind: str, tp=None):
    """(y, final state) of a recurrent block over ``h`` (B, S, d); with
    ``tp`` (Mamba's weights this rank's blocks) the rank's partial ``y``
    and its block of the state."""
    pm = _mixer_params(p, cfg, kind)
    if kind == "mamba":
        return mamba_forward(pm, h, cfg.mamba, chunk=cfg.ssm_chunk, tp=tp)
    if kind == "mlstm":
        return mlstm_forward(pm, h, cfg.xlstm)
    return slstm_forward(pm, h, cfg.xlstm)


def _position_apply(p, x, positions, *, cfg: ModelConfig, ctx, i: int,
                    kind: str, mode: str):
    """One (mixer + FFN) position of a superblock."""
    if kind == "attn":
        x, kv = _attn_apply(p, x, cfg, ctx, i, positions, mode)
        update = _ring_trim(kv, cfg.window_pattern[i]) if mode == "prefill" \
            else None
    elif kind in RECURRENT:
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        if _tp(ctx):
            # the whole sequence through the rank's blocks (a partial
            # sum), or through whole weights (the rank keeps its block
            # of the output)
            from repro_torch.dist.sharding import tp_enter, tp_leave
            block = recurrent_blocks(p, cfg, kind)
            y, state = _recurrent_forward(p, tp_enter(h, ctx), cfg, kind,
                                          ctx if block else None)
            y = tp_leave(y, ctx, partial=block)
        else:
            y, state = _recurrent_forward(p, h, cfg, kind)
        x = x + y
        update = state if mode == "prefill" else None
    else:
        raise ValueError(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.pos_has_ffn(i):
        x, aux = _ffn_apply(p, x, cfg, ctx, i)
    return x, aux, update


def _ring_trim(kv: torch.Tensor, window: int | None) -> torch.Tensor:
    """Prefill cache beat tensor; windowed layers keep a ring of size W."""
    S = kv.shape[1]
    if window is None or S <= window:
        return kv
    return torch.roll(kv[:, -window:], shifts=S % window, dims=1)


def _embed_inputs(params, batch, cfg: ModelConfig, ctx) -> torch.Tensor:
    """The embedded tokens (and the VLM stub's patches).  Under a
    tensor-parallel ``RankLocal`` the residual stream's block: from this
    rank's vocab rows of the table a partial sum (each token's row on
    the rank that holds it, zeros elsewhere) leaving through
    ``sharding.tp_leave``, or the whole lookup cut to the block."""
    table = params["embed"]
    block = _tp(ctx) and table.shape[0] != cfg.vocab
    if block:
        x = layers.embed_block(batch["tokens"], table,
                               ctx.tp_index * table.shape[0])
    else:
        x = layers.embed(batch["tokens"], table)
    x = x.to(cfg.cdtype)
    if cfg.vlm_patches and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(cfg.cdtype)
        x = x.clone()
        # a partial sum: the patches counted on one rank
        x[:, :pe.shape[1]] = pe if not block or ctx.tp_index == 0 else 0
    if _tp(ctx):
        from repro_torch.dist.sharding import tp_leave
        x = tp_leave(x, ctx, partial=block)
    return x


def forward(params, batch, cfg: ModelConfig, ctx=None, *,
            mode: str = "train"):
    """batch: {"tokens": (B,S) int, optional "patch_embeds"; an encoder
    config also "audio_frames" (B, F, d)}.

    Returns (logits (B,S,V), aux, cache_states).  ``mode="prefill"``
    returns only the last position's logits (B,1,V) and the cache states
    ``{"pos{i}": (NS, B, S or W, K, 2D)}`` of the attention positions and
    the final states of the recurrent ones, stacked over superblocks
    (whisper: ``{"pos0", "enc_out"}``); ``mode="hidden"`` returns the
    final-normed hidden states in place of logits.  Differentiable: the
    flash attention carries the reference's backward.

    Under a mesh every output is placed on the batch over the data axes
    (a ``DTensor``: this rank's block; the cache states' batch is their
    dim 1), and ``aux`` is the mean over the data axes of each block's
    aux (the reference's per-data-shard estimate)."""
    check_supported(cfg)
    if mode not in ("train", "prefill", "hidden"):
        raise ValueError(f"unknown mode {mode!r}")
    if meshed(ctx):
        from repro_torch.dist import sharding
        local, specs = sharding.split_tree(params)
        out, aux, states, _, _ = _rank_forward(local, specs, batch, cfg,
                                               ctx, mode)
        return (_place_batch(out, ctx, 0), aux,
                _place_states(states, cfg, ctx))
    params = cast_params(params, cfg)
    if cfg.encoder is not None:
        from repro_torch.models import encdec
        return encdec.forward(params, batch, cfg, ctx, mode=mode)
    x = _embed_inputs(params, batch, cfg, ctx)
    B, S = batch["tokens"].shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat in ("full", "dots") and torch.is_grad_enabled()
    states = []
    for sbi in range(cfg.n_superblocks):
        sb_p = superblock(params["blocks"], sbi)
        if remat:
            x, aux_d, upd = checkpoint(superblock_apply, sb_p, x, cfg, ctx,
                                       positions, mode=mode,
                                       use_reentrant=False)
        else:
            x, aux_d, upd = superblock_apply(sb_p, x, cfg, ctx, positions,
                                             mode=mode)
        aux = aux + aux_d
        states.append(upd)
    cache_states = _stack(states) if mode == "prefill" else {}
    if mode == "prefill":
        x = x[:, -1:]      # serving prefill only needs next-token logits
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "hidden":
        return x, aux, cache_states
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = layers.unembed(x, head.to(cfg.cdtype))
    return logits, aux, cache_states


# ---------------------------------------------------------------------------
# The mesh forward: one SPMD program, each rank on its batch block
# ---------------------------------------------------------------------------

def _batch_block(x, ctx):
    """This rank's block of a batch operand over the data axes (a
    ``DTensor`` so placed, or a plain full tensor it slices)."""
    from repro_torch.dist import sharding
    return sharding.local_block(x, ctx.mesh, ctx.batch_spec())


def _place_batch(x, ctx, dim: int):
    """A rank's block of an output placed on its batch (dim ``dim``) over
    the data axes."""
    from repro_torch.dist import sharding
    spec = sharding.P(*([None] * dim), *ctx.batch_spec())
    return sharding.from_local(x, ctx.mesh, spec)


def _rank_superblock(sb_local, x, *, specs, ctx, rl, cfg, positions, mode):
    """Gather a superblock's weights by ``specs`` (under tensor
    parallelism :func:`tp_specs`: the layers' blocks kept) and apply
    them (run inside the superblock's checkpoint: the backward gathers
    them again)."""
    from repro_torch.dist import sharding
    sb_p = sharding.gather_tree(sb_local, specs, ctx.mesh,
                                reduce=_reduce_axes(ctx, rl))
    return superblock_apply(sb_p, x, cfg, rl, positions, mode=mode)


def _reduce_axes(ctx, rl) -> tuple:
    """The axes over which a rank's cotangent of a gathered weight is a
    partial: the data axes; under tensor parallelism the model axis too
    (each rank's cotangent is its share)."""
    return ctx.data_axes + ((ctx.model_axis,) if rl.tp is not None else ())


def _rank_forward(local, specs, batch, cfg: ModelConfig, ctx, mode: str):
    """:func:`forward` on this rank: ``local`` holds the rank's blocks of
    the params (``specs`` their placement), ``batch`` the global batch or
    its placed blocks.  Returns the rank's (logits or hidden, aux over
    the data axes, cache states, the gathered top-level weights, its
    ``RankLocal``) as plain tensors; the logits and hidden states whole
    (every position, every vocab entry)."""
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P
    mesh, reduce = ctx.mesh, ctx.data_axes
    batch = {k: _batch_block(v, ctx) for k, v in batch.items()}
    local = cast_params(local, cfg)
    B, S = batch["tokens"].shape
    rl = rank_ctx(ctx, cfg, S)
    if cfg.encoder is not None:
        from repro_torch.models import encdec
        if rl.tp is not None:
            specs = _encdec_tp_specs(local, specs, ctx)
        whole = sharding.gather_tree(local, specs, mesh,
                                     reduce=_reduce_axes(ctx, rl))
        return encdec.forward(whole, batch, cfg, rl, mode=mode) + (whole,
                                                                    rl)
    top = {k: local[k] for k in local if k != "blocks"}
    top_specs = {k: specs[k] for k in top}
    if rl.tp is not None:
        top_specs = tp_specs(top, top_specs, ctx.model_axis)
    whole = sharding.gather_tree(top, top_specs, mesh,
                                 reduce=_reduce_axes(ctx, rl))
    x = _embed_inputs(whole, batch, cfg, rl)
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat in ("full", "dots") and torch.is_grad_enabled()
    sb_specs = sharding.tree_map(lambda a, sp: P(*sp[1:]), local["blocks"],
                                 specs["blocks"])
    if rl.tp is not None:
        sb_specs = tp_specs(tree_map(lambda a: a[0], local["blocks"]),
                            sb_specs, ctx.model_axis)
    fn = functools.partial(_rank_superblock, specs=sb_specs, ctx=ctx, rl=rl,
                           cfg=cfg, positions=positions, mode=mode)
    states = []
    for sbi in range(cfg.n_superblocks):
        sb_local = tree_map(lambda a: a[sbi], local["blocks"])
        if remat:
            x, aux_d, upd = checkpoint(fn, sb_local, x, use_reentrant=False)
        else:
            x, aux_d, upd = fn(sb_local, x)
        aux = aux + aux_d
        states.append(upd)
    if any(cfg.moe_pattern) and reduce:
        aux = sharding.global_sum(aux, mesh, reduce) / ctx.data_size
    cache_states = _stack(states) if mode == "prefill" else {}
    if mode == "prefill":
        x = sharding.tp_enter(x, rl)[:, -1:]
        x = layers.rms_norm(x, whole["final_norm"], cfg.norm_eps)
    else:
        x = sharding.tp_enter(layers.rms_norm(x, whole["final_norm"],
                                              cfg.norm_eps), rl)
    if mode == "hidden":
        return x, aux, cache_states, whole, rl
    head = whole["embed"] if cfg.tie_embeddings else whole["lm_head"]
    logits = layers.unembed(x, head.to(cfg.cdtype))
    if head.shape[0] != cfg.vocab:              # this rank's vocab block
        logits = sharding.gather_seq(logits, mesh, ctx.model_axis, -1)
    return logits, aux, cache_states, whole, rl


def _stacked_tp_specs(local, specs, ctx):
    """:func:`tp_specs` of a subtree stacked over its leading dim (the
    superblocks, the encoder's layers, the cross stack), read a layer at
    a time; a leaf no layer keeps keeps its spec."""
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P
    per = sharding.tree_map(lambda a, sp: P(*sp[1:]), local, specs)
    one = tp_specs(tree_map(lambda a: a[0], local), per, ctx.model_axis)
    return sharding.tree_map(
        lambda a, sp, p1, p2: sp if p1 == p2 else P(None, *p2), local,
        specs, per, one)


def _encdec_tp_specs(local, specs, ctx):
    """The encoder-decoder's specs with the tensor-parallel layers'
    blocks kept (:func:`tp_specs`): the embedding's vocab rows, and in
    the encoder's layers, the decoder's and its cross-attention the
    attention's and the MLP's blocks."""
    top = [k for k in ("embed", "final_norm", "lm_head") if k in local]
    out = dict(specs)
    out.update(tp_specs({k: local[k] for k in top},
                        {k: specs[k] for k in top}, ctx.model_axis))
    for k in ("blocks", "cross"):
        out[k] = _stacked_tp_specs(local[k], specs[k], ctx)
    out["encoder"] = dict(specs["encoder"], blocks=_stacked_tp_specs(
        local["encoder"]["blocks"], specs["encoder"]["blocks"], ctx))
    return out


def _place_states(states: dict, cfg: ModelConfig, ctx) -> dict:
    """A mesh prefill's cache states placed: on their batch over the data
    axes (dim 1 of a stacked ``(NS, B, ...)`` leaf, dim 0 of
    ``enc_out``), and a recurrent state a block-wise mixer returned
    (this rank's block of Mamba's channels) also on that dim over the
    model axis: the recurrent states as the decode step keeps them
    (``serve/engine.step_specs``)."""
    from repro_torch.dist import sharding
    out = {}
    for key, v in states.items():
        if key == "enc_out":
            out[key] = _place_batch(v, ctx, 0)
            continue
        kind = cfg.block_pattern[int(key[3:])]
        dims = STATE_BLOCK_DIMS.get(kind)
        if dims is None or v[0].shape[dims[0] + 1] == cfg.mamba.ed:
            out[key] = sharding.tree_map(lambda a: _place_batch(a, ctx, 1),
                                         v)
            continue

        def one(a, d):
            parts = [None, *ctx.batch_spec()] + [None] * (a.ndim - 2)
            parts[d + 1] = ctx.model_axis
            return sharding.from_local(a, ctx.mesh, sharding.P(*parts))

        out[key] = type(v)(*(one(a, d) for a, d in zip(v, dims)))
    return out


def _whole(t, ctx):
    """A weight whole under a mesh: a ``DTensor`` gathered
    (differentiable), a plain tensor as it is."""
    from repro_torch.dist import sharding
    if not sharding.is_dtensor(t):
        return t
    return sharding.gather_tree(t.to_local(), sharding.spec_of(t), ctx.mesh,
                                reduce=ctx.data_axes)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def label_logprob_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(lse, ll) in float32, the label's logit taken by a one-hot
    reduction over the vocab axis (no gather), as the reference does."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    onehot = labels[..., None] == torch.arange(
        logits.shape[-1], dtype=labels.dtype, device=logits.device)
    ll = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    return lse, ll


def _xent_chunk(x, head, labels, w, rl=None):
    """A chunk's sums; with ``rl`` ``head`` is this rank's vocab block."""
    logits = layers.unembed(x, head)
    lse, ll = (label_logprob_terms(logits, labels) if rl is None
               else _vocab_parallel_terms(logits, labels, rl))
    return torch.sum((lse - ll) * w), torch.sum(w)


def _vocab_parallel_terms(logits: torch.Tensor, labels: torch.Tensor, rl):
    """:func:`label_logprob_terms` on this rank's vocab block of the
    logits (rows ``[i n, (i + 1) n)`` of the vocab): ``lse = m + log(
    psum(sum(exp(logits - m))))`` with ``m`` the ``pmax`` of the detached
    logits, ``ll`` the ``psum`` of the one-hot sum over the block; each in
    float32, no whole-vocab gather."""
    from repro_torch.dist import sharding
    mesh, axis = rl.tp.mesh, rl.tp_axis
    logits = logits.float()
    n = logits.shape[-1]
    m = sharding.pmax(torch.amax(logits.detach(), dim=-1), mesh, axis)
    s = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    lse = m + torch.log(sharding.all_sum(s, mesh, axis))
    onehot = (labels - rl.tp_index * n)[..., None] == torch.arange(
        n, dtype=labels.dtype, device=logits.device)
    ll = sharding.all_sum(torch.sum(torch.where(onehot, logits, 0.0),
                                    dim=-1), mesh, axis)
    return lse, ll


def chunked_xent(x, head, labels, w, ctx=None, *,
                 chunk: int = 512) -> torch.Tensor:
    """Head matmul + weighted cross entropy over sequence chunks: only one
    chunk's ``(B, chunk, V)`` logits are alive at a time, each chunk under
    a checkpoint while gradients are on (recomputed in the backward).  The
    chunk falls back to ``S`` when it does not divide ``S`` or covers it.
    Returns ``sum(w * (lse - ll)) / max(sum(w), 1)``.

    Under a mesh ``x``, ``labels`` and ``w`` are the batch (placed on it
    over the data axes, or whole: each rank takes its block), ``head``
    whole or a ``DTensor`` (gathered), and the sums run over the whole
    batch: ``psum(num) / max(psum(den), 1)`` over the data axes, the same
    number on every rank (not a mean of the blocks' losses)."""
    if meshed(ctx):
        return _global_xent(_batch_block(x, ctx), _whole(head, ctx),
                            _batch_block(labels, ctx), _batch_block(w, ctx),
                            ctx, chunk)
    num, den = _xent_terms(x, head, labels, w, chunk)
    return num / torch.clamp(den, min=1.0)


def _global_xent(x, head, labels, w, ctx, chunk: int = 512, rl=None):
    """The rank's blocks' sums, added over the data axes: every rank
    returns the whole batch's loss.  With ``rl`` ``head`` is this rank's
    vocab block (:func:`_vocab_parallel_terms`)."""
    from repro_torch.dist import sharding
    num, den = _xent_terms(x, head, labels, w, chunk, rl)
    num = sharding.global_sum(num, ctx.mesh, ctx.data_axes)
    den = sharding.psum(den.detach(), ctx.mesh, ctx.data_axes)
    return num / torch.clamp(den, min=1.0)


def _xent_terms(x, head, labels, w, chunk: int, rl=None):
    """``(sum(w * (lse - ll)), sum(w))`` over the chunks of
    :func:`chunked_xent`."""
    S = x.shape[1]
    if S % chunk or S <= chunk:
        chunk = S
    remat = torch.is_grad_enabled()
    num = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, S, chunk):
        args = (x[:, lo:lo + chunk], head, labels[:, lo:lo + chunk],
                w[:, lo:lo + chunk], rl)
        n, d = (checkpoint(_xent_chunk, *args, use_reentrant=False)
                if remat else _xent_chunk(*args))
        num, den = num + n, den + d
    return num, den


def loss_fn(params, batch, cfg: ModelConfig, ctx=None):
    """Next-token cross entropy; batch: tokens, labels, optional
    loss_weight (ones by default).  Returns (loss + aux, {"loss", "aux"}).
    Under a mesh the loss is the whole batch's (:func:`chunked_xent`),
    the same number on every rank."""
    if meshed(ctx):
        from repro_torch.dist import sharding
        return rank_loss(*sharding.split_tree(params), batch, cfg, ctx)
    x, aux, _ = forward(params, batch, cfg, ctx, mode="hidden")
    labels = batch["labels"]
    w = batch.get("loss_weight")
    if w is None:
        w = torch.ones(labels.shape, dtype=torch.float32,
                       device=labels.device)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    loss = chunked_xent(x, head.to(cfg.cdtype), labels, w, ctx)
    return loss + aux, {"loss": loss, "aux": aux}


def rank_loss(local, specs, batch, cfg: ModelConfig, ctx):
    """:func:`loss_fn` under a mesh on this rank's blocks of the params
    (``local``, placed as ``specs`` says): the train step differentiates
    it with respect to ``local``."""
    from repro_torch.dist import sharding
    x, aux, _, whole, rl = _rank_forward(local, specs, batch, cfg, ctx,
                                         "hidden")
    labels = _batch_block(batch["labels"], ctx)
    w = batch.get("loss_weight")
    w = (torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
         if w is None else _batch_block(w, ctx))
    head = whole["embed"] if cfg.tie_embeddings else whole["lm_head"]
    loss = _global_xent(x, head.to(cfg.cdtype), labels, w, ctx,
                        rl=rl if head.shape[0] != cfg.vocab else None)
    total = loss + aux
    if rl.tp is not None:
        # every rank of the model axis holds the same loss: each
        # differentiates its share of it
        total = sharding.share(total, ctx.mesh, ctx.model_axis)
    return total, {"loss": loss, "aux": aux}
