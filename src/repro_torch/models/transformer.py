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
and every :func:`chunked_xent` chunk.  Sharding constraints wait for
``dist`` (item 9h).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import refuse_mesh, resolve as resolve_device
from repro_torch.kernels._common import tree_leaves
from repro_torch.models import attention, layers
from repro_torch.models.moe import MoESpec, init_moe, moe_layer
from repro_torch.models.ssm import MambaSpec, init_mamba, mamba_forward
from repro_torch.models.xlstm import (XLSTMSpec, init_mlstm, init_slstm,
                                      mlstm_forward, slstm_forward)

RECURRENT = ("mamba", "mlstm", "slstm")


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


def superblock(params_blocks: dict, sbi: int) -> dict:
    """Superblock ``sbi``'s parameters: views into the stacked leaves."""
    return tree_map(lambda a: a[sbi], params_blocks)


# ---------------------------------------------------------------------------
# Mixed precision and the FFN block
# ---------------------------------------------------------------------------

def cast_params(params, cfg: ModelConfig, ctx=None):
    """Compute in ``cfg.compute_dtype``: floating leaves are cast (router
    weights excepted, as in the reference).  Leaves already in the compute
    dtype are returned as they are, so a caller may cast once up front."""
    if cfg.cdtype == cfg.pdtype:
        return params

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        if t.is_floating_point() and t.dtype != cfg.cdtype \
                and not path.endswith("router"):
            return t.to(cfg.cdtype)
        return t

    return walk(params, "")


def _ffn_apply(p, x, cfg: ModelConfig, ctx, i: int, *, policy=None):
    """``policy`` overrides cfg.vx_policy for the GLU field split (the step
    scheduler keeps single-token splits on the plain path)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not cfg.pos_has_ffn(i):
        return x, aux
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe_pattern[i]:
        y, aux = moe_layer(p["moe"], h, cfg.moe, ctx)
    elif cfg.mlp == "swiglu":
        y = layers.glu_ffn(p["ffn"], h, fused=cfg.fused_glu,
                           policy=policy if policy is not None
                           else cfg.vx_policy)
    else:
        y = layers.mlp_ffn(p["mlp"], h)
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
    projection back in its ``(d, 2 * inner)`` matmul shape."""
    if kind == "mamba":
        pm = dict(p["mamba"])
        pm["in_proj"] = pm["in_proj"].reshape(cfg.d_model, 2 * cfg.mamba.ed)
        return pm
    if kind == "mlstm":
        px = dict(p["xl"])
        px["up"] = px["up"].reshape(cfg.d_model, 2 * cfg.xlstm.m_inner)
        return px
    return p["slstm"]


def _recurrent_forward(p, h, cfg: ModelConfig, kind: str):
    """(y, final state) of a recurrent block over ``h`` (B, S, d)."""
    pm = _mixer_params(p, cfg, kind)
    if kind == "mamba":
        return mamba_forward(pm, h, cfg.mamba, chunk=cfg.ssm_chunk)
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
        y, state = _recurrent_forward(
            p, layers.rms_norm(x, p["ln1"], cfg.norm_eps), cfg, kind)
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
    x = layers.embed(batch["tokens"], params["embed"]).to(cfg.cdtype)
    if cfg.vlm_patches and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(cfg.cdtype)
        x = x.clone()
        x[:, :pe.shape[1]] = pe
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
    flash attention carries the reference's backward."""
    check_supported(cfg)
    refuse_mesh(ctx)
    if mode not in ("train", "prefill", "hidden"):
        raise ValueError(f"unknown mode {mode!r}")
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


def _xent_chunk(x, head, labels, w):
    lse, ll = label_logprob_terms(layers.unembed(x, head), labels)
    return torch.sum((lse - ll) * w), torch.sum(w)


def chunked_xent(x, head, labels, w, ctx=None, *,
                 chunk: int = 512) -> torch.Tensor:
    """Head matmul + weighted cross entropy over sequence chunks: only one
    chunk's ``(B, chunk, V)`` logits are alive at a time, each chunk under
    a checkpoint while gradients are on (recomputed in the backward).  The
    chunk falls back to ``S`` when it does not divide ``S`` or covers it.
    Returns ``sum(w * (lse - ll)) / max(sum(w), 1)``."""
    refuse_mesh(ctx)
    S = x.shape[1]
    if S % chunk or S <= chunk:
        chunk = S
    remat = torch.is_grad_enabled()
    num = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, S, chunk):
        args = (x[:, lo:lo + chunk], head, labels[:, lo:lo + chunk],
                w[:, lo:lo + chunk])
        n, d = (checkpoint(_xent_chunk, *args, use_reentrant=False)
                if remat else _xent_chunk(*args))
        num, den = num + n, den + d
    return num / torch.clamp(den, min=1.0)


def loss_fn(params, batch, cfg: ModelConfig, ctx=None):
    """Next-token cross entropy; batch: tokens, labels, optional
    loss_weight (ones by default).  Returns (loss + aux, {"loss", "aux"})."""
    x, aux, _ = forward(params, batch, cfg, ctx, mode="hidden")
    labels = batch["labels"]
    w = batch.get("loss_weight")
    if w is None:
        w = torch.ones(labels.shape, dtype=torch.float32,
                       device=labels.device)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    loss = chunked_xent(x, head.to(cfg.cdtype), labels, w, ctx)
    return loss + aux, {"loss": loss, "aux": aux}
