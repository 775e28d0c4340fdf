"""Decoder-only transformer: config, parameters and the FFN block.

Port of the parts of ``repro``'s ``models/transformer.py`` that the paged
serving path uses: :class:`ModelConfig` (the same fields), a seeded
:func:`init_params` with the reference's parameter layout, shapes and
scales (leaves stacked over superblocks, ``(NS, ...)``), :func:`cast_params`
and :func:`_ffn_apply`, plus :func:`params_from_jax`, which turns the
reference's ``init_params`` output (converted through ``np.asarray``) into
the port's parameters.

Waiting for later slices: ``forward`` / ``loss_fn`` (training and dense
prefill), and the MoE, Mamba, xLSTM and encoder families — their configs
are accepted, but init raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve as resolve_device
from repro_torch.models import layers


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
    moe: Any = None
    mamba: Any = None
    xlstm: Any = None
    encoder: Any = None
    vlm_patches: int = 0
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
    """This slice covers dense attention decoders with a SwiGLU FFN."""
    if cfg.encoder is not None or any(k != "attn"
                                      for k in cfg.block_pattern) \
            or any(cfg.moe_pattern) or cfg.mlp not in ("swiglu", "none"):
        raise NotImplementedError(
            f"{cfg.name}: the port covers dense attention decoders with a "
            f"SwiGLU FFN; MoE, Mamba, xLSTM, encoder blocks and the GELU "
            f"MLP wait for a later slice")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_pos(cfg: ModelConfig, i: int, g: torch.Generator, device) -> dict:
    dt = cfg.pdtype
    d, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = d ** -0.5
    wq = layers.normal((d, H * D), s, g, dt, device)
    wk = layers.normal((d, K, D), s, g, dt, device)
    wv = layers.normal((d, K, D), s, g, dt, device)
    attn = {"wq": wq,
            # interleave K/V output features -> one coalesced beat per head
            "wkv": torch.stack([wk, wv], dim=-1).reshape(d, K * 2 * D),
            "wo": layers.normal((H * D, d), (H * D) ** -0.5, g, dt, device)}
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((D,), dtype=dt, device=device)
        attn["k_norm"] = torch.ones((D,), dtype=dt, device=device)
    p: dict[str, Any] = {"ln1": torch.ones((d,), dtype=dt, device=device),
                         "attn": attn}
    if cfg.pos_has_ffn(i):
        f = cfg.d_ff
        p["ln2"] = torch.ones((d,), dtype=dt, device=device)
        wg = layers.normal((d, f), s, g, dt, device)
        wu = layers.normal((d, f), s, g, dt, device)
        wo = layers.normal((f, d), f ** -0.5, g, dt, device)
        p["ffn"] = ({"wi": torch.stack([wg, wu], dim=-1).reshape(d, 2 * f),
                     "wo": wo} if cfg.fused_glu
                    else {"wg": wg, "wu": wu, "wo": wo})
    return p


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
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


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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
    y = layers.glu_ffn(p["ffn"], h, fused=cfg.fused_glu,
                       policy=policy if policy is not None
                       else cfg.vx_policy)
    return x + y, aux
