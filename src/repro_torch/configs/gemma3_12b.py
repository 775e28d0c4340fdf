"""gemma3-12b — 48L d3840 16H (GQA kv=8) ff15360 vocab 262144.

5:1 local:global attention interleave (window 1024), qk-norm, head_dim 256
[hf:google/gemma-3-12b]. Local layers are O(S*W) -> runs long_500k.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import ModelConfig

_PATTERN = ("attn",) * 6
_WINDOWS = (1024, 1024, 1024, 1024, 1024, None)   # 5 local : 1 global


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", d_model=3840, n_layers=48, n_heads=16,
        n_kv_heads=8, head_dim=256, d_ff=15360, vocab=262144,
        block_pattern=_PATTERN, window_pattern=_WINDOWS,
        moe_pattern=(False,) * 6, mlp="swiglu", qk_norm=True,
        rope_theta=1e6,  # global theta; local layers use 10k in HF (noted)
        param_dtype="float32", compute_dtype="bfloat16", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-smoke", d_model=96, n_layers=6, n_heads=4,
        n_kv_heads=2, head_dim=24, d_ff=192, vocab=512,
        block_pattern=_PATTERN, window_pattern=(16, 16, 16, 16, 16, None),
        moe_pattern=(False,) * 6, mlp="swiglu", qk_norm=True)


def arch() -> ArchConfig:
    return ArchConfig(model=config(), smoke=smoke_config(),
                      runs_long_context=True, family="dense",
                      notes="long_500k: local layers keep W=1024 ring "
                            "caches; global layers' 500k KV is sharded "
                            "over (data, model) sequence axes.")
