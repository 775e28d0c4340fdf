"""qwen3-0.6b — 28L d1024 16H (GQA kv=8) ff3072 vocab 151936.

qk-norm + GQA, head_dim 128 [hf:Qwen/Qwen3-0.6B].  The same geometry as
``repro``'s ``configs/qwen3_0_6b.py``."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", d_model=1024, n_layers=28, n_heads=16,
        n_kv_heads=8, head_dim=128, d_ff=3072, vocab=151936,
        mlp="swiglu", qk_norm=True, rope_theta=1e6,
        param_dtype="float32", compute_dtype="bfloat16", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-smoke", d_model=128, n_layers=2, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512,
        mlp="swiglu", qk_norm=True)


def arch() -> ArchConfig:
    return ArchConfig(model=config(), smoke=smoke_config(),
                      runs_long_context=False, family="dense")
