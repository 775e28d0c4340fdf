"""starcoder2-3b — 30L d3072 24H (GQA kv=2) ff12288 vocab 49152.

GQA + RoPE, 2-matmul GELU MLP [arXiv:2402.19173]. Full attention ->
long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", d_model=3072, n_layers=30, n_heads=24,
        n_kv_heads=2, head_dim=128, d_ff=12288, vocab=49152,
        mlp="mlp", fused_glu=False, rope_theta=999999.0,
        param_dtype="float32", compute_dtype="bfloat16", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke", d_model=96, n_layers=2, n_heads=6,
        n_kv_heads=2, head_dim=16, d_ff=192, vocab=512,
        mlp="mlp", fused_glu=False)


def arch() -> ArchConfig:
    return ArchConfig(model=config(), smoke=smoke_config(),
                      runs_long_context=False, family="dense")
