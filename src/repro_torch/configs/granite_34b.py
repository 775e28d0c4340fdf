"""granite-34b — 88L d6144 48H (MQA kv=1) ff24576 vocab 49152.

GPT-BigCode-lineage code model [arXiv:2405.04324]: MQA + 2-matmul GELU MLP
(param count lands at ~34B with the non-GLU MLP). Pure full attention ->
long_500k skipped (DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", d_model=6144, n_layers=88, n_heads=48,
        n_kv_heads=1, head_dim=128, d_ff=24576, vocab=49152,
        mlp="mlp", fused_glu=False, rope_theta=1e4,
        param_dtype="float32", compute_dtype="bfloat16", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-smoke", d_model=128, n_layers=2, n_heads=4,
        n_kv_heads=1, head_dim=32, d_ff=256, vocab=512,
        mlp="mlp", fused_glu=False, rope_theta=1e4)


def arch() -> ArchConfig:
    return ArchConfig(model=config(), smoke=smoke_config(),
                      runs_long_context=False, family="dense",
                      notes="MQA kv=1: KV replicated over model axis; "
                            "Q heads sharded.")
