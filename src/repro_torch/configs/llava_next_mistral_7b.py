"""llava-next-mistral-7b — 32L d4096 32H (GQA kv=8) ff14336 vocab 32000.

Mistral-7B backbone; anyres vision tiling is a STUB: input_specs provides
precomputed patch embeddings (B, 2880, 4096) that overwrite the first image
token positions. Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32000,
        mlp="swiglu", rope_theta=1e6, vlm_patches=2880, tie_embeddings=False,
        param_dtype="float32", compute_dtype="bfloat16", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-smoke", d_model=128, n_layers=2, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512,
        mlp="swiglu", vlm_patches=16, tie_embeddings=False)


def arch() -> ArchConfig:
    return ArchConfig(model=config(), smoke=smoke_config(),
                      runs_long_context=False, family="vlm",
                      notes="anyres tiling stub = 5 x 576 patches.")
