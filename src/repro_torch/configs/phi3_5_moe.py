"""phi3.5-moe-42b-a6.6b — 32L d4096 32H (GQA kv=8), MoE 16e top-2 ff6400,
vocab 32064 [hf:microsoft/Phi-3.5-MoE-instruct]. Every layer MoE.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import MoESpec
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b", d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=6400, vocab=32064,
        block_pattern=("attn",), moe_pattern=(True,), mlp="swiglu",
        moe=MoESpec(n_experts=16, top_k=2, d_ff=6400),
        rope_theta=1e4, tie_embeddings=False,
        param_dtype="float32", compute_dtype="bfloat16", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke", d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        block_pattern=("attn",), moe_pattern=(True,), mlp="swiglu",
        moe=MoESpec(n_experts=4, top_k=2, d_ff=128), tie_embeddings=False)


def arch() -> ArchConfig:
    return ArchConfig(model=config(), smoke=smoke_config(),
                      runs_long_context=False, family="moe",
                      notes="16 experts / 16-way model axis -> exactly one "
                            "expert per device (EP sweet spot).")
