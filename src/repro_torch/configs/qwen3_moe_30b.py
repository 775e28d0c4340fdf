"""qwen3-moe-30b-a3b — 48L d2048 32H (GQA kv=4), MoE 128e top-8 expert-ff
768, vocab 151936, qk-norm [hf:Qwen/Qwen3-30B-A3B]. The EARTH dispatch
stress case: 128 experts, top-8 (1M routed units per train step).
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import MoESpec
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", d_model=2048, n_layers=48, n_heads=32,
        n_kv_heads=4, head_dim=128, d_ff=768, vocab=151936,
        block_pattern=("attn",), moe_pattern=(True,), mlp="swiglu",
        moe=MoESpec(n_experts=128, top_k=8, d_ff=768), qk_norm=True,
        rope_theta=1e6, tie_embeddings=False,
        param_dtype="float32", compute_dtype="bfloat16", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=64, vocab=512,
        block_pattern=("attn",), moe_pattern=(True,), mlp="swiglu",
        moe=MoESpec(n_experts=8, top_k=2, d_ff=64), qk_norm=True,
        tie_embeddings=False)


def arch() -> ArchConfig:
    return ArchConfig(model=config(), smoke=smoke_config(),
                      runs_long_context=False, family="moe",
                      notes="128e/16 shards -> 8 experts per device; "
                            "ragged grouped GEMM after EARTH compaction.")
