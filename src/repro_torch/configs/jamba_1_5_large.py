"""jamba-1.5-large-398b — 72L d8192 64H (GQA kv=8) ff24576 vocab 65536.

Hybrid Mamba+attention 1:7 interleave with MoE (16e top-2) every second
layer [arXiv:2403.19887]: superblock of 8 = 7 mamba + 1 attn (position 4),
MoE on odd positions. SSM state is O(1) per token -> runs long_500k.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import MoESpec
from repro_torch.models.ssm import MambaSpec
from repro_torch.models.transformer import ModelConfig

_PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
            "mamba")
_MOE = (False, True, False, True, False, True, False, True)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", d_model=8192, n_layers=72, n_heads=64,
        n_kv_heads=8, head_dim=128, d_ff=24576, vocab=65536,
        block_pattern=_PATTERN, window_pattern=(None,) * 8,
        moe_pattern=_MOE, mlp="swiglu",
        moe=MoESpec(n_experts=16, top_k=2, d_ff=24576),
        mamba=MambaSpec(d_model=8192, expand=2, state_dim=16, conv_width=4),
        rope_theta=1e4, param_dtype="float32", compute_dtype="bfloat16",
        remat="full", ssm_chunk=256)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", d_model=64, n_layers=8, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128,
        vocab=512, block_pattern=_PATTERN, window_pattern=(None,) * 8,
        moe_pattern=_MOE, mlp="swiglu",
        moe=MoESpec(n_experts=4, top_k=2, d_ff=128),
        mamba=MambaSpec(d_model=64, expand=2, state_dim=8, conv_width=4),
        ssm_chunk=32)


def arch() -> ArchConfig:
    return ArchConfig(model=config(), smoke=smoke_config(),
                      runs_long_context=True, family="hybrid",
                      notes="~398B total via 36 MoE layers x 16e x "
                            "swiglu(8192->24576); ~94B active (top-2).")
