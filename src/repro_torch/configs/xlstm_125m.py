"""xlstm-125m — 12L d768 4H, sLSTM + mLSTM blocks, vocab 50304, d_ff=0
[arXiv:2405.04517]. Superblock of 6 = 5 mLSTM + 1 sLSTM (the paper's
m:s ratio family). Attention-free, O(1) state -> runs long_500k;
the interleaved-KV technique is inapplicable (no KV cache) — noted in
DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import ModelConfig
from repro_torch.models.xlstm import XLSTMSpec

_PATTERN = ("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm")


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", d_model=768, n_layers=12, n_heads=4,
        n_kv_heads=4, head_dim=192, d_ff=0, vocab=50304,
        block_pattern=_PATTERN, window_pattern=(None,) * 6,
        moe_pattern=(False,) * 6, mlp="none",
        xlstm=XLSTMSpec(d_model=768, n_heads=4),
        param_dtype="float32", compute_dtype="bfloat16", remat="full",
        ssm_chunk=128)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", d_model=64, n_layers=6, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=0, vocab=512,
        block_pattern=_PATTERN, window_pattern=(None,) * 6,
        moe_pattern=(False,) * 6, mlp="none",
        xlstm=XLSTMSpec(d_model=64, n_heads=4), ssm_chunk=16)


def arch() -> ArchConfig:
    return ArchConfig(model=config(), smoke=smoke_config(),
                      runs_long_context=True, family="ssm")
