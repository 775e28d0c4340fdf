"""whisper-tiny — enc-dec 4+4L d384 6H ff1536 vocab 51865 [arXiv:2212.04356].

Conv/mel frontend is a STUB: input_specs provides precomputed frame
embeddings (B, 1500, 384). Backbone exercised per the assignment; decoder
has causal self-attn (interleaved KV cache) + cross-attn over cached
encoder K/V. Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import EncoderSpec, ModelConfig


def config() -> ModelConfig:
    # vocab padded 51865 -> 51968 (multiple of 256) so the unembedding can
    # shard over the 16-way model axis — standard Megatron-style padding.
    return ModelConfig(
        name="whisper-tiny", d_model=384, n_layers=4, n_heads=6,
        n_kv_heads=6, head_dim=64, d_ff=1536, vocab=51968,
        mlp="mlp", fused_glu=False, rope_theta=1e4,
        encoder=EncoderSpec(n_layers=4, context=1500),
        param_dtype="float32", compute_dtype="bfloat16", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke", d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
        mlp="mlp", fused_glu=False,
        encoder=EncoderSpec(n_layers=2, context=64))


def arch() -> ArchConfig:
    return ArchConfig(model=config(), smoke=smoke_config(),
                      runs_long_context=False, family="audio",
                      notes="RMSNorm + sinusoidal positions instead of "
                            "whisper's LayerNorm/learned-pos (backbone "
                            "stub; noted deviation).")
