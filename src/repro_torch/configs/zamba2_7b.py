"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks,
ssm_state=64. [arXiv:2411.15242; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, mamba_version=2,
    ssm_head_dim=64, shared_attn_every=6,
    source="arXiv:2411.15242; unverified",
)


def smoke() -> ModelConfig:
    return CONFIG.with_overrides(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab=256, ssm_state=16, ssm_head_dim=16, shared_attn_every=2,
        ssm_chunk=16, loss_chunk=16, remat="none")
