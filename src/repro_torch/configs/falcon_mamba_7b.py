"""falcon-mamba-7b [ssm] — mamba1, attention-free, ssm_state=16.
[arXiv:2410.05355; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2, mamba_version=1,
    source="arXiv:2410.05355; unverified",
)


def smoke() -> ModelConfig:
    return CONFIG.with_overrides(
        num_layers=2, d_model=64, vocab=256, ssm_state=8, ssm_chunk=16,
        loss_chunk=16, remat="none")
