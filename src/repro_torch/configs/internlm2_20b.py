"""internlm2-20b [dense] — GQA kv=8. [arXiv:2403.17297; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab=92544,
    source="arXiv:2403.17297; hf",
)


def smoke() -> ModelConfig:
    return CONFIG.with_overrides(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab=256, loss_chunk=16, remat="none")
