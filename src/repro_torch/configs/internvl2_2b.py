"""internvl2-2b [vlm] — InternViT (stub) + InternLM2 backbone, GQA kv=8.
[arXiv:2404.16821; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab=92553,
    vision_tokens=256,
    source="arXiv:2404.16821; hf",
)


def smoke() -> ModelConfig:
    return CONFIG.with_overrides(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab=256, vision_tokens=8, loss_chunk=16, remat="none")
