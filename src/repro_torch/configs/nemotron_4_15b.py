"""nemotron-4-15b [dense] — GQA kv=8, squared-ReLU MLP.
[arXiv:2402.16819; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24576, vocab=256000, act="relu2",
    source="arXiv:2402.16819; unverified",
)


def smoke() -> ModelConfig:
    return CONFIG.with_overrides(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=192,
        vocab=256, loss_chunk=16, remat="none")
