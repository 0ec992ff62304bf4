"""command-r-35b [dense] — GQA kv=8, no bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab=256000,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)


def smoke() -> ModelConfig:
    return CONFIG.with_overrides(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=160,
        vocab=256, loss_chunk=16, remat="none")
