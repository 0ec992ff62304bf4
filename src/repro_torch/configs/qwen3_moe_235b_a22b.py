"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, GQA kv=4, head_dim 128.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    head_dim=128, d_ff=1536, vocab=151936,
    moe_experts=128, moe_top_k=8, moe_d_ff=1536,
    opt_dtype="bfloat16",   # 235B: fp32 moments would not fit one pod
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)


def smoke() -> ModelConfig:
    return CONFIG.with_overrides(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, vocab=256, moe_experts=8, moe_top_k=2, moe_d_ff=96,
        loss_chunk=16, remat="none")
