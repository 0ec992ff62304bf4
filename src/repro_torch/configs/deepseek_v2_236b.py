"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=1536, vocab=102400,
    moe_experts=160, moe_top_k=6, moe_d_ff=1536, moe_shared_experts=2,
    mla_kv_lora=512, mla_q_lora=1536,
    mla_qk_nope_dim=128, mla_qk_rope_dim=64, mla_v_head_dim=128,
    opt_dtype="bfloat16",
    source="arXiv:2405.04434; hf",
)


def smoke() -> ModelConfig:
    return CONFIG.with_overrides(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=96,
        vocab=256, moe_experts=8, moe_top_k=2, moe_d_ff=96,
        moe_shared_experts=1, mla_kv_lora=32, mla_q_lora=48,
        mla_qk_nope_dim=16, mla_qk_rope_dim=8, mla_v_head_dim=16,
        loss_chunk=16, remat="none")
