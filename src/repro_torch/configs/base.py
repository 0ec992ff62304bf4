"""Model / run configuration dataclasses.

One frozen ``ModelConfig`` describes any architecture in the assigned pool
(dense / MoE / MLA / SSM / hybrid / enc-dec / VLM).  ``ShapeConfig``
describes an input-shape cell (train_4k / prefill_32k / decode_32k /
long_500k).  Everything downstream (models, sharding, launch) is driven
by these two objects.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // num_heads

    # --- MoE ---------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_impl: str = "gspmd"     # gspmd | ep (shard_map all-to-all dispatch)
    moe_weight_dtype: str = ""   # "int8" = quantized expert FFs (serving)

    # --- MLA (deepseek-v2) ---------------------------------------------------
    mla_kv_lora: int = 0         # kv compression rank; 0 => standard GQA
    mla_q_lora: int = 0
    mla_qk_nope_dim: int = 128
    mla_qk_rope_dim: int = 64
    mla_v_head_dim: int = 128

    # --- SSM (mamba) -----------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 1       # 1 => S6 selective scan, 2 => SSD
    ssm_head_dim: int = 64       # mamba2 heads
    ssm_chunk: int = 256         # seq chunk for the scan/SSD formulation
    ssm_scan_dtype: str = "float32"  # dtype of materialized scan elements
                                 # (bf16 halves the S6 HBM traffic; the
                                 # Pallas kernel keeps fp32 in VMEM)

    # --- hybrid (zamba2): shared attention block every k SSM blocks -------------
    shared_attn_every: int = 0

    # --- encoder-decoder (whisper) ------------------------------------------------
    encoder_layers: int = 0
    audio_frames: int = 1500     # stub conv-frontend output length (whisper)

    # --- VLM stub -------------------------------------------------------------------
    vision_tokens: int = 0       # stub ViT patch embeddings prepended to text

    # --- misc ------------------------------------------------------------------------
    act: str = "silu"            # silu | relu2 | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"          # none | dots | full
    loss_chunk: int = 512       # seq chunk for cross-entropy (memory)
    opt_dtype: str = "float32"   # AdamW moment dtype (bf16 for 200B+ archs)
    source: str = ""             # provenance tag [source; verified-tier]

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing => long_500k applies."""
        return self.family in ("ssm", "hybrid")

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ---------------
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.mla_kv_lora:
        q = (d * cfg.mla_q_lora + cfg.mla_q_lora * cfg.num_heads *
             (cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim)) if cfg.mla_q_lora else \
            d * cfg.num_heads * (cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim)
        kv = d * (cfg.mla_kv_lora + cfg.mla_qk_rope_dim)
        kv += cfg.mla_kv_lora * cfg.num_heads * (cfg.mla_qk_nope_dim +
                                                 cfg.mla_v_head_dim)
        o = cfg.num_heads * cfg.mla_v_head_dim * d
        return q + kv + o
    q = d * cfg.num_heads * hd
    kv = 2 * d * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * d
    return q + kv + o


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    mult = 3 if cfg.act == "silu" else 2     # gated MLPs have w1,w3,w2
    return mult * cfg.d_model * d_ff


def _ssm_params(cfg: ModelConfig) -> int:
    d, e = cfg.d_model, cfg.ssm_expand
    d_in = e * d
    if cfg.mamba_version == 1:
        dt_rank = max(1, (d + 15) // 16)
        return (d * 2 * d_in                    # in_proj
                + d_in * cfg.ssm_conv           # conv1d
                + d_in * (dt_rank + 2 * cfg.ssm_state)  # x_proj
                + dt_rank * d_in                # dt_proj
                + d_in * cfg.ssm_state          # A_log
                + d_in                          # D
                + d_in * d)                     # out_proj
    n_heads = d_in // cfg.ssm_head_dim
    return (d * (2 * d_in + 2 * cfg.ssm_state + n_heads)  # in_proj (zxBCdt)
            + (d_in + 2 * cfg.ssm_state) * cfg.ssm_conv   # conv1d
            + 3 * n_heads                        # A_log, D, dt_bias
            + d_in * d)                          # out_proj


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    total = cfg.vocab * d                        # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab * d                   # lm head
    per_layer = 2 * d                            # norms
    if cfg.family == "ssm":
        per_layer += _ssm_params(cfg)
        total += cfg.num_layers * per_layer
        return total + d
    if cfg.family == "hybrid":
        total += cfg.num_layers * (2 * d + _ssm_params(cfg))
        n_shared = (cfg.num_layers + cfg.shared_attn_every - 1) \
            // cfg.shared_attn_every if cfg.shared_attn_every else 0
        total += _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + 2 * d
        del n_shared  # shared block counted once (weights reused)
        return total + d
    attn = _attn_params(cfg)
    if cfg.moe_experts:
        experts = cfg.moe_top_k if active_only else cfg.moe_experts
        mlp = (experts + cfg.moe_shared_experts) * _mlp_params(cfg, cfg.moe_d_ff)
        mlp += d * cfg.moe_experts               # router
    else:
        mlp = _mlp_params(cfg, cfg.d_ff)
    total += cfg.num_layers * (per_layer + attn + mlp)
    if cfg.family == "encdec":
        enc = cfg.encoder_layers * (2 * d + attn + _mlp_params(cfg, cfg.d_ff))
        dec_cross = cfg.num_layers * (attn + d)  # cross-attention + norm
        total += enc + dec_cross
    return total + d                             # final norm


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
