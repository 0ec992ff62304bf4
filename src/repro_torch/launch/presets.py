"""Baseline parallelism presets per (arch family × shape mode): a copy of
``repro.launch.presets``, whose rule tables need no jax.

The mesh SHAPE is fixed by the assignment ((16,16) / (2,16,16)); what a
framework chooses is how logical axes map onto it.  Baselines:

  * dense/ssm/hybrid/encdec/vlm TRAIN  -> pure DP + 2-axis FSDP
        batch over (pod,data,model); weight d_model rows over both axes.
        A 3-35B dense model on 256 chips is compute-starved under TP=16
        (``repro``'s reckoning on its TPU v5e mesh: activation all-reduce
        ~4s vs 0.6s matmul), so DP+FSDP is the right default.
  * MoE TRAIN                          -> EP/TP over 'model', DP over
        (pod,data), FSDP weight shard over 'data', grad-accumulation
        microbatches to fit the wider residual stream.
  * PREFILL                            -> DP over 'data', TP over 'model'
        (latency-oriented: small global batch cannot fill 256-way DP).
  * DECODE                             -> DP over 'data', TP over 'model',
        KV-cache sequence dim sharded over 'model'.
  * long_500k (batch=1)                -> sequence parallelism: KV/state
        over 'data', heads over 'model', batch on 'pod' only.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from ..configs.base import ModelConfig, ShapeConfig

DP_FSDP = {
    "batch": ("pod", "data", "model"),
    "heads": None, "kv_heads": None, "ff": None, "experts": None,
    "vocab": None, "embed": ("data", "model"), "act_embed": None,
}

MOE_TRAIN = {
    "batch": ("pod", "data"),
    "heads": "model", "kv_heads": "model", "ff": "model",
    "experts": "model", "vocab": "model", "embed": "data",
    # TP-shard the residual stream: layer-boundary all-gather/reduce-scatter
    # instead of 16x replicated scan carries (38GB -> 2.4GB on the 236Bs in
    # repro's TPU dry run)
    "act_embed": "model",
}

SERVE_TP = {
    "batch": ("pod", "data"),
    "heads": "model", "kv_heads": "model", "ff": "model",
    "experts": "model", "vocab": "model",
    # weights 2-axis sharded: a 236B MoE in bf16 is 472GB — TP-only would
    # leave 29.5GB/chip of weights (472GB / 16).  Dense weights gather
    # FSDP-style over "data"; MoE expert FFs shard their hidden dim over
    # "data" instead, so decode reduces small expert OUTPUTS over data
    # rather than gathering each layer's expert weights.
    "embed": "data",
    # the KV cache seq dim shards over 'model' (32k x large-batch caches)
    "act_embed": None, "kv_seq": "model",
}

DECODE_TP = dict(SERVE_TP)

LONG_SP = {
    "batch": ("pod",),
    "heads": "model", "kv_heads": "model", "ff": "model",
    "experts": "model", "vocab": "model", "embed": None,
    "act_embed": None, "kv_seq": "data",
}


def preset(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Dict[str, Any], int]:
    """-> (logical-axis rules, microbatches)."""
    if shape.name == "long_500k":
        return dict(LONG_SP), 1
    if shape.mode == "train":
        if cfg.moe_experts:
            return dict(MOE_TRAIN), 1
        return dict(DP_FSDP), 1
    if shape.mode == "prefill":
        return dict(SERVE_TP), 1
    return dict(DECODE_TP), 1
