"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the H100's peaks, a served model's FLOPs in closed form,
and K5's work (a copy of the port's ``flash_attention_work``).

Model FLOPs count each product once at the model's own shapes: the
attention projections, the causal attention's two products over the
positions a query sees, the router, the routed experts at top-k with no
capacity padding, the shared experts, and the output head once a
forward (a prefill's last position, every decoded token).  A decoded
token attends over its whole context as standard attention would (MLA's
keys and values of earlier positions taken as cached, not expanded
again).
"""
from __future__ import annotations

from typing import Any, Dict

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _experts(c: Dict[str, Any]) -> int:
    return c.get("n_routed_experts", c.get("num_experts"))


def projection_flops(c: Dict[str, Any]) -> int:
    """Matmul FLOPs a token spends outside attention's two products in
    one layer: the attention projections, the router, its top-k experts
    and the shared experts (SiLU-gated: three matrices an FFN)."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    if "kv_lora_rank" in c:
        nope, rope, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                          c["v_head_dim"])
        r, rq = c["kv_lora_rank"], c["q_lora_rank"]
        attn = d * rq + rq * h * (nope + rope) + d * (r + rope) \
            + r * h * (nope + vd) + h * vd * d
    else:
        hd, kv = c["head_dim"], c["num_key_value_heads"]
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    f = c["moe_intermediate_size"]
    ffn = 3 * d * f * (c["num_experts_per_tok"] + c.get("n_shared_experts", 0))
    return 2 * (attn + d * _experts(c) + ffn)


def attention_flops(c: Dict[str, Any], pairs: int) -> int:
    """q . k and p . v over ``pairs`` (query, key) pairs in one layer."""
    h = c["num_attention_heads"]
    if "kv_lora_rank" in c:
        dk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
        dv = c["v_head_dim"]
    else:
        dk = dv = c["head_dim"]
    return 2 * h * (dk + dv) * pairs


def head_flops(c: Dict[str, Any]) -> int:
    return 2 * c["hidden_size"] * c["vocab_size"]


def prefill_flops(c: Dict[str, Any], s: int) -> int:
    """A whole-prompt admit of ``s`` tokens."""
    layers = c["num_hidden_layers"]
    pairs = s * (s + 1) // 2
    return layers * (s * projection_flops(c) + attention_flops(c, pairs)) \
        + head_flops(c)


def decode_flops(c: Dict[str, Any], context: int) -> int:
    """One decoded token that attends over ``context`` positions (itself
    included)."""
    layers = c["num_hidden_layers"]
    return layers * (projection_flops(c) + attention_flops(c, context)) \
        + head_flops(c)


def k5_work(c: Dict[str, Any], s: int, elem: int = 2) -> Dict[str, int]:
    """K5's work in one layer of a whole-prompt admit of ``s`` tokens: the
    port's ``flash_attention_work`` on q (1, s, H, dk), k (1, s, Hk, dk),
    v (1, s, Hk, dv), causal: q, k and v read once and the output
    (1, s, H, dv) written once; 2 (dk + dv) FLOPs a head and attended pair.
    MLA's k and v are expanded to every head before K5."""
    h = c["num_attention_heads"]
    if "kv_lora_rank" in c:
        dk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
        dv, hk = c["v_head_dim"], h
    else:
        dk = dv = c["head_dim"]
        hk = c["num_key_value_heads"]
    nbytes = elem * (s * h * dk + s * hk * dk + s * hk * dv + s * h * dv)
    pairs = s * (s + 1) // 2
    return {"bytes": nbytes, "matmul_flops": 2 * h * (dk + dv) * pairs}


def k5_bound_s(c: Dict[str, Any], s: int) -> float:
    """The least time K5 can take in one layer of an admit of ``s``."""
    w = k5_work(c, s)
    return max(w["matmul_flops"] / PEAK_BF16_FLOPS,
               w["bytes"] / PEAK_HBM_BYTES)
