"""Public decode-attention wrapper: CPU tensors take the plain version,
CUDA tensors launch a CUDA kernel (or raise).
``decode_attention.launches`` counts kernel launches, and
``decode_attention.tc_launches`` / ``.simt_launches`` those of each route
(``kernel.route``)."""
from __future__ import annotations

import torch

from .kernel import decode_attention_cuda, route
from .ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); caches: (B,S,Hkv,hd); length: (B,) -> (B,H,hd)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, length)
    out = decode_attention_cuda(q, k_cache, v_cache, length)
    if q.shape[0]:
        decode_attention.launches += 1
        if route(q.dtype, q.shape[-1], q.shape[1] // k_cache.shape[2]) == "tc":
            decode_attention.tc_launches += 1
        else:
            decode_attention.simt_launches += 1
    return out


decode_attention.launches = 0
decode_attention.tc_launches = 0
decode_attention.simt_launches = 0
