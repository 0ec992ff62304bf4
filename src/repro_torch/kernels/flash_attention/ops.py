"""Public flash-attention wrapper: CPU tensors take the plain version,
CUDA tensors launch a CUDA kernel (or raise).
``flash_attention.launches`` counts kernel launches, and
``flash_attention.tc_launches`` / ``.simt_launches`` those of each route
(``kernel.route``)."""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda, route
from .ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """q: (B,Sq,H,dqk); k: (B,Sk,Hkv,dqk); v: (B,Sk,Hkv,dv) -> (B,Sq,H,dv)
    (K5; dv == dqk but for MLA's prefill).  Causal masks top-left aligned
    (query i sees keys 0..i), as the TPU kernel."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    out = flash_attention_cuda(q, k, v, causal=causal)
    flash_attention.launches += 1
    if route(q.dtype, q.shape[-1], v.shape[-1]) == "tc":
        flash_attention.tc_launches += 1
    else:
        flash_attention.simt_launches += 1
    return out


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.simt_launches = 0
