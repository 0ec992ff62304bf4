"""Public flash-attention wrapper: CPU tensors take the plain version,
CUDA tensors launch the CUDA kernel (or raise).
``flash_attention.launches`` counts kernel launches."""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """q: (B,Sq,H,hd); k/v: (B,Sk,Hkv,hd) -> (B,Sq,H,hd) (K5).  Causal
    masks top-left aligned (query i sees keys 0..i), as the TPU kernel."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    out = flash_attention_cuda(q, k, v, causal=causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
