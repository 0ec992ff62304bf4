"""Public decode-attention wrapper: CPU tensors take the plain version,
CUDA tensors launch a CUDA kernel (or raise), and ``meta`` tensors take
the meta route, which makes the output's shape and dtype and nothing
else.  On the card and on ``meta`` the call charges
``decode_attention_work`` to the active cost counter
(``backend.charged``).
``decode_attention.launches`` counts kernel launches, and
``decode_attention.tc_launches`` / ``.simt_launches`` those of each route
(``kernel.route``)."""
from __future__ import annotations

from typing import Optional

import torch

from ..backend import charged
from .kernel import decode_attention_cuda, route
from .ref import decode_attention_ref


def decode_attention_work(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, length: torch.Tensor,
                          positions: Optional[int] = None) -> dict:
    """K3's work on these inputs: q read and the output written once, the
    rows' lengths (int32) read once, and the K and V of ``positions``
    cache positions, summed over the rows, read once; q . k and p . v, 4 H
    hd FLOPs a position, as matmul FLOPs in q's type.

    ``positions`` defaults to B * S, the caches' whole capacity.  The
    kernel reads each row only up to its length, but the lengths live on
    the device, and a count taken from shapes must not read them back (a
    host read would stall the stream, and ``meta`` tensors hold no
    values).  A caller that has the lengths on the host (a bound) passes
    their sum."""
    b, h, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    positions = b * s if positions is None else int(positions)
    size = q.element_size()
    return {"bytes": 2 * positions * hkv * hd * size + 2 * b * h * hd * size
            + 4 * b, "matmul_flops": 4 * positions * h * hd, "ops": 0,
            "type": str(q.dtype).replace("torch.", "")}


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); caches: (B,S,Hkv,hd); length: (B,) -> (B,H,hd)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, length)
    with charged("K3", decode_attention_work(q, k_cache, v_cache, length)):
        if q.device.type == "meta":
            return _meta_output(q, v_cache)
        out = decode_attention_cuda(q, k_cache, v_cache, length)
    if q.shape[0]:
        decode_attention.launches += 1
        if route(q.dtype, q.shape[-1], q.shape[1] // k_cache.shape[2]) == "tc":
            decode_attention.tc_launches += 1
        else:
            decode_attention.simt_launches += 1
    return out


def _meta_output(q: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """The meta route of K3: the output, empty."""
    return q.new_empty(q.shape[:2] + v_cache.shape[-1:])


decode_attention.launches = 0
decode_attention.tc_launches = 0
decode_attention.simt_launches = 0
