"""Launcher of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``).

K6 ``ssm_scan_cuda`` replaces ``ssm_scan_pallas``
(``repro/kernels/ssm_scan/kernel.py``); the design notes sit in the CUDA
source.  y and h_last are allocated here with ``torch.empty``; the
kernel launches on the current stream and does not synchronise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_STATE = 32          # the kernel's shared-memory tiles hold 32 states


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Bb,L,Din); dt: (Bb,L,Din) f32; B, C: (Bb,L,N); A: (Din,N) f32;
    D: (Din,); h0: (Bb,Din,N) f32 or None.  x, B, C and D share one
    dtype (f32, bf16 or f16).  -> (y (Bb,L,Din) x.dtype, h_last f32)."""
    tensors = [x, dt, B, C, A, D] + ([] if h0 is None else [h0])
    dev = x.device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("ssm_scan: expects tensors on one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError("ssm_scan: expects contiguous tensors")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (B, C, D)):
        raise ValueError(f"ssm_scan: x, B, C, D must share one of "
                         f"{list(_DTYPES)}, got {x.dtype}, {B.dtype}, "
                         f"{C.dtype}, {D.dtype}")
    if any(t.dtype != torch.float32 for t in [dt, A] + tensors[6:]):
        raise ValueError("ssm_scan: dt, A and h0 must be float32")
    if x.dim() != 3:
        raise ValueError(f"ssm_scan: x must be (Bb, L, Din), got {x.shape}")
    bb, l, din = x.shape
    n = A.shape[-1]
    if dt.shape != x.shape or B.shape != (bb, l, n) or C.shape != B.shape \
            or A.shape != (din, n) or D.shape != (din,) \
            or (h0 is not None and h0.shape != (bb, din, n)):
        raise ValueError("ssm_scan: mismatched shapes")
    if not 1 <= n <= MAX_STATE or bb > 65535:
        raise ValueError(f"ssm_scan: takes 1 <= N <= {MAX_STATE} and "
                         f"Bb <= 65535, got N={n}, Bb={bb}")
    if not x.numel():
        raise ValueError(f"ssm_scan: empty input {tuple(x.shape)}")
    y = torch.empty_like(x)
    h_last = torch.empty((bb, din, n), dtype=torch.float32, device=dev)
    build.launch("ssm_scan_launch", x.data_ptr(), dt.data_ptr(),
                 B.data_ptr(), C.data_ptr(), A.data_ptr(), D.data_ptr(),
                 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), bb, l, din, n, _DTYPES[x.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    return y, h_last
