"""Public selective-scan wrapper: CPU tensors take the plain version,
CUDA tensors launch the CUDA kernel (or raise).  ``ssm_scan.launches``
counts kernel launches."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import ssm_scan_cuda
from .ref import ssm_scan_ref


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (Bb,L,Din); B, C: (Bb,L,N); A: (Din,N); D: (Din,);
    h0: (Bb,Din,N) or None -> (y (Bb,L,Din) x.dtype, h_last (Bb,Din,N)
    f32) (K6)."""
    if x.device.type == "cpu":
        return ssm_scan_ref(x, dt, B, C, A, D, h0)
    out = ssm_scan_cuda(x, dt, B, C, A, D, h0)
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0
