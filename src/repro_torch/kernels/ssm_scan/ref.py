"""Plain PyTorch version of the S6 selective scan (K6), the Mamba-1 core.

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t
    y_t = h_t . C_t + D * x_t

The recurrence of ``repro/kernels/ssm_scan/ref.py``: one step per
position, all maths in f32, y in x's dtype, h_last in f32.  The CUDA
kernel computes the same recurrence as a scan over segments of the
sequence, with ``2^(dt * A log2 e)`` on the card's SFU, so its sums come
in another order and its exponentials differ in the last bits: the two
agree within repro's 1e-4, not bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (Bb,L,Din); B, C: (Bb,L,N); A: (Din,N); D: (Din,);
    h0: (Bb,Din,N) or None -> (y (Bb,L,Din) in x.dtype, h_last f32)."""
    bb, l, din = x.shape
    n = A.shape[1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = B.float(), C.float(), A.float()
    h = torch.zeros((bb, din, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float().clone()
    ys = torch.empty((bb, l, din), dtype=torch.float32, device=x.device)
    for t in range(l):
        dtt = dtf[:, t]                                     # (Bb,Din)
        da = torch.exp(dtt[..., None] * Af[None])           # (Bb,Din,N)
        h = da * h + (dtt * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys[:, t] = torch.einsum("bdn,bn->bd", h, Cf[:, t])
    y = ys + D.float()[None, None] * xf
    return y.to(x.dtype), h
