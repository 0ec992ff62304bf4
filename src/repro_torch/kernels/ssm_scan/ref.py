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

from typing import Optional

import torch


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                 h0: Optional[torch.Tensor] = None,
                 state_tile: Optional[int] = None):
    """x, dt: (Bb,L,Din); B, C: (Bb,L,N); A: (Din,N); D: (Din,);
    h0: (Bb,Din,N) or None -> (y (Bb,L,Din) in x.dtype, h_last f32); with
    ``state_tile`` also the state at the start of each ``state_tile``
    positions, (Bb, ceil(L / state_tile), N, Din) f32 (h0 first), as K6
    writes them for its backward."""
    bb, l, din = x.shape
    n = A.shape[1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = B.float(), C.float(), A.float()
    h = torch.zeros((bb, din, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float().clone()
    ys = torch.empty((bb, l, din), dtype=torch.float32, device=x.device)
    starts = []
    for t in range(l):
        if state_tile and t % state_tile == 0:
            starts.append(h.transpose(1, 2))
        dtt = dtf[:, t]                                     # (Bb,Din)
        da = torch.exp(dtt[..., None] * Af[None])           # (Bb,Din,N)
        h = da * h + (dtt * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys[:, t] = torch.einsum("bdn,bn->bd", h, Cf[:, t])
    y = ys + D.float()[None, None] * xf
    if state_tile:
        return y.to(x.dtype), h, torch.stack(starts, 1).contiguous()
    return y.to(x.dtype), h


def ssm_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                     h0: Optional[torch.Tensor], y_grad: Optional[torch.Tensor],
                     h_last_grad: Optional[torch.Tensor]):
    """The gradient of ``ssm_scan_ref`` (K6b's plain version) as the
    explicit reverse recurrence, with a_t = exp(dt_t A) and h_{-1} = h0 (0
    without one):

        g_t = C_t dy_t + a_{t+1} g_{t+1},      g_L = dh_last
        dx_t = sum_n g_t dt_t B_t + D dy_t
        ddt_t = sum_n g_t (x_t B_t + A a_t h_{t-1})
        dB_t = sum_d g_t dt_t x_t,             dC_t = sum_d dy_t h_t
        dA = sum_{b,t} g_t dt_t a_t h_{t-1},   dD = sum_{b,t} dy_t x_t
        dh0 = a_0 g_0

    ``y_grad`` or ``h_last_grad`` None count as zeros.  Returns (dx, ddt,
    dB, dC, dA, dD, dh0), each in its input's dtype, all maths in f32;
    dh0 is None when h0 is."""
    bb, l, din = x.shape
    n = A.shape[1]
    dev = x.device
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = B.float(), C.float(), A.float()
    dy = torch.zeros((bb, l, din), dtype=torch.float32, device=dev) \
        if y_grad is None else y_grad.float()
    h = torch.zeros((bb, din, n), dtype=torch.float32, device=dev) \
        if h0 is None else h0.float()
    hs = [h]                                    # h_{t-1} for t = 0..L-1, h_L
    for t in range(l):
        da = torch.exp(dtf[:, t, :, None] * Af[None])
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        hs.append(h)
    g_next = torch.zeros((bb, din, n), dtype=torch.float32, device=dev) \
        if h_last_grad is None else h_last_grad.float()
    q = g_next                                  # a_{t+1} g_{t+1}; dh_last at L
    dx = torch.empty((bb, l, din), dtype=torch.float32, device=dev)
    ddt = torch.empty_like(dx)
    dB = torch.empty((bb, l, n), dtype=torch.float32, device=dev)
    dC = torch.empty_like(dB)
    dA = torch.zeros((din, n), dtype=torch.float32, device=dev)
    for t in range(l - 1, -1, -1):
        dtt = dtf[:, t]                                      # (Bb,Din)
        da = torch.exp(dtt[..., None] * Af[None])            # (Bb,Din,N)
        g = Cf[:, t, None, :] * dy[:, t, :, None] + q        # (Bb,Din,N)
        hprev = hs[t]
        ah = da * hprev
        gdt = g * dtt[..., None]
        dx[:, t] = torch.einsum("bdn,bn->bd", gdt, Bf[:, t])
        ddt[:, t] = torch.einsum("bdn,bn->bd", g, Bf[:, t]) * xf[:, t] \
            + torch.einsum("bdn,dn->bd", g * ah, Af)
        dB[:, t] = torch.einsum("bdn,bd->bn", gdt, xf[:, t])
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dy[:, t])
        dA += torch.einsum("bdn,bdn->dn", gdt, ah)
        q = da * g
    dx = dx + D.float()[None, None] * dy
    dD = torch.einsum("bld,bld->d", dy, xf)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dB.to(B.dtype), dC.to(C.dtype),
            dA.to(A.dtype), dD.to(D.dtype),
            None if h0 is None else q.to(h0.dtype))
