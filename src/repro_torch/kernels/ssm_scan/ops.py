"""Public selective-scan wrappers: CPU tensors take the plain versions,
CUDA tensors launch the CUDA kernels (or raise).

``ssm_scan`` is K6, through ``SsmScanFn`` on the serve path and in
training alike (outside autograd ``Function.apply`` records no graph);
``ssm_scan.launches`` counts its kernel launches.  The backward is K6b
(``ssm_scan_bwd_cuda``, or ``ssm_scan_bwd_ref`` on the CPU);
``ssm_scan.bwd_launches`` counts K6b's calls (each two kernel launches:
the scan, then the sums across clusters).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import STATE_TILE, ssm_scan_bwd_cuda, ssm_scan_cuda
from .ref import ssm_scan_bwd_ref, ssm_scan_ref


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (Bb,L,Din); B, C: (Bb,L,N); A: (Din,N); D: (Din,);
    h0: (Bb,Din,N) or None -> (y (Bb,L,Din) x.dtype, h_last (Bb,Din,N)
    f32): ``SsmScanFn``, which records nothing outside autograd."""
    return SsmScanFn.apply(x, dt, B, C, A, D, h0)


ssm_scan.launches = 0
ssm_scan.bwd_launches = 0


class SsmScanFn(torch.autograd.Function):
    """``ssm_scan`` with a gradient: ``SsmScanFn.apply(x, dt, B, C, A, D,
    h0)``.  When an input needs a gradient, the forward also asks K6 for
    the state at each ``STATE_TILE``-position tile's start and saves them
    with its inputs: K6b starts each of its tiles from them.  Outside
    autograd (serving, ``no_grad``) it asks for none, so K6's launches and
    outputs are those of a plain call.  On the CPU the plain scan returns
    its own states and the plain backward recomputes the recurrence, so
    the two devices take one path here.  Each gradient comes in its
    input's dtype."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, D, h0):
        states = any(ctx.needs_input_grad)
        if x.device.type == "cpu":
            out = ssm_scan_ref(x, dt, B, C, A, D, h0,
                               STATE_TILE if states else None)
        else:
            out = ssm_scan_cuda(x, dt, B, C, A, D, h0, states=states)
            ssm_scan.launches += 1
        ctx.save_for_backward(x, dt, B, C, A, D, h0,
                              out[2] if states else None)
        ctx.set_materialize_grads(False)     # an unused output: None, not 0
        return out[0], out[1]

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, B, C, A, D, h0, hs = ctx.saved_tensors
        if x.device.type == "cpu":
            return ssm_scan_bwd_ref(x, dt, B, C, A, D, h0, dy, dh_last)
        grads = ssm_scan_bwd_cuda(x, dt, B, C, A, D, h0, dy, dh_last, hs)
        ssm_scan.bwd_launches += 1
        return grads
