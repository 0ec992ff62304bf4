"""Public selective-scan wrappers: CPU tensors take the plain versions,
CUDA tensors launch the CUDA kernels (or raise), and ``meta`` tensors take
the meta route, which makes the outputs' shapes and dtypes and nothing
else.  On the card and on ``meta`` each call charges its work
(``ssm_scan_work``, ``ssm_scan_bwd_work``) to the active cost counter
(``backend.charged``) under "K6" or "K6b".

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

from ..backend import charged
from .kernel import STATE_TILE, ssm_scan_bwd_cuda, ssm_scan_cuda
from .ref import ssm_scan_bwd_ref, ssm_scan_ref


# f32 operations K6 must do per (position, channel, state): dt*A, exp,
# da*h, (dt*x)*B, +, h*C, the reduction's add; and per (position,
# channel): dt*x, D*x, +
K6_OPS_STATE, K6_OPS_CHANNEL = 7, 3
# f32 operations K6b must do per (position, channel, state): a_t, g_t
# (C dy + q), q = a g, g dt, dx's and dB's products, ddt's (x B + A a h),
# dA's, dC's dy h and the state h = a h + dt x B; and per (position,
# channel): dt x, D dy, dy x
K6B_OPS_STATE, K6B_OPS_CHANNEL = 16, 3


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def ssm_scan_work(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                  h0: Optional[torch.Tensor] = None) -> dict:
    """K6's work on these inputs: each input read once, y (x's type) and
    h_last (f32) written once; ``K6_OPS_*`` f32 operations and no matmul
    FLOPs; ``exponentials``, one a (position, channel, state), for an SFU
    bound."""
    bb, l, din = x.shape
    n = A.shape[1]
    return {"bytes": _nbytes((x, dt, B, C, A, D, h0)) + _nbytes((x,))
            + bb * din * n * 4,
            "matmul_flops": 0,
            "ops": bb * l * din * (K6_OPS_STATE * n + K6_OPS_CHANNEL),
            "exponentials": bb * l * din * n, "type": "float32"}


def ssm_scan_bwd_work(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                      h0: Optional[torch.Tensor], dy: Optional[torch.Tensor],
                      dh_last: Optional[torch.Tensor]) -> dict:
    """K6b's work on these inputs: each input read once (dy and dh_last
    where given) and each gradient written once in its input's type (dh0
    where h0 is given); ``K6B_OPS_*`` f32 operations and no matmul FLOPs;
    ``exponentials``, one a (position, channel, state), for an SFU bound.
    K6's tile start states, which the kernel reads, are not the function's
    input and are not counted."""
    bb, l, din = x.shape
    n = A.shape[1]
    return {"bytes": _nbytes((x, dt, B, C, A, D, h0, dy, dh_last))
            + _nbytes((x, dt, B, C, A, D, h0)),
            "matmul_flops": 0,
            "ops": bb * l * din * (K6B_OPS_STATE * n + K6B_OPS_CHANNEL),
            "exponentials": bb * l * din * n, "type": "float32"}


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
            with charged("K6", ssm_scan_work(x, dt, B, C, A, D, h0)):
                if x.device.type == "meta":
                    out = _meta_forward(x, A, states)
                else:
                    out = ssm_scan_cuda(x, dt, B, C, A, D, h0, states=states)
            if x.device.type != "meta":
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
        with charged("K6b", ssm_scan_bwd_work(x, dt, B, C, A, D, h0, dy,
                                              dh_last)):
            if x.device.type == "meta":
                return _meta_backward(x, dt, B, C, A, D, h0)
            grads = ssm_scan_bwd_cuda(x, dt, B, C, A, D, h0, dy, dh_last, hs)
        ssm_scan.bwd_launches += 1
        return grads


def _meta_backward(*inputs):
    """The meta route of K6b: each gradient empty, like its input (dh0
    None where h0 is)."""
    return tuple(None if t is None else torch.empty_like(t) for t in inputs)


def _meta_forward(x: torch.Tensor, A: torch.Tensor, states: bool):
    """The meta route of K6: y, h_last and, when asked, the tile start
    states, empty (what ``ssm_scan_cuda`` returns)."""
    bb, l, din = x.shape
    n = A.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    out = (torch.empty_like(x), torch.empty((bb, din, n), **f32))
    if states:
        out += (torch.empty((bb, -(-l // STATE_TILE), n, din), **f32),)
    return out
