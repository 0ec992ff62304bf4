"""Mamba-1 sequence mixer of the port: the S6 half of ``repro.models.ssm``.

A multi-token segment (prefill) runs its selective scan in kernel K6
(the CUDA kernel on the card, its plain version on the CPU), which walks
the whole sequence: the port takes any prompt length, where ``repro``'s
chunked jnp scan keeps only whole ``ssm_chunk`` multiples.  A one-token
step (decode) stays plain torch, as in ``repro``.  The Mamba-2 SSD path
is not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssm_scan.ops import ssm_scan
from . import layers as L

Params = Dict[str, Any]


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, (cfg.d_model + 15) // 16)


def require_mamba1(cfg: ModelConfig) -> None:
    if cfg.mamba_version != 1:
        raise NotImplementedError(
            f"mamba_version {cfg.mamba_version} (the SSD path) is not "
            "ported yet: ROADMAP queue 1, item 5")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def mamba_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    require_mamba1(cfg)
    d, din, st = cfg.d_model, d_inner(cfg), cfg.ssm_state
    r = dt_rank(cfg)
    return {
        "in_proj": (d, 2 * din),
        "conv_w": (cfg.ssm_conv, din),
        "conv_b": (din,),
        "x_proj": (din, r + 2 * st),
        "dt_proj": (r, din),
        "dt_bias": (din,),
        "A_log": (din, st),
        "D": (din,),
        "out_proj": (din, d),
    }


def mamba_params(cfg: ModelConfig, generator: torch.Generator,
                 device) -> Params:
    """One layer's weights with ``repro``'s ``mamba_params``
    distributions: N(0, 1/d_model) matrices, zero conv bias, then the
    S4-style overrides A_log = log(1..N), dt_bias = log(expm1(0.01)),
    D = 1."""
    dtype = L.dt(cfg)
    out = {}
    std = 1.0 / math.sqrt(cfg.d_model)
    for name, shape in sorted(mamba_shapes(cfg).items()):
        if name == "A_log":
            a = torch.arange(1, shape[1] + 1, dtype=torch.float32,
                             device=device)
            out[name] = torch.log(a).expand(shape).to(dtype).contiguous()
        elif name == "dt_bias":
            out[name] = torch.full(shape, math.log(math.expm1(0.01)),
                                   dtype=dtype, device=device)
        elif name == "D":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif len(shape) == 1:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            out[name] = (torch.randn(shape, generator=generator,
                                     dtype=torch.float32, device=device)
                         * std).to(dtype)
    return out


def mamba_state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple]:
    require_mamba1(cfg)
    din, st, k = d_inner(cfg), cfg.ssm_state, cfg.ssm_conv
    return {"h": (batch, din, st), "conv": (batch, k - 1, din)}


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B,S,C); w: (K,C). Returns (out, new_state)."""
    k = w.shape[0]
    if state is not None:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
        new_state = xp[:, -(k - 1):, :]
    else:
        xp = F.pad(x, (0, 0, k - 1, 0))
        new_state = None
    out = xp[:, 0:x.shape[1], :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :]), new_state


# ---------------------------------------------------------------------------
# Mamba-1: S6 selective scan
# ---------------------------------------------------------------------------

def mamba1_scan_inputs(params: Params, x: torch.Tensor, cfg: ModelConfig,
                       state: Optional[Dict[str, torch.Tensor]] = None):
    """Everything before the scan: the input projection, the causal conv
    and the selective parameters.  Returns (xs, z, dt_v, B, C, A,
    new_conv) with B and C contiguous (K6 takes no strides)."""
    din, st = d_inner(cfg), cfg.ssm_state
    xz = x @ params["in_proj"]
    xs, z = xz[..., :din], xz[..., din:]
    conv_state = state["conv"] if state is not None else None
    xs, new_conv = _causal_conv(xs, params["conv_w"], params["conv_b"],
                                conv_state)
    proj = xs @ params["x_proj"]                           # (B,S,r+2st)
    r = dt_rank(cfg)
    dt_raw = proj[..., :r]
    Bc = proj[..., r:r + st].contiguous()
    Cc = proj[..., r + st:].contiguous()
    dt_v = F.softplus(dt_raw @ params["dt_proj"]
                      + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())                # (din, st)
    return xs, z, dt_v, Bc, Cc, A, new_conv


def mamba1_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B,S,d). state: {"h": (B,din,st) f32, "conv": (B,K-1,din)}."""
    s = x.shape[1]
    xs, z, dt_v, Bc, Cc, A, new_conv = mamba1_scan_inputs(params, x, cfg,
                                                          state)
    if state is not None and s == 1:                        # decode step
        h0 = state["h"]
        da = torch.exp(dt_v[:, 0, :, None] * A[None])       # (B,din,st)
        dbx = (dt_v[:, 0, :, None] * Bc[:, 0, None, :]
               * xs[:, 0, :, None].float())
        h = da * h0 + dbx
        y = torch.einsum("bds,bs->bd", h, Cc[:, 0].float())
        y = y + params["D"].float() * xs[:, 0].float()
        y = y[:, None, :].to(x.dtype)
        new_state = {"h": h, "conv": new_conv}
    else:
        h0 = state["h"] if state is not None else None
        y, h_last = ssm_scan(xs, dt_v.contiguous(), Bc, Cc, A, params["D"],
                             h0)
        new_state = ({"h": h_last, "conv": new_conv}
                     if state is not None else None)
    y = y * F.silu(z)
    return y @ params["out_proj"], new_state
