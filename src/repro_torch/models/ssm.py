"""Mamba sequence mixers of the port (``repro.models.ssm``): Mamba-1 (S6
selective scan) and Mamba-2 (SSD, the chunked matmul form).

A Mamba-1 segment of several tokens (prefill) runs its selective scan in
kernel K6 (the CUDA kernel on the card, its plain version on the CPU),
which walks the whole sequence: the port takes any prompt length, where
``repro``'s chunked jnp scan keeps only whole ``ssm_chunk`` multiples.
A one-token step (decode) stays plain torch, as in ``repro``.  In
training (no state) the scan's gradient is K6b, the hand-written
backward of ``SsmScanFn``, where ``repro`` runs ``jax.grad`` through its
jnp scan.

Mamba-2's SSD reaches no Pallas kernel in ``repro`` (it is jnp there),
so the port's copy is plain torch too (autograd differentiates it as it
is: nothing in it writes in place), with ``repro``'s f32 state: the
intra-chunk scores, the state's contribution and the new state are
``einsum`` products over chunks of ``ssm_chunk`` positions, one chunk at
a time.  The last chunk may be shorter, so the port takes any prompt
length here too, where ``repro`` reshapes to whole chunks and fails off
the grid.
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


def mamba_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, (cfg.d_model + 15) // 16)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def mamba_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, din, st = cfg.d_model, d_inner(cfg), cfg.ssm_state
    if cfg.mamba_version == 1:
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
    h = mamba_heads(cfg)
    conv_dim = din + 2 * st
    return {
        "in_proj": (d, 2 * din + 2 * st + h),   # z, x, B, C, dt
        "conv_w": (cfg.ssm_conv, conv_dim),
        "conv_b": (conv_dim,),
        "dt_bias": (h,),
        "A_log": (h,),
        "D": (h,),
        "norm_w": (din,),
        "out_proj": (din, d),
    }


def mamba_specs(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes of ``mamba_shapes``'s leaves (``repro``'s
    ``mamba_specs``)."""
    if cfg.mamba_version == 1:
        return {"in_proj": ("embed", "ff"), "conv_w": (None, "ff"),
                "conv_b": ("ff",), "x_proj": ("ff", None),
                "dt_proj": (None, "ff"), "dt_bias": ("ff",),
                "A_log": ("ff", None), "D": ("ff",),
                "out_proj": ("ff", "embed")}
    return {"in_proj": ("embed", "ff"), "conv_w": (None, "ff"),
            "conv_b": ("ff",), "dt_bias": ("heads",), "A_log": ("heads",),
            "D": ("heads",), "norm_w": ("ff",), "out_proj": ("ff", "embed")}


def mamba_params(cfg: ModelConfig, generator: torch.Generator,
                 device) -> Params:
    """One layer's weights with ``repro``'s ``mamba_params``
    distributions: N(0, 1/d_model) matrices, zero conv bias, then the
    S4-style overrides dt_bias = log(expm1(0.01)), D = 1, and A_log =
    log(1..N) (Mamba-1) or A_log = 0 and norm_w = 1 (Mamba-2)."""
    dtype = L.dt(cfg)
    out = {}
    std = 1.0 / math.sqrt(cfg.d_model)
    for name, shape in sorted(mamba_shapes(cfg).items()):
        if name == "A_log" and cfg.mamba_version == 1:
            a = torch.arange(1, shape[1] + 1, dtype=torch.float32,
                             device=device)
            out[name] = torch.log(a).expand(shape).to(dtype).contiguous()
        elif name == "A_log":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif name == "norm_w":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
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
    """h (f32) and the conv window (the working dtype)."""
    din, st, k = d_inner(cfg), cfg.ssm_state, cfg.ssm_conv
    if cfg.mamba_version == 1:
        return {"h": (batch, din, st), "conv": (batch, k - 1, din)}
    return {"h": (batch, mamba_heads(cfg), cfg.ssm_head_dim, st),
            "conv": (batch, k - 1, din + 2 * st)}


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


# ---------------------------------------------------------------------------
# Mamba-2: SSD (chunked matmul form)
# ---------------------------------------------------------------------------

def mamba2_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B,S,d). state: {"h": (B,H,P,N) f32, "conv": (B,K-1,din+2N)}."""
    b, s, _ = x.shape
    din, st = d_inner(cfg), cfg.ssm_state
    h_n, p_d = mamba_heads(cfg), cfg.ssm_head_dim
    proj = x @ params["in_proj"]
    z = proj[..., :din]
    xBC = proj[..., din:2 * din + 2 * st]
    dt_raw = proj[..., 2 * din + 2 * st:]
    conv_state = state["conv"] if state is not None else None
    xBC, new_conv = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                                 conv_state)
    xs = xBC[..., :din]
    Bc, Cc = xBC[..., din:din + st], xBC[..., din + st:]
    dt_v = F.softplus(dt_raw.float() + params["dt_bias"].float())  # (B,S,H)
    A = -torch.exp(params["A_log"].float())                         # (H,)
    xh = xs.reshape(b, s, h_n, p_d)
    if state is not None and s == 1:
        y, h = _ssd_step(xh, dt_v, Bc, Cc, A, params["D"], state["h"])
        y = y.reshape(b, 1, din).to(x.dtype)
    else:
        h0 = state["h"] if state is not None else None
        y, h = _ssd_chunks(xh, dt_v, Bc, Cc, A, params["D"], cfg, h0)
    new_state = {"h": h, "conv": new_conv} if state is not None else None
    y = _gated_rmsnorm(y, F.silu(z), params["norm_w"], cfg.norm_eps)
    return y @ params["out_proj"], new_state


def _ssd_step(xh, dt_v, Bc, Cc, A, D, h0):
    """One token: h = exp(dt A) h0 + (dt x) B^T, y = h C + D x.  xh:
    (B,1,H,P); dt_v: (B,1,H); Bc, Cc: (B,1,N); h0: (B,H,P,N) f32."""
    x0 = xh[:, 0].float()                                   # (B,H,P)
    da = torch.exp(dt_v[:, 0] * A[None])                    # (B,H)
    dbx = torch.einsum("bhp,bs->bhps", dt_v[:, 0, :, None] * x0,
                       Bc[:, 0].float())
    h = da[..., None, None] * h0 + dbx
    y = torch.einsum("bhps,bs->bhp", h, Cc[:, 0].float())
    return y + D.float()[None, :, None] * x0, h


def _gated_rmsnorm(y, gate, w, eps):
    orig = y.dtype
    y = y.float() * gate.float()
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(orig)


def _segsum(logd: torch.Tensor) -> torch.Tensor:
    """log decay(i<-j) = sum_{t=j+1..i} logd_t, lower-triangular (-inf
    above the diagonal)."""
    c = logd.shape[-1]
    cs = torch.cumsum(logd, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]              # (.., i, j)
    mask = torch.ones((c, c), dtype=torch.bool, device=logd.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def _ssd_chunks(xh, dt_v, Bc, Cc, A, D, cfg: ModelConfig,
                h0: Optional[torch.Tensor] = None):
    """The SSD over chunks of ``ssm_chunk`` positions (the last one may be
    shorter), carrying the f32 state between them: each chunk's output is
    its attention-like intra-chunk term plus the carried state's term.
    xh: (B,S,H,P); dt_v: (B,S,H) f32; Bc, Cc: (B,S,N).  Returns (y in xh's
    dtype (B,S,H*P), h_last (B,H,P,N) f32)."""
    b, s, h_n, p_d = xh.shape
    st = Bc.shape[-1]
    c = min(cfg.ssm_chunk, s)
    h = h0 if h0 is not None else torch.zeros(
        (b, h_n, p_d, st), dtype=torch.float32, device=xh.device)
    ys = []
    for lo in range(0, s, c):
        xk = xh[:, lo:lo + c].float()                       # (B,c,H,P)
        dtk = dt_v[:, lo:lo + c]                            # (B,c,H)
        Bk = Bc[:, lo:lo + c].float()                       # (B,c,N)
        Ck = Cc[:, lo:lo + c].float()
        logd_t = (dtk * A[None, None, :]).transpose(1, 2)   # (B,H,c)
        # intra-chunk: scores C_i . B_j decayed from j to i, times dt x
        cb = torch.einsum("bis,bjs->bij", Ck, Bk)           # (B,c,c)
        scores = cb[:, None] * torch.exp(_segsum(logd_t))   # (B,H,c,c)
        xdt = xk * dtk[..., None]                           # (B,c,H,P)
        y = torch.einsum("bhij,bjhp->bihp", scores, xdt)
        # inter-chunk: the carried state decayed to each position
        dcum = torch.cumsum(logd_t, dim=-1)                 # (B,H,c)
        y = y + torch.einsum("bihs,bhps->bihp",
                             Ck[:, :, None, :]
                             * torch.exp(dcum).transpose(1, 2)[..., None], h)
        # the new carried state
        dlast = dcum[..., -1:]                              # (B,H,1)
        w_state = torch.exp(dlast - dcum).transpose(1, 2)   # (B,c,H)
        hk = torch.einsum("bjhp,bjs->bhps", xdt * w_state[..., None], Bk)
        h = h * torch.exp(dlast)[..., None] + hk
        ys.append(y)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + D.float()[None, None, :, None] * xh.float()
    return y.reshape(b, s, h_n * p_d).to(xh.dtype), h


def mamba_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[Dict[str, torch.Tensor]] = None):
    if cfg.mamba_version == 1:
        return mamba1_forward(params, x, cfg, state)
    return mamba2_forward(params, x, cfg, state)
