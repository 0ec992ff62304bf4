# repro-lint: allow(RL004) -- one launch shape (CHANNELS), compiled in
"""Launchers of the CUDA selective-scan kernels (``csrc/ssm_scan.cu``, K6,
and ``csrc/ssm_scan_bwd.cu``, its gradient, K6b).

K6 ``ssm_scan_cuda`` replaces ``ssm_scan_pallas``
(``repro/kernels/ssm_scan/kernel.py``).  K6b ``ssm_scan_bwd_cuda`` has no
TPU counterpart (``repro`` differentiates its jnp scan with
``jax.grad``): it takes K6's inputs, the states K6 wrote at the start of
each of its tiles (``ssm_scan_cuda(..., states=True)``) and the gradients
of y and h_last, and returns the inputs' gradients in two launches (the
scan, in clusters of ``BWD_CLUSTER`` blocks, then the sums across
clusters).  The design notes sit in the CUDA sources.  Outputs and
scratch are allocated here with ``torch.empty``; the kernels launch on
the current stream and do not synchronise.  K6 has no run-time launch
shape: the shared-memory tile layout of ``csrc/ssm_scan.cu`` fixes its
block of channels, ``CHANNELS``, autotune's one ``ssm_scan`` candidate,
so there is nothing to resolve through ``autotune.tiles_for`` (hence the
RL004 pragma above).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_STATE = 32          # the kernel's shared-memory tiles hold 32 states
CHANNELS = 32           # K6's channels a block (kChannels in csrc/ssm_scan.cu)
# the tile of positions of K6 and K6b (kTile in csrc/ssm_scan.cu and
# csrc/ssm_scan_bwd.cu): K6 writes the state at each tile's start, K6b
# starts each tile from it
STATE_TILE = 128
# K6b's block of channels and cluster of blocks (kChannels, kCluster in
# csrc/ssm_scan_bwd.cu), which size its scratch
BWD_CHANNELS = 32
BWD_CLUSTER = 8


def _check(name: str, x, dt, B, C, A, D, h0) -> None:
    """The inputs K6 and K6b take: one CUDA device, contiguous, x, B, C
    and D in one of ``_DTYPES``, dt, A and h0 f32, matching shapes, 1 <= N
    <= ``MAX_STATE``, Bb <= 65535, nothing empty; else ``ValueError``."""
    tensors = [x, dt, B, C, A, D] + ([] if h0 is None else [h0])
    dev = x.device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expects tensors on one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (B, C, D)):
        raise ValueError(f"{name}: x, B, C, D must share one of "
                         f"{list(_DTYPES)}, got {x.dtype}, {B.dtype}, "
                         f"{C.dtype}, {D.dtype}")
    if any(t.dtype != torch.float32 for t in [dt, A] + tensors[6:]):
        raise ValueError(f"{name}: dt, A and h0 must be float32")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (Bb, L, Din), got {x.shape}")
    bb, l, din = x.shape
    n = A.shape[-1]
    if dt.shape != x.shape or B.shape != (bb, l, n) or C.shape != B.shape \
            or A.shape != (din, n) or D.shape != (din,) \
            or (h0 is not None and h0.shape != (bb, din, n)):
        raise ValueError(f"{name}: mismatched shapes")
    if not 1 <= n <= MAX_STATE or bb > 65535:
        raise ValueError(f"{name}: takes 1 <= N <= {MAX_STATE} and "
                         f"Bb <= 65535, got N={n}, Bb={bb}")
    if not x.numel():
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                  h0: Optional[torch.Tensor] = None, states: bool = False):
    """x: (Bb,L,Din); dt: (Bb,L,Din) f32; B, C: (Bb,L,N); A: (Din,N) f32;
    D: (Din,); h0: (Bb,Din,N) f32 or None.  x, B, C and D share one
    dtype (f32, bf16 or f16).  -> (y (Bb,L,Din) x.dtype, h_last f32), and
    with ``states`` the state at the start of each ``STATE_TILE``-position
    tile, (Bb, ceil(L / STATE_TILE), N, Din) f32 (h0 first), as a third
    output: what ``ssm_scan_bwd_cuda`` starts its tiles from.  y and
    h_last are the same bits either way."""
    _check("ssm_scan", x, dt, B, C, A, D, h0)
    bb, l, din = x.shape
    n = A.shape[-1]
    dev = x.device
    y = torch.empty_like(x)
    h_last = torch.empty((bb, din, n), dtype=torch.float32, device=dev)
    hs = torch.empty((bb, -(-l // STATE_TILE), n, din), dtype=torch.float32,
                     device=dev) if states else None
    build.launch("ssm_scan_launch", x.data_ptr(), dt.data_ptr(),
                 B.data_ptr(), C.data_ptr(), A.data_ptr(), D.data_ptr(),
                 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), 0 if hs is None else hs.data_ptr(), bb, l,
                 din, n, _DTYPES[x.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    return (y, h_last, hs) if states else (y, h_last)


def ssm_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                      h0: Optional[torch.Tensor], dy: Optional[torch.Tensor],
                      dh_last: Optional[torch.Tensor], states: torch.Tensor):
    """K6b: the gradients (dx, ddt, dB, dC, dA, dD, dh0) of
    ``ssm_scan_cuda`` at its inputs, from dy (Bb,L,Din) in x's dtype and
    dh_last (Bb,Din,N) f32 (either None: zeros), with ``states`` the tile
    start states ``ssm_scan_cuda(..., h0, states=True)`` returned on the
    same inputs.  dx, dB, dC, dD in x's dtype; ddt, dA, dh0 f32; dh0 is
    None when h0 is."""
    _check("ssm_scan backward", x, dt, B, C, A, D, h0)
    bb, l, din = x.shape
    n = A.shape[-1]
    dev = x.device
    if dy is None:
        dy = torch.zeros_like(x)
    dy = dy.contiguous()
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != dev:
        raise ValueError(f"ssm_scan backward: dy must be {x.dtype} "
                         f"{tuple(x.shape)} on {dev}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    if dh_last is not None:
        dh_last = dh_last.contiguous()
        if dh_last.shape != (bb, din, n) or dh_last.dtype != torch.float32 \
                or dh_last.device != dev:
            raise ValueError(f"ssm_scan backward: dh_last must be f32 "
                             f"{(bb, din, n)} on {dev}")
    tiles = -(-l // STATE_TILE)
    if states.shape != (bb, tiles, n, din) or states.dtype != torch.float32 \
            or states.device != dev or not states.is_contiguous():
        raise ValueError(f"ssm_scan backward: states must be contiguous f32 "
                         f"{(bb, tiles, n, din)} on {dev} (ssm_scan_cuda's "
                         f"with states=True)")
    dx, dB, dC, dD = (torch.empty_like(t) for t in (x, B, C, D))
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dh0 = None if h0 is None else torch.empty_like(h0)
    clusters = -(-din // (BWD_CHANNELS * BWD_CLUSTER))
    floats = bb * (2 * clusters * l * n + din * n + din)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    build.launch("ssm_scan_bwd_launch", x.data_ptr(), dt.data_ptr(),
                 B.data_ptr(), C.data_ptr(), A.data_ptr(), D.data_ptr(),
                 states.data_ptr(), dy.data_ptr(),
                 0 if dh_last is None else dh_last.data_ptr(), dx.data_ptr(),
                 ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
                 dD.data_ptr(), 0 if dh0 is None else dh0.data_ptr(),
                 scratch.data_ptr(), floats, bb, l, din, n, _DTYPES[x.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    return dx, ddt, dB, dC, dA, dD, dh0


def bwd_occupancy(n: int, dtype: torch.dtype) -> dict:
    """K6b's scan kernel at N = ``n`` states in ``dtype``, as the card
    runs it: resident blocks and warps an SM, clusters the card holds at
    once, registers and local (spilled) bytes a thread, shared memory a
    block."""
    import ctypes
    out = (ctypes.c_int * 6)()
    build.launch("ssm_scan_bwd_occupancy", n, _DTYPES[dtype],
                 ctypes.addressof(out))
    blocks, clusters, regs, local, smem, threads = list(out)
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "clusters": clusters, "registers": regs, "local_bytes": local,
            "smem_bytes": smem, "threads": threads}
