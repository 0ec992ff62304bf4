"""Plain PyTorch version of the EDRA-tree math (K4).

A torch-only copy of ``repro.kernels.edra_tree.ref.tree_math``: per
(event, observer) pair, the acknowledge TTL, hop depth, tree parent,
Rule-8 fan-out and the absolute acknowledge time along the ancestor
chain (hash-derived interval phases and exponential edge delays, Eq
IV.4 early close when ``fill_rate > 0``).  The CPU tests use it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.

uint32 arithmetic is the definition.  Torch has no uint32 arithmetic,
so every word is held as int64 in [0, 2^32) and masked with
``0xFFFFFFFF`` after each ``+``, ``-``, ``*`` and ``<<``; right shifts
of such values are logical.  A product of two 32-bit words would pass
2^63, so ``_mul32`` splits the constant into 16-bit halves.  Float
steps run in float32 with constants rounded to float32 on the host
exactly as ``tree_math`` rounds them, one rounding per operation.

Ids travel as int32 tensors holding the uint32 bits, as in the ring
lookups; ``parent`` comes back the same way.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_PHI = 0x9E3779B9
_M1 = 0x7FEB352D
_M2 = 0x846CA68B


def _u32(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int64) & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 holding the same uint32 bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32): both partial products stay
    below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer: uint32 -> well-mixed uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _h2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-word hash; ``a`` is the stream key, ``b`` the counter."""
    return _mix(a ^ _mul32(b, _PHI))


def _u01(h: torch.Tensor) -> torch.Tensor:
    """uint32 hash -> float32 uniform in (0, 1): 24 high bits + half-ulp."""
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32) -> int32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((_mul32(x, 0x01010101)) >> 24).to(torch.int32)


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exactly representable
    in float32, so torch and the CUDA kernel see the same constant)."""
    return float(np.float32(x))


def phase_key(seed: int) -> int:
    """The interval-phase stream key of ``tree_math`` (a uint32)."""
    return (seed * 0x9E3779B1 + 0x165667B1) & _M32


def tree_math(offset: torch.Tensor, n: torch.Tensor, reporter: torch.Tensor,
              t_detect: torch.Tensor, event_key: torch.Tensor, *,
              levels: int, theta: float, delta_avg: float, seed: int = 0,
              fill_rate: float = 0.0, e_cap: float = 2.0):
    """offset/n/reporter/event_key: (P,) int32 holding uint32 bits;
    t_detect: (P,) float32.  Returns (ack f32, ttl i32, depth i32,
    parent i32 holding uint32 bits, sends i32), each (P,)."""
    offset, n = _u32(offset), _u32(n)
    reporter, event_key = _u32(reporter), _u32(event_key)

    # rho(n) = ceil(log2 n) via bit-smear of n-1 (exact for n >= 2)
    s = (n - 1) & _M32
    for sh in (1, 2, 4, 8, 16):
        s = s | (s >> sh)
    rho_n = popcount32(s)
    lsb = offset & ((0 - offset) & _M32)
    ttl = torch.where(offset == 0, rho_n, popcount32((lsb - 1) & _M32))
    depth = popcount32(offset)
    parent = offset & ((offset - 1) & _M32)

    key = torch.full_like(offset, phase_key(seed))
    theta_f, inv_theta = f32(theta), f32(1.0 / theta) if theta > 0 else 0.0
    e_buf = f32(fill_rate * theta)
    e_cap_m1 = f32(e_cap - 1.0)
    inv_fill = f32(1.0 / fill_rate) if fill_rate > 0 else 0.0
    delta = f32(delta_avg)
    t = t_detect.to(torch.float32)
    cur = torch.zeros_like(offset)
    for b in reversed(range(levels)):
        bit = ((offset >> b) & 1) != 0
        sender = ((reporter + cur) & _M32) % n
        nxt = cur | (1 << b)
        h = _h2(event_key, nxt)            # per-(event, edge) stream
        if theta > 0.0:
            # sender forwards at its next interval boundary (Rules 1-4);
            # the 1e-5 nudge keeps a flush-instant ack in the NEXT interval
            ph = _u01(_h2(key, sender)) * theta_f
            flush = ph + torch.ceil((t - ph) * inv_theta + f32(1e-5)) * theta_f
            if fill_rate > 0.0:            # Eq IV.4 early close
                u = 1.0 - (flush - t) * inv_theta
                u = torch.clamp(u, 0.0, 1.0)
                mean_b = u * e_buf
                z = (_u01(_mix(h ^ 0xB5297A4D)) + _u01(_mix(h ^ 0x68E31DA4))
                     + _u01(_mix(h ^ 0x1B56C4E9)) - 1.5) * 2.0
                buffered = mean_b + torch.sqrt(mean_b) * z
                need = torch.clamp(e_cap_m1 - buffered, min=0.0)
                flush = torch.minimum(flush, t + need * inv_fill)
        else:
            flush = t                      # unbuffered (1h-Calot)
        dly = -torch.log(_u01(h)) * delta
        t = torch.where(bit, flush + dly, t)
        cur = torch.where(bit, nxt, cur)

    sends = torch.zeros_like(depth)
    for l in range(levels):
        fits = ((offset + (1 << l)) & _M32) < n         # Rule 8
        sends = sends + ((l < ttl) & fits).to(torch.int32)
    return t, ttl, depth, _i32(parent), sends
