"""Launcher of the CUDA EDRA-tree kernel (``csrc/edra_tree.cu``).

K4 ``edra_tree_cuda`` replaces ``edra_tree_pallas``
(``repro/kernels/edra_tree/kernel.py``); the design notes sit in the
CUDA source.  The float constants are rounded to float32 here exactly
as ``tree_math`` rounds them, and the phase key travels as a uint32.
Outputs are allocated with ``torch.empty`` unless ``out=`` hands in
five tensors to write (a caller filling slices of larger buffers); the
kernel launches on the current stream and does not synchronise.  The
grid, ``grid_waves`` waves of resident blocks, comes from
``autotune.tiles_for`` or from ``tiles=`` (a search's candidate).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import build
from ..autotune import tiles_for
from .ref import f32, phase_key

_IN_TYPES = (torch.int32, torch.int32, torch.int32, torch.float32, torch.int32)
_OUT_TYPES = (torch.float32, torch.int32, torch.int32, torch.int32,
              torch.int32)


def _check(what: str, tensors: Sequence[torch.Tensor], dtypes, p: int,
           dev: torch.device) -> None:
    for t, dtype in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"edra_tree: expects {what} on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if t.dtype != dtype or not t.is_contiguous() or t.shape != (p,):
            raise ValueError(
                f"edra_tree: expects contiguous (P,) {what} of types "
                f"{[str(d) for d in dtypes]}, got "
                f"{[(str(x.dtype), tuple(x.shape)) for x in tensors]}")


def edra_tree_cuda(offset: torch.Tensor, n: torch.Tensor,
                   reporter: torch.Tensor, t_detect: torch.Tensor,
                   event_key: torch.Tensor, *, levels: int, theta: float,
                   delta_avg: float, seed: int = 0, fill_rate: float = 0.0,
                   e_cap: float = 2.0,
                   out: Optional[Sequence[torch.Tensor]] = None,
                   tiles: Optional[dict] = None):
    """(P,) int32 offsets/ring sizes/reporters/event keys (uint32 bits,
    every n >= 1) + (P,) f32 detection times -> (ack f32, ttl i32,
    depth i32, parent i32 holding uint32 bits, sends i32), each (P,)."""
    ins = (offset, n, reporter, t_detect, event_key)
    dev = offset.device
    if dev.type != "cuda":
        raise ValueError(f"edra_tree: expects CUDA tensors, got {dev}")
    p = offset.numel()
    _check("inputs", ins, _IN_TYPES, p, dev)
    if not 1 <= levels <= 32:
        raise ValueError(f"edra_tree: levels {levels} not in [1, 32]")
    if out is None:
        out = tuple(torch.empty(p, dtype=d, device=dev) for d in _OUT_TYPES)
    else:
        out = tuple(out)
        if len(out) != 5:
            raise ValueError("edra_tree: out= takes five tensors")
        _check("outputs", out, _OUT_TYPES, p, dev)
    if not p:
        return out
    if tiles is None:
        tiles = tiles_for("edra_tree", dev, p=p)
    variant = 0 if theta <= 0.0 else 2 if fill_rate > 0.0 else 1
    build.launch(
        "edra_tree_launch", *(t.data_ptr() for t in ins),
        *(t.data_ptr() for t in out), p, levels, variant, f32(theta),
        f32(1.0 / theta) if theta > 0.0 else 0.0, f32(fill_rate * theta),
        f32(e_cap - 1.0), f32(1.0 / fill_rate) if fill_rate > 0.0 else 0.0,
        f32(delta_avg), phase_key(seed), tiles["grid_waves"],
        torch.cuda.current_stream(dev).cuda_stream)
    return out
