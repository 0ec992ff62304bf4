"""Public EDRA-tree wrapper: CPU tensors take the plain version, CUDA
tensors launch the CUDA kernel (or raise).  ``edra_tree.launches``
counts kernel launches, so a run can show its main path went through
the kernel, and ``edra_tree.pairs`` the pairs those launches took."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .kernel import edra_tree_cuda
from .ref import tree_math


def edra_tree(offset: torch.Tensor, n: torch.Tensor, reporter: torch.Tensor,
              t_detect: torch.Tensor, event_key: torch.Tensor, *,
              levels: int, theta: float, delta_avg: float, seed: int = 0,
              fill_rate: float = 0.0, e_cap: float = 2.0,
              out: Optional[Sequence[torch.Tensor]] = None):
    """(P,) int32 offsets/ring sizes/reporters/event keys (uint32 bits)
    + (P,) f32 detection times -> (ack f32, ttl i32, depth i32, parent
    i32 holding uint32 bits, sends i32), each (P,) (K4).  ``out=`` takes
    five (P,) tensors to write into.  See ``ref.tree_math`` for the
    semantics; ``fill_rate``/``e_cap`` arm the Eq IV.4 early close."""
    kw = dict(levels=levels, theta=theta, delta_avg=delta_avg, seed=seed,
              fill_rate=fill_rate, e_cap=e_cap)
    if offset.device.type == "cpu":
        res = tree_math(offset, n, reporter, t_detect, event_key, **kw)
        if out is None:
            return res
        for dst, src in zip(out, res):
            dst.copy_(src)
        return tuple(out)
    res = edra_tree_cuda(offset, n, reporter, t_detect, event_key, out=out,
                         **kw)
    if offset.numel():
        edra_tree.launches += 1
        edra_tree.pairs += offset.numel()
    return res


edra_tree.launches = 0
edra_tree.pairs = 0
