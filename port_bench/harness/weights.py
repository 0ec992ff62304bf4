"""Random weights from the seed, made on the device in the type they are
served in, one call a leaf (each stacked over the layers), in the layout
of the port's parameter tree.

The benchmark makes them and hands the same tensors to the port and to
the reference; neither changes them.  Matrices are N(0, 1 / fan_in) with
fan_in the leaf's second-to-last axis, the embedding N(0, 1), norm scales
one.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch


def leaves(tree: Dict[str, Any], path: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v


def std_of(path: Tuple[str, ...], shape) -> float:
    name = path[-1]
    if name == "embedding":
        return 1.0
    return float(shape[-2]) ** -0.5


def make_weights(shapes: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """``shapes``: the port's parameter tree as ``meta`` tensors
    (``Model.abstract_params()``); returns the same tree on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    out: Dict[str, Any] = {}
    for path, meta in leaves(shapes):
        if path[-1].startswith("ln"):
            t = torch.ones(meta.shape, dtype=meta.dtype, device=device)
        else:
            t = torch.randn(meta.shape, dtype=meta.dtype, generator=gen,
                            device=device)
            t.mul_(std_of(path, meta.shape))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def nbytes(tree: Dict[str, Any]) -> int:
    return sum(t.numel() * t.element_size() for _, t in leaves(tree))
