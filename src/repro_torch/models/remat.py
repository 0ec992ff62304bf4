"""Training helpers shared by every family of the port: the remat policy
(``repro``'s ``jax.checkpoint`` modes on ``torch.utils.checkpoint``) and
the split of a tree of stacked layer weights into its layers."""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..sharding import specs as sh

Params = Dict[str, Any]

# the products whose outputs remat="dots" keeps: ``repro``'s
# checkpoint_dots_with_no_batch_dims keeps the outputs of the dots without
# batch dimensions, which are the 2-D products here (not the experts' bmm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg: ModelConfig, fn, mode: Optional[str] = None):
    """``fn`` under ``mode`` (``cfg.remat`` by default): ``"none"`` as it
    is, ``"full"`` recomputed in the backward from its inputs, ``"dots"``
    recomputed but for the matrix products' outputs.  Outside autograd it
    runs as it is.  The recomputation runs under the forward's mesh and
    rules (``specs.snapshot``): on the card the backward runs in the
    autograd engine's own thread, which does not see the caller's
    thread-local mesh."""
    mode = cfg.remat if mode is None else mode
    if mode not in ("none", "dots", "full"):
        raise ValueError(f"remat={mode!r}: takes none, dots or full")
    if mode == "none":
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        state = sh.snapshot()

        def contexts():
            fwd, rec = create_selective_checkpoint_contexts(_save_dots) \
                if mode == "dots" else (contextlib.nullcontext(),
                                             contextlib.nullcontext())
            return fwd, _both(rec, sh.installed(state))
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=contexts)
    return wrapped


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def layer_slices(stacked: Params, n: int) -> List[Params]:
    """The ``n`` per-layer trees of a tree of stacked leaves, one
    ``unbind`` a leaf (its backward stacks the layers' gradients into one
    gradient of the stacked leaf)."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            return [{k: p[i] for k, p in parts.items()} for i in range(n)]
        return tree.unbind(0)
    return list(split(stacked))
