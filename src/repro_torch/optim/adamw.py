"""AdamW + global-norm clipping + warmup-cosine schedule of the port
(``repro.optim.adamw``) on trees of torch tensors.

``apply_updates`` updates the parameters and the moments IN PLACE, under
``torch.no_grad()`` (``repro`` returns fresh trees; the port saves the
copies, the largest allocation of a step): the update of each element is
``repro``'s f32 arithmetic, cast back to the parameter's dtype, with no
weight decay on leaves of fewer than two dimensions.  The leaves stacked
on a layer axis are updated a layer at a time (``torch._foreach_*`` over
every leaf's slice of that layer), and a tensor of more than ``_PIECE``
values (a layer's stacked experts, the embedding) in pieces of its
leading axis, one after another, so the f32 temporaries stay a piece's
size: 0.27 GB each, where one layer's w1 of qwen3-moe's experts would
make 3.2 GB.  Every element sees the same operations in the same order, so
the pieces change no bit of the result.  The step count, learning rate
and clip scale live on the device: a step reads nothing back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

Params = Any
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
# the most values of one tensor that an update group holds (2^26: each
# f32 temporary of a piece is 256 MiB)
_PIECE = 1 << 26


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree in ``jax.tree.leaves``' order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warm-up to
    ``peak_lr``, then a cosine decay to ``end_lr_frac * peak_lr`` at
    ``total_steps``."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.end_lr_frac + (1 - cfg.end_lr_frac)
                         * 0.5 * (1.0 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params: Params, cfg: OptConfig) -> Dict[str, Any]:
    """``{"m", "v", "step"}``: zero moments in ``cfg.moment_dtype`` beside
    each leaf, and a 0-dim int32 step count on the parameters' device."""
    mdt = _DTYPES[cfg.moment_dtype]

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=mdt, device=tree.device)

    dev = leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares
    (taken as its squared f32 norm, with no f32 copy of the leaf)."""
    sq = [torch.linalg.vector_norm(x, dtype=torch.float32).square()
          for x in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def _groups(*trees) -> List[Tuple[List[bool], ...]]:
    """Parallel trees (params first) cut into update groups: each leaf
    outside ``layers`` alone, then for each layer its slice of every
    stacked leaf.  A group is (weight-decay flags, then a list of matching
    tensors a tree); a leaf decays where it has two dimensions or more
    (a stacked leaf always has), as ``repro`` decides on whole leaves.
    Tensors of more than ``_PIECE`` values are cut (``_cut``)."""
    def split(tree):
        if isinstance(tree, dict) and "layers" in tree:
            rest = {k: v for k, v in tree.items() if k != "layers"}
            return leaves(rest), leaves(tree["layers"])
        return leaves(tree), []

    parts = [split(t) for t in trees]
    groups = [([p.dim() >= 2],) + tuple([part[0][i]] for part in parts)
              for i, p in enumerate(parts[0][0])]
    stacked = parts[0][1]
    for layer in range(stacked[0].shape[0] if stacked else 0):
        groups.append(([True] * len(stacked),)
                      + tuple([x[layer] for x in part[1]] for part in parts))
    return [piece for group in groups for piece in _cut(group)]


def _cut(group: Tuple[List, ...]) -> List[Tuple[List, ...]]:
    """A group with every tensor of more than ``_PIECE`` values moved out
    into groups of one piece each: views of at most ``_PIECE`` values
    (or one row of the leading axis) cut along that axis."""
    decay, *trees = group
    big = [i for i, p in enumerate(trees[0]) if p.numel() > _PIECE]
    if not big:
        return [group]
    small = [i for i in range(len(decay)) if i not in big]
    out = [([decay[i] for i in small],) + tuple([t[i] for i in small]
                                                 for t in trees)] \
        if small else []
    for i in big:
        rows = max(1, _PIECE // (trees[0][i].numel() // trees[0][i].shape[0]))
        for views in zip(*(t[i].split(rows) for t in trees)):
            out.append(([decay[i]],) + tuple([v] for v in views))
    return out


@torch.no_grad()
def apply_updates(params: Params, grads: Params, state: Dict[str, Any],
                  cfg: OptConfig) -> Tuple[Params, Dict[str, Any],
                                           Dict[str, torch.Tensor]]:
    """One AdamW step, in place; returns (params, state, {"grad_norm",
    "lr"}): the same trees, and 0-dim device tensors."""
    state["step"] += 1
    step = state["step"].to(torch.float32)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, state["step"])
    bc1 = 1.0 - torch.pow(cfg.b1, step)
    bc2 = 1.0 - torch.pow(cfg.b2, step)
    for decay, ps, gs, ms, vs in _groups(params, grads, state["m"],
                                         state["v"]):
        g = [x.float() * scale for x in gs]
        m32 = [x.float() for x in ms]           # the moments themselves in f32
        v32 = [x.float() for x in vs]
        torch._foreach_mul_(m32, cfg.b1)
        torch._foreach_add_(m32, torch._foreach_mul(g, 1 - cfg.b1))
        torch._foreach_mul_(v32, cfg.b2)
        torch._foreach_add_(v32, torch._foreach_mul(
            torch._foreach_mul(g, 1 - cfg.b2), g))
        delta = torch._foreach_div(m32, bc1)
        vhat = torch._foreach_div(v32, bc2)
        torch._foreach_sqrt_(vhat)
        torch._foreach_add_(vhat, cfg.eps)
        torch._foreach_div_(delta, vhat)
        del g, vhat
        p32 = [x.float() for x in ps]
        for d, p, wd in zip(delta, p32, decay):
            if wd:
                d.add_(p * cfg.weight_decay)
        p32 = torch._foreach_sub(p32, torch._foreach_mul(delta, lr))
        torch._foreach_copy_(ps, p32)
        if m32[0] is not ms[0]:                 # moments below f32
            torch._foreach_copy_(ms, m32)
            torch._foreach_copy_(vs, v32)
    return params, state, {"grad_norm": gnorm, "lr": lr}
