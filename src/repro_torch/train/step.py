"""Training / prefill / decode step functions of the port
(``repro.train.step``).

``make_train_step`` returns (params, opt_state, batch) -> (params,
opt_state, metrics) with:
  * optional gradient-accumulation microbatching: the batch cut into
    ``microbatches`` equal slices on its leading axis, each slice's
    gradients added into f32 accumulators, loss and gradients divided by
    the count, as ``repro``'s scan does;
  * AdamW + clipping from ``optim.adamw``, applied in place;
  * the optional int8 gradient compression (quantize and dequantize each
    leaf with its own scale).
One card and no mesh: ``repro``'s ``constrain_to_params`` (a sharding
constraint on the gradients) is the identity here.  The gradients come
from ``torch.autograd.grad`` of ``Model.train_loss`` at leaves that share
the parameters' storage; metrics are 0-dim device tensors, so a step
reads nothing back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..models import Model
from ..optim.adamw import OptConfig, apply_updates, init_state, leaves


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1            # grad-accumulation splits
    grad_compression: str = "none"   # none | int8


def _unflatten(tree, flat: List[torch.Tensor]):
    """``flat`` (``leaves``' order) in ``tree``'s structure."""
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(tree)


def _quantize_grads(grads):
    """int8 symmetric quantization with a scale a leaf, dequantized right
    away (f32), as ``repro``'s ``_quantize_grads``."""
    def q(g):
        scale = (torch.max(torch.abs(g)) + 1e-12) / 127.0
        qi = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return qi.to(torch.float32) * scale
    return _unflatten(grads, [q(g) for g in leaves(grads)])


def _value_and_grad(model: Model, params, batch) -> Tuple[torch.Tensor, Any]:
    """(loss, gradient tree) of ``model.train_loss`` at ``params``."""
    flat = leaves(params)
    bad = [t.dtype for t in flat if not t.is_floating_point()]
    if bad:
        raise ValueError(f"train_step: parameters of {bad} take no gradient "
                         f"(int8 experts are a serving quantization)")
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in flat]
        loss = model.train_loss(_unflatten(params, xs), batch)
        grads = torch.autograd.grad(loss, xs)
    return loss.detach(), _unflatten(params, list(grads))


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    if tcfg.grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression={tcfg.grad_compression!r}: takes "
                         f"none or int8")

    def accumulated_grads(params, batch):
        n = tcfg.microbatches
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch[{k!r}] of {v.shape[0]} rows does not "
                                 f"split into {n} microbatches")
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
        acc = None
        for i in range(n):
            micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                     for k, v in batch.items()}
            loss, grads = _value_and_grad(model, params, micro)
            if acc is None:
                acc = [torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device) for g in leaves(grads)]
            torch._foreach_add_(acc, [g.float() for g in leaves(grads)])
            loss_sum = loss_sum + loss
            del grads
        torch._foreach_div_(acc, float(n))
        return loss_sum / n, _unflatten(params, acc)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if tcfg.microbatches > 1:
            loss, grads = accumulated_grads(params, batch)
        else:
            loss, grads = _value_and_grad(model, params, batch)
        if tcfg.grad_compression == "int8":
            grads = _quantize_grads(grads)
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   tcfg.opt)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def serve_step(params, cache, tokens, index):
        return model.decode_step(params, cache, tokens, index)
    return serve_step


def init_train_state(model: Model, generator, tcfg: TrainConfig, *,
                     device=None):
    """Random weights (``Model.init``) and a fresh AdamW state."""
    params = model.init(generator, device=device)
    return params, init_state(params, tcfg.opt)
