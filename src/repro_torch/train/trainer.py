"""Training loop with membership-driven fault tolerance (the port's
``repro.train.trainer``).

Wires together: data pipeline -> train step -> AdamW, checkpoint cadence
(``FailoverManager``), a restore on membership events, and step-time
heartbeats into the ``ElasticController`` (Rule 5 generalized).  One
card and no mesh: ``model_axis`` only shapes the controller's plan.
Each batch goes to the card from pinned host memory without blocking the
host, and the metrics are read back (``float``) only on logged steps, so
a step does not wait for the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..kernels.backend import resolve_device
from ..models import Model
from ..optim import adamw
from ..runtime import (ElasticController, FailoverConfig, FailoverManager,
                       Membership)
from .step import TrainConfig, make_train_step


@dataclass
class TrainerConfig:
    steps: int = 200
    log_every: int = 10
    train: TrainConfig = field(default_factory=TrainConfig)
    failover: Optional[FailoverConfig] = None


class Trainer:
    def __init__(self, model: Model, cfg: TrainerConfig, *,
                 membership: Optional[Membership] = None,
                 model_axis: int = 1, device=None):
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step_fn = make_train_step(model, cfg.train)
        self.membership = membership
        self.controller = (ElasticController(membership,
                                             model_axis=model_axis)
                           if membership else None)
        self.failover = (FailoverManager(cfg.failover, self.controller)
                         if (cfg.failover and self.controller) else None)
        self.history: List[Dict[str, float]] = []

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> tuple:
        """Random weights on the trainer's device and a fresh AdamW state."""
        params = self.model.init(generator, device=self.device)
        opt = adamw.init_state(params, self.cfg.train.opt)
        return params, opt

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def fit(self, state: tuple, data: Iterator[Dict[str, np.ndarray]],
            start_step: int = 0) -> tuple:
        params, opt = state
        step = start_step
        for batch in data:
            if step >= self.cfg.steps:
                break
            t0 = time.perf_counter()
            params, opt, metrics = self.step_fn(params, opt,
                                                self._to_device(batch))
            dt = time.perf_counter() - t0
            step += 1

            if self.controller is not None:
                self.controller.heartbeat(0, dt)
            if self.failover is not None:
                self.failover.maybe_save(step, {"params": params, "opt": opt})
                if self.failover.needs_restore():
                    step, restored = self.failover.restore_latest(
                        {"params": params, "opt": opt})
                    params, opt = restored["params"], restored["opt"]

            if step % self.cfg.log_every == 0 or step == 1:
                rec = {"step": step,
                       "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "lr": float(metrics["lr"]),
                       "step_time_s": dt}
                self.history.append(rec)
        return params, opt
