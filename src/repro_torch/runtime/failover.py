"""Checkpoint/restart bound to membership generations, and replica
restarts on them (the port's ``repro.runtime.failover``).

``FailoverManager``: the trainer saves a checkpoint every
``save_every_steps`` steps (``ckpt``, keeping the last ``keep_last``);
on a membership event the ``ElasticController`` bumps its generation,
``needs_restore`` turns true, and the trainer restores the latest
complete checkpoint onto its own devices and resumes from its step.

``ReplicaSupervisor`` is the serve-plane counterpart, with its registry
of tensor-parallel replica groups: instead of checkpoints it tracks
per-node membership generations, so the serve cluster knows when a
node's device-resident state (KV slabs) must be treated as lost and its
replica restarted rather than resumed.
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Any, Dict, Optional

from .. import ckpt as ckpt_lib
from .elastic import ElasticController
from .membership import Membership


@dataclass
class FailoverConfig:
    ckpt_dir: str
    save_every_steps: int = 100
    keep_last: int = 3


class FailoverManager:
    def __init__(self, cfg: FailoverConfig, controller: ElasticController):
        self.cfg = cfg
        self.controller = controller
        self._seen_generation = controller.generation
        os.makedirs(cfg.ckpt_dir, exist_ok=True)

    # -- checkpoint cadence ---------------------------------------------------
    def maybe_save(self, step: int, state: Any) -> Optional[str]:
        if step % self.cfg.save_every_steps:
            return None
        path = ckpt_lib.save(self.cfg.ckpt_dir, step, state)
        self._gc()
        return path

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_", 1)[1]) for d in os.listdir(self.cfg.ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.cfg.keep_last]:
            shutil.rmtree(os.path.join(self.cfg.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restart path -----------------------------------------------------------
    def needs_restore(self) -> bool:
        return self.controller.generation != self._seen_generation

    def restore_latest(self, target_state: Any) -> tuple[int, Any]:
        """(step, state) of the latest complete checkpoint, each leaf on
        its target's device and in its dtype."""
        step = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if step is None:
            raise FileNotFoundError("no checkpoint to restore")
        state = ckpt_lib.restore(self.cfg.ckpt_dir, step, target_state)
        self._seen_generation = self.controller.generation
        return step, state


class ReplicaSupervisor:
    """Membership-generation clock for serving replicas.

    Every membership event bumps the global generation.  A node that
    leaves (crash/preemption) or is quarantined has its *required*
    generation pinned to the bump, so a replica stamped before that point
    — i.e. whose device state predates the departure — must be restarted
    with a fresh cache if the node ever re-enters the ring; its sessions
    were already migrated off by the serve cluster and must re-prefill,
    never resume against a stale slab.
    """

    def __init__(self, membership: Membership):
        self.generation = 0
        self._required: Dict[int, int] = {}
        self.membership = membership
        # node id -> device ids of its replica group (tensor-parallel
        # serving: one ring node spans a group of devices; see models.tp)
        self._groups: Dict[int, tuple] = {}
        membership.subscribe(self._on_event)

    def _on_event(self, ev) -> None:
        self.generation += 1
        if ev.kind != "join":              # leave/quarantine invalidates
            self._required[ev.subject_id] = self.generation

    def stamp(self) -> int:
        """Generation to tag a freshly created replica with."""
        return self.generation

    def needs_restart(self, node_id: int, stamp: int) -> bool:
        """True iff the node suffered an event since ``stamp`` that
        invalidates device state created under it."""
        return stamp < self._required.get(node_id, 0)

    # -- replica groups (tensor-parallel serving) ---------------------------
    def register_group(self, node_id: int, device_ids) -> None:
        """Bind a ring node to the devices of its TP replica group."""
        self._groups[node_id] = tuple(device_ids)

    def release_group(self, node_id: int) -> None:
        self._groups.pop(node_id, None)

    def group_owner(self, device_id: int) -> Optional[int]:
        """Ring node whose replica group holds ``device_id`` (None if the
        device backs no registered group)."""
        for node, devs in self._groups.items():
            if device_id in devs:
                return node
        return None

    def device_lost(self, device_id: int) -> Optional[int]:
        """Partial-group loss: losing ANY device of a group loses the
        whole replica (weight shards and KV slices are useless without
        their siblings).  Fails the owning node on the ring, which drives
        the serve cluster's migration of its sessions to healthy groups.
        Returns the failed node id."""
        node = self.group_owner(device_id)
        if node is None:
            return None
        self._groups.pop(node, None)
        if node in set(self.membership.members()):
            self.membership.fail(node)
        return node
