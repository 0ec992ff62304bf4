"""Replica restarts on membership generations (the port's copy of
``ReplicaSupervisor`` from ``repro.runtime.failover``), with its registry
of tensor-parallel replica groups.

``repro``'s ``FailoverManager`` (checkpoint restore) waits for the
training slice (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

from typing import Dict, Optional

from .membership import Membership


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
