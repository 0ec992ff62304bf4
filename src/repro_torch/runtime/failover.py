"""Replica restarts on membership generations (the port's copy of
``ReplicaSupervisor`` from ``repro.runtime.failover``).

``repro``'s ``FailoverManager`` (checkpoint restore) waits for the
training slice, and the supervisor's tensor-parallel group registry
(``register_group``, ``device_lost``) for the TP slice (ROADMAP queue 1,
items 4 and 3).
"""
from __future__ import annotations

from typing import Dict

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
