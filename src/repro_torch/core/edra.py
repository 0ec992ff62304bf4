"""EDRA membership events (paper §IV, footnote 3).

The port needs only the ``Event`` record that ``Membership`` and
``RingState.apply_events`` consume; the dissemination-tree machinery
comes with the churn plane.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Event:
    """A membership event: a peer joined or left (paper footnote 3)."""

    subject_id: int          # ring ID of the peer that joined/left
    kind: str                # "join" | "leave"
    addr: Tuple[str, int] = ("0.0.0.0", 0)
    seq: int = 0             # tiebreaker for idempotence
