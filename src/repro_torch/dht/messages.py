"""Wire formats (paper Fig. 2) and traffic accounting.

All sizes in *bits* and including the 28-byte IPv4+UDP headers, exactly as
the paper counts them:

  D1HT / OneHop maintenance message: 40-byte fixed part (v_m = 320) +
      4 bytes per default-port event (m = 32) + 6 bytes otherwise (m = 48).
  1h-Calot maintenance message: fixed 48 bytes (v_c = 384), one event each.
  ack / heartbeat: 36 bytes (v_a = v_h = 288).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..core.edra import Event

V_M_BITS = 320
V_C_BITS = 384
V_A_BITS = 288
V_H_BITS = 288
DEFAULT_PORT = 1117  # the "default IPv4 port" of our D1HT instance (§VI)


@dataclass(frozen=True)
class Message:
    """Base simulated datagram."""

    src: int                  # peer ring ID
    dst: int
    kind: str                 # "maint" | "ack" | "heartbeat" | "lookup" | ...
    size_bits: int
    payload: tuple = ()
    ttl: int = -1             # EDRA TTL for maint messages
    seq: int = 0


def d1ht_maintenance_size(events: Sequence[Event]) -> int:
    """v_m + Σ m_i (Fig 2a)."""
    return V_M_BITS + sum(e.wire_bits for e in events)


def calot_maintenance_size() -> int:
    """Fixed 48 bytes — one event per message, counters make no sense (§VII-A)."""
    return V_C_BITS


def ack_size() -> int:
    return V_A_BITS


def heartbeat_size() -> int:
    return V_H_BITS


@dataclass
class TrafficMeter:
    """Per-peer byte accounting, split by direction and class."""

    out_bits: float = 0.0
    in_bits: float = 0.0
    out_msgs: int = 0
    in_msgs: int = 0
    maint_out_bits: float = 0.0   # routing-table maintenance + failure detection

    def send(self, bits: int, maintenance: bool = True) -> None:
        self.out_bits += bits
        self.out_msgs += 1
        if maintenance:
            self.maint_out_bits += bits

    def recv(self, bits: int) -> None:
        self.in_bits += bits
        self.in_msgs += 1

    def out_bps(self, seconds: float) -> float:
        return self.maint_out_bits / max(seconds, 1e-9)
