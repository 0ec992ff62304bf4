"""Consistent-hashing identifier ring (paper §III).

Peers and keys live on the same 2^64 identifier ring: key IDs are
hashes of key values, peer IDs hashes of peer addresses (SHA-1
truncated to ``ID_BITS`` bits).  Framework-free (Python + numpy).

``RoutingTable`` is a facade over the shared ``RingState``: membership
mutates and the serving router reads ONE versioned sorted-array
representation, the one ``RingState`` uploads to the device.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, Iterator, List, Optional

from .ringstate import RingState

ID_BITS = 64
RING_SIZE = 1 << ID_BITS


def hash_id(value: bytes | str) -> int:
    """SHA-1 of ``value`` truncated to ID_BITS bits (paper §III, [37])."""
    if isinstance(value, str):
        value = value.encode("utf-8")
    digest = hashlib.sha1(value).digest()
    return int.from_bytes(digest[: ID_BITS // 8], "big")


def peer_id(ip: str, port: int = 0) -> int:
    """Peer ID = hash of its address (paper hashes the IP address)."""
    return hash_id(f"{ip}:{port}" if port else ip)


def key_id(key: bytes | str) -> int:
    return hash_id(key)


def ring_distance(a: int, b: int) -> int:
    """Clockwise distance from a to b on the ring."""
    return (b - a) % RING_SIZE


def in_interval(x: int, lo: int, hi: int, *, inclusive_hi: bool = True) -> bool:
    """True iff x ∈ (lo, hi] (or (lo, hi)) walking clockwise on the ring."""
    d_x = ring_distance(lo, x)
    d_hi = ring_distance(lo, hi)
    if d_x == 0:
        return False
    return d_x <= d_hi if inclusive_hi else d_x < d_hi


class RoutingTable:
    """A full routing table: the sorted set of all known peer IDs.

    Single-hop lookup = the *successor* of the key ID (the first peer
    clockwise from the key), as in Chord/D1HT.
    """

    __slots__ = ("state", "_ids_cache")

    def __init__(self, ids: Optional[Iterable[int]] = None, *,
                 state: Optional[RingState] = None):
        self.state = state if state is not None else RingState(ids or ())
        self._ids_cache: tuple = (-1, [])

    @property
    def ids(self) -> List[int]:
        """Sorted active peer IDs, cached per active_version."""
        ver, lst = self._ids_cache
        if ver != self.state.active_version:
            lst = self.state.active_ids_list()
            self._ids_cache = (self.state.active_version, lst)
        return lst

    def add(self, pid: int) -> bool:
        return self.state.add(pid)

    def remove(self, pid: int) -> bool:
        return self.state.remove(pid)

    def __contains__(self, pid: int) -> bool:
        return pid in self.state

    def __len__(self) -> int:
        return len(self.state)

    def __iter__(self) -> Iterator[int]:
        return iter(self.state)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, RoutingTable):
            return self.ids == other.ids
        return NotImplemented

    def __repr__(self) -> str:
        return f"RoutingTable(n={len(self)}, version={self.state.version})"

    def successor_of(self, x: int) -> int:
        """First peer clockwise from x (the owner of key x)."""
        return self.state.successor_of(x)

    def predecessor_of(self, x: int) -> int:
        return self.state.predecessor_of(x)

    def succ(self, p: int, i: int = 1) -> int:
        """succ(p, i): the i-th successor of peer p (paper §IV)."""
        return self.state.succ(p, i)

    def pred(self, p: int, i: int = 1) -> int:
        return self.state.succ(p, -i)

    def stretch(self, p: int, k: int) -> List[int]:
        """stretch(p,k) = {succ(p,i) | 0 <= i <= k} (paper §IV)."""
        return self.state.stretch(p, k)

    def owner(self, key: bytes | str) -> int:
        return self.state.successor_of(key_id(key))


def build_ring(num_peers: int, *, seed: int = 0) -> RoutingTable:
    """Deterministic ring of ``num_peers`` synthetic peers (10.x.x.x IPs)."""
    ids = []
    i = 0
    seen = set()
    while len(ids) < num_peers:
        ip = f"10.{(seed + i) >> 16 & 255}.{(seed + i) >> 8 & 255}.{(seed + i) & 255}"
        pid = peer_id(ip, port=1000 + ((seed + i) >> 24))
        if pid not in seen:
            seen.add(pid)
            ids.append(pid)
        i += 1
    return RoutingTable(ids)
