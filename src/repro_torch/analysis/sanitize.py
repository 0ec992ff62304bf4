"""REPRO_SANITIZE=1 runtime invariant sanitizer of the port (the
counterpart of ``repro.analysis.sanitize``, DESIGN.md §14).

Cheap post-condition wrappers over the three stateful planes whose
invariants carry the paper's correctness argument, as in ``repro``:

  RingState (paper §IV, EDRA): ``add``, ``remove``, ``set_quarantined``,
  ``apply_events`` and ``lookup``
    * ``version`` / ``active_version`` are monotonically non-decreasing
      and ``active_version <= version``;
    * the live id slab ``_ids[:n]`` stays strictly sorted;
    * quarantined peers never appear in ``active_ids()`` (§V);
    * ``lookup`` (kernels K1/K2 on the card, their plain versions on the
      CPU) agrees with the flat numpy oracle
      ``act[searchsorted(act, key) % n]`` on 8 sampled keys a batch.

  BlockStore (paper §V): ``put``, ``sync``, ``remove``
    * after ``put``: exactly ``min(r, live)`` fresh copies on reachable,
      non-quarantined holders, and the key's tombstone is gone;
    * after ``sync``: every placed key (64 sampled) has ``min(r, live)``
      live up-to-date copies;
    * tombstoned keys are never placed (no resurrection).

  Replica (serve plane): ``admit``, ``admit_from_blocks``,
  ``begin_admit``, ``advance_prefills``, ``evict``, ``decode_round``
    * slot conservation: ``free + active-sessions + pending-prefills ==
      slots`` with pairwise-disjoint slot sets, and the ``active`` mask
      matches ``sessions`` exactly, checked on exception paths too.

``install()`` monkeypatches the wrappers in (idempotent; the classes are
imported at that call, not when this module is); ``uninstall()``
restores the originals.  ``import repro_torch`` installs when
``REPRO_SANITIZE`` is truthy, so a test run of the port under that flag
runs sanitized.  The wrappers are O(state-size) at worst: for tests, not
for timing runs.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Tuple

import numpy as np

__all__ = ["SanitizeError", "enabled", "install", "uninstall", "stats"]

_LOOKUP_SAMPLE = 8       # keys per lookup batch twin-checked vs the oracle
_SYNC_SAMPLE = 64        # keys per sync checked for replica cardinality


class SanitizeError(AssertionError):
    """A runtime invariant the paper (or the serve plane) relies on was
    violated.  Always a bug — never catch and continue."""


def enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "").lower() in (
        "1", "true", "on", "yes")


_checks: Dict[str, int] = {}
_originals: List[Tuple[type, str, Callable]] = []


def stats() -> Dict[str, int]:
    """Invariant-check counters (name -> times run); for tests asserting
    the sanitizer actually engaged."""
    return dict(_checks)


def _count(name: str) -> None:
    _checks[name] = _checks.get(name, 0) + 1


def _fail(msg: str) -> None:
    raise SanitizeError(f"REPRO_SANITIZE: {msg}")


# ---------------------------------------------------------------------------
# RingState
# ---------------------------------------------------------------------------

def _check_ringstate(st, prev_version: int, prev_active: int,
                     where: str) -> None:
    _count("ringstate")
    if st.version < prev_version or st.active_version < prev_active:
        _fail(f"RingState.{where}: version went backwards "
              f"({prev_version}->{st.version}, "
              f"active {prev_active}->{st.active_version})")
    if st.active_version > st.version:
        _fail(f"RingState.{where}: active_version {st.active_version} "
              f"> version {st.version}")
    n = st._n
    ids = st._ids[:n]
    if n > 1 and not bool(np.all(ids[:-1] < ids[1:])):
        _fail(f"RingState.{where}: live id slab not strictly sorted")
    quar = st._quar[:n]
    if quar.any():
        act = st.active_ids()
        bad = np.intersect1d(act, ids[quar])
        if bad.size:
            _fail(f"RingState.{where}: quarantined peer(s) "
                  f"{bad[:4].tolist()} present in active_ids (paper §V)")


def _wrap_ring_mutator(cls, name: str) -> None:
    orig = getattr(cls, name)

    def wrapper(self, *args, **kwargs):
        pv, pa = self.version, self.active_version
        try:
            return orig(self, *args, **kwargs)
        finally:
            _check_ringstate(self, pv, pa, name)

    _install_one(cls, name, orig, wrapper)


def _wrap_ring_lookup(cls) -> None:
    orig = cls.lookup

    def wrapper(self, keys, **kwargs):
        out = orig(self, keys, **kwargs)
        _count("ringstate.lookup")
        act = self.active_ids()
        keys = np.asarray(keys, np.uint64)
        k = min(_LOOKUP_SAMPLE, keys.size)
        if k and act.size:
            sample = keys[:k]
            oracle = act[np.searchsorted(act, sample) % act.size]
            got = np.asarray(out)[:k]
            if not bool(np.array_equal(got, oracle)):
                i = int(np.nonzero(got != oracle)[0][0])
                _fail("RingState.lookup disagrees with the flat numpy "
                      f"oracle at key {int(sample[i])}: got "
                      f"{int(got[i])}, oracle {int(oracle[i])} "
                      "(directory/bucket path diverged)")
        return out

    _install_one(cls, "lookup", orig, wrapper)


# ---------------------------------------------------------------------------
# BlockStore
# ---------------------------------------------------------------------------

def _check_tombs_disjoint(store, where: str) -> None:
    both = set(store._tombs) & set(store._placement)
    if both:
        _fail(f"BlockStore.{where}: tombstoned key(s) "
              f"{sorted(both)[:4]} still placed (resurrection hazard)")


def _wrap_store_put(cls) -> None:
    orig = cls.put

    def wrapper(self, name, value, **kwargs):
        meta = orig(self, name, value, **kwargs)
        _count("blockstore.put")
        key = self.key_of(name)
        live = self.state.active_ids()
        group = self._placement.get(key, ())
        want = min(self.replication, int(live.size))
        if len(group) != want:
            _fail(f"BlockStore.put({name!r}): placed on {len(group)} "
                  f"nodes, expected min(r={self.replication}, "
                  f"live={int(live.size)}) = {want}")
        for node in group:
            if self.state.is_quarantined(node):
                _fail(f"BlockStore.put({name!r}): replica {node} is "
                      "quarantined (paper §V: masked peers own nothing)")
            entry = self._nodes.get(node, {}).get(key)
            if entry is None or entry[0].version != meta.version:
                _fail(f"BlockStore.put({name!r}): holder {node} missing "
                      "the fresh copy")
        if key in self._tombs:
            _fail(f"BlockStore.put({name!r}): tombstone survived the put")
        _check_tombs_disjoint(self, "put")
        return meta

    _install_one(cls, "put", orig, wrapper)


def _wrap_store_sync(cls) -> None:
    orig = cls.sync

    def wrapper(self):
        out = orig(self)
        _count("blockstore.sync")
        live = self.state.active_ids()
        want_full = min(self.replication, int(live.size))
        counts = self.replica_counts()
        for key in sorted(counts)[:_SYNC_SAMPLE]:
            if counts[key] != want_full:
                _fail(f"BlockStore.sync: key {key} has {counts[key]} "
                      f"live up-to-date copies, expected {want_full} "
                      "after convergence")
        _check_tombs_disjoint(self, "sync")
        return out

    _install_one(cls, "sync", orig, wrapper)


def _wrap_store_remove(cls) -> None:
    orig = cls.remove

    def wrapper(self, name):
        out = orig(self, name)
        _count("blockstore.remove")
        key = self.key_of(name)
        if key in self._placement:
            _fail(f"BlockStore.remove({name!r}): key still placed")
        _check_tombs_disjoint(self, "remove")
        return out

    _install_one(cls, "remove", orig, wrapper)


# ---------------------------------------------------------------------------
# Replica slot conservation
# ---------------------------------------------------------------------------

def _check_slots(rep, where: str) -> None:
    _count("replica.slots")
    free = list(rep._free)
    sess = list(rep.sessions.values())
    pend = [st["slot"] for st in rep._pending.values()]
    total = len(free) + len(sess) + len(pend)
    if total != rep.slots:
        _fail(f"Replica.{where}: slot leak — free({len(free)}) + "
              f"sessions({len(sess)}) + pending({len(pend)}) = {total} "
              f"!= slots({rep.slots})")
    all_slots = free + sess + pend
    if len(set(all_slots)) != len(all_slots):
        _fail(f"Replica.{where}: slot double-booked across "
              "free/sessions/pending")
    active = set(np.nonzero(rep.active)[0].tolist())
    if active != set(sess):
        _fail(f"Replica.{where}: active mask {sorted(active)} != "
              f"session slots {sorted(set(sess))}")


def _wrap_replica(cls, name: str) -> None:
    orig = getattr(cls, name)

    def wrapper(self, *args, **kwargs):
        try:
            return orig(self, *args, **kwargs)
        finally:
            # conservation must hold on exception paths too: admit/
            # prefill rollback bugs are exactly the ones that leak slots
            _check_slots(self, name)

    _install_one(cls, name, orig, wrapper)


# ---------------------------------------------------------------------------
# install / uninstall
# ---------------------------------------------------------------------------

def _install_one(cls: type, name: str, orig: Callable,
                 wrapper: Callable) -> None:
    wrapper.__name__ = orig.__name__
    wrapper.__qualname__ = orig.__qualname__
    wrapper.__doc__ = orig.__doc__
    wrapper.__repro_sanitized__ = True  # type: ignore[attr-defined]
    _originals.append((cls, name, orig))
    setattr(cls, name, wrapper)


def install() -> bool:
    """Wrap the invariant checks in (idempotent).  Returns True if this
    call did the installation."""
    if _originals:
        return False
    from ..core.ringstate import RingState
    from ..dht.data import BlockStore
    from ..serve.server import Replica

    for name in ("add", "remove", "set_quarantined", "apply_events"):
        _wrap_ring_mutator(RingState, name)
    _wrap_ring_lookup(RingState)
    _wrap_store_put(BlockStore)
    _wrap_store_sync(BlockStore)
    _wrap_store_remove(BlockStore)
    for name in ("admit", "admit_from_blocks", "begin_admit",
                 "advance_prefills", "evict", "decode_round"):
        _wrap_replica(Replica, name)
    return True


def uninstall() -> None:
    """Restore every wrapped method (idempotent)."""
    while _originals:
        cls, name, orig = _originals.pop()
        setattr(cls, name, orig)
    _checks.clear()
