"""RingState — the single device-resident routing-table subsystem.

Every layer that needs key -> owner resolution (the serving router, the
runtime placement, the ``RoutingTable`` facade, and the CUDA
``ring_lookup`` kernels) shares ONE representation of the D1HT
full routing table (paper §III–IV): a sorted array of full 64-bit peer
IDs held in preallocated, capacity-doubling numpy buffers, versioned so
downstream caches (in particular the on-device hi/lo uint32 word-split
table fed to the kernel) refresh exactly when membership changed and
never otherwise.

This is the port's copy of ``repro.core.ringstate``: the numpy host logic
is unchanged; ``device_table``, ``device_bucket_table`` and ``lookup``
hold torch tensors on ``device`` and launch the port's kernels.

Design points (DESIGN.md §2–§4):

  * **Incremental, batched deltas.**  ``apply_events`` consumes EDRA
    join/leave events and merges them into the sorted table with
    O(k log n) searches plus one O(n + k) vectorized placement — never a
    full re-sort/rebuild, matching EDRA's per-Theta-interval event
    batches (Rules 1–4).
  * **Version monotonicity.**  ``version`` strictly increases on every
    mutation batch; consumers key caches on it.
  * **Quarantine mask** (paper §V): peers can be present in the state but
    excluded from ownership while in quarantine, so a quarantined spot
    node is tracked without ever owning keys/sessions.
  * **Device residency.**  ``device_table()`` uploads the active table as
    (hi, lo) word pairs padded to a power-of-two capacity; the live
    length travels as a (1,) device tensor the kernel reads, so a lookup
    never syncs on it.  ``upload_count`` counts actual
    uploads — the serve-path acceptance tests assert it stays at 1 across
    unchanged-membership request batches.
  * **Two-level bucket index** (DESIGN.md §7): above ``_BUCKET_MIN_N``
    peers, lookups run through a radix-partitioned (B, BW) bucket table
    — top-``R``-bits directory, one bounded row per query — so per-key
    kernel work is O(BW), not O(n).  The directory is maintained
    incrementally next to the sorted table; ``device_bucket_table()``
    re-ships only the rows a membership batch dirtied (``index_copy_``),
    making device maintenance traffic O(touched buckets) per EDRA batch
    instead of O(n).  Views the radix cannot partition (adversarially
    clustered ids) fall back to the flat-scan kernel, which stays the
    correctness oracle.
  * **Successor-list replicas** (Leslie, *Reliable Data Storage in
    Distributed Hash Tables*): ``replica_set(key, r)`` is the r-way
    successor-list view used for replicated placement.

Device tensors: eager torch has only partial uint32 support, so the
tables and keys travel as ``torch.int32`` tensors carrying the uint32 bit
patterns (``np_u32.view(np.int32)``); the kernels read them as uint32.
``device=None`` means the CUDA card, and raises without one (pass
``device="cpu"`` to run the plain versions on the host).  The device is
resolved at the first device-path call, so host-only users never need it.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.backend import bucket_budget_bytes, resolve_device

_MIN_CAPACITY = 64
_MIN_DEVICE_CAPACITY = 2048   # one kernel table tile (kernel.BT)
_WORD = np.uint64(32)
_LO_MASK = np.uint64(0xFFFFFFFF)
_DIFF_HISTORY = 128           # retained ownership-diff batches

# -- two-level bucket index (DESIGN.md §7) ----------------------------------
_BUCKET_ROW = 128             # row width; must equal ring_lookup.ref.BW
_BUCKET_TARGET = 32           # mean ids per bucket the directory aims for
_BUCKET_MIN_N = 2048          # below this the flat scan wins (one BT tile)
_MAX_R_BONUS = 2              # extra directory doublings before fallback


@dataclass(frozen=True)
class OwnerDiff:
    """Key ranges whose owner changed between two active-view versions.

    ``arcs`` is a (A, 2) uint64 array of clockwise half-open ring arcs
    (lo, hi]: a key k lies in an arc iff 0 < (k - lo) mod 2^64 <=
    (hi - lo) mod 2^64.  ``arcs is None`` means the diff could not be
    bounded (history evicted, or a view passed through <= 1 active peer)
    and EVERY key must be treated as affected — consumers fall back to a
    full re-resolve, never to silent staleness.
    """

    old_version: int
    new_version: int
    arcs: Optional[np.ndarray]

    @property
    def full(self) -> bool:
        return self.arcs is None

    def affected(self, keys) -> np.ndarray:
        """(Q,) uint64 key IDs -> (Q,) bool: owner changed across the diff."""
        keys = np.asarray(keys, np.uint64)
        if self.arcs is None:
            return np.ones(keys.shape, bool)
        if not self.arcs.size:
            return np.zeros(keys.shape, bool)
        lo = self.arcs[:, 0][None, :]
        hi = self.arcs[:, 1][None, :]
        d_k = keys[:, None] - lo           # uint64 arithmetic wraps the ring
        d_hi = hi - lo
        return ((d_k != np.uint64(0)) & (d_k <= d_hi)).any(axis=1)


def _as_u64(ids: Iterable[int]) -> np.ndarray:
    if isinstance(ids, np.ndarray):
        return ids.astype(np.uint64, copy=False)
    return np.fromiter((int(i) for i in ids), dtype=np.uint64)


@dataclass(frozen=True)
class ReplicaView:
    """Candidate metadata for one key's replica set — what a placement
    policy (``repro_torch.runtime.placement.PlacementPolicy``) ranks.

    ``ids`` is the r-way successor list in RING order (owner first): a
    policy may reorder it but never change the SET — the successor list
    is the canonical, independently re-derivable location of the key's
    replicas (readers and repair must be able to find them without
    consulting the writer's policy).  ``ring_rank`` maps a candidate
    back to its successor-list position (0 = primary), the tie-breaker
    that keeps any rank-only policy deterministic; ``arc_dist`` is each
    candidate's clockwise ring distance from the key (how "far" past
    the owner the candidate sits — churn-sensitivity metadata: lower
    arc_dist candidates lose the key to fewer distinct joiner arcs).
    """

    key: int
    ids: Tuple[int, ...]
    version: int                  # active-view version the view was cut at
    n_active: int                 # active peers backing it (r is clamped)
    arc_dist: Tuple[int, ...]

    def ring_rank(self, node: int) -> int:
        """Successor-list position of ``node`` (ValueError if absent)."""
        return self.ids.index(node)


class RingState:
    """Versioned, incrementally-maintained full routing table."""

    def __init__(self, ids: Iterable[int] = (), *,
                 capacity: int = _MIN_CAPACITY, device=None):
        self._device_arg = device
        self._device: Optional[torch.device] = None
        init = np.unique(_as_u64(ids))
        cap = max(capacity, _MIN_CAPACITY)
        while cap < init.size:
            cap *= 2
        self._ids = np.zeros(cap, np.uint64)       # sorted live ids in [:_n]
        self._quar = np.zeros(cap, bool)           # aligned quarantine mask
        self._ids[:init.size] = init
        self._n = int(init.size)
        self.version = 1
        self.active_version = 1    # bumps only when the ACTIVE view changes
        self.upload_count = 0
        self._active_cache: Tuple[int, Optional[np.ndarray]] = (0, None)
        self._dev_version = 0
        self._dev: Optional[tuple] = None
        self._dev_capacity = 0
        # two-level bucket index (armed lazily by the first device lookup
        # so pure-Python users never pay directory maintenance)
        self._bkt_enabled = False
        self._bkt_valid = False
        self._bkt_cap = 0              # pow2 >= n driving the sizing
        self._bkt_bits = 0             # R: directory has 2^R buckets
        self._bkt_edges: Optional[np.ndarray] = None
        self._bkt_occ: Optional[np.ndarray] = None     # (B,) int32
        self._bkt_pad: Optional[np.ndarray] = None     # (B,) uint64
        self._bkt_starts: Optional[np.ndarray] = None  # (B,) int64
        self._bkt_dirty: Optional[np.ndarray] = None   # (B,) bool
        self._bkt_dev: Optional[tuple] = None
        self._bkt_dev_bits = -1
        # upload accounting (flat + bucket paths; bench observability)
        self.upload_bytes = 0
        self.full_uploads = 0
        self.delta_uploads = 0
        # ownership-diff log: (active_version, arcs|None) per mutation
        # batch that moved the active view; None marks an unbounded batch.
        # Recording is opt-in (track_owner_diffs / first owner_diff call)
        # so the EDRA delta-apply hot path pays nothing without consumers.
        self._arc_log: deque = deque()
        self._diff_enabled = False
        self._diff_floor = self.active_version   # oldest answerable version

    @property
    def device(self) -> torch.device:
        """Where the device tables live (resolved at first use)."""
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        return self._device

    # -- capacity management --------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._ids.size

    def _ensure_capacity(self, need: int) -> None:
        cap = self._ids.size
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        ids = np.zeros(cap, np.uint64)
        quar = np.zeros(cap, bool)
        ids[:self._n] = self._ids[:self._n]
        quar[:self._n] = self._quar[:self._n]
        self._ids, self._quar = ids, quar

    def _bump(self, active: bool = True) -> None:
        """Record a mutation.  ``active=False`` marks changes that leave
        the ownership view intact (e.g. tracking a new quarantined peer)
        so the device table and active-view caches are NOT invalidated."""
        self.version += 1
        if active:
            self.active_version += 1

    # -- ownership diffs -------------------------------------------------------
    def track_owner_diffs(self) -> None:
        """Start logging ownership-change arcs.  Diff consumers (the
        serve plane) enable this up front; ``owner_diff`` also enables it
        on first call (answering that first call conservatively)."""
        if not self._diff_enabled:
            self._diff_enabled = True
            self._diff_floor = self.active_version
            self._arc_log.clear()

    @staticmethod
    def _sorted_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """a \\ b for sorted-unique uint64 arrays without setdiff1d's
        re-sorts (this sits on the EDRA delta-apply hot path)."""
        if not b.size:
            return a.copy()
        i = np.minimum(np.searchsorted(b, a), b.size - 1)
        return a[b[i] != a]

    def _record_arcs(self, old_act: np.ndarray) -> None:
        """Log the ring arcs whose owner moved in the batch that just
        bumped ``active_version`` (old_act = active view before it).

        A peer p entering the active view claims (pred_new(p), p]; a peer
        leaving it releases (pred_old(p), p] to its successor.  The union
        of those arcs is exactly the set of keys whose owner changed in
        this batch.  Views passing through <= 1 active peer have no
        well-defined predecessor arcs and are logged as unbounded."""
        if not self._diff_enabled:
            return
        new_act = self.active_ids()
        if old_act.size <= 1 or new_act.size <= 1:
            arcs: Optional[np.ndarray] = None
        else:
            added = self._sorted_diff(new_act, old_act)
            removed = self._sorted_diff(old_act, new_act)
            segs = []
            if added.size:
                i = np.searchsorted(new_act, added)
                segs.append(np.stack(
                    [new_act[(i - 1) % new_act.size], added], axis=1))
            if removed.size:
                i = np.searchsorted(old_act, removed)
                segs.append(np.stack(
                    [old_act[(i - 1) % old_act.size], removed], axis=1))
            arcs = np.concatenate(segs, axis=0) if segs \
                else np.zeros((0, 2), np.uint64)
        self._arc_log.append((self.active_version, arcs))
        while len(self._arc_log) > _DIFF_HISTORY:
            self._diff_floor, _ = self._arc_log.popleft()

    def owner_diff(self, old_version: int,
                   new_version: Optional[int] = None) -> OwnerDiff:
        """Which key ranges changed owners between two active-view
        versions (default: now)?  Consumers holding per-key state (the
        serve plane's sessions) re-resolve ONLY keys inside the returned
        arcs instead of re-routing everything on every membership batch.
        A diff older than the retained history is returned as full."""
        if new_version is None:
            new_version = self.active_version
        if old_version > new_version:
            raise ValueError(f"old_version {old_version} is newer than "
                             f"new_version {new_version}")
        self.track_owner_diffs()   # idempotent; arms recording from here
        if old_version < self._diff_floor:
            return OwnerDiff(old_version, new_version, None)
        segs = []
        for ver, arcs in self._arc_log:
            if old_version < ver <= new_version:
                if arcs is None:
                    return OwnerDiff(old_version, new_version, None)
                segs.append(arcs)
        merged = np.concatenate(segs, axis=0) if segs \
            else np.zeros((0, 2), np.uint64)
        return OwnerDiff(old_version, new_version, merged)

    # -- views ----------------------------------------------------------------
    def __len__(self) -> int:
        """Number of *active* (non-quarantined) peers."""
        return int(self.active_ids().size)

    @property
    def total(self) -> int:
        """All tracked peers, quarantined included."""
        return self._n

    def all_ids(self) -> np.ndarray:
        """Sorted uint64 view of every tracked peer (read-only)."""
        v = self._ids[:self._n]
        v.flags.writeable = False
        return v

    def active_ids(self) -> np.ndarray:
        """Sorted uint64 array of ownership-eligible peers (cached)."""
        ver, arr = self._active_cache
        if ver == self.active_version and arr is not None:
            return arr
        live = self._ids[:self._n]
        arr = live[~self._quar[:self._n]] if self._quar[:self._n].any() \
            else live.copy()
        arr.flags.writeable = False
        self._active_cache = (self.active_version, arr)
        return arr

    def active_ids_list(self) -> List[int]:
        return [int(x) for x in self.active_ids()]

    def __iter__(self) -> Iterator[int]:
        return iter(self.active_ids_list())

    def __contains__(self, pid: int) -> bool:
        act = self.active_ids()
        i = int(np.searchsorted(act, np.uint64(pid)))
        return i < act.size and int(act[i]) == int(pid)

    def is_quarantined(self, pid: int) -> bool:
        i = int(np.searchsorted(self._ids[:self._n], np.uint64(pid)))
        return i < self._n and int(self._ids[i]) == int(pid) \
            and bool(self._quar[i])

    def __repr__(self) -> str:
        return (f"RingState(n={len(self)}, total={self._n}, "
                f"version={self.version}, capacity={self.capacity})")

    # -- mutation -------------------------------------------------------------
    def add(self, pid: int, *, quarantined: bool = False) -> bool:
        """Insert one peer (or update its quarantine flag). True if the
        active view changed."""
        pid = int(pid)
        old_act = self.active_ids()
        i = int(np.searchsorted(self._ids[:self._n], np.uint64(pid)))
        if i < self._n and int(self._ids[i]) == pid:
            if bool(self._quar[i]) == quarantined:
                return False
            self._quar[i] = quarantined
            self._bump()
            self._record_arcs(old_act)
            self._bucket_note([pid])
            return True
        self._insert_block(np.asarray([pid], np.uint64),
                           np.asarray([quarantined], bool))
        self._bump(active=not quarantined)
        if not quarantined:
            self._record_arcs(old_act)
            self._bucket_note([pid])
        return not quarantined

    def remove(self, pid: int) -> bool:
        pid = int(pid)
        old_act = self.active_ids()
        i = int(np.searchsorted(self._ids[:self._n], np.uint64(pid)))
        if i >= self._n or int(self._ids[i]) != pid:
            return False
        was_active = not bool(self._quar[i])
        self._ids[i:self._n - 1] = self._ids[i + 1:self._n]
        self._quar[i:self._n - 1] = self._quar[i + 1:self._n]
        self._n -= 1
        self._bump(active=was_active)
        if was_active:
            self._record_arcs(old_act)
            self._bucket_note([pid])
        return True

    def set_quarantined(self, pid: int, flag: bool) -> bool:
        """Flip the ownership-exclusion mask for a tracked peer."""
        old_act = self.active_ids()
        i = int(np.searchsorted(self._ids[:self._n], np.uint64(pid)))
        if i >= self._n or int(self._ids[i]) != int(pid):
            return False
        if bool(self._quar[i]) == flag:
            return False
        self._quar[i] = flag
        self._bump()
        self._record_arcs(old_act)
        self._bucket_note([int(pid)])
        return True

    def apply_events(self, events: Sequence) -> int:
        """Batched EDRA delta: one merge for a whole Theta-interval flush.

        ``events`` is any sequence of objects with ``subject_id`` and
        ``kind`` in {"join", "leave"} (repro_torch.core.edra.Event).  Later
        events win over earlier ones for the same subject (a join + leave
        in one batch nets out).  Returns the number of table slots that
        changed; bumps ``version`` iff non-zero.
        """
        last: dict = {}
        for ev in events:
            last[int(ev.subject_id)] = ev.kind
        joins = np.array(sorted(p for p, k in last.items() if k == "join"),
                         np.uint64)
        leaves = np.array(sorted(p for p, k in last.items() if k != "join"),
                          np.uint64)
        old_act = self.active_ids()
        changed = active_changed = 0
        if leaves.size:
            removed, removed_active = self._remove_block(leaves)
            changed += removed
            active_changed += removed_active
        if joins.size:
            merged = self._merge_block(joins)  # inserts/unmasks: all active
            changed += merged
            active_changed += merged
        if changed:
            self._bump(active=active_changed > 0)
            if active_changed:
                self._record_arcs(old_act)
                self._bucket_note(np.concatenate([joins, leaves]))
        return changed

    def _merge_block(self, new_ids: np.ndarray) -> int:
        """Insert sorted unique ``new_ids`` not already present:
        O(k log n) membership searches + one O(n + k) placement.  A join
        for a peer already tracked under quarantine clears its mask (an
        explicit EDRA join event = admission, paper §V)."""
        live = self._ids[:self._n]
        pos = np.searchsorted(live, new_ids)
        present = (pos < self._n) & (live[np.minimum(pos, self._n - 1)]
                                     == new_ids) if self._n else \
            np.zeros(new_ids.shape, bool)
        changed = 0
        if present.any():
            at = pos[present]
            unmasked = self._quar[:self._n][at]
            self._quar[at[unmasked]] = False
            changed += int(unmasked.sum())
        fresh = new_ids[~present]
        if fresh.size:
            self._insert_block(fresh, np.zeros(fresh.size, bool))
            changed += int(fresh.size)
        return changed

    def _insert_block(self, fresh: np.ndarray, quar: np.ndarray) -> None:
        """Vectorized multi-insert into the capacity buffer (fresh is
        sorted, unique, disjoint from the live table)."""
        n, k = self._n, int(fresh.size)
        self._ensure_capacity(n + k)
        old_ids = self._ids[:n].copy()
        old_quar = self._quar[:n].copy()
        pos = np.searchsorted(old_ids, fresh)
        dst_new = pos + np.arange(k)           # final slots of new entries
        mask = np.ones(n + k, bool)
        mask[dst_new] = False
        self._ids[:n + k][mask] = old_ids
        self._ids[dst_new] = fresh
        self._quar[:n + k][mask] = old_quar
        self._quar[dst_new] = quar
        self._n = n + k

    def _remove_block(self, gone: np.ndarray) -> Tuple[int, int]:
        """Returns (slots removed, of which were active).  Absent ids are
        matched elementwise — a miss whose bisect position lands on some
        *other* departing id must not double-count it."""
        if not self._n:
            return 0, 0
        live = self._ids[:self._n]
        pos = np.searchsorted(live, gone)
        ok = pos < self._n
        hit = pos[ok][live[pos[ok]] == gone[ok]]
        if not hit.size:
            return 0, 0
        keep = np.ones(self._n, bool)
        keep[hit] = False
        active_hits = int((~self._quar[:self._n][hit]).sum())
        m = int(keep.sum())
        self._ids[:m] = live[keep]
        self._quar[:m] = self._quar[:self._n][keep]
        self._n = m
        return int(hit.size), active_hits

    # -- ring navigation (active view) ---------------------------------------
    def successor_index(self, x: int) -> int:
        act = self.active_ids()
        if not act.size:
            raise LookupError("empty routing table")
        return int(np.searchsorted(act, np.uint64(int(x)))) % act.size

    def successor_of(self, x: int) -> int:
        act = self.active_ids()
        return int(act[self.successor_index(x)])

    def predecessor_of(self, x: int) -> int:
        act = self.active_ids()
        if not act.size:
            raise LookupError("empty routing table")
        i = int(np.searchsorted(act, np.uint64(int(x))))
        return int(act[(i - 1) % act.size])

    def succ(self, p: int, i: int = 1) -> int:
        """succ(p, i): the i-th successor of peer p (paper §IV)."""
        act = self.active_ids()
        j = int(np.searchsorted(act, np.uint64(int(p))))
        if j >= act.size or int(act[j]) != int(p):
            raise LookupError(f"peer {p} not in table")
        return int(act[(j + i) % act.size])

    def stretch(self, p: int, k: int) -> List[int]:
        """stretch(p,k) = {succ(p,i) | 0 <= i <= k} (paper §IV)."""
        n = len(self)
        return [self.succ(p, i) for i in range(min(k, n - 1) + 1)]

    def replica_set(self, key, r: int) -> List[int]:
        """Successor-list view: the r distinct active peers starting at the
        key's owner, clockwise with wrap-around — the r-way replica group
        in the sense of Leslie's reliable-DHT-storage scheme."""
        act = self.active_ids()
        if not act.size:
            raise LookupError("empty routing table")
        from .ring import key_id  # local: ring imports this module at top
        x = key if isinstance(key, int) else key_id(key)
        start = self.successor_index(x)
        r = min(r, act.size)
        idx = (start + np.arange(r)) % act.size
        return [int(v) for v in act[idx]]

    def replica_view(self, key, r: int) -> ReplicaView:
        """``replica_set`` plus candidate metadata (ring ranks, arc
        distances, view version) — the input a placement policy ranks.
        The id ORDER is exactly ``replica_set``'s, so a consumer that
        takes ``view.ids`` unranked behaves bit-identically to the
        legacy successor-list loops."""
        act = self.active_ids()
        if not act.size:
            raise LookupError("empty routing table")
        from .ring import key_id
        x = key if isinstance(key, int) else key_id(key)
        ids = self.replica_set(x, r)
        dist = tuple((int(i) - x) & 0xFFFFFFFFFFFFFFFF  # wraps the ring
                     for i in ids)
        return ReplicaView(key=int(x), ids=tuple(ids),
                           version=self.active_version,
                           n_active=int(act.size), arc_dist=dist)

    def replica_sets(self, keys, r: int) -> np.ndarray:
        """Vectorized ``replica_set`` over a key batch: (Q,) uint64 key
        IDs -> (Q, min(r, n)) uint64 replica groups, owner first.  The
        data plane's re-replication sweep resolves every affected
        block's new placement in one call instead of Q bisects."""
        act = self.active_ids()
        if not act.size:
            raise LookupError("empty routing table")
        keys = np.asarray(keys, np.uint64)
        r = min(r, act.size)
        start = np.searchsorted(act, keys) % act.size
        idx = (start[:, None] + np.arange(r)[None, :]) % act.size
        return act[idx]

    def owner(self, key) -> int:
        from .ring import key_id
        x = key if isinstance(key, int) else key_id(key)
        return self.successor_of(x)

    # -- two-level bucket index (DESIGN.md §7) ---------------------------------
    def _bits_for(self, cap: int) -> int:
        """Directory size for a table capacity: 2^R buckets targeting
        ``_BUCKET_TARGET`` ids each, clamped so the (B, BW) matrix fits
        the device's budget (``kernels.backend.bucket_budget_bytes``)."""
        budget = bucket_budget_bytes(self.device)
        b = max(64, cap // _BUCKET_TARGET)
        while b > 64 and b * _BUCKET_ROW * 8 > budget:
            b //= 2
        return b.bit_length() - 1

    def _enable_buckets(self) -> None:
        if self._bkt_enabled:
            return
        self._bkt_enabled = True
        cap = max(self._bkt_cap, _MIN_DEVICE_CAPACITY)
        while cap < len(self):
            cap *= 2
        self._bkt_cap = cap
        self._set_bits(self._bits_for(cap))

    def _set_bits(self, bits: int) -> None:
        """(Re)size the directory; every row becomes dirty (the device
        arrays change shape, so the next sync is a full rebuild — the
        bucketized analogue of a capacity-doubling recompile)."""
        nb = 1 << bits
        self._bkt_bits = bits
        self._bkt_edges = np.arange(nb, dtype=np.uint64) \
            << np.uint64(64 - bits)
        self._bkt_occ = np.full(nb, -1, np.int32)
        self._bkt_pad = np.zeros(nb, np.uint64)
        self._bkt_starts = np.zeros(nb, np.int64)
        self._bkt_dirty = np.ones(nb, bool)
        self._refresh_directory(None)

    def _bucket_note(self, touched) -> None:
        """Per mutation batch that moved the active view: grow/refresh
        the directory and accumulate dirty rows.  No-op until the first
        device lookup arms the index."""
        if not self._bkt_enabled:
            return
        n = len(self)
        if n > self._bkt_cap:
            cap = self._bkt_cap
            while cap < n:
                cap *= 2
            self._bkt_cap = cap
            bits = self._bits_for(cap)
            if bits != self._bkt_bits:
                self._set_bits(bits)
                return
        self._refresh_directory(touched)

    def _refresh_directory(self, touched) -> None:
        """Vectorized O(B log n) directory recompute: per-bucket starts,
        occupancy, and successor pad ids.  Dirty rows = rows whose
        occupancy or pad changed, plus the rows of explicitly touched
        ids (an id swap inside one bucket keeps occ AND pad constant but
        still rewrites row content)."""
        act = self.active_ids()
        n = int(act.size)
        if n == 0:
            self._bkt_valid = False
            self._bkt_dirty[:] = True
            return
        starts = np.searchsorted(act, self._bkt_edges).astype(np.int64)
        ends = np.append(starts[1:], n)
        occ = (ends - starts).astype(np.int32)
        if int(occ.max()) >= _BUCKET_ROW:   # no slack slot left for pad
            if self._escalate(act):
                return
            # clustering the radix cannot split (e.g. ids differing only
            # in low bits past R): flat scan takes over until it clears
            self._bkt_valid = False
            self._bkt_dirty[:] = True
            self._bkt_occ, self._bkt_starts = occ, starts
            self._bkt_pad = act[ends % n]
            return
        pad = act[ends % n]
        dirty = (occ != self._bkt_occ) | (pad != self._bkt_pad)
        if touched is not None and len(touched):
            rows = (np.asarray(touched, np.uint64)
                    >> np.uint64(64 - self._bkt_bits)).astype(np.int64)
            dirty[rows] = True
        self._bkt_dirty |= dirty
        self._bkt_occ, self._bkt_pad, self._bkt_starts = occ, pad, starts
        self._bkt_valid = True

    def _escalate(self, act: np.ndarray) -> bool:
        """Overflowing bucket: try a finer radix (more directory bits)
        within the memory budget before giving up on the index."""
        budget = bucket_budget_bytes(self.device)
        bits = self._bkt_bits
        max_bits = self._bits_for(self._bkt_cap) + _MAX_R_BONUS
        while bits < max_bits:
            bits += 1
            if (1 << bits) * _BUCKET_ROW * 8 > budget:
                return False
            edges = np.arange(1 << bits, dtype=np.uint64) \
                << np.uint64(64 - bits)
            occ = np.diff(np.append(np.searchsorted(act, edges), act.size))
            if int(occ.max()) < _BUCKET_ROW:
                self._set_bits(bits)
                return True
        return False

    def _build_rows(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(hi, lo) uint32 row blocks for the given bucket indices: live
        entries first, successor pad id in every slack slot."""
        act = self.active_ids()
        starts = self._bkt_starts[rows]
        occ = self._bkt_occ[rows].astype(np.int64)
        pad = self._bkt_pad[rows]
        j = np.arange(_BUCKET_ROW, dtype=np.int64)[None, :]
        idx = np.minimum(starts[:, None] + j, act.size - 1)
        vals = np.where(j < occ[:, None], act[idx], pad[:, None])
        return ((vals >> _WORD).astype(np.uint32),
                (vals & _LO_MASK).astype(np.uint32))

    def _upload(self, words: np.ndarray) -> torch.Tensor:
        """Host uint32/int32 words -> int32 tensor on the device (the
        uint32 bit patterns are kept, see the module docstring).  Always a
        copy, so a CPU table never aliases the host directory arrays."""
        return torch.from_numpy(np.ascontiguousarray(words).view(
            np.int32)).to(self.device, copy=True)

    def device_bucket_table(self):
        """(bkt_hi, bkt_lo, occ) int32 device tensors for the bucketized
        kernel, or None while the radix cannot represent the view (empty
        table / unsplittable clustering) — callers fall back to the flat
        scan.

        Delta protocol: after the first full materialization, a sync
        ships ONLY the rows membership batches dirtied since the last
        sync, written in place with one ``index_copy_`` per tensor —
        device maintenance traffic is O(touched buckets) per EDRA batch,
        never O(n).  In-place (unlike ``repro``'s functional update): a
        caller holding the returned tuple sees the new rows."""
        self._enable_buckets()
        if not self._bkt_valid:
            return None
        if self._bkt_dev is not None and self._bkt_dev_bits == self._bkt_bits \
                and not self._bkt_dirty.any():
            return self._bkt_dev
        nb = 1 << self._bkt_bits
        if self._bkt_dev is None or self._bkt_dev_bits != self._bkt_bits:
            hi, lo = self._build_rows(np.arange(nb))
            self._bkt_dev = (self._upload(hi), self._upload(lo),
                             self._upload(self._bkt_occ))
            self._bkt_dev_bits = self._bkt_bits
            self.full_uploads += 1
            self.upload_bytes += nb * (_BUCKET_ROW * 8 + 4)
        else:
            rows = np.nonzero(self._bkt_dirty)[0]
            hi, lo = self._build_rows(rows)
            bhi, blo, occ = self._bkt_dev
            at = torch.from_numpy(rows.astype(np.int64)).to(self.device)
            bhi.index_copy_(0, at, self._upload(hi))
            blo.index_copy_(0, at, self._upload(lo))
            occ.index_copy_(0, at, self._upload(self._bkt_occ[rows]))
            self.delta_uploads += 1
            self.upload_bytes += int(rows.size) * (_BUCKET_ROW * 8 + 4)
        self.upload_count += 1
        self._bkt_dirty[:] = False
        return self._bkt_dev

    def bucket_stats(self) -> dict:
        """Observability for the two-level index (bench + tests)."""
        if not self._bkt_enabled or self._bkt_occ is None:
            return {"enabled": False}
        occ = self._bkt_occ
        nb = 1 << self._bkt_bits
        return {
            "enabled": True,
            "valid": bool(self._bkt_valid),
            "buckets": nb,
            "row_width": _BUCKET_ROW,
            "max_occupancy": int(occ.max()) if occ.size else 0,
            "mean_occupancy": float(occ.mean()) if occ.size else 0.0,
            "directory_bytes": nb * 4,
            "matrix_bytes": nb * _BUCKET_ROW * 8,
        }

    # -- device-resident table -------------------------------------------------
    @property
    def device_capacity(self) -> int:
        """Padded on-device table length (0 until first upload)."""
        return self._dev_capacity

    def device_table(self):
        """(table_hi, table_lo, n) int32 device tensors for the
        ring_lookup64 kernel; ``n`` is a (1,) tensor the kernel reads.

        Rebuilt (and re-uploaded) only when the *active* view moved since
        the last call (quarantine-only tracking changes don't count);
        capacity-padded so churn only changes the *data*, never the
        shapes.
        """
        if self._dev is not None and self._dev_version == self.active_version:
            return self._dev
        act = self.active_ids()
        n = int(act.size)
        cap = max(self._dev_capacity, _MIN_DEVICE_CAPACITY)
        while cap < n:
            cap *= 2
        hi = np.zeros(cap, np.uint32)
        lo = np.zeros(cap, np.uint32)
        hi[:n] = (act >> _WORD).astype(np.uint32)
        lo[:n] = (act & _LO_MASK).astype(np.uint32)
        self._dev = (self._upload(hi), self._upload(lo),
                     self._upload(np.array([n], np.int32)))
        self._dev_capacity = cap
        self._dev_version = self.active_version
        self.upload_count += 1
        self.full_uploads += 1             # the flat table has no delta
        self.upload_bytes += cap * 8 + 4   # path: every sync re-ships it
        return self._dev

    def lookup(self, keys: np.ndarray, *,
               use_buckets: Optional[bool] = None) -> np.ndarray:
        """Batched on-device successor lookup: (Q,) uint64 key IDs ->
        (Q,) uint64 owner peer IDs.

        Dispatch (DESIGN.md §7): tables of ``_BUCKET_MIN_N`` peers or
        more resolve through the two-level bucket index (O(row) per
        key, kernel K2); smaller tables — and views the radix cannot
        partition — use the flat search (kernel K1).  ``use_buckets``
        pins the preference (True still falls back when the index is
        invalid).  One host read of the result per call."""
        from ..kernels.ring_lookup.ops import (ring_lookup64,
                                               ring_lookup_bucketed)

        act = self.active_ids()
        if not act.size:
            raise LookupError("empty routing table")
        keys = np.asarray(keys, np.uint64)
        khi = self._upload((keys >> _WORD).astype(np.uint32))
        klo = self._upload((keys & _LO_MASK).astype(np.uint32))
        if use_buckets is None:
            use_buckets = act.size >= _BUCKET_MIN_N
        if use_buckets:
            dev = self.device_bucket_table()
            if dev is not None:
                ohi, olo = ring_lookup_bucketed(khi, klo, *dev)
                words = torch.stack([ohi, olo]).cpu().numpy().view(np.uint32)
                return (words[0].astype(np.uint64) << _WORD) \
                    | words[1].astype(np.uint64)
        thi, tlo, n = self.device_table()
        idx = ring_lookup64(khi, klo, thi, tlo, n).cpu().numpy()
        return act[idx]

    def lookup_keys(self, keys: Sequence[str], *, namespace: str = "") -> np.ndarray:
        """Hash string keys onto the ring and resolve owners on-device."""
        from .ring import hash_id
        ids = np.fromiter(
            (hash_id(f"{namespace}{k}") for k in keys), np.uint64, len(keys))
        return self.lookup(ids)
