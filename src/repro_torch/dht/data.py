"""Replicated KV-block data plane over the ring (port of
``repro.dht.data``, DESIGN.md §11).

``BlockStore`` is a versioned, checksummed block store whose placement
IS ``RingState.replica_set``: every block lives on the r active
successors of its key.  ``put`` writes the whole replica set and meters
the upload bytes; ``get`` returns the freshest checksum-valid copy and
read-repairs stale or missing members of the CURRENT set; ``sync``
re-places exactly the keys inside the ``owner_diff`` arcs or with a dead
recorded holder; ``remove`` buries the version, so a stale copy that
rejoins can never resurrect the block.  A *leave* keeps a peer's store
(its disk may come back), a *crash* (``drop_node``) destroys it.

``PrefixCache`` rides on top: content-addressed prompt-prefix chunks
(key = hash of the token prefix itself), so a session sharing a system
prompt imports the prefix KV instead of re-prefilling it.

The one difference from ``repro``: the KVB1 header.  ``repro`` writes
``arr.dtype.str``, which for a bfloat16 array is the void type ``'<V2'``
and reads back as raw bytes no cache accepts.  The port's bfloat16 slabs
are ``Bf16Words`` (the 2-byte words of a torch bfloat16 tensor, as
uint16), which travel under the tag ``bf16`` and come back as
``Bf16Words``; every dtype numpy names keeps ``repro``'s header, so a
float32 block is byte-equal across the two packages.
"""
from __future__ import annotations

import hashlib
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.ring import key_id
from ..core.ringstate import RingState

__all__ = ["BlockMeta", "BlockStore", "Bf16Words", "PrefixCache",
           "pack_array", "unpack_array"]


# ---------------------------------------------------------------------------
# array <-> bytes framing (KV blocks travel as plain bytes through the DHT)
# ---------------------------------------------------------------------------

_MAGIC = b"KVB1"
_BF16 = b"bf16"


class Bf16Words(np.ndarray):
    """uint16 words that hold bfloat16 bit patterns: numpy has no
    bfloat16, so a bfloat16 slab leaves torch as its raw words and this
    class is its tag.  ``torch.from_numpy(a.view(np.int16)).view(
    torch.bfloat16)`` gives the tensor back bit for bit."""

    @staticmethod
    def of(words: np.ndarray) -> "Bf16Words":
        return np.asarray(words, np.uint16).view(Bf16Words)


def pack_array(arr: np.ndarray) -> bytes:
    """Self-describing little header + raw bytes: the store itself only
    ever sees opaque ``bytes`` (like any DHT), so shape/dtype must ride
    inside the value."""
    dt = _BF16 if isinstance(arr, Bf16Words) else None
    arr = np.ascontiguousarray(arr)
    dt = dt or arr.dtype.str.encode()
    head = _MAGIC + struct.pack("<BB", len(dt), arr.ndim) + dt \
        + struct.pack(f"<{arr.ndim}q", *arr.shape)
    return head + arr.tobytes()


def unpack_array(data: bytes) -> np.ndarray:
    if data[:4] != _MAGIC:
        raise ValueError("not a packed array block")
    dtl, ndim = struct.unpack_from("<BB", data, 4)
    off = 6
    tag = data[off:off + dtl]
    dt = np.dtype(np.uint16) if tag == _BF16 else np.dtype(tag.decode())
    off += dtl
    shape = struct.unpack_from(f"<{ndim}q", data, off)
    off += 8 * ndim
    arr = np.frombuffer(data, dt, offset=off).reshape(shape).copy()
    return Bf16Words.of(arr) if tag == _BF16 else arr


# ---------------------------------------------------------------------------
# block store
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BlockMeta:
    """Per-copy metadata: total order (version) + integrity (crc)."""

    version: int
    size: int
    crc: int

    @staticmethod
    def of(version: int, value: bytes) -> "BlockMeta":
        return BlockMeta(version, len(value), zlib.crc32(value))

    def valid(self, value: bytes) -> bool:
        return len(value) == self.size and zlib.crc32(value) == self.crc


class BlockStore:
    """r-way replicated block store placed by the ring's successor lists.

    ``policy`` is an optional ``repro_torch.runtime.placement.
    PlacementPolicy`` (duck-typed, so this module never imports the
    runtime package): it RANKS each key's replica set — which copy a read
    prefers, which member a co-located consumer treats as primary — but
    never changes the SET (the successor list stays the canonical,
    policy-independent location of the copies, so ``sync``'s vectorized
    re-replication resolves placement through ``replica_sets`` under any
    policy).  ``None`` is exactly ring-successor order.

    ``put(..., at=key)`` overrides the PLACEMENT key: the block is
    stored under its own name but placed on ``at``'s replica set.  The
    serve plane places every session KV block ``at`` the session's ring
    key, so a session's blocks and the session itself land on the SAME
    replica set — the migration target already holds the handoff blocks
    locally instead of fetching them from wherever the block-name hash
    happened to scatter them (and churn can no longer re-home the
    session and its blocks to different replicas).
    """

    def __init__(self, state: RingState, *, replication: int = 2,
                 policy=None):
        if replication < 1:
            raise ValueError("replication must be >= 1")
        self.state = state
        self.replication = replication
        self.policy = policy
        # physical per-node stores: node id -> {key id -> (meta, value)}.
        # THIS is the ground truth the invariant suite twin-checks; the
        # indexes below are derived bookkeeping a real deployment would
        # hold per-node anyway (what do I store? what version did the
        # coordinator last hand out?).
        self._nodes: Dict[int, Dict[int, Tuple[BlockMeta, bytes]]] = {}
        self._placement: Dict[int, Tuple[int, ...]] = {}   # key -> holders
        self._pkey: Dict[int, int] = {}    # key -> placement-key override
        self._names: Dict[int, str] = {}                   # key -> debug name
        self._vclock: Dict[int, int] = {}    # coordinator version counter
        self._tombs: Dict[int, int] = {}     # key -> version buried at
        # churn cursor for owner_diff-driven repair
        state.track_owner_diffs()
        self._seen_version = state.active_version
        # metering (same observability discipline as RingState's
        # upload_bytes/delta_uploads)
        self.puts = 0
        self.gets = 0
        self.removes = 0
        self.read_repairs = 0
        self.repair_syncs = 0
        self.upload_bytes = 0        # put-path replica writes
        self.repair_bytes = 0        # read-repair + re-replication copies
        self.corrupt_copies = 0      # torn copies detected and discarded
        self.lost_blocks = 0         # keys with zero surviving copies

    # -- key space -----------------------------------------------------------
    @staticmethod
    def key_of(name) -> int:
        """Ring key of a block: ints pass through, strings hash (SHA-1
        truncation, the same keyspace peers live in)."""
        return int(name) if isinstance(name, (int, np.integer)) \
            else key_id(name)

    # -- reachability --------------------------------------------------------
    def _reachable(self, node: int) -> bool:
        """Readable/writable: tracked by the ring (active or quarantined
        — a §V-masked peer owns nothing but still answers) AND its
        physical store was not destroyed by a crash."""
        return (node in self.state or self.state.is_quarantined(node))

    def _copy(self, node: int, key: int) -> Optional[Tuple[BlockMeta, bytes]]:
        """The node's checksum-verified copy, or None (missing, torn, or
        buried under the key's tombstone)."""
        entry = self._nodes.get(node, {}).get(key)
        if entry is None:
            return None
        meta, value = entry
        if not meta.valid(value):
            self.corrupt_copies += 1
            del self._nodes[node][key]
            return None
        if meta.version <= self._tombs.get(key, 0):
            return None
        return entry

    def _pkey_of(self, key: int) -> int:
        return self._pkey.get(key, key)

    def _group(self, key: int) -> List[int]:
        pk = self._pkey_of(key)
        if self.policy is None:
            return [int(p) for p in self.state.replica_set(
                pk, self.replication)]
        return self.policy.replica_group(self.state, pk, self.replication)

    # -- core interface ------------------------------------------------------
    def put(self, name, value: bytes, *, at=None) -> BlockMeta:
        """Store ``value`` on every member of the key's replica set.
        The new version supersedes every copy (and any tombstone).
        ``at`` (a key id or name) overrides the placement key — the
        block keeps its own identity but lives on ``at``'s replica set
        (session-KV co-location; see the class docstring)."""
        if not isinstance(value, bytes):
            raise TypeError("BlockStore values are bytes")
        key = self.key_of(name)
        if at is not None:
            self._pkey[key] = self.key_of(at)
        else:
            self._pkey.pop(key, None)
        group = self._group(key)
        version = max(self._vclock.get(key, 0), self._tombs.get(key, 0)) + 1
        meta = BlockMeta.of(version, value)
        for node in group:
            self._nodes.setdefault(node, {})[key] = (meta, value)
        # drop copies parked on reachable ex-holders (placement moved)
        for node in self._placement.get(key, ()):
            if node not in group and self._reachable(node):
                self._nodes.get(node, {}).pop(key, None)
        self._vclock[key] = version
        self._tombs.pop(key, None)
        self._placement[key] = tuple(group)
        if isinstance(name, str):
            self._names[key] = name
        self.puts += 1
        self.upload_bytes += len(value) * len(group)
        return meta

    def get(self, name) -> Optional[bytes]:
        """Read the freshest checksum-valid copy; ``None`` on a miss.

        Consults the key's CURRENT replica set first, falling back to
        the last recorded holders (placement drift), then read-repairs:
        every live replica-set member ends up holding the winning
        version before the value is returned."""
        key = self.key_of(name)
        self.gets += 1
        group = self._group(key)
        seen = list(group)
        seen += [n for n in self._placement.get(key, ()) if n not in group]
        best: Optional[Tuple[BlockMeta, bytes]] = None
        for node in seen:
            if not self._reachable(node):
                continue
            entry = self._copy(node, key)
            if entry is not None and (best is None
                                      or entry[0].version > best[0].version):
                best = entry
        if best is None:
            return None
        meta, value = best
        repaired = False
        for node in group:
            cur = self._copy(node, key)
            if cur is None or cur[0].version < meta.version:
                self._nodes.setdefault(node, {})[key] = (meta, value)
                self.repair_bytes += meta.size
                repaired = True
        if repaired:
            self.read_repairs += 1
            self._placement[key] = tuple(group)
        self._vclock[key] = max(self._vclock.get(key, 0), meta.version)
        return value

    def get_array(self, name) -> Optional[np.ndarray]:
        data = self.get(name)
        return None if data is None else unpack_array(data)

    def put_array(self, name, arr: np.ndarray) -> BlockMeta:
        return self.put(name, pack_array(arr))

    def contains(self, name) -> bool:
        """Placement-index probe (no repair, no version race): does the
        store believe it holds a live copy of this key?"""
        key = self.key_of(name)
        if key in self._tombs or key not in self._placement:
            return False
        return any(self._reachable(n) and self._copy(n, key) is not None
                   for n in self._placement[key])

    def remove(self, name) -> bool:
        """Delete from every reachable holder and bury the version: a
        stale copy rejoining later can never resurrect the block."""
        key = self.key_of(name)
        version = self._vclock.get(key, 0)
        found = False
        for node in set(self._placement.pop(key, ())) | set(self._group(key)):
            if self._reachable(node) and \
                    self._nodes.get(node, {}).pop(key, None) is not None:
                found = True
        if version:
            self._tombs[key] = version
        self._pkey.pop(key, None)
        self._names.pop(key, None)
        self.removes += 1
        return found

    # -- churn ---------------------------------------------------------------
    def drop_node(self, node: int) -> None:
        """Crash semantics: the node's physical store is destroyed (a
        graceful leave keeps it — the disk may rejoin within T_detach)."""
        self._nodes.pop(node, None)

    def sync(self) -> Dict[str, int]:
        """Churn-driven re-replication: restore r live copies for exactly
        the keys the membership batches since the last sync affected.

        Affected = keys inside the ``owner_diff`` arcs (a joiner/leaver
        moved their primary) UNION keys with a dead or unreachable
        recorded holder (the leaver was a non-primary replica).  Copy
        traffic — and the per-key placement recompute — is O(affected
        blocks), never O(blocks): the arc test is one vectorized pass
        and the holder test is a set probe per key."""
        target = self.state.active_version
        stats = {"checked": 0, "repaired": 0, "copied_bytes": 0, "lost": 0}
        if not self._placement:
            self._seen_version = target
            return stats
        diff = self.state.owner_diff(self._seen_version, target)
        keys = np.fromiter(self._placement, np.uint64, len(self._placement))
        # arc membership is tested on the PLACEMENT keys: a co-located
        # block moves exactly when its anchor's replica set moved
        pkeys = np.fromiter((self._pkey_of(int(k)) for k in keys),
                            np.uint64, keys.size) if self._pkey else keys
        arc_hit = diff.affected(pkeys)
        live = set(int(x) for x in self.state.active_ids())
        affected: List[int] = []
        for k, hit in zip(keys.tolist(), arc_hit):
            holders = self._placement[k]
            if hit or any(h not in live or
                          k not in self._nodes.get(h, ())
                          for h in holders):
                affected.append(k)
        stats["checked"] = len(affected)
        if affected:
            # replica_sets is policy-independent by the set-preserving
            # invariant: a policy ranks within the successor set, so the
            # repair target SET is the same under any policy
            groups = self.state.replica_sets(
                np.asarray([self._pkey_of(k) for k in affected], np.uint64),
                self.replication)
            for k, group_row in zip(affected, groups):
                group = [int(g) for g in group_row]
                self._replace(k, group, stats)
        self._seen_version = target
        self.repair_syncs += 1
        self.lost_blocks += stats["lost"]
        self.repair_bytes += stats["copied_bytes"]
        return stats

    def _replace(self, key: int, group: List[int],
                 stats: Dict[str, int]) -> None:
        """Re-place one key onto ``group``: freshest surviving copy wins,
        missing/stale members are rewritten, reachable ex-holders are
        trimmed back to exactly the replica set."""
        candidates = set(group) | set(self._placement.get(key, ()))
        best: Optional[Tuple[BlockMeta, bytes]] = None
        for node in candidates:
            if not self._reachable(node):
                continue
            entry = self._copy(node, key)
            if entry is not None and (best is None
                                      or entry[0].version > best[0].version):
                best = entry
        if best is None:
            # every copy died between syncs (more simultaneous failures
            # than replicas) — surface it, never serve a resurrected
            # tombstone or hang the placement index on a ghost
            del self._placement[key]
            self._pkey.pop(key, None)
            self._names.pop(key, None)
            stats["lost"] += 1
            return
        meta, value = best
        repaired = False
        for node in group:
            cur = self._copy(node, key)
            if cur is None or cur[0].version < meta.version:
                self._nodes.setdefault(node, {})[key] = (meta, value)
                stats["copied_bytes"] += meta.size
                repaired = True
        for node in self._placement.get(key, ()):
            if node not in group and self._reachable(node):
                self._nodes.get(node, {}).pop(key, None)
        self._placement[key] = tuple(group)
        if repaired:
            stats["repaired"] += 1

    # -- observability / invariants ------------------------------------------
    def replica_counts(self) -> Dict[int, int]:
        """key -> number of LIVE, checksum-valid, up-to-date copies (the
        invariant suite asserts this equals min(r, live peers) for every
        key after convergence)."""
        live = set(int(x) for x in self.state.active_ids())
        out: Dict[int, int] = {}
        for key in self._placement:
            newest = 0
            copies: List[int] = []
            for node in self._placement[key]:
                if node not in live:
                    continue
                entry = self._copy(node, key)
                if entry is None:
                    continue
                if entry[0].version > newest:
                    newest = entry[0].version
                    copies = [node]
                elif entry[0].version == newest:
                    copies.append(node)
            out[key] = len(copies)
        return out

    def stats(self) -> Dict[str, int]:
        return {
            "blocks": len(self._placement),
            "replication": self.replication,
            "puts": self.puts,
            "gets": self.gets,
            "removes": self.removes,
            "read_repairs": self.read_repairs,
            "repair_syncs": self.repair_syncs,
            "upload_bytes": self.upload_bytes,
            "repair_bytes": self.repair_bytes,
            "corrupt_copies": self.corrupt_copies,
            "lost_blocks": self.lost_blocks,
        }


# ---------------------------------------------------------------------------
# content-addressed prefix cache
# ---------------------------------------------------------------------------

class PrefixCache:
    """Cross-session prompt-prefix KV cache over a ``BlockStore``.

    Keys are content-addressed: chunk j of a prompt is stored under the
    hash of the token prefix ``tokens[:(j+1)*chunk]`` (plus a salt naming
    the model — KV from another checkpoint must never hit).  Because KV
    at a position depends on the WHOLE prefix, hashing the full prefix —
    not the chunk — is what makes a hit bit-exact: two sessions sharing
    a system prompt share every full chunk inside it, and the importing
    session skips those chunks' prefill FLOPs entirely.

    ``match`` stops one segment short of the prompt end: the final
    (possibly padded) segment must be computed anyway to produce the
    last-token logits the admit returns.
    """

    def __init__(self, store: BlockStore, *, chunk: int, salt: str = ""):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.store = store
        self.chunk = chunk
        self.salt = salt
        self.hits = 0          # chunks imported instead of computed
        self.misses = 0        # chunks computed (and then inserted)
        self.tokens_saved = 0  # prefill token-positions skipped

    def _name(self, tokens: np.ndarray, end: int) -> str:
        h = hashlib.sha1(self.salt.encode())
        h.update(np.ascontiguousarray(tokens[:end], np.int32).tobytes())
        return f"prefix/{h.hexdigest()}"

    def max_cover(self, length: int) -> int:
        """Longest importable prefix for a prompt of ``length`` tokens:
        whole chunks only, and never the final segment."""
        return max(((length - 1) // self.chunk) * self.chunk, 0)

    def chunk_name(self, tokens: np.ndarray, end: int) -> Optional[str]:
        """Public content-address of the chunk ending at ``end`` — what
        admission affinity keys warm-replica lookups on (None when the
        prompt has no importable chunk there)."""
        if end < self.chunk or end > self.max_cover(len(tokens)):
            return None
        return self._name(np.asarray(tokens, np.int32), end)

    def match(self, tokens: np.ndarray) -> Tuple[int, List[np.ndarray]]:
        """Longest contiguous run of cached prefix chunks: returns
        (covered token count, the chunk blocks to import)."""
        tokens = np.asarray(tokens, np.int32)
        blocks: List[np.ndarray] = []
        covered = 0
        cap = self.max_cover(len(tokens))
        while covered + self.chunk <= cap:
            end = covered + self.chunk
            data = self.store.get(self._name(tokens, end))
            if data is None:
                break
            blocks.append(unpack_array(data))
            covered = end
        self.hits += len(blocks)
        self.tokens_saved += covered
        return covered, blocks

    def insert(self, tokens: np.ndarray, off: int, block: np.ndarray) -> None:
        """Offer the freshly computed chunk ``[off, off+chunk)`` of a
        prompt; no-ops when an equal-content block is already stored."""
        tokens = np.asarray(tokens, np.int32)
        end = off + self.chunk
        if end > len(tokens):
            return                      # padded final segment: never cached
        name = self._name(tokens, end)
        self.misses += 1
        if self.store.contains(name):
            return
        self.store.put(name, pack_array(block))
