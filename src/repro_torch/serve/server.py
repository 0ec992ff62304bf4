"""Batched serving with D1HT session routing (port of ``repro.serve.server``).

Requests carry a session id; the D1HT ring (full routing table, one
local lookup) decides which serving replica owns the session's KV cache.
``SessionRouter`` resolves whole request batches on the device through
``RingState.lookup`` (kernels K1/K2).  Each ``Replica`` runs continuous
batched decode over its slots: every active slot decodes at its OWN
cache position, with decode attention in kernel K3 (the dense and MoE
families); a family without per-slot decode (SSM, hybrid) steps its
slots in lockstep and admits whole prompts, whose prefill scans in kernel
K6 (Mamba-1) or the plain-torch SSD (Mamba-2), and whose shared attention
block runs K5 in the prefill and K3 in decode.  A fused round runs
the bucketed ring lookup (K2) on the batch's session keys next to the
gather and decode, and reads the owners back with the tokens in one
host transfer.

A replica of a family with KV blocks (``Model.supports_kv_blocks``)
exports a session's chunks as host slabs, admits a session from such
slabs (``admit_from_blocks``: only the tail is re-prefilled), and with
a ``PrefixCache`` imports a prompt's cached prefix chunks instead of
computing them; ``repro_torch.serve.cluster.ServeCluster`` drives it.

Differences from ``repro`` that the port makes on purpose: the KV slab
is updated in place (no functional copy), out-of-range gather rows are
clamped and zeroed explicitly, and only the real rows are scattered back
(torch's index ops raise where JAX fills or drops).  A failed overlapped
prefill is recorded in ``failed_prefills`` unless the failure is the
device's (``backend.DEVICE_FAULTS``), which propagates.

A replica built on a tensor-parallel group (``group=``, a
``models.tp.TPReplicaGroup``) holds one cache and one parameter tree a
shard, runs every forward, slot write and decode round on the group's
shard threads, joins the shards' vocab slices and takes the greedy pick
here, and runs no fused route (the ring lookup stays host-side for
groups, as in ``repro``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.ring import hash_id
from ..core.ringstate import RingState
from ..kernels.backend import (DEVICE_FAULTS, resolve_device, strict_fp32,
                               synchronize)
from ..kernels.ring_lookup.ops import ring_lookup_bucketed
from ..models import Model
from ..runtime import Membership


@dataclass
class Request:
    session_id: str
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16


class SessionRouter:
    """Batched session -> replica resolution over the ring.

    Routes from the Membership's shared ``RingState``: the sorted table
    lives on the device as capacity-padded (hi, lo) word pairs and is
    re-uploaded only when a membership event bumps the state version —
    never per request batch — and lookups compare full 64-bit IDs.
    """

    def __init__(self, membership: Membership):
        self.membership = membership
        self.state: RingState = membership.ring_state
        self.route_ns = 0
        self.route_batches = 0
        self.route_keys = 0

    @property
    def uploads(self) -> int:
        """Device-table uploads so far."""
        return self.state.upload_count

    @property
    def route_us_per_key(self) -> float:
        """Measured mean resolution cost per routed key (host clock,
        including the lookup's one device read)."""
        return self.route_ns / 1e3 / max(self.route_keys, 1)

    def route(self, session_ids: List[str]) -> List[int]:
        keys = np.fromiter(
            (session_key(s) for s in session_ids),
            np.uint64, len(session_ids))
        t0 = time.perf_counter_ns()
        owners = self.state.lookup(keys)
        self.route_ns += time.perf_counter_ns() - t0
        self.route_batches += 1
        self.route_keys += len(session_ids)
        return [int(p) for p in owners]


def session_key(session_id: str) -> int:
    """Ring key of a session (shared by router, placement and cluster)."""
    return hash_id(f"session/{session_id}")


def _decode_bucket(active: int, slots: int) -> int:
    """Pad an active-slot count to the next power of two (capped at the
    slot count): decode batches only ever take log2(slots)+1 shapes."""
    b = 1
    while b < active:
        b *= 2
    return min(b, slots)


def _words(a: np.ndarray) -> torch.Tensor:
    """uint32 host words -> int32 tensor carrying the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _write_row(cache: Dict[str, torch.Tensor], one: Dict[str, torch.Tensor],
               slot: int) -> None:
    for name, dst in cache.items():
        dst[:, slot] = one[name][:, 0]


def _decode_rows(model: Model, params, cache: Dict[str, torch.Tensor],
                 tokens: np.ndarray, lengths: np.ndarray,
                 idx: Optional[np.ndarray], n: int, lockstep: Optional[int],
                 dev: torch.device) -> torch.Tensor:
    """One decode step of a replica's slab on ``dev``, in place: every row
    when ``idx`` is None, else the rows ``idx`` (the first ``n`` real,
    the rest padding that reads zeros and is never written back).
    Returns the (rows, V) logits."""
    tok = torch.from_numpy(tokens).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    if idx is None:
        logits, _ = model.decode_step(params, cache, tok,
                                      ln if lockstep is None else lockstep)
        return logits
    at = torch.from_numpy(idx).to(dev)
    sub = {name: c.index_select(1, at) for name, c in cache.items()}
    tok, ln = tok[at], ln[at]
    for t in sub.values():
        t[:, n:] = 0
    tok[n:] = 0
    ln[n:] = 0
    logits, sub = model.decode_step(params, sub, tok,
                                    ln if lockstep is None else lockstep)
    real = at[:n]
    for name, c in cache.items():
        c.index_copy_(1, real, sub[name][:, :n])
    return logits


class Replica:
    """One serving replica: a slab of continuous-batching decode slots.

    Slot bookkeeping is flat per-slot host arrays (``lengths``,
    ``tokens``, ``active``) plus an O(1) free-list.  ``decode_round``
    compacts the active slots into a power-of-two bucket and steps only
    those rows, each at its own cache position.  ``device=None`` means
    the CUDA card (raises without one); pass ``device="cpu"`` to run on
    the host.  ``generation`` is the membership generation the replica
    was created at; ``prefix_cache`` a ``dht.data.PrefixCache`` that
    chunked prefills consult and feed (families with KV blocks only).
    ``group`` is a ``models.tp.TPReplicaGroup``: the replica then lives
    on the group's devices (``device`` is ignored) and ``attach_params``
    takes the group's shard list (``group.shard_params``).
    """

    def __init__(self, model: Model, *, slots: int, max_len: int,
                 generation: int = 0, prefill_chunk: Optional[int] = None,
                 prefix_cache=None, device=None, group=None):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.generation = generation
        self.group = group
        # the forward's owner: the group's shards, or the model on device
        self._fwd = model if group is None else group
        self.device = resolve_device(device) if group is None \
            else group.devices[0]
        if self.device.type == "cuda":
            strict_fp32()
        self.prefix_cache = prefix_cache if model.supports_kv_blocks else None
        # wall time the last admit_from_blocks spent importing blocks
        # (the cluster splits handoff transfer from re-prefill with it)
        self.import_us = 0.0
        self.cache = self._init_cache(slots)
        self.lengths = np.zeros((slots,), np.int32)
        self.tokens = np.zeros((slots, 1), np.int32)
        self.active = np.zeros((slots,), bool)
        # per-slot session ring-key words for the fused route→decode round
        self.key_hi = np.zeros((slots,), np.uint32)
        self.key_lo = np.zeros((slots,), np.uint32)
        self.sessions: Dict[str, int] = {}
        self._free = list(range(slots - 1, -1, -1))   # pop() -> slot 0 first
        self.prefill_chunk = prefill_chunk \
            if model.supports_chunked_prefill else None
        # in-flight overlapped prefills: sid -> progress state (slot is
        # reserved but the session is NOT in ``sessions`` until complete)
        self._pending: Dict[str, dict] = {}
        # owners resolved by the last *fused* decode round: sid -> uint64
        self.routed_owners: Dict[str, int] = {}
        # sids whose overlapped prefill failed (slot already released)
        self.failed_prefills: List[str] = []

    @property
    def num_active(self) -> int:
        return len(self.sessions)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_pending(self) -> int:
        return len(self._pending)

    def attach_params(self, params) -> None:
        self.params = params

    def _init_cache(self, batch: int):
        if self.group is not None:
            return self.group.init_cache(batch, self.max_len)
        return self.model.init_cache(batch, self.max_len, device=self.device)

    def _fresh_cache(self):
        return self._init_cache(1)

    def _sync(self) -> None:
        for dev in (self.group.devices if self.group is not None
                    else (self.device,)):
            synchronize(dev)

    def _cache_with_blocks(self, blocks):
        """A one-row cache holding ``blocks`` from position 0; each block
        must cover exactly one prefill chunk (a shorter run would leave
        positions the tail prefill never writes)."""
        if any(b.ndim < 2 or b.shape[1] != self.prefill_chunk
               for b in blocks):
            raise ValueError("a KV block does not cover one prefill chunk "
                             f"of {self.prefill_chunk} positions")
        if self.group is not None:
            return self.group.cache_with_blocks(self.max_len, blocks)
        return self.model.cache_with_blocks(self.max_len, blocks,
                                            device=self.device)

    def _release(self, slot: int) -> None:
        self._free.append(slot)
        self.active[slot] = False
        self.lengths[slot] = 0
        self.tokens[slot, 0] = 0

    def admit(self, req: Request) -> int:
        """Prefill a prompt into a free slot (a one-row cache, then
        written into the slab) and return the first generated token.
        Any prefill failure rolls the slot allocation back."""
        s = len(req.prompt)
        if s >= self.max_len:   # validate BEFORE allocating
            raise ValueError(f"prompt of {s} tokens >= max_len {self.max_len}")
        fresh = False
        if req.session_id in self.sessions:
            slot = self.sessions[req.session_id]
        elif self._free:
            slot = self._free.pop()
            self.sessions[req.session_id] = slot
            fresh = True
        else:
            raise RuntimeError("replica full")
        try:
            one = self._fresh_cache()
            if self._chunkable(s):
                tok, one = self._run_chunks(req.prompt, one)
            else:
                prompt = torch.from_numpy(np.asarray(req.prompt, np.int32))
                batch = {"tokens": prompt.to(self.device)[None, :]}
                logits, one = self._fwd.prefill(self.params, batch, one)
                tok = int(torch.argmax(logits[0]))
            self._write_slot(one, slot)
            self._commit_slot(req.session_id, slot, s, tok)
        except BaseException:
            if fresh:
                del self.sessions[req.session_id]
                self._release(slot)
            raise
        return tok

    # -- chunked / overlapped prefill ---------------------------------------
    def _chunkable(self, s: int) -> bool:
        """Chunk the prefill iff a chunk size is configured and the
        padded prompt fits the cache."""
        c = self.prefill_chunk
        return bool(c) and (s + c - 1) // c * c <= self.max_len

    def _segment(self, buf: np.ndarray, off: int) -> torch.Tensor:
        c = self.prefill_chunk
        return torch.from_numpy(buf[off:off + c]).to(self.device)[None, :]

    def _run_chunks(self, prompt: np.ndarray, one, *,
                    start: int = 0) -> Tuple[int, object]:
        """Drive the fixed-shape segment program over a prompt from cache
        position ``start`` (0 = the whole prompt; > 0 continues over a
        cache whose first ``start`` positions were imported from KV
        blocks); returns (first generated token, filled one-row cache).

        With a prefix cache and ``start == 0``, the longest cached
        token-prefix is imported instead of computed, and every freshly
        computed full chunk is offered back."""
        c = self.prefill_chunk
        s = len(prompt)
        if start == 0 and self.prefix_cache is not None:
            covered, blocks = self.prefix_cache.match(prompt)
            if covered:
                one = self._cache_with_blocks(blocks)
                start = covered
        padded = (s + c - 1) // c * c
        buf = np.zeros(padded, np.int32)
        buf[:s] = prompt
        logits = None
        for off in range(start, padded, c):
            logits, one = self._fwd.prefill_chunk(
                self.params, self._segment(buf, off), one, off)
            if self.prefix_cache is not None and off + c <= s:
                self.prefix_cache.insert(
                    prompt, off, self._fwd.export_kv_block(one, 0, off, c))
        # the prompt's last real token sits at column (s-1) - (padded-c)
        # of the final (right-padded) segment's all-position logits
        tok = int(torch.argmax(logits[0, (s - 1) - (padded - c)]))
        return tok, one

    def admit_from_blocks(self, req: Request, blocks) -> int:
        """Admit from imported KV blocks: cache positions
        [0, len(blocks)*chunk) come off the wire, only the rest of the
        prompt is re-prefilled.  The blocks are bit-identical to what
        this replica would have computed, so the token — and every decode
        after it — matches a from-scratch admit.  No blocks: ``admit``.
        A failed import or tail prefill leaks no slot.  ``import_us`` is
        the import's wall time between two device syncs."""
        if not blocks:
            return self.admit(req)
        s = len(req.prompt)
        c = self.prefill_chunk
        if not self._chunkable(s):
            raise ValueError("prompt not chunkable on this replica")
        covered = len(blocks) * c
        if covered > max(((s - 1) // c) * c, 0):
            raise ValueError("blocks cover the final segment: the tail "
                             "must be recomputed to produce logits")
        if s >= self.max_len:
            raise ValueError(f"prompt of {s} tokens >= max_len {self.max_len}")
        fresh = False
        if req.session_id in self.sessions:
            slot = self.sessions[req.session_id]
        elif self._free:
            slot = self._free.pop()
            self.sessions[req.session_id] = slot
            fresh = True
        else:
            raise RuntimeError("replica full")
        try:
            self._sync()
            t0 = time.perf_counter_ns()
            one = self._cache_with_blocks(blocks)
            self._sync()
            self.import_us = (time.perf_counter_ns() - t0) / 1e3
            tok, one = self._run_chunks(req.prompt, one, start=covered)
            self._write_slot(one, slot)
            self._commit_slot(req.session_id, slot, s, tok)
        except BaseException:
            if fresh:
                del self.sessions[req.session_id]
                self._release(slot)
            raise
        return tok

    def export_block(self, session_id: str, j: int) -> np.ndarray:
        """Chunk ``j`` of the session's live cache as a host slab
        (positions [j*chunk, (j+1)*chunk); the caller guarantees the
        session's length has crossed that boundary)."""
        c = self.prefill_chunk
        return self._fwd.export_kv_block(self.cache, self.sessions[session_id],
                                         j * c, c)

    def export_block_shards(self, session_id: str, j: int) -> List[np.ndarray]:
        """Chunk ``j`` as per-shard slabs — shard s is the kv-head slice
        shard s of the replica group holds (a one-element list for a
        single-device replica), each storable on its own so a group
        export never gathers the full slab onto one device."""
        if self.group is None:
            return [self.export_block(session_id, j)]
        c = self.prefill_chunk
        return self.group.export_kv_shards(
            self.cache, self.sessions[session_id], j * c, c)

    def _commit_slot(self, session_id: str, slot: int, s: int,
                     tok: int) -> None:
        key = np.uint64(session_key(session_id))
        self.key_hi[slot] = np.uint32(key >> np.uint64(32))
        self.key_lo[slot] = np.uint32(key & np.uint64(0xFFFFFFFF))
        self.lengths[slot] = s
        self.tokens[slot, 0] = tok
        self.active[slot] = True

    def begin_admit(self, req: Request) -> Optional[int]:
        """Start an admit that overlaps with decode rounds.

        When the prompt is chunkable the slot is reserved, the prefill
        state parked in ``_pending``, and None is returned —
        ``advance_prefills`` then moves it one fixed-shape chunk at a
        time until the first token materializes.  Otherwise this is the
        synchronous ``admit``.  The session enters ``sessions`` only on
        completion, so a half-filled slot is never decoded."""
        s = len(req.prompt)
        if not self._chunkable(s):
            return self.admit(req)
        if req.session_id in self.sessions or req.session_id in self._pending:
            raise RuntimeError(f"session {req.session_id} already resident")
        if s >= self.max_len:
            raise ValueError(f"prompt of {s} tokens >= max_len {self.max_len}")
        if not self._free:
            raise RuntimeError("replica full")
        slot = self._free.pop()
        c = self.prefill_chunk
        padded = (s + c - 1) // c * c
        buf = np.zeros(padded, np.int32)
        buf[:s] = np.asarray(req.prompt, np.int32)
        st = {"slot": slot, "cache": None, "prompt": buf, "s": s, "off": 0,
              "logits": None}
        if self.prefix_cache is not None:
            # overlapped admits hit the prefix cache too (inserts stay on
            # the synchronous path only)
            covered, blocks = self.prefix_cache.match(
                np.asarray(req.prompt, np.int32))
            if covered:
                st["cache"] = self._cache_with_blocks(blocks)
                st["off"] = covered
        if st["cache"] is None:
            st["cache"] = self._fresh_cache()
        self._pending[req.session_id] = st
        return None

    def advance_prefills(self, chunks: int = 1) -> Dict[str, int]:
        """Advance every in-flight overlapped prefill by up to ``chunks``
        segments; returns {sid: first token} for the ones that completed.
        A failed chunk releases the reserved slot, drops the pending
        state and records the sid in ``failed_prefills`` (siblings'
        completions are kept); a device fault is re-raised after the
        release."""
        done: Dict[str, int] = {}
        for sid in list(self._pending):
            st = self._pending[sid]
            try:
                c = self.prefill_chunk
                for _ in range(chunks):
                    off = st["off"]
                    st["logits"], st["cache"] = self._fwd.prefill_chunk(
                        self.params, self._segment(st["prompt"], off),
                        st["cache"], off)
                    st["off"] = off + c
                    if st["off"] >= len(st["prompt"]):
                        break
                if st["off"] < len(st["prompt"]):
                    continue
                padded, s, slot = len(st["prompt"]), st["s"], st["slot"]
                tok = int(torch.argmax(
                    st["logits"][0, (s - 1) - (padded - c)]))
                self._write_slot(st["cache"], slot)
                self.sessions[sid] = slot
                self._commit_slot(sid, slot, s, tok)
                del self._pending[sid]
                done[sid] = tok
            except Exception as exc:
                del self._pending[sid]
                self._release(st["slot"])
                if isinstance(exc, DEVICE_FAULTS):
                    raise
                self.failed_prefills.append(sid)
        return done

    def _write_slot(self, one_cache, slot: int) -> None:
        if self.group is None:
            _write_row(self.cache, one_cache, slot)
        else:
            self.group.map(lambda i: _write_row(self.cache[i], one_cache[i],
                                                slot))

    def decode_round(self, route=None) -> Dict[str, int]:
        """One decode step for all active sessions — each at its own
        cache position.  The active slots are compacted into a batch
        padded to a power-of-two bucket (``_decode_bucket``); padding
        rows read zeros and are never written back.

        ``route`` is the device bucket directory (bkt_hi, bkt_lo, occ)
        from ``RingState.device_bucket_table``: when given, the round is
        FUSED — the bucketed owner lookup (K2) on the batch's session
        keys runs in the same round, and the owners land in
        ``routed_owners`` (sid -> uint64 peer id).  One host read per
        round either way: the B tokens (and the owner words)."""
        self.routed_owners = {}
        if self.group is not None:
            route = None     # the ring lookup stays host-side for groups
        if not self.sessions:
            return {}
        act_idx = np.nonzero(self.active)[0]
        if (self.lengths[act_idx] >= self.max_len).any():
            raise RuntimeError(f"a session reached max_len {self.max_len}")
        n = act_idx.size
        bucket = _decode_bucket(n, self.slots)
        # lockstep families (SSM, hybrid) step every row at the longest
        # active session's length, as repro's ``_index``; padding rows
        # keep state 0 and are dropped on the way back
        lockstep = None if self.model.supports_per_slot_decode \
            else int(self.lengths[act_idx].max())
        # full house: the gather would be the identity — step the slab in
        # place (inactive rows decode garbage at position 0, as repro's
        # full-house round does; admit rewrites the slot).  Otherwise the
        # padding rows' index is clamped to a real slot and what they
        # gathered is zeroed: they decode at position 0 and are dropped
        idx = None
        if bucket < self.slots:
            idx = np.full(bucket, self.slots - 1, np.int64)
            idx[:n] = act_idx
        owners = None
        if self.group is not None:
            g = self.group
            logits = g.join_logits(g.map(lambda i: _decode_rows(
                g.local_model, self.params[i], self.cache[i], self.tokens,
                self.lengths, idx, n, lockstep, g.devices[i])))
        else:
            if route is not None:
                key_hi = _words(self.key_hi).to(self.device)
                key_lo = _words(self.key_lo).to(self.device)
                if idx is not None:
                    at = torch.from_numpy(idx).to(self.device)
                    key_hi, key_lo = key_hi[at], key_lo[at]
                    key_hi[n:] = 0
                    key_lo[n:] = 0
                owners = ring_lookup_bucketed(key_hi, key_lo, *route)
            logits = _decode_rows(self.model, self.params, self.cache,
                                  self.tokens, self.lengths, idx, n,
                                  lockstep, self.device)
        rows = act_idx if idx is None else np.arange(n)
        picked = torch.argmax(logits, dim=-1).to(torch.int32)
        row_of = {int(s): int(r) for s, r in zip(act_idx, rows)}
        if owners is not None:
            host = torch.stack([picked, *owners]).cpu().numpy()
            nxt = host[0]
            words = host[1:].view(np.uint32).astype(np.uint64)
            owner_ids = (words[0] << np.uint64(32)) | words[1]
            self.routed_owners = {sid: int(owner_ids[row_of[slot]])
                                  for sid, slot in self.sessions.items()}
        else:
            nxt = picked.cpu().numpy()
        self.tokens[act_idx, 0] = nxt[rows]
        self.lengths[act_idx] += 1
        return {sid: int(nxt[row_of[slot]])
                for sid, slot in self.sessions.items()}

    def evict(self, session_id: str) -> None:
        """Free the session's slot and zero its row."""
        slot = self.sessions.pop(session_id, None)
        if slot is None:
            pend = self._pending.pop(session_id, None)
            if pend is not None:           # abandon an in-flight prefill
                self._free.append(pend["slot"])
            return
        self._release(slot)
        self.key_hi[slot] = 0
        self.key_lo[slot] = 0
