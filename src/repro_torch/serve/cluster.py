"""ServeCluster — churn-aware continuous-batching orchestration over the
D1HT ring (port of ``repro.serve.cluster``).

ServeCluster turns RingState into an end-to-end serve plane:

  * **Ownership**: a session's key is its ring hash; its home replica is
    the key's successor, resolved through the shared device-resident
    table (one hop, no directory — the paper's whole point).
  * **Membership subscription**: on every leave/quarantine/join batch the
    cluster asks ``RingState.owner_diff`` which key RANGES moved and
    re-resolves only the sessions inside them — O(affected), not
    O(sessions) per event.
  * **Migration**: an affected session moves to its ``replica_set``
    successor (Leslie's r-way successor-list replica group) and is
    re-prefilled from its transcript — the control plane keeps every
    session's prompt + generated tokens as the recoverable hot state
    (DistHash's replicated-object model), so a crash loses no session
    even though the device slab is gone.
  * **Quarantine gateways** (paper §V): a quarantined node owns no
    sessions (the mask excludes it from the active view) but proxies
    submissions to the real owner, paying one extra nearby hop.
  * **Generation restarts**: ``runtime.failover.ReplicaSupervisor`` pins
    a required generation per departed node; a node re-entering the ring
    gets a FRESH replica (its old slab is stale) instead of resuming.
  * **KV data plane** (``dht.data``): every session's full KV chunks are
    replicated on its replica set, so a migration is a cache HANDOFF
    (fetch + tail re-prefill), and prompt-prefix chunks are shared
    across sessions through the ``PrefixCache``.

Differences from ``repro``.  Every replica is built on ``device`` (None =
the CUDA card) and takes its decode attention route from the device, so
there is no ``decode_kernel=`` switch.  ``_calibrate_route`` times the
port's bucketed lookup (K2) between two device syncs.  Tensor-parallel
replica groups (``tp > 1``, ``mesh=``, ``lose_device``) are not ported:
``tp > 1`` raises, naming ROADMAP queue 1 item 3.  A handoff import or a
migration admit that fails degrades to recompute or a retry as in
``repro``, except for a device fault (``backend.DEVICE_FAULTS``), which
propagates.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from ..analysis.metering import metered
from ..core.ringstate import _BUCKET_MIN_N
from ..dht.data import BlockStore, PrefixCache, pack_array, unpack_array
from ..kernels.backend import DEVICE_FAULTS, synchronize
from ..kernels.ring_lookup.ops import ring_lookup_bucketed
from ..models import Model
from ..runtime import Membership, ReplicaSupervisor
from ..runtime.placement import PlacementPolicy

from .server import Replica, Request, SessionRouter, _words, session_key


@dataclass
class SessionRecord:
    """Control-plane view of one session — everything needed to rebuild
    it anywhere (the recoverable hot state)."""

    session_id: str
    key: int                       # ring key id
    prompt: np.ndarray
    max_new_tokens: int
    owner: int = -1
    # where the request physically came from (a node id or a Topology
    # region name; None = no locality info) — the placement policy's
    # ranking origin for this session's admission AND every later
    # migration, so a re-home optimizes for the same client
    origin: Optional[object] = None
    generated: List[int] = field(default_factory=list)
    migrations: int = 0
    done: bool = False
    # KV chunks exported to the replicated block store so far (chunk j
    # covers cache positions [j*chunk, (j+1)*chunk) of the transcript)
    exported_chunks: int = 0

    @property
    def transcript(self) -> np.ndarray:
        """prompt + every generated token: re-prefilling this on a new
        replica reproduces the decode state exactly (the last generated
        token is the pending input, so the prefill's next-token output is
        bit-for-bit what the old replica's next round would have
        emitted)."""
        if not self.generated:
            return np.asarray(self.prompt, np.int32)
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.generated, np.int32)])


@dataclass
class RequestTrace:
    """Per-request wall-clock breakdown through the serve path (all in
    microseconds) — the measured request-latency plane's serve-side leg
    (DESIGN.md §9):

      * ``route_us``  — owner resolution (replica_set successor walks at
        submit and on every migration);
      * ``queue_us``  — capacity probing plus any time the session spent
        stranded waiting for a replica_set slot to free;
      * ``decode_us`` — prefill(s), including migration re-prefills, plus
        this session's share of every decode round it took a token from;
      * ``handoff_us`` — cache-TRANSFER time on migrations: fetching the
        session's KV blocks from the replica set plus importing them
        into the new replica's cache.  Kept apart from ``decode_us`` so
        a handoff (transfer) and a re-prefill (recompute) migration are
        distinguishable in the report instead of both landing in the
        route/decode buckets.
    """

    submitted_ns: int = 0
    completed_ns: int = 0
    queue_us: float = 0.0
    route_us: float = 0.0
    decode_us: float = 0.0
    handoff_us: float = 0.0
    _stranded_ns: int = 0          # transient: set while awaiting re-home

    @property
    def done(self) -> bool:
        return self.completed_ns > 0

    @property
    def total_us(self) -> float:
        """Submit -> completion wall time (in-flight sessions read 'so
        far')."""
        end = self.completed_ns or time.perf_counter_ns()
        return (end - self.submitted_ns) / 1e3


class ServeCluster:
    """Cluster-wide serve plane: replicas keyed by ring node, sessions
    migrated on churn, quarantined nodes proxying as gateways.
    ``device=None`` builds every replica on the CUDA card (raises without
    one); pass ``device="cpu"`` to serve on the host."""

    def __init__(self, membership: Membership, model: Model, params, *,
                 slots: int = 8, max_len: int = 64, replication: int = 2,
                 prefill_chunk: Optional[int] = 16,
                 prefill_duty: int = 6,
                 fused: Optional[bool] = None,
                 kv_blocks: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 block_store: Optional[BlockStore] = None,
                 tp: int = 1,
                 policy: Optional[PlacementPolicy] = None,
                 device=None):
        if int(tp) != 1:
            raise NotImplementedError("tensor-parallel replica groups "
                                      "(tp > 1) are not ported yet: ROADMAP "
                                      "queue 1, item 3")
        self.membership = membership
        self.state = membership.ring_state
        # every placement decision in the serve plane — admission spill,
        # migration targets, stranded re-homes — ranks through ONE
        # policy (DESIGN.md §13); default = the membership's policy (so
        # gateways and the serve plane always agree), which itself
        # defaults to RingSuccessor = the legacy successor-walk order
        self.policy = policy if policy is not None else membership.policy
        self.model = model
        self.params = params
        self.device = device
        self.slots = slots
        self.max_len = max_len
        self.replication = replication
        # chunked prefill segment length (None/0 = whole-prompt prefill);
        # migration re-prefills additionally OVERLAP decode rounds
        self.prefill_chunk = prefill_chunk
        # stall-free scheduling: advance in-flight prefill chunks only
        # every Nth decode round, bounding the sustained decode-
        # throughput hit to ~chunk_cost/(N*round_cost) while the drain
        # stays far below a synchronous whole-prompt re-prefill
        self.prefill_duty = max(int(prefill_duty), 1)
        self._step_seq = 0
        # fused route→gather→decode rounds: None = auto (engage once the
        # ring is big enough for the bucket directory to pay for itself —
        # the same _BUCKET_MIN_N threshold the lookup dispatch uses),
        # True = force (tests / small rings), False = never
        self.fused = fused
        self.router = SessionRouter(membership)
        self.supervisor = ReplicaSupervisor(membership)
        # prefix-cache-aware admission: node -> content-addresses of the
        # prefix chunks that node has computed or imported (warm = no
        # fetch needed in a real placement); ``submit`` prefers a warm
        # replica_set candidate when several have capacity
        self._warm_prefixes: Dict[int, Set[str]] = {}
        self.prefix_affinity_hits = 0
        self.replicas: Dict[int, Replica] = {}
        self.sessions: Dict[str, SessionRecord] = {}
        self.traces: Dict[str, RequestTrace] = {}
        self.proxied: Dict[int, int] = {}      # gateway node -> proxy count
        self.migrated_sessions = 0
        # locality accounting: placements whose target sits in a
        # different Topology region than the request's origin (only
        # metered when the policy carries a topology and the request an
        # origin — the geo demo/bench read these)
        self.cross_region_admits = 0
        self.cross_region_migrations = 0
        self.stranded = 0                  # handoff attempts deferred on
        # overlapped migration re-prefills in flight: sid -> target node
        self._pending_homes: Dict[str, Dict] = {}
        self._retry: Set[str] = set()      # sids needing an off-event re-home
        # DHT-backed KV data plane (DESIGN.md §11): None = auto (on when
        # the family exports KV blocks and prefill is chunked).  The
        # store replicates every session's full KV chunks across the
        # ring, so migration becomes a cache HANDOFF (fetch + tail
        # re-prefill) instead of a transcript recompute; the prefix
        # cache shares prompt-prefix chunks across sessions.
        want_kv = kv_blocks if kv_blocks is not None else \
            bool(self.prefill_chunk) and model.supports_kv_blocks
        self.blocks: Optional[BlockStore] = None
        self.prefix: Optional[PrefixCache] = None
        if want_kv:
            if not (self.prefill_chunk and model.supports_kv_blocks):
                raise ValueError("kv_blocks needs a chunk-prefill family "
                                 "and a prefill_chunk size")
            self.blocks = block_store if block_store is not None else \
                BlockStore(self.state, replication=replication,
                           policy=self.policy)
            if prefix_cache is None or prefix_cache:
                self.prefix = PrefixCache(self.blocks,
                                          chunk=self.prefill_chunk,
                                          salt=model.cfg.name)
        self.handoffs = 0              # migrations served from KV blocks
        self.handoff_misses = 0        # block fetches that found nothing
        self.handoff_chunks = 0        # chunks imported instead of recomputed
        self.exported_blocks = 0       # chunks shipped into the store
        self.fused_rounds = 0
        self.fused_routed_keys = 0
        # fused-route owners that differ from the control plane's record:
        # sessions living on a replica_set spill member or mid-migration
        self.route_divergence = 0
        self._route_cal_us_per_key: Optional[float] = None
        self.state.track_owner_diffs()     # arm arc logging before events
        self._seen_version = self.state.active_version
        membership.subscribe(self._on_event)

    # -- replica lifecycle ---------------------------------------------------
    def _live_replica(self, node: int) -> Optional[Replica]:
        """The node's replica iff its device state is still valid.  A
        slab built before the node left and re-entered is stale —
        discarded here, so every caller (capacity probe, residency
        check, admit) agrees on restart-means-fresh (failover generation
        bump drives the replica restart)."""
        rep = self.replicas.get(node)
        if rep is not None and self.supervisor.needs_restart(node,
                                                            rep.generation):
            del self.replicas[node]
            self._forget_node(node)
            return None
        return rep

    def _replica_for(self, node: int) -> Replica:
        rep = self._live_replica(node)
        if rep is None:
            rep = Replica(self.model, slots=self.slots, max_len=self.max_len,
                          generation=self.supervisor.stamp(),
                          prefill_chunk=self.prefill_chunk,
                          prefix_cache=self.prefix, device=self.device)
            rep.attach_params(self.params)
            self.replicas[node] = rep
        return rep

    def _has_capacity(self, node: int) -> bool:
        rep = self._live_replica(node)
        if rep is not None:
            return rep.num_free > 0
        return self.slots > 0

    def _forget_node(self, node: int) -> None:
        """A node's replica is gone: drop its warm-prefix residency."""
        self._warm_prefixes.pop(node, None)

    def _session_resident(self, rec: "SessionRecord") -> bool:
        """Does the session's slot actually exist on its recorded owner?
        False for stranded sessions (owner died with the slab) — even if
        the same node id later re-enters the ring with a fresh replica."""
        rep = self._live_replica(rec.owner)
        return rep is not None and rec.session_id in rep.sessions

    # -- request intake --------------------------------------------------------
    def submit(self, req: Request, *, via: Optional[int] = None,
               origin=None) -> int:
        """Admit a session and return its first generated token.

        ``via`` is the node the request physically arrived at.  A
        quarantined ``via`` node acts as a §V gateway: it forwards to the
        key's owner without ever owning the session (it is masked out of
        the active view, so the lookup can never pick it).  ``origin``
        (a node id or Topology region name; defaults to ``via``) is the
        locality the placement policy optimizes for — it sticks to the
        session, so migrations keep serving the same client."""
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            # guarantees any mid-stream transcript (prompt + generated,
            # at most prompt + max_new - 1 tokens) re-prefills into a
            # successor's cache on migration
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        if via is not None and self.state.is_quarantined(via):
            self.proxied[via] = self.proxied.get(via, 0) + 1
        if origin is None:
            origin = via
        t_sub = time.perf_counter_ns()
        key = session_key(req.session_id)
        # host-side policy-ranked replica group (no device dispatch for a
        # single key); admission spills down the ranked group exactly
        # like migration does, so a hot arc fills its group before
        # rejecting — ring-successor order under the default policy
        group = self.policy.replica_group(self.state, key,
                                          self.replication, origin=origin)
        t_route = time.perf_counter_ns()
        cands = [n for n in group if self._has_capacity(n)]
        owner = cands[0] if cands else None
        if owner is None:
            raise RuntimeError(
                f"no capacity in the {len(group)}-way replica set for "
                f"session {req.session_id}")
        if len(cands) > 1:
            # prefix-cache-aware admission: among capacity-holding
            # replica_set candidates, prefer one that already computed or
            # imported this prompt's first prefix chunk (warm = the
            # prefix KV needs no fetch in a real placement)
            warm = self._warm_candidate(req.prompt, cands)
            if warm is not None:
                owner = warm
                self.prefix_affinity_hits += 1
        rec = SessionRecord(req.session_id, key, np.asarray(req.prompt,
                                                            np.int32),
                            req.max_new_tokens, owner=owner, origin=origin)
        self._note_region(rec, migration=False)
        t_queue = time.perf_counter_ns()
        tok = self._replica_for(owner).admit(req)
        self._note_warm(owner, rec.prompt)
        t_admit = time.perf_counter_ns()
        self.traces[req.session_id] = RequestTrace(
            submitted_ns=t_sub,
            route_us=(t_route - t_sub) / 1e3,
            queue_us=(t_queue - t_route) / 1e3,
            decode_us=(t_admit - t_queue) / 1e3)
        self.sessions[req.session_id] = rec
        self._export_session(rec)      # replicate the prompt's KV chunks
        self._push_token(rec, tok)
        return tok

    # -- placement-policy plumbing --------------------------------------------
    def _group_for(self, rec: "SessionRecord") -> List[int]:
        """Policy-ranked replica group for a session's NEXT placement:
        ranked from the session's recorded origin, with the current
        owner as the affinity candidate (policies may discount it so
        churn does not bounce a well-placed session; RingSuccessor
        ignores both and reproduces the legacy successor walk)."""
        return self.policy.replica_group(
            self.state, rec.key, self.replication,
            origin=rec.origin, prefer=rec.owner if rec.owner >= 0 else None)

    def _note_region(self, rec: "SessionRecord", *, migration: bool) -> None:
        topo = self.policy.topology
        if topo is None or rec.origin is None:
            return
        if topo.region_of(rec.owner) != (
                rec.origin if isinstance(rec.origin, str)
                else topo.region_of(rec.origin)):
            if migration:
                self.cross_region_migrations += 1
            else:
                self.cross_region_admits += 1

    # -- prefix-affinity bookkeeping ------------------------------------------
    def _warm_candidate(self, prompt, cands: List[int]) -> Optional[int]:
        if self.prefix is None:
            return None
        name = self.prefix.chunk_name(np.asarray(prompt, np.int32),
                                      self.prefix.chunk)
        if name is None:
            return None
        return next((n for n in cands
                     if name in self._warm_prefixes.get(n, ())), None)

    def _note_warm(self, node: int, prompt) -> None:
        """Record that ``node`` now holds every full prefix chunk of this
        prompt (it just computed or imported them)."""
        if self.prefix is None:
            return
        prompt = np.asarray(prompt, np.int32)
        c = self.prefix.chunk
        names = set()
        for end in range(c, self.prefix.max_cover(len(prompt)) + 1, c):
            nm = self.prefix.chunk_name(prompt, end)
            if nm is not None:
                names.add(nm)
        if names:
            self._warm_prefixes.setdefault(node, set()).update(names)

    # -- KV data plane (DESIGN.md §11) ----------------------------------------
    @staticmethod
    def _block_name(session_id: str, j: int) -> str:
        """Store name of chunk ``j`` (``repro``'s name for shard 0: one
        card holds every kv head)."""
        return f"kv/{session_id}/{j}"

    def _export_session(self, rec: SessionRecord) -> None:
        """Ship every newly completed KV chunk of the session's live
        cache into the replicated store (put = r-way successor write).
        These blocks are what make a later migration a cache handoff:
        they survive the owner's death on its replica set."""
        if self.blocks is None or rec.done:
            return
        rep = self._live_replica(rec.owner)
        if rep is None:
            return
        slot = rep.sessions.get(rec.session_id)
        if slot is None:
            return
        c = self.prefill_chunk
        full = int(rep.lengths[slot]) // c
        for j in range(rec.exported_chunks, full):
            # placed AT the session's ring key, not the block-name hash:
            # the session and its blocks share ONE replica set, so the
            # migration target the policy picks already holds the
            # handoff blocks locally
            self.blocks.put(self._block_name(rec.session_id, j),
                            pack_array(rep.export_block(rec.session_id, j)),
                            at=rec.key)
            self.exported_blocks += 1
        rec.exported_chunks = max(rec.exported_chunks, full)

    def _fetch_blocks(self, rec: SessionRecord, s: int) -> List[np.ndarray]:
        """The longest contiguous run of the session's stored KV chunks,
        capped so the final prompt segment is always recomputed (its
        all-position logits carry the admit token)."""
        c = self.prefill_chunk
        cap = max(((s - 1) // c) * c, 0)
        blocks: List[np.ndarray] = []
        while (len(blocks) + 1) * c <= cap:
            data = self.blocks.get(self._block_name(rec.session_id,
                                                    len(blocks)))
            if data is None:
                break
            blocks.append(unpack_array(data))
        return blocks

    def _drop_session_blocks(self, rec: SessionRecord) -> None:
        if self.blocks is None:
            return
        for j in range(rec.exported_chunks):
            self.blocks.remove(self._block_name(rec.session_id, j))
        rec.exported_chunks = 0

    def _push_token(self, rec: SessionRecord, tok: int) -> None:
        rec.generated.append(tok)
        if len(rec.generated) >= rec.max_new_tokens:
            rec.done = True
            trace = self.traces.get(rec.session_id)
            if trace is not None and not trace.done:
                trace.completed_ns = time.perf_counter_ns()
            rep = self.replicas.get(rec.owner)
            if rep is not None:
                rep.evict(rec.session_id)
            self._drop_session_blocks(rec)   # a finished session's KV is
            # dead weight on r nodes — reclaim it (prefix chunks persist:
            # they are content-addressed, not session-owned)

    # -- decode loop -----------------------------------------------------------
    def _route_table(self):
        """Device bucket directory for fused rounds, or None to run the
        classic (unfused) rounds.  Auto mode engages fusion at the same
        ring size the lookup dispatch switches to the bucket index, so
        small test clusters keep their exact legacy upload accounting."""
        if self.fused is False:
            return None
        if self.fused is None and len(self.state) < _BUCKET_MIN_N:
            return None
        return self.state.device_bucket_table()

    @metered
    def _calibrate_route(self, rep: Replica, route) -> None:
        """One-time per-key cost of the on-device route, measured by
        timing the bucketed lookup (K2) standalone on this replica's key
        slab (a warm call, then a second one timed between two device
        syncs).  A fused round runs route and decode together, so this
        is how the queue/route/decode trace splits survive fusion: the
        round's wall time is split into a route share (this calibration
        x keys) and a decode share.

        ``@metered``: the syncs are the measurement, and the meter
        counter lets tests assert it stays out of the round loop (one
        call per cluster, never per round)."""
        khi = _words(rep.key_hi).to(rep.device)
        klo = _words(rep.key_lo).to(rep.device)
        ring_lookup_bucketed(khi, klo, *route)
        synchronize(rep.device)
        t0 = time.perf_counter_ns()
        ring_lookup_bucketed(khi, klo, *route)
        synchronize(rep.device)
        self._route_cal_us_per_key = \
            (time.perf_counter_ns() - t0) / 1e3 / max(rep.key_hi.size, 1)

    def step(self) -> Dict[str, int]:
        """One continuous-batching round across every replica: advance
        in-flight overlapped prefills by one chunk, then run one decode
        round (fused with the on-device route when enabled)."""
        if self._seen_version != self.state.active_version:
            self._migrate_affected()       # retry deferred re-homes
        self._service_pending()
        route = self._route_table()
        self._step_seq += 1
        duty_turn = self._step_seq % self.prefill_duty == 0
        out: Dict[str, int] = {}
        for node in list(self.replicas):
            rep = self.replicas[node]
            # advance chunks on the duty-cycle beat — or every round
            # when the replica has no decode traffic to protect
            if rep.num_pending and (duty_turn or not rep.sessions):
                t0 = time.perf_counter_ns()
                completions = rep.advance_prefills()
                adv_us = (time.perf_counter_ns() - t0) / 1e3
                self._finish_pending(node, rep, completions, adv_us)
            if route is not None and self._route_cal_us_per_key is None \
                    and rep.sessions:
                self._calibrate_route(rep, route)
            t0 = time.perf_counter_ns()
            toks = rep.decode_round(route=route)
            round_us = (time.perf_counter_ns() - t0) / 1e3
            route_us = 0.0
            if route is not None and toks:
                self.fused_rounds += 1
                self.fused_routed_keys += len(rep.routed_owners)
                self._note_owner_divergence(rep)
                route_us = min((self._route_cal_us_per_key or 0.0)
                               * len(toks), round_us)
            share_route = route_us / max(len(toks), 1)
            share_decode = (round_us - route_us) / max(len(toks), 1)
            for sid, tok in toks.items():
                trace = self.traces.get(sid)
                if trace is not None:
                    trace.decode_us += share_decode
                    trace.route_us += share_route
                self._push_token(self.sessions[sid], tok)
                out[sid] = tok
        if self.blocks is not None and duty_turn:
            # decode rounds advance lengths across chunk boundaries;
            # ship the newly completed chunks on the same duty beat the
            # prefill scheduler uses, bounding the export sync cost to
            # ~1/duty of rounds
            for rec in self.live_sessions:
                self._export_session(rec)
        return out

    def _note_owner_divergence(self, rep: Replica) -> None:
        for sid, owner in rep.routed_owners.items():
            rec = self.sessions.get(sid)
            if rec is not None and owner != rec.owner:
                self.route_divergence += 1

    def _finish_pending(self, node: int, rep: Replica,
                        completions: Dict[str, int], adv_us: float) -> None:
        """Commit overlapped re-prefills that just completed (the admit
        token is the session's next token) and re-strand any that
        failed mid-chunk (their slot is already released)."""
        share_us = adv_us / max(len(completions), 1)
        for sid, tok in completions.items():
            self._pending_homes.pop(sid, None)
            rec = self.sessions.get(sid)
            if rec is None:
                rep.evict(sid)
                continue
            trace = self.traces.get(sid)
            if trace is not None:
                trace.decode_us += share_us
            self._push_token(rec, tok)
        for sid in rep.failed_prefills:
            self._pending_homes.pop(sid, None)
            self._retry.add(sid)
        rep.failed_prefills.clear()

    def _service_pending(self) -> None:
        """Re-home sessions whose overlapped-prefill target died with the
        chunks in flight, plus strands with no membership event left to
        piggyback a retry on."""
        for sid in list(self._pending_homes):
            node = self._pending_homes[sid]["node"]
            rep = self._live_replica(node)
            if rep is None or (sid not in rep._pending
                               and sid not in rep.sessions):
                del self._pending_homes[sid]
                self._retry.add(sid)
        for sid in list(self._retry):
            self._retry.discard(sid)
            rec = self.sessions.get(sid)
            if rec is None or rec.done or self._session_resident(rec) \
                    or sid in self._pending_homes:
                continue
            self._rehome(rec)

    def _rehome(self, rec: SessionRecord) -> None:
        group = self._group_for(rec)
        try:
            self._handoff(rec, group)
        except RuntimeError as exc:        # replica_set full right now
            if isinstance(exc, DEVICE_FAULTS):
                raise
            self.stranded += 1
            self._retry.add(rec.session_id)
            trace = self.traces.get(rec.session_id)
            if trace is not None and not trace._stranded_ns:
                trace._stranded_ns = time.perf_counter_ns()

    def run(self, max_rounds: int = 1024) -> int:
        """Decode until every live session completes; returns rounds."""
        rounds = 0
        while any(not r.done for r in self.sessions.values()):
            if rounds >= max_rounds:
                raise RuntimeError("sessions did not complete")
            self.step()
            rounds += 1
        return rounds

    @property
    def live_sessions(self) -> List[SessionRecord]:
        return [r for r in self.sessions.values() if not r.done]

    @property
    def pending_migrations(self) -> int:
        """Overlapped re-prefills still in flight (chunks not yet done)."""
        return len(self._pending_homes)

    # -- churn handling --------------------------------------------------------
    def _on_event(self, ev) -> None:
        if ev.kind != "join":
            # leave: the node's slab is gone with it; quarantine: the
            # supervisor pinned its generation, so the slab could never
            # be resumed anyway — reclaim it instead of hoarding KV
            if self.replicas.pop(ev.subject_id, None) is not None:
                self._forget_node(ev.subject_id)
            if self.blocks is not None and ev.kind == "leave":
                # a detected failure takes the node's block copies with
                # it (quarantine keeps them: the peer is alive, §V)
                self.blocks.drop_node(ev.subject_id)
        if self.blocks is not None:
            # re-replicate exactly the affected blocks BEFORE re-homing
            # sessions: the handoff fetch below must find r live copies
            self.blocks.sync()
        self._migrate_affected()

    def _migrate_affected(self) -> int:
        """Move exactly the sessions whose key range changed owners, and
        the sessions whose node left the active view.

        The second set is the port's: a session that warm-prefix
        affinity placed on a replica_set member other than its key's
        owner leaves with that member while the key's owner stays, so
        ``owner_diff`` does not cover it (``repro`` strands it for good).

        ``_seen_version`` only advances when the whole batch re-homed: a
        session that finds its entire replica_set full stays flagged (the
        skip check makes reprocessing idempotent) and is retried by the
        next ``step``/event once capacity frees, instead of silently
        pointing at a dead owner forever."""
        target_version = self.state.active_version
        diff = self.state.owner_diff(self._seen_version, target_version)
        live = self.live_sessions
        if not live:
            self._seen_version = target_version
            return 0
        keys = np.fromiter((r.key for r in live), np.uint64, len(live))
        gone = np.fromiter((r.owner not in self.state for r in live), bool,
                           len(live))
        hit = diff.affected(keys) | gone
        moved = 0
        complete = True
        for rec in (r for r, h in zip(live, hit) if h):
            if rec.session_id in self._pending_homes:
                continue    # an overlapped re-home is already in flight;
                # _service_pending re-strands it if that target dies
            t0 = time.perf_counter_ns()
            group = self._group_for(rec)
            trace = self.traces.get(rec.session_id)
            if trace is not None:
                trace.route_us += (time.perf_counter_ns() - t0) / 1e3
            if group[0] == rec.owner and self._session_resident(rec):
                continue    # still primary AND its slot is really there
                # (a bare owner-id match is not enough: a stranded
                # session's dead owner may have re-entered the ring with
                # an empty slab)
            try:
                self._handoff(rec, group)
                moved += 1
            except RuntimeError as exc:     # replica_set full right now
                if isinstance(exc, DEVICE_FAULTS):
                    raise
                self.stranded += 1
                complete = False
                if trace is not None and not trace._stranded_ns:
                    trace._stranded_ns = time.perf_counter_ns()
        if complete:
            self._seen_version = target_version
        return moved

    def _handoff(self, rec: SessionRecord, group: List[int]) -> None:
        """Re-prefill the session's transcript on the first member of its
        replica_set group with a free slot (capacity spill down the r-way
        successor list); the admit's return value IS the next token.  The
        new slot is filled BEFORE the old one is freed, so a failed admit
        never strands a session half-migrated."""
        resident = self._session_resident(rec)
        new_owner = None
        for n in group:
            if n == rec.owner and resident:
                return      # a group member already holds its live slot;
                # moving it to a lower-priority member gains nothing
            if self._has_capacity(n):
                new_owner = n
                break
        if new_owner is None:
            raise RuntimeError(
                f"no capacity in the {len(group)}-way replica set for "
                f"session {rec.session_id}")
        t0 = time.perf_counter_ns()
        trace = self.traces.get(rec.session_id)
        if trace is not None and trace._stranded_ns:
            trace.queue_us += (t0 - trace._stranded_ns) / 1e3
            trace._stranded_ns = 0
        rep = self._replica_for(new_owner)
        req = Request(rec.session_id, rec.transcript, rec.max_new_tokens)
        if self.blocks is not None and rep._chunkable(len(req.prompt)) \
                and self._handoff_from_blocks(rec, rep, req, resident,
                                              new_owner, trace):
            return
        if not resident and rep._chunkable(len(req.prompt)):
            # the old slab is gone, so nobody is decoding this session:
            # re-prefill it one fixed-shape chunk per round, OVERLAPPED
            # with the replicas' decode rounds instead of stalling them
            if rep.begin_admit(req) is None:
                self._pending_homes[rec.session_id] = {"node": new_owner,
                                                       "t0": t0}
                # ownership transfers NOW (the old owner is gone and the
                # route must point at the re-prefill target); the next
                # token arrives when the pending completes
                rec.owner = new_owner
                rec.migrations += 1
                self.migrated_sessions += 1
                self._note_region(rec, migration=True)
                return
            raise AssertionError("chunkable begin_admit returned a token")
        tok = rep.admit(req)
        if trace is not None:
            trace.decode_us += (time.perf_counter_ns() - t0) / 1e3
        if resident:                        # clean handoff: free the slot
            self.replicas[rec.owner].evict(rec.session_id)
        rec.owner = new_owner
        rec.migrations += 1
        self.migrated_sessions += 1
        self._note_region(rec, migration=True)
        self._note_warm(new_owner, rec.prompt)
        self._push_token(rec, tok)

    def _handoff_from_blocks(self, rec: SessionRecord, rep: Replica,
                             req: Request, resident: bool, new_owner: int,
                             trace: Optional[RequestTrace]) -> bool:
        """Zero-recompute cache handoff: fetch the session's KV chunks
        from their replica sets and admit from them — only the final
        prompt segment is re-prefilled.  Returns False on a total block
        miss (or an import failure), sending the caller down the
        re-prefill paths; the migration then costs recompute but never
        correctness."""
        if resident:
            # the old slab is still live (quarantine / spill): flush its
            # newest chunks into the store first so the transfer covers
            # the whole transcript, not just the last duty-beat export
            self._export_session(rec)
        t0 = time.perf_counter_ns()
        blocks = self._fetch_blocks(rec, len(req.prompt))
        if not blocks:
            self.handoff_misses += 1
            return False
        fetch_us = (time.perf_counter_ns() - t0) / 1e3
        t1 = time.perf_counter_ns()
        try:
            tok = rep.admit_from_blocks(req, blocks)
        except Exception as exc:
            # a torn/mismatched block import degrades to recompute and
            # never kills the migration batch; a device fault propagates
            if isinstance(exc, DEVICE_FAULTS):
                raise
            self.handoff_misses += 1
            return False
        admit_us = (time.perf_counter_ns() - t1) / 1e3
        if trace is not None:
            trace.handoff_us += fetch_us + rep.import_us
            trace.decode_us += max(admit_us - rep.import_us, 0.0)
        self.handoffs += 1
        self.handoff_chunks += len(blocks)
        if resident:
            self.replicas[rec.owner].evict(rec.session_id)
        # chunks up to the fetched run are still stored and content-
        # valid; anything past it (a lost block broke the run) will be
        # re-exported from the new slab on the next duty beat
        rec.exported_chunks = len(blocks)
        rec.owner = new_owner
        rec.migrations += 1
        self.migrated_sessions += 1
        self._note_region(rec, migration=True)
        self._note_warm(new_owner, rec.prompt)
        self._push_token(rec, tok)
        return True

    # -- observability -----------------------------------------------------------
    def latency_report(self) -> Dict[str, float]:
        """Serve-path request-latency distribution with the queue/route/
        decode breakdown (completed sessions only), µs.  The measured
        twin of the request plane's network-side accounting: BENCH
        latency rows report lookup latency, this reports what the serve
        path adds on top of the route."""
        done = [t for t in self.traces.values() if t.done]
        if not done:
            return {"completed": 0}
        tot = np.array([t.total_us for t in done])
        return {
            "completed": len(done),
            "total_us_mean": round(float(tot.mean()), 1),
            "total_us_p50": round(float(np.percentile(tot, 50)), 1),
            "total_us_p99": round(float(np.percentile(tot, 99)), 1),
            "queue_us_mean": round(
                float(np.mean([t.queue_us for t in done])), 1),
            "route_us_mean": round(
                float(np.mean([t.route_us for t in done])), 1),
            "decode_us_mean": round(
                float(np.mean([t.decode_us for t in done])), 1),
            "handoff_us_mean": round(
                float(np.mean([t.handoff_us for t in done])), 1),
            "router_route_us_per_key": round(
                self.router.route_us_per_key, 2),
        }

    def stats(self) -> Dict[str, int]:
        """Serve-plane counters plus the routing plane's device-traffic
        accounting: the router resolves through ``RingState.lookup``
        (two-level bucket index at scale, flat scan below it — §7), so
        ``route_upload_bytes`` IS the maintenance traffic this cluster's
        membership churn has cost the device so far."""
        out = {
            "sessions": len(self.sessions),
            "live": len(self.live_sessions),
            "replicas": len(self.replicas),
            "migrated": self.migrated_sessions,
            "stranded": self.stranded,
            "proxied": sum(self.proxied.values()),
            "route_uploads": self.state.upload_count,
            "route_upload_bytes": self.state.upload_bytes,
            "route_delta_uploads": self.state.delta_uploads,
        }
        if self.policy.topology is not None:
            out.update({
                "cross_region_admits": self.cross_region_admits,
                "cross_region_migrations": self.cross_region_migrations,
            })
        if self.blocks is not None:
            out.update({
                "handoffs": self.handoffs,
                "handoff_misses": self.handoff_misses,
                "handoff_chunks": self.handoff_chunks,
                "exported_blocks": self.exported_blocks,
                "block_upload_bytes": self.blocks.upload_bytes,
                "block_repair_bytes": self.blocks.repair_bytes,
            })
        if self.prefix is not None:
            out.update({
                "prefix_hits": self.prefix.hits,
                "prefix_misses": self.prefix.misses,
                "prefix_tokens_saved": self.prefix.tokens_saved,
                "prefix_affinity_hits": self.prefix_affinity_hits,
            })
        return out
