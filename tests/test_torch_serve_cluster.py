"""The port's ServeCluster and the Replica block path against repro's, on
qwen2.5-3b smoke() in float32 with the port's weights converted from
repro's.  Every cluster scenario of ``test_serve_cluster.py``,
``test_kv_handoff.py``, ``test_fused_serve.py`` and ``test_placement.py``
runs on both packages from the same numpy requests and the same
membership events; the generated tokens, owners, migrations, proxy
counts and every counter of ``stats()`` must be identical.  At the
replica: exported blocks hold repro's KV (within 1e-4) and cross the
wire byte for byte, ``admit_from_blocks`` is token-equal to a
from-scratch admit, a prefix hit skips its chunks.

The deliberate differences of this slice, each pinned here: a bfloat16
handoff counts as a handoff on the port (repro's KVB1 header cannot
carry bfloat16, so its handoff is a miss); a device fault inside an
overlapped prefill or a block import propagates instead of degrading to
recompute; there is no ``decode_kernel=`` argument (tensor-parallel
groups: ``test_torch_tp.py``).
"""
import inspect
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.dht.data as jdata
import repro.dht.des as jdes
import repro.runtime as jruntime
import repro.serve as jserve
from repro.configs import get_smoke_config as j_smoke
from repro.core.ringstate import RingState as JRingState
from repro.models import Model as JModel
from repro_torch import runtime, serve
from repro_torch.analysis.metering import meter_count
from repro_torch.configs import get_smoke_config
from repro_torch.core.ringstate import RingState
from repro_torch.dht import data, des
from repro_torch.kernels.build import KernelLaunchError
from repro_torch.models import Model

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
CHUNK = 8


@pytest.fixture(scope="module")
def pair():
    jcfg = j_smoke("qwen2.5-3b").with_overrides(dtype="float32")
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg)
    port = SimpleNamespace(
        name="port", model=m, params=m.load(jax.device_get(jp), device="cpu"),
        cfg=cfg, runtime=runtime, serve=serve, data=data, des=des,
        RingState=lambda ids=(): RingState(ids, device="cpu"),
        kw={"device": "cpu"})
    ref = SimpleNamespace(
        name="repro", model=jm, params=jp, cfg=jcfg, runtime=jruntime,
        serve=jserve, data=jdata, des=jdes, RingState=JRingState, kw={})
    return ref, port


def _membership(ns, n, t, *, policy=None, net="10.3.0", port0=7000):
    m = ns.runtime.Membership(t_q=60.0, now=lambda: t[0], policy=policy,
                              **ns.kw)
    for i in range(n):
        m.request_join(f"{net}.{i}", port0 + i)
    return m


def _cluster(ns, mem, **kw):
    return ns.serve.ServeCluster(mem, ns.model, ns.params, **kw, **ns.kw)


def _requests(ns, count, *, max_new, seed=0, base=4, step=3, mod=4,
              prefix="s"):
    rng = np.random.default_rng(seed)
    return [ns.serve.Request(f"{prefix}{i}",
                             rng.integers(0, ns.cfg.vocab,
                                          base + (i % mod) * step,
                                          dtype=np.int32),
                             max_new_tokens=max_new)
            for i in range(count)]


def _busiest(cluster):
    by_owner = {}
    for rec in cluster.sessions.values():
        if not rec.done:
            by_owner.setdefault(rec.owner, []).append(rec)
    return max(by_owner, key=lambda o: (len(by_owner[o]), o))


def _observe(cluster):
    return {
        "tokens": {s: list(r.generated) for s, r in cluster.sessions.items()},
        "owners": {s: r.owner for s, r in cluster.sessions.items()},
        "migrations": {s: r.migrations for s, r in cluster.sessions.items()},
        "exported": {s: r.exported_chunks
                     for s, r in cluster.sessions.items()},
        "stats": cluster.stats(),
        "proxied": dict(cluster.proxied),
        "replicas": sorted(cluster.replicas),
        "pending": cluster.pending_migrations,
        "divergence": cluster.route_divergence,
        "fused": (cluster.fused_rounds, cluster.fused_routed_keys),
        "done": sorted(s for s, t in cluster.traces.items() if t.done),
    }


# ---------------------------------------------------------------------------
# cluster scenarios, each run on both packages
# ---------------------------------------------------------------------------

def _failure_mid_decode(ns):
    """A replica with >= 8 mixed-length sessions fails from a SimNet event
    heap while decode rounds are in flight."""
    t = [0.0]
    m = _membership(ns, 5, t)
    c = _cluster(ns, m, slots=16, max_len=64)
    for r in _requests(ns, 12, max_new=10):
        c.submit(r)
    victim = _busiest(c)
    net = ns.des.SimNet(ns.des.LanDelay(), seed=1)
    net.schedule_at(3.0, lambda: m.fail(victim))
    out = [victim]
    while c.live_sessions:
        net.run_until(net.now + 1.0)
        out.append(sorted(c.step().items()))
    return out + [_observe(c)]


def _join(ns):
    t = [0.0]
    m = _membership(ns, 6, t)
    c = _cluster(ns, m, slots=16, max_len=64)
    for r in _requests(ns, 10, max_new=8, seed=5):
        c.submit(r)
    nid = m.request_join("10.3.7.7", 7777)
    out = [nid, _observe(c)]
    c.run()
    return out + [_observe(c)]


def _quarantine_gateway(ns):
    t = [0.0]
    m = _membership(ns, 4, t)
    c = _cluster(ns, m, slots=8, max_len=64)
    gw = m.request_join("10.9.9.9", 9999, preemptible=True)
    for r in _requests(ns, 4, max_new=6, seed=9):
        c.submit(r, via=gw)
    out = [gw, _observe(c)]
    c.run()
    t[0] = 61.0
    out.append(m.poll_quarantine())
    sid = next(f"n-{i}" for i in range(10_000)
               if c.router.route([f"n-{i}"])[0] == gw)
    rng = np.random.default_rng(11)
    c.submit(ns.serve.Request(sid, rng.integers(0, ns.cfg.vocab, 5,
                                                dtype=np.int32), 4))
    c.run()
    return out + [sid, _observe(c)]


def _quarantine_member(ns):
    t = [0.0]
    m = _membership(ns, 5, t)
    c = _cluster(ns, m, slots=16, max_len=64)
    for r in _requests(ns, 10, max_new=8, seed=2):
        c.submit(r)
    straggler = _busiest(c)
    out = [m.quarantine_member(straggler), _observe(c)]
    c.run()
    return out + [_observe(c)]


def _generation_restart(ns):
    t = [0.0]
    m = _membership(ns, 4, t)
    c = _cluster(ns, m, slots=8, max_len=64)
    for r in _requests(ns, 8, max_new=4, seed=7):
        c.submit(r)
    victim = sorted({rec.owner for rec in c.sessions.values()})[0]
    old_gen = c.replicas[victim].generation
    info = m.nodes[victim]
    m.fail(victim)
    m.admit(victim, info.addr)
    c.run()
    for r in _requests(ns, 6, max_new=3, seed=13, prefix="re-s"):
        c.submit(r)
    c.run()
    gens = {n: rep.generation for n, rep in c.replicas.items()}
    return [old_gen, gens, c.supervisor.generation, _observe(c)]


def _owned_sid(c, node, start, prefix):
    return next(f"{prefix}{i}" for i in range(start, 100_000)
                if c.router.route([f"{prefix}{i}"])[0] == node)


def _spill_when_successor_full(ns):
    t = [0.0]
    m = _membership(ns, 3, t)
    c = _cluster(ns, m, slots=2, max_len=64, replication=2)
    rng = np.random.default_rng(6)
    a = c.router.route(["c0"])[0]
    b = int(m.ring_state.succ(a, 1))
    i = 0
    for node in (a, a, b, b):
        sid = _owned_sid(c, node, i, "c")
        i = int(sid[1:]) + 1
        c.submit(ns.serve.Request(sid, rng.integers(0, ns.cfg.vocab, 5,
                                                    dtype=np.int32), 6))
    m.fail(a)
    out = [_observe(c)]
    c.run()
    return out + [_observe(c)]


def _stranded_rehome(ns):
    t = [0.0]
    m = _membership(ns, 2, t)
    c = _cluster(ns, m, slots=2, max_len=64, replication=2)
    rng = np.random.default_rng(12)
    a = c.router.route(["f0"])[0]
    b = next(n for n in m.members() if n != a)
    i = 0
    for node, max_new in ((a, 8), (a, 8), (b, 2), (b, 2)):
        sid = _owned_sid(c, node, i, "f")
        i = int(sid[1:]) + 1
        c.submit(ns.serve.Request(sid, rng.integers(0, ns.cfg.vocab, 5,
                                                    dtype=np.int32), max_new))
    m.fail(a)
    out = [c.stranded]
    c.run()
    return out + [_observe(c)]


def _stranded_onto_rejoined_owner(ns):
    t = [0.0]
    m = _membership(ns, 2, t)
    c = _cluster(ns, m, slots=2, max_len=64, replication=2)
    rng = np.random.default_rng(14)
    a = c.router.route(["r0"])[0]
    b = next(n for n in m.members() if n != a)
    i = 0
    for node in (a, b, b):
        sid = _owned_sid(c, node, i, "r")
        i = int(sid[1:]) + 1
        c.submit(ns.serve.Request(sid, rng.integers(0, ns.cfg.vocab, 5,
                                                    dtype=np.int32), 8))
    info = m.nodes[a]
    m.fail(a)
    out = [c.stranded]
    m.admit(a, info.addr)
    c.run()
    return out + [_observe(c)]


def _kill_via_cache_handoff(ns):
    """Prompts of 9..21 tokens at chunk 8: every session has exported
    chunks, so the victim's sessions are handed off from the store."""
    t = [0.0]
    m = _membership(ns, 5, t, net="10.4.0", port0=7100)
    c = _cluster(ns, m, slots=16, max_len=64, prefill_chunk=CHUNK)
    for r in _requests(ns, 10, max_new=8, base=9, step=3, mod=5, prefix="h"):
        c.submit(r)
    victim = _busiest(c)
    moved = sorted(rec.session_id for rec in c.sessions.values()
                   if rec.owner == victim)
    m.fail(victim)
    handed = [sid for sid in moved if c.traces[sid].handoff_us > 0]
    out = [moved, handed, _observe(c)]
    c.run()
    return out + [_observe(c), c.latency_report()["handoff_us_mean"] > 0]


def _handoff_miss(ns):
    t = [0.0]
    m = _membership(ns, 5, t, net="10.4.0", port0=7100)
    c = _cluster(ns, m, slots=16, max_len=64, prefill_chunk=CHUNK,
                 prefix_cache=False)
    for r in _requests(ns, 8, max_new=8, seed=3, base=9, step=3, mod=5,
                       prefix="h"):
        c.submit(r)
    victim = _busiest(c)
    for rec in c.sessions.values():
        if rec.owner == victim:
            for j in range(rec.exported_chunks):
                c.blocks.remove(c._block_name(rec.session_id, j))
    m.fail(victim)
    out = [_observe(c)]
    c.run()
    return out + [_observe(c)]


def _reclaim_blocks(ns):
    t = [0.0]
    m = _membership(ns, 4, t, net="10.4.0", port0=7100)
    c = _cluster(ns, m, slots=8, max_len=64, prefill_chunk=CHUNK,
                 prefix_cache=False)
    for r in _requests(ns, 4, max_new=4, seed=5, base=9, step=3, mod=5,
                       prefix="h"):
        c.submit(r)
    c.run()
    held = [c.blocks.contains(c._block_name(s, 0)) for s in sorted(c.sessions)]
    return [held, c.blocks.stats(), _observe(c)]


def _shared_system_prompt(ns):
    t = [0.0]
    m = _membership(ns, 5, t, net="10.4.0", port0=7100)
    c = _cluster(ns, m, slots=8, max_len=64, prefill_chunk=CHUNK)
    rng = np.random.default_rng(41)
    system = rng.integers(0, ns.cfg.vocab, 16, dtype=np.int32)
    for i in range(6):
        tail = rng.integers(0, ns.cfg.vocab, 3 + i, dtype=np.int32)
        c.submit(ns.serve.Request(f"sys{i}", np.concatenate([system, tail]),
                                  max_new_tokens=4))
    out = [_observe(c)]
    c.run()
    return out + [_observe(c)]


def _fused_and_unfused(ns):
    outs = []
    for fused in (True, False):
        t = [0.0]
        c = _cluster(ns, _membership(ns, 4, t), slots=8, max_len=64,
                     fused=fused)
        for r in _requests(ns, 6, max_new=8, seed=3):
            c.submit(r)
        c.run()
        outs.append(_observe(c))
    assert outs[0]["tokens"] == outs[1]["tokens"]
    return outs


def _fused_overlapped_migration(ns):
    t = [0.0]
    m = _membership(ns, 5, t)
    c = _cluster(ns, m, slots=16, max_len=64, fused=True,
                 prefill_chunk=CHUNK, prefill_duty=2)
    for r in _requests(ns, 8, max_new=10, seed=21):
        c.submit(r)
    out = [sorted(c.step().items()) for _ in range(2)]
    m.fail(_busiest(c))
    while c.live_sessions:
        out.append(sorted(c.step().items()))
    return out + [_observe(c), c.route_divergence]


def _failed_overlapped_migration(ns):
    """A re-prefill poisoned mid-chunk (a TypeError, not a device fault)
    re-strands its session, which a later round re-homes."""
    t = [0.0]
    m = _membership(ns, 5, t)
    c = _cluster(ns, m, slots=16, max_len=64, prefill_chunk=CHUNK,
                 prefill_duty=1, kv_blocks=False)
    for r in _requests(ns, 8, max_new=10, seed=23):
        c.submit(r)
    c.step()
    m.fail(_busiest(c))
    sid = sorted(c._pending_homes)[0]
    node = c._pending_homes[sid]["node"]
    c.replicas[node]._pending[sid]["prompt"] = None     # poison
    out = [sid, c.pending_migrations]
    while c.live_sessions:
        c.step()
    return out + [_observe(c)]


def _policy_plumbing(ns):
    """test_placement.py's twin run: churn, a quarantined gateway and a
    kill, under the membership's default policy."""
    t = [0.0]
    m = _membership(ns, 6, t, net="10.8.0", port0=7300)
    c = _cluster(ns, m, slots=16, max_len=64, prefill_chunk=CHUNK)
    rng = np.random.default_rng(5)
    for i in range(9):
        c.submit(ns.serve.Request(
            f"s{i}", rng.integers(0, ns.cfg.vocab, 6 + (i % 3) * 5,
                                  dtype=np.int32), max_new_tokens=6))
    q = m.request_join("10.8.9.9", 7999, preemptible=True)
    c.submit(ns.serve.Request(
        "via-gw", rng.integers(0, ns.cfg.vocab, 7, dtype=np.int32),
        max_new_tokens=6), via=q)
    c.step()
    m.fail(sorted(m.members())[0])
    c.run()
    return [_observe(c), {nid: e.gateways
                          for nid, e in m.quarantine.pending.items()}]


def _geo_latency_aware(ns):
    """examples/geo_serve.py's workload under both policies: origins
    alternate between two pinned regions, one node a region fails."""
    out = []
    topo = ns.runtime.Topology({"us": (0.0, 0.0), "eu": (40.0, 0.0)})
    for pol in (ns.runtime.RingSuccessor(topology=topo),
                ns.runtime.LatencyAware(topo, affinity_ms=5.0)):
        t = [0.0]
        m = ns.runtime.Membership(t_q=60.0, now=lambda: t[0], policy=pol,
                                  **ns.kw)
        by_region = {"us": [], "eu": []}
        for r, region in enumerate(("us", "eu")):
            for i in range(4):
                nid = m.request_join(f"10.9.{r}.{i}", 7100 + 10 * r + i)
                topo.place(nid, region)
                by_region[region].append(nid)
        c = _cluster(ns, m, slots=8, max_len=48)
        for i, r in enumerate(_requests(ns, 12, max_new=6, base=4, step=5,
                                        mod=3, prefix="g")):
            c.submit(r, origin=("us", "eu")[i % 2])
        for _ in range(2):
            c.step()
        m.fail(by_region["us"][0])
        m.fail(by_region["eu"][0])
        c.run(max_rounds=64)
        out.append(_observe(c))
    cross = [o["stats"]["cross_region_admits"]
             + o["stats"]["cross_region_migrations"] for o in out]
    assert cross[1] < cross[0]
    return out


SCENARIOS = [_failure_mid_decode, _join, _quarantine_gateway,
             _quarantine_member, _generation_restart,
             _spill_when_successor_full, _stranded_rehome,
             _stranded_onto_rejoined_owner, _kill_via_cache_handoff,
             _handoff_miss, _reclaim_blocks, _shared_system_prompt,
             _fused_and_unfused, _fused_overlapped_migration,
             _failed_overlapped_migration, _policy_plumbing,
             _geo_latency_aware]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[1:])
def test_cluster_scenario_matches_repro(pair, scenario):
    ref, port = pair
    want = scenario(ref)
    got = scenario(port)
    assert got == want
    # every scenario runs to the end: no session lost or left in flight
    finals = got if scenario in (_fused_and_unfused, _geo_latency_aware) \
        else [next(o for o in reversed(got)
                   if isinstance(o, dict) and "tokens" in o)]
    for obs in finals:
        assert obs["pending"] == 0 and obs["stats"]["live"] == 0
        assert sorted(obs["done"]) == sorted(obs["tokens"])


def test_cluster_counters_and_traces_match_repro(pair):
    """The handoff counters moved, the fused route was calibrated once
    per cluster, and both packages report the same latency keys."""
    ref, port = pair
    reports, metered = [], []
    for ns in (ref, port):
        t = [0.0]
        c = _cluster(ns, _membership(ns, 4, t), slots=8, max_len=64,
                     fused=True, prefill_chunk=CHUNK)
        before = meter_count(serve.ServeCluster._calibrate_route) \
            if ns is port else 0
        for r in _requests(ns, 4, max_new=6, seed=7, base=9):
            c.submit(r)
        c.run()
        if ns is port:
            metered.append(meter_count(serve.ServeCluster._calibrate_route)
                           - before)
            assert c._route_cal_us_per_key is not None
        for tr in c.traces.values():
            assert tr.done and tr.decode_us > 0 and tr.route_us >= 0
        reports.append(sorted(c.latency_report()))
    assert reports[0] == reports[1]
    assert metered == [1]


# ---------------------------------------------------------------------------
# replica-level block export / import
# ---------------------------------------------------------------------------

def _replica(ns, **kw):
    rep = ns.serve.Replica(ns.model, slots=2, max_len=48, prefill_chunk=CHUNK,
                           **kw, **ns.kw)
    rep.attach_params(ns.params)
    return rep


def test_exported_blocks_hold_repros_kv_and_cross_the_wire_exactly(pair):
    ref, port = pair
    prompt = np.random.default_rng(21).integers(0, port.cfg.vocab, 20,
                                                dtype=np.int32)
    reps = {}
    for ns in (ref, port):
        reps[ns.name] = _replica(ns)
        reps[ns.name].admit(ns.serve.Request("x", prompt, max_new_tokens=6))
    jblocks = [reps["repro"].export_block("x", j) for j in range(2)]
    tblocks = [reps["port"].export_block("x", j) for j in range(2)]
    assert reps["port"].export_block_shards("x", 1)[0].tobytes() \
        == tblocks[1].tobytes()
    for jb, tb in zip(jblocks, tblocks):
        assert tb.shape == port.model.kv_block_shape(CHUNK) == jb.shape
        assert tb.dtype == jb.dtype == np.float32
        np.testing.assert_allclose(tb, jb, atol=ATOL, rtol=0)
    # repro's blocks through the port's wire and cache: byte for byte
    cache = port.model.cache_with_blocks(
        48, [data.unpack_array(jdata.pack_array(b)) for b in jblocks],
        device="cpu")
    for j, jb in enumerate(jblocks):
        back = port.model.export_kv_block(cache, 0, j * CHUNK, CHUNK)
        assert data.pack_array(back) == jdata.pack_array(jb)


def test_admit_from_blocks_is_token_equal_to_an_admit(pair):
    """Blocks of one replica admitted on another: the first token and
    every decode after it equal a from-scratch admit's, on both
    packages, and the port's imported rows equal the blocks exactly."""
    ref, port = pair
    prompt = np.random.default_rng(21).integers(0, port.cfg.vocab, 20,
                                                dtype=np.int32)
    streams = []
    for ns in (ref, port):
        a, b = _replica(ns), _replica(ns)
        req = ns.serve.Request("x", prompt, max_new_tokens=6)
        tok_a = a.admit(req)
        blocks = [a.export_block("x", j) for j in range(20 // CHUNK)]
        tok_b = b.admit_from_blocks(req, blocks)
        assert b.import_us > 0.0
        if ns is port:
            slot = b.sessions["x"]
            for j, blk in enumerate(blocks):
                got = port.model.export_kv_block(b.cache, slot, j * CHUNK,
                                                 CHUNK)
                assert got.tobytes() == blk.tobytes()
        sa = [tok_a] + [a.decode_round()["x"] for _ in range(5)]
        sb = [tok_b] + [b.decode_round()["x"] for _ in range(5)]
        assert sa == sb
        streams.append(sa)
    assert streams[0] == streams[1]


def test_admit_from_blocks_guards(pair):
    outs = []
    for ns in pair:
        prompt = np.random.default_rng(22).integers(0, ns.cfg.vocab, 16,
                                                    dtype=np.int32)
        a, b = _replica(ns), _replica(ns)
        a.admit(ns.serve.Request("x", prompt))
        blocks = [a.export_block("x", 0), a.export_block("x", 1)]
        with pytest.raises(ValueError):
            b.admit_from_blocks(ns.serve.Request("y", prompt), blocks)
        tok = b.admit_from_blocks(ns.serve.Request("y", prompt), [])
        free = b.num_free
        with pytest.raises(Exception):
            b.admit_from_blocks(ns.serve.Request("w", prompt),
                                [np.zeros((3, 3), np.float32)])
        assert b.num_free == free and "w" not in b.sessions
        if ns.name == "port":
            # a run shorter than one chunk a block would leave positions
            # the tail prefill never writes: refused
            with pytest.raises(ValueError, match="prefill chunk"):
                b.admit_from_blocks(ns.serve.Request("w", prompt),
                                    [blocks[0][:, :CHUNK // 2]])
            assert b.num_free == free and "w" not in b.sessions
        outs.append((tok, sorted(b.sessions), b.num_free))
    assert outs[0] == outs[1]


def test_prefix_hit_skips_prefill_chunks(pair, monkeypatch):
    """A second session with the same 20-token prompt imports the two
    full chunks: one segment call instead of three, the same tokens."""
    ref, port = pair
    calls = [0]
    inner = Model.prefill_chunk

    def counting(self, *a, **kw):
        calls[0] += 1
        return inner(self, *a, **kw)

    monkeypatch.setattr(Model, "prefill_chunk", counting)
    prompt = np.random.default_rng(31).integers(0, port.cfg.vocab, 20,
                                                dtype=np.int32)
    streams = []
    for ns in (ref, port):
        state = ns.RingState()
        for i in range(4):
            state.add((i + 1) * (2**64 // 5))
        pc = ns.data.PrefixCache(ns.data.BlockStore(state, replication=2),
                                 chunk=CHUNK, salt=ns.cfg.name)
        rep = ns.serve.Replica(ns.model, slots=4, max_len=48,
                               prefill_chunk=CHUNK, prefix_cache=pc, **ns.kw)
        rep.attach_params(ns.params)
        calls[0] = 0
        got = {"p1": [rep.admit(ns.serve.Request("p1", prompt, 5))]}
        first = calls[0]
        calls[0] = 0
        got["p2"] = [rep.admit(ns.serve.Request("p2", prompt, 5))]
        second = calls[0]
        for _ in range(4):
            for sid, tok in rep.decode_round().items():
                got[sid].append(tok)
        assert got["p1"] == got["p2"]
        streams.append((got, pc.hits, pc.misses, pc.tokens_saved))
        if ns is port:
            assert (first, second) == (3, 1)
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# deliberate differences
# ---------------------------------------------------------------------------

def _bf16_kill(ns, model, params):
    t = [0.0]
    m = _membership(ns, 5, t, net="10.4.0", port0=7100)
    c = ns.serve.ServeCluster(m, model, params, slots=16, max_len=64,
                              prefill_chunk=CHUNK, prefix_cache=False,
                              **ns.kw)
    for r in _requests(ns, 10, max_new=6, base=9, step=3, mod=5, prefix="h"):
        c.submit(r)
    victim = _busiest(c)
    moved = [rec for rec in c.sessions.values() if rec.owner == victim]
    m.fail(victim)
    return c, moved


def test_bf16_handoff_counts_as_a_handoff(pair):
    """Difference (a): with a bfloat16 cache every migrated session is
    handed off from its blocks on the port, and the imported rows are
    the blocks bit for bit; repro's blocks come back as '<V2' bytes, so
    each of its handoffs is a miss and a re-prefill (with its prefix
    cache on, the re-prefill's prefix hit raises out of the migration:
    both run without one here)."""
    ref, port = pair
    cfg = get_smoke_config("qwen2.5-3b")                     # bfloat16
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    c, moved = _bf16_kill(port, model, params)
    assert moved and c.handoffs == len(moved) and c.handoff_misses == 0
    for rec in moved:
        rep = c.replicas[rec.owner]
        slot = rep.sessions[rec.session_id]
        for j in range(rec.exported_chunks):
            blk = data.unpack_array(c.blocks.get(
                c._block_name(rec.session_id, j)))
            assert isinstance(blk, data.Bf16Words)
            got = model.export_kv_block(rep.cache, slot, j * CHUNK, CHUNK)
            assert got.tobytes() == blk.tobytes()
    c.run()
    assert all(rec.done for rec in c.sessions.values())
    jm = JModel(j_smoke("qwen2.5-3b"))
    jc, jmoved = _bf16_kill(ref, jm, jm.init(jax.random.PRNGKey(0)))
    assert jc.handoffs == 0 and jc.handoff_misses == len(jmoved) > 0


FAULTS = [KernelLaunchError("decode_attention_tc_launch: CUDA error 700"),
          torch.AcceleratorError("CUDA error: an illegal memory access")]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda e: type(e).__name__)
def test_device_fault_in_an_overlapped_prefill_propagates(pair, fault,
                                                          monkeypatch):
    """Difference (b): a poisoned prompt (TypeError) lands in
    ``failed_prefills`` and re-strands, but a kernel or CUDA fault in an
    overlapped re-prefill propagates out of ``ServeCluster.step``."""
    _, port = pair
    t = [0.0]
    m = _membership(port, 5, t)
    c = _cluster(port, m, slots=16, max_len=64, prefill_chunk=CHUNK,
                 prefill_duty=1, kv_blocks=False)
    for r in _requests(port, 8, max_new=10, seed=23):
        c.submit(r)
    c.step()
    m.fail(_busiest(c))
    assert c.pending_migrations > 1
    poisoned, node = next((sid, h["node"])
                          for sid, h in sorted(c._pending_homes.items()))
    c.replicas[node]._pending[poisoned]["prompt"] = None
    c.step()
    assert poisoned not in c._pending_homes and poisoned in c._retry
    inner = Model.prefill_chunk

    def faulty(self, params, tokens, cache, index):
        raise fault

    monkeypatch.setattr(Model, "prefill_chunk", faulty)
    with pytest.raises(type(fault)):
        while c.pending_migrations:
            c.step()
    monkeypatch.setattr(Model, "prefill_chunk", inner)


@pytest.mark.parametrize("fault", FAULTS, ids=lambda e: type(e).__name__)
def test_device_fault_in_a_block_import_propagates(pair, fault, monkeypatch):
    """Difference (b): a torn block still degrades to recompute (a miss),
    but a device fault inside ``admit_from_blocks`` propagates out of the
    migration the membership event drives."""
    _, port = pair

    def kill(torn):
        t = [0.0]
        m = _membership(port, 5, t, net="10.4.0", port0=7100)
        c = _cluster(port, m, slots=16, max_len=64, prefill_chunk=CHUNK,
                     prefix_cache=False)
        for r in _requests(port, 10, max_new=8, base=9, step=3, mod=5,
                           prefix="h"):
            c.submit(r)
        victim = _busiest(c)
        n = sum(rec.owner == victim for rec in c.sessions.values())
        inner = Model.cache_with_blocks

        def hooked(self, max_len, blocks, *, device=None):
            if torn:
                blocks = [b[:, :, :, :1] for b in blocks]   # a head
                return inner(self, max_len, blocks, device=device)
            raise fault

        monkeypatch.setattr(Model, "cache_with_blocks", hooked)
        try:
            m.fail(victim)
        finally:
            monkeypatch.setattr(Model, "cache_with_blocks", inner)
        return c, n

    c, n = kill(torn=True)
    assert c.handoffs == 0 and c.handoff_misses == n > 0
    c.run()
    assert all(rec.done for rec in c.sessions.values())
    with pytest.raises(type(fault)):
        kill(torn=False)


def test_tp_and_decode_kernel_are_not_arguments(pair):
    """Difference (d): there is no ``decode_kernel=`` switch (the device
    picks K3's route).  ``tp`` and ``mesh`` are arguments since the
    tensor-parallel slice (difference (c) is gone): ``tp=2`` builds
    groups of two entries of the pool, and a ``tp`` that does not divide
    the pool raises repro's error."""
    _, port = pair
    t = [0.0]
    m = _membership(port, 2, t)
    cl = _cluster(port, m, tp=2)
    assert cl.stats()["tp"] == 2 and cl.stats()["groups"] == 4
    with pytest.raises(ValueError, match="divide the 5 pooled device"):
        _cluster(port, m, tp=2, mesh=["cpu"] * 5)
    params = inspect.signature(serve.ServeCluster).parameters
    assert "decode_kernel" not in params and "mesh" in params
    with pytest.raises(TypeError):
        _cluster(port, m, decode_kernel=True)
    assert hasattr(serve.ServeCluster, "lose_device")


# ---------------------------------------------------------------------------
# the twins of examples/serve_lm.py and examples/geo_serve.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["serve_lm", "geo_serve"])
def test_twin_runs_at_smoke_size(module):
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.{module}", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert res.returncode == 0, res.stdout + res.stderr
    last = res.stdout.strip().splitlines()[-1]
    if module == "geo_serve":
        assert last.startswith("ok: latency_aware cut cross-region")
    else:
        assert last.startswith("  user-5: [")


def _affinity_then_fail(ns):
    """Session "a" computes a 16-token prefix on node A; "b", whose key's
    owner is B with A next on the ring, shares that prefix, so warm-prefix
    affinity places it on A.  Then A fails: A's arc moves (``a``), B's
    does not (``b``)."""
    t = [0.0]
    m = _membership(ns, 3, t, net="10.6.0", port0=7400)
    c = _cluster(ns, m, slots=8, max_len=64, prefill_chunk=CHUNK)
    rng = np.random.default_rng(51)
    system = rng.integers(0, ns.cfg.vocab, 16, dtype=np.int32)
    a_node = c.router.route(["a"])[0]
    b_sid = next(f"b{i}" for i in range(100_000)
                 if m.ring_state.replica_set(
                     ns.serve.session_key(f"b{i}"), 2)[1] == a_node)

    def req(sid):
        tail = rng.integers(0, ns.cfg.vocab, 5, dtype=np.int32)
        return ns.serve.Request(sid, np.concatenate([system, tail]), 8)

    c.submit(req("a"))
    c.submit(req(b_sid))
    assert c.sessions[b_sid].owner == a_node and c.prefix_affinity_hits == 1
    c.step()
    m.fail(a_node)
    return c, b_sid, a_node


def test_a_session_on_a_non_owner_member_moves_when_that_member_fails(pair):
    """Deliberate difference (e): the port re-homes a session whose node
    left the active view even when its key's owner did not change, so
    the affinity-placed session completes with its unfailed tokens;
    repro's ``owner_diff`` does not cover it and it never completes."""
    ref, port = pair
    c, sid, a_node = _affinity_then_fail(port)
    assert c.sessions[sid].owner not in (a_node, -1)
    assert c.handoffs == 2 and c.handoff_misses == 0
    c.run(max_rounds=32)
    jc, jsid, ja_node = _affinity_then_fail(ref)
    assert (jsid, ja_node) == (sid, a_node) and jc.handoffs == 1
    assert jc.sessions[sid].owner == a_node       # still on the dead node
    with pytest.raises(RuntimeError, match="did not complete"):
        jc.run(max_rounds=32)
    done = {s: r.generated for s, r in jc.sessions.items() if r.done}
    assert done and all(c.sessions[s].generated == g
                        for s, g in done.items())
    t = [0.0]
    clean = _cluster(port, _membership(port, 3, t, net="10.6.0", port0=7400),
                     slots=8, max_len=64, prefill_chunk=CHUNK)
    for s in ("a", sid):
        clean.submit(port.serve.Request(s, c.sessions[s].prompt, 8))
    clean.run()
    assert {s: r.generated for s, r in clean.sessions.items()} \
        == {s: r.generated for s, r in c.sessions.items()}
