"""The port's KV-block data plane (``repro_torch.dht.data``) and placement
layer against repro's, on the same numpy inputs: the KVB1 wire bytes,
every scenario of ``tests/test_block_store.py`` run on both packages with
the store's physical copies, stats, ``replica_counts``, tombstones and
reads compared after each step, the prefix cache, and ``Topology`` /
``LatencyAware`` rankings under ``SimNet`` churn with each delay model.

Also the one deliberate difference of the wire format: a bfloat16 slab
round-trips KVB1 bit for bit on the port (``Bf16Words`` under the tag
``bf16``), where repro writes the void type ``'<V2'`` and cannot read
the block back into a cache (``src/repro/dht/data.py:69-95``).
"""
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.dht.data as jdata
import repro.dht.des as jdes
import repro.runtime.placement as jplace
from repro.configs import get_smoke_config as j_smoke
from repro.core.edra import Event as JEvent
from repro.core.ringstate import RingState as JRingState
from repro.models import transformer as jtransformer
from repro_torch.configs import get_smoke_config
from repro_torch.core.edra import Event
from repro_torch.core.ringstate import RingState
from repro_torch.dht import data, des
from repro_torch.models import Model
from repro_torch.runtime import placement

REPRO = SimpleNamespace(RingState=JRingState, Event=JEvent, des=jdes,
                        place=jplace, **{k: getattr(jdata, k) for k in (
                            "BlockMeta", "BlockStore", "PrefixCache",
                            "pack_array", "unpack_array")})
PORT = SimpleNamespace(RingState=lambda ids=(): RingState(ids, device="cpu"),
                       Event=Event, des=des, place=placement,
                       **{k: getattr(data, k) for k in (
                           "BlockMeta", "BlockStore", "PrefixCache",
                           "pack_array", "unpack_array")})

R = 3
POOL = [(i + 1) * (2**64 // 12) % 2**64 for i in range(11)]
KEYS = [(i * 2**64) // 7 + 5 for i in range(7)]


def _fresh(ns, n=6):
    state = ns.RingState()
    for pid in POOL[:n]:
        state.add(pid)
    return state, ns.BlockStore(state, replication=R)


def _snapshot(store):
    """Everything observable about a store: physical copies, placement,
    tombstones, version clock, stats and live replica counts."""
    nodes = {n: {k: (m.version, m.size, m.crc, v) for k, (m, v) in d.items()}
             for n, d in store._nodes.items() if d}
    return (nodes, dict(store._placement), dict(store._tombs),
            dict(store._vclock), store.stats(), store.replica_counts())


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float16", "int32", "uint8"])
def test_kvb1_bytes_equal_repro(dtype):
    arr = (np.arange(2 * 3 * 4 * 5).reshape(2, 3, 4, 5) % 11).astype(dtype)
    packed = data.pack_array(arr)
    assert packed == jdata.pack_array(arr)
    for unpack in (data.unpack_array, jdata.unpack_array):
        out = unpack(packed)
        assert out.dtype == arr.dtype and out.shape == arr.shape
        assert type(out) is np.ndarray
        np.testing.assert_array_equal(out, arr)


def test_kvb1_rejects_foreign_bytes_and_meta_integrity():
    for ns in (REPRO, PORT):
        with pytest.raises(ValueError):
            ns.unpack_array(b"not a block")
        meta = ns.BlockMeta.of(3, b"payload")
        assert meta.valid(b"payload")
        assert not meta.valid(b"payloaX")
        assert not meta.valid(b"payload-longer")
        assert meta == ns.BlockMeta(3, 7, meta.crc)
    assert data.BlockMeta.of(3, b"payload").crc \
        == jdata.BlockMeta.of(3, b"payload").crc


def test_bf16_slab_roundtrips_kvb1_bit_for_bit():
    """Deliberate difference (a): the port's bfloat16 block survives
    pack/unpack and lands in a fresh cache bit for bit; repro's header
    says '<V2' and its ``cache_with_blocks`` cannot cast it."""
    cfg = get_smoke_config("qwen2.5-3b")               # bfloat16
    assert str(cfg.dtype) == "bfloat16"
    m = Model(cfg)
    cache = m.init_cache(1, 32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for name in ("k", "v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=gen))
    block = m.export_kv_block(cache, 0, 8, 8)
    assert isinstance(block, data.Bf16Words)
    assert block.shape == m.kv_block_shape(8) and block.dtype == np.uint16
    packed = data.pack_array(block)
    assert packed[4:10] == b"\x04\x05bf16"        # tag length, ndim, tag
    back = data.unpack_array(packed)
    assert isinstance(back, data.Bf16Words)
    np.testing.assert_array_equal(back, block)
    fresh = m.cache_with_blocks(32, [back, back], device="cpu")
    for name in ("k", "v"):
        want = cache[name][:, 0, 8:16].view(torch.int16)
        assert torch.equal(fresh[name][:, 0, 0:8].view(torch.int16), want)
        assert torch.equal(fresh[name][:, 0, 8:16].view(torch.int16), want)
        assert not fresh[name][:, 0, 16:].any()
    # repro on the same config: the header is '<V2' and the block is
    # raw void bytes that no cache accepts
    jcfg = j_smoke("qwen2.5-3b")
    jblock = jtransformer.export_kv_block(
        jcfg, jtransformer.init_cache(jcfg, 1, 32), 0, 0, 8)
    jback = jdata.unpack_array(jdata.pack_array(jblock))
    assert jback.dtype.str == "|V2"
    with pytest.raises((ValueError, TypeError)):
        jtransformer.cache_with_blocks(jcfg, 32, [jback])


def test_foreign_blocks_are_refused_before_any_write():
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    m = Model(cfg)
    cache = m.init_cache(1, 32, device="cpu")
    good = m.export_kv_block(cache, 0, 0, 8)
    for bad in (np.zeros((3, 3), np.float32), good.astype(np.float16),
                data.Bf16Words.of(good.view(np.uint32).astype(np.uint16)),
                good[:, :, :1]):
        with pytest.raises(ValueError):
            m.cache_with_blocks(32, [good, bad], device="cpu")
        with pytest.raises(ValueError):
            m.import_kv_block(cache, 0, 8, bad)
    assert not cache["k"].any() and not cache["v"].any()


# ---------------------------------------------------------------------------
# the store's scenarios, on both packages
# ---------------------------------------------------------------------------

def _put_places_on_replica_set(ns):
    state, store = _fresh(ns)
    store.put(KEYS[0], b"x" * 100)
    return [state.replica_set(KEYS[0], R), store.get(KEYS[0]),
            _snapshot(store)]


def _overwrite_bumps_version(ns):
    _, store = _fresh(ns)
    store.put(KEYS[0], b"v1")
    meta = store.put(KEYS[0], b"v2")
    return [meta.version, store.get(KEYS[0]), _snapshot(store)]


def _remove_buries(ns):
    state, store = _fresh(ns)
    store.put(KEYS[1], b"secret")
    holder = state.replica_set(KEYS[1], R)[0]
    state.remove(holder)
    out = [store.remove(KEYS[1])]
    state.add(holder)
    out += [store.get(KEYS[1]), store.sync(), store.get(KEYS[1]),
            store.contains(KEYS[1]), _snapshot(store)]
    return out


def _put_after_remove(ns):
    _, store = _fresh(ns)
    store.put(KEYS[2], b"a")
    store.remove(KEYS[2])
    store.put(KEYS[2], b"b")
    return [store.get(KEYS[2]), _snapshot(store)]


def _corrupt_copy(ns):
    state, store = _fresh(ns)
    store.put(KEYS[3], b"clean-bytes")
    victim = state.replica_set(KEYS[3], R)[1]
    meta, _ = store._nodes[victim][KEYS[3]]
    store._nodes[victim][KEYS[3]] = (meta, b"torn bytes!")
    return [store.get(KEYS[3]), store.corrupt_copies, _snapshot(store)]


def _stale_rejoin(ns):
    state, store = _fresh(ns)
    store.put(KEYS[4], b"old")
    holder = state.replica_set(KEYS[4], R)[0]
    state.remove(holder)
    out = [store.sync()]
    store.put(KEYS[4], b"new")
    state.add(holder)
    out += [store.get(KEYS[4]), store.sync(), _snapshot(store)]
    return out


def _crash_and_sync(ns):
    state, store = _fresh(ns)
    store.put(KEYS[5], b"p" * 64)
    victim = state.replica_set(KEYS[5], R)[0]
    state.remove(victim)
    store.drop_node(victim)
    return [store.sync(), store.get(KEYS[5]), _snapshot(store)]


def _all_replicas_lost(ns):
    state, store = _fresh(ns)
    store.put(KEYS[6], b"doomed")
    for node in state.replica_set(KEYS[6], R):
        state.remove(node)
        store.drop_node(node)
    return [store.sync(), store.get(KEYS[6]), _snapshot(store)]


def _sync_without_churn(ns):
    _, store = _fresh(ns)
    for k in KEYS:
        store.put(k, b"y" * 32)
    return [store.sync(), store.sync(), _snapshot(store)]


def _string_names_and_arrays(ns):
    _, store = _fresh(ns)
    store.put("kv/sess-1/0", b"named")
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    store.put_array("kv/sess-1/1", arr)
    store.put("kv/sess-1/2", b"co-located", at="session/s1")
    return [store.get("kv/sess-1/0"), store.contains("kv/sess-1/0"),
            store.get_array("kv/sess-1/1").tolist(),
            store.key_of("kv/sess-1/2"), _snapshot(store)]


SCENARIOS = [_put_places_on_replica_set, _overwrite_bumps_version,
             _remove_buries, _put_after_remove, _corrupt_copy, _stale_rejoin,
             _crash_and_sync, _all_replicas_lost, _sync_without_churn,
             _string_names_and_arrays]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[1:])
def test_store_scenario_matches_repro(scenario):
    assert scenario(PORT) == scenario(REPRO)


def _op_stream(rng, n_ops):
    """test_block_store.py's churn stream: puts, removes, graceful
    leaves, crashes, same-ID rejoins and syncs."""
    ops = []
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.40:
            ops.append(("put", KEYS[int(rng.integers(len(KEYS)))],
                        bytes(rng.integers(0, 256, size=int(
                            rng.integers(1, 64))).astype(np.uint8))))
        elif roll < 0.50:
            ops.append(("remove", KEYS[int(rng.integers(len(KEYS)))]))
        elif roll < 0.65:
            ops.append(("leave", POOL[int(rng.integers(len(POOL)))]))
        elif roll < 0.80:
            ops.append(("crash", POOL[int(rng.integers(len(POOL)))]))
        elif roll < 0.92:
            ops.append(("rejoin", POOL[int(rng.integers(len(POOL)))]))
        else:
            ops.append(("sync",))
    return ops


def _replay(ns, ops):
    state, store = _fresh(ns)
    trace = []
    for op in ops:
        kind = op[0]
        if kind == "put":
            trace.append(store.put(op[1], op[2]).version)
        elif kind == "remove":
            trace.append(store.remove(op[1]))
        elif kind in ("leave", "crash") and len(state) > R:
            state.remove(op[1])
            if kind == "crash":
                store.drop_node(op[1])
        elif kind == "rejoin":
            state.add(op[1])
        elif kind == "sync":
            trace.append(store.sync())
        trace.append(_snapshot(store))
    trace.append(store.sync())
    trace.append([store.get(k) for k in KEYS])
    trace.append(_snapshot(store))
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_churn_stream_matches_repro(seed):
    """Stats, replica counts, tombstones and every physical copy equal
    after each op of a random churn stream, and after convergence."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(4):
        ops = _op_stream(rng, int(rng.integers(10, 40)))
        assert _replay(PORT, ops) == _replay(REPRO, ops)


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------

def _prefix_content_addressing(ns):
    _, store = _fresh(ns)
    pc = ns.PrefixCache(store, chunk=4, salt="m0")
    shared = np.arange(12, dtype=np.int32)
    pc.insert(shared, 0, np.full((2, 4), 7, np.float32))
    pc.insert(shared, 4, np.full((2, 4), 8, np.float32))
    other = np.concatenate([shared[:8], np.array([99, 98, 97, 96, 95],
                                                 np.int32)])
    fork = shared.copy()
    fork[5] = 1000
    out = []
    for toks in (other, fork):
        covered, blocks = pc.match(toks)
        out.append((covered, [b.tolist() for b in blocks]))
    return out + [pc.chunk_name(shared, 4), pc.chunk_name(shared, 12),
                  pc.hits, pc.misses, pc.tokens_saved, _snapshot(store)]


def _prefix_final_segment(ns):
    _, store = _fresh(ns)
    pc = ns.PrefixCache(store, chunk=4)
    toks = np.arange(8, dtype=np.int32)
    pc.insert(toks, 0, np.zeros((1, 4), np.float32))
    pc.insert(toks, 4, np.zeros((1, 4), np.float32))
    covered, blocks = pc.match(toks)
    return [covered, len(blocks), [pc.max_cover(n) for n in (1, 4, 8, 9)],
            pc.misses, _snapshot(store)]


def _prefix_salt_and_counters(ns):
    _, store = _fresh(ns)
    a = ns.PrefixCache(store, chunk=2, salt="model-a")
    b = ns.PrefixCache(store, chunk=2, salt="model-b")
    toks = np.arange(7, dtype=np.int32)
    for off in (0, 2, 4):
        a.insert(toks, off, np.float32(off) * np.ones((1, 2), np.float32))
    return [b.match(toks)[0], a.match(toks)[0], a.hits, a.misses,
            a.tokens_saved, b.hits, _snapshot(store)]


@pytest.mark.parametrize("scenario", [_prefix_content_addressing,
                                      _prefix_final_segment,
                                      _prefix_salt_and_counters],
                         ids=lambda f: f.__name__[1:])
def test_prefix_cache_scenario_matches_repro(scenario):
    assert scenario(PORT) == scenario(REPRO)


# ---------------------------------------------------------------------------
# placement: Topology and LatencyAware under SimNet churn
# ---------------------------------------------------------------------------

def _rand_ids(rng, k):
    return np.unique(rng.integers(0, 2**64, size=2 * k + 16,
                                  dtype=np.uint64))[:k]


def _rankings(ns, topo, state, keys, origins):
    la = ns.place.LatencyAware(topo)
    sticky = ns.place.LatencyAware(topo, affinity_ms=1e6)
    out = [la.gateways(state, 2, origin=o) for o in origins]
    for key in keys:
        view = state.replica_view(int(key), 3)
        for o in origins:
            out.append(la.rank(view, origin=o))
            out.append(sticky.rank(view, origin=o, prefer=view.ids[-1]))
            out.append(la.replica_group(state, int(key), 3, origin=o,
                                        prefer=view.ids[0]))
    return out


def _geo_run(ns, delay, seed):
    """Joins and leaves fired from a SimNet's event heap at delays drawn
    from ``delay``; after each batch, the policy's rankings for a key
    sample, from node and region origins."""
    rng = np.random.default_rng(seed)
    ids = _rand_ids(rng, 40)
    state = ns.RingState(ids[:24])
    topo = ns.place.Topology.multi_dc(4)
    for i, p in enumerate(ids[:6]):
        topo.place(int(p), topo.names[i % 2])
    dmodel = {"lan": lambda: ns.des.LanDelay(),
              "wan": lambda: ns.des.WanDelay(),
              "geo": lambda: ns.des.GeoDelay(topo)}[delay]()
    net = ns.des.SimNet(dmodel, seed=seed)
    draw = random.Random(seed)
    when = 0.0
    for i, p in enumerate(ids[24:]):
        when += dmodel.sample_pair(draw, int(ids[0]), int(p)) \
            if delay == "geo" else dmodel.sample(draw)
        kind = "leave" if i % 3 == 2 else "join"
        pid = int(ids[i]) if kind == "leave" else int(p)
        net.schedule_at(when, lambda pid=pid, kind=kind: state.apply_events(
            [ns.Event(subject_id=pid, kind=kind)]))
    keys = rng.integers(0, 2**64, size=12, dtype=np.uint64)
    origins = ["us-east", "ap-south", int(ids[1]), int(ids[30])]
    out = [topo.region_index(ids).tolist(),
           topo.rtt_ms_many("eu-west", ids).tolist()]
    for _ in range(4):
        net.run_until(when * (_ + 1) / 4 + 1e-9)
        out.append(state.active_ids().tolist())
        out.append(_rankings(ns, topo, state, keys, origins))
    return out


@pytest.mark.parametrize("delay", ["lan", "wan", "geo"])
def test_latency_aware_rankings_match_repro_under_simnet(delay):
    assert _geo_run(PORT, delay, 3) == _geo_run(REPRO, delay, 3)


def test_geo_delay_and_single_region_match_repro():
    out = []
    for ns in (PORT, REPRO):
        topo = ns.place.Topology.multi_dc(4)
        gd = ns.des.GeoDelay(topo, sigma=0.25)
        rng = random.Random(0)
        single = ns.place.LatencyAware(ns.place.Topology.single_region())
        state = ns.RingState(_rand_ids(np.random.default_rng(5), 32))
        view = state.replica_view(12345, 3)
        out.append(([gd.sample_pair(rng, a, b) for a in topo.names
                     for b in topo.names], gd.mean,
                    single.rank(view, origin=int(view.ids[2])),
                    list(view.ids), topo.one_way_ms("us-east", "eu-west")))
    assert out[0] == out[1]
    assert out[0][2] == out[0][3]          # one region: ring order


def test_block_store_placement_set_is_policy_independent():
    """The copies' holder SET never depends on the policy, and equals
    repro's under every policy."""
    ids = _rand_ids(np.random.default_rng(16), 48)
    snaps = []
    for ns in (PORT, REPRO):
        topo = ns.place.Topology.multi_dc(3)
        for pol in (None, ns.place.RingSuccessor(),
                    ns.place.LatencyAware(topo)):
            s = ns.BlockStore(ns.RingState(ids.copy()), replication=3,
                              policy=pol)
            for i in range(24):
                s.put(f"blk/{i}", bytes([i]) * 64)
                s.put(f"kv/{i}", bytes([i]) * 64, at=i * 7 + 1)
            snaps.append({k: sorted(v) for k, v in s._placement.items()})
    assert all(snap == snaps[0] for snap in snaps)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-235b-a22b",
                                  "internvl2-2b", "deepseek-v2-236b",
                                  "falcon-mamba-7b", "zamba2-7b",
                                  "whisper-small"])
def test_kv_blocks_where_repro_has_them(arch):
    """``supports_kv_blocks`` is repro's for every family (dense, MoE and
    VLM text; not MLA, SSM, hybrid or encoder-decoder), and a family
    without blocks refuses every block call."""
    from repro.models import Model as JModel
    m = Model(get_smoke_config(arch))
    want = JModel(j_smoke(arch)).supports_kv_blocks
    assert m.supports_kv_blocks == want
    if want:
        assert m.kv_block_shape(4) == jtransformer.kv_block_shape(
            j_smoke(arch), 4)
        return
    cache = m.init_cache(1, 8, device="cpu")
    for call in (lambda: m.kv_block_shape(4),
                 lambda: m.export_kv_block(cache, 0, 0, 4),
                 lambda: m.cache_with_blocks(8, [], device="cpu")):
        with pytest.raises(NotImplementedError, match="no KV block"):
            call()


def test_block_export_and_import_match_repro_byte_for_byte():
    """The same float32 cache contents on both packages: every export
    (one chunk, one shard, two shards on the kv-head axis) is
    byte-equal to repro's, a shard count that does not divide kv_heads
    raises repro's error, and an import writes repro's rows."""
    import jax.numpy as jnp
    from repro_torch.models import transformer
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    jcfg = j_smoke("qwen2.5-3b").with_overrides(dtype="float32")
    rng = np.random.default_rng(8)
    shape = transformer.cache_shapes(cfg, 2, 32)["k"]
    host = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    cache = {n: torch.from_numpy(a.copy()) for n, a in host.items()}
    jcache = {n: jnp.asarray(a) for n, a in host.items()}
    for row, off in ((0, 0), (1, 8), (1, 24)):
        want = jtransformer.export_kv_block(jcfg, jcache, row, off, 8)
        got = transformer.export_kv_block(cfg, cache, row, off, 8)
        assert data.pack_array(got) == jdata.pack_array(want)
        (shard,) = transformer.export_kv_block_shards(cfg, cache, row, off,
                                                      8, 1)
        (jshard,) = jtransformer.export_kv_block_shards(jcfg, jcache, row,
                                                        off, 8, 1)
        assert shard.tobytes() == jshard.tobytes() == got.tobytes()
        halves = transformer.export_kv_block_shards(cfg, cache, row, off,
                                                    8, 2)
        jhalves = jtransformer.export_kv_block_shards(jcfg, jcache, row,
                                                      off, 8, 2)
        assert [h.tobytes() for h in halves] == \
            [h.tobytes() for h in jhalves]
    with pytest.raises(ValueError, match="shards=3 must divide kv_heads=2"):
        transformer.export_kv_block_shards(cfg, cache, 0, 0, 8, 3)
    block = jtransformer.export_kv_block(jcfg, jcache, 1, 16, 8)
    jout = jtransformer.import_kv_block(jcfg, jcache, 0, 8, block)
    out = transformer.import_kv_block(cfg, cache, 0, 8, np.asarray(block))
    for n in ("k", "v"):
        assert out[n].numpy().tobytes() == np.asarray(jout[n]).tobytes()
