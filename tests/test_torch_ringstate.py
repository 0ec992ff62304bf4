"""The port's RingState against repro's: owners equal repro's
``RingState.lookup(use_pallas=False)`` and a numpy bisect on every path
(only owners are compared: the bucket layouts depend on the device
budget), upload accounting, delta sync, and the device bucket budget."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core.edra import Event as JEvent
from repro.core.ringstate import RingState as JRingState
from repro_torch.core.edra import Event
from repro_torch.core.ringstate import _BUCKET_ROW, RingState
from repro_torch.kernels import backend

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

RNG = np.random.default_rng(41)
ROW_BYTES = _BUCKET_ROW * 8 + 4


def _rand_ids(k: int) -> np.ndarray:
    return np.unique(RNG.integers(0, 2**64, size=2 * k, dtype=np.uint64))[:k]


def _oracle(act: np.ndarray, keys: np.ndarray) -> np.ndarray:
    return act[np.searchsorted(act, keys) % act.size]


def _keys(state) -> np.ndarray:
    act = state.active_ids()
    one = np.uint64(1)
    return np.unique(np.concatenate([
        RNG.integers(0, 2**64, size=300, dtype=np.uint64), act, act - one,
        act + one, np.array([0, 2**64 - 1], np.uint64)]))


def _check(port: RingState, ref: JRingState, keys=None) -> None:
    keys = _keys(ref) if keys is None else np.asarray(keys, np.uint64)
    np.testing.assert_array_equal(port.active_ids(), ref.active_ids())
    want = _oracle(ref.active_ids(), keys)
    np.testing.assert_array_equal(ref.lookup(keys, use_pallas=False), want)
    for use_buckets in (True, False, None):
        np.testing.assert_array_equal(
            port.lookup(keys, use_buckets=use_buckets), want)


def _pair(ids):
    return RingState(ids, device="cpu"), JRingState(ids)


@pytest.mark.parametrize("ids", [
    _rand_ids(1), _rand_ids(2), _rand_ids(50), _rand_ids(3000),
    # all-equal hi words: no radix splits them -> flat fallback
    (np.uint64(0xDEADBEEF) << np.uint64(32)) | np.arange(1, 4001,
                                                         dtype=np.uint64),
    # moderate clustering below one base bucket: the directory escalates
    np.unique(RNG.integers(0, 1 << 58, size=400, dtype=np.uint64))[:300],
], ids=["n1", "n2", "n50", "n3000", "all_equal_hi", "escalate"])
def test_owners_match_repro_and_bisect(ids):
    port, ref = _pair(ids)
    _check(port, ref)


def test_owners_match_under_quarantine():
    port, ref = _pair(_rand_ids(2500))
    live = ref.active_ids()
    for pid in np.unique(live[RNG.integers(0, live.size, size=400)]):
        assert port.set_quarantined(int(pid), True) \
            == ref.set_quarantined(int(pid), True)
    _check(port, ref)
    masked = np.setdiff1d(ref.all_ids(), ref.active_ids())
    owners = port.lookup(_keys(ref), use_buckets=True)
    assert not np.isin(owners, masked).any()


def test_owners_match_through_churn_sequences():
    port, ref = _pair(_rand_ids(2600))
    keys = RNG.integers(0, 2**64, size=200, dtype=np.uint64)
    port.lookup(keys)
    for i in range(6):
        live = ref.active_ids()
        gone = live[RNG.integers(0, live.size, size=24)]
        fresh = _rand_ids(24)
        port.apply_events([Event(int(p), "leave", seq=i) for p in gone]
                          + [Event(int(p), "join", seq=i) for p in fresh])
        ref.apply_events([JEvent(int(p), "leave", seq=i) for p in gone]
                         + [JEvent(int(p), "join", seq=i) for p in fresh])
        _check(port, ref, keys)


def test_upload_count_stays_put_across_unchanged_batches():
    for n, use_buckets in ((3000, True), (100, False)):
        state = RingState(_rand_ids(n), device="cpu")
        keys = RNG.integers(0, 2**64, size=64, dtype=np.uint64)
        state.lookup(keys, use_buckets=use_buckets)
        assert state.upload_count == 1
        for _ in range(100):
            state.lookup(keys, use_buckets=use_buckets)
        assert state.upload_count == 1


def test_delta_sync_ships_dirty_rows_and_equals_full_rebuild():
    state = RingState(_rand_ids(3000), device="cpu")
    state.lookup(RNG.integers(0, 2**64, size=64, dtype=np.uint64))
    assert state.full_uploads == 1
    for i in range(5):
        live = state.active_ids()
        evs = [Event(int(p), "leave", seq=i)
               for p in live[RNG.integers(0, live.size, size=32)]]
        evs += [Event(int(p), "join", seq=i) for p in _rand_ids(32)]
        state.apply_events(evs)
        rows = int(state._bkt_dirty.sum())
        deltas, sent = state.delta_uploads, state.upload_bytes
        assert state.device_bucket_table() is not None
        assert state.delta_uploads == deltas + 1
        assert state.upload_bytes == sent + rows * ROW_BYTES
    fresh = RingState(state.active_ids(), device="cpu")
    fresh._enable_buckets()
    incr, scratch = state.device_bucket_table(), fresh.device_bucket_table()
    assert state.bucket_stats()["buckets"] == fresh.bucket_stats()["buckets"]
    for a, b in zip(incr, scratch):
        assert a.dtype == torch.int32
        assert torch.equal(a, b)


def test_empty_table_raises_lookup_error():
    with pytest.raises(LookupError, match="empty routing table"):
        RingState(device="cpu").lookup(np.array([1], np.uint64))


def test_device_tables_default_to_the_card(monkeypatch):
    """No device and no CUDA: the device path raises and names the CPU
    opt-in; host-only use never resolves a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = RingState(_rand_ids(10))
    assert state.successor_of(5) in state.active_ids()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        state.device_table()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        state.lookup(np.array([1], np.uint64))


@pytest.mark.parametrize("l2_bytes,bits,valid", [
    (50 * 10**6, 15, True),      # an H100's L2 -> 32 MiB budget
    (8 << 20, 13, False),        # repro's 8 MB TPU budget: flat fallback
])
def test_bucket_budget_on_a_million_peer_ring(monkeypatch, l2_bytes, bits,
                                              valid):
    """n = 10^6 (capacity 2^20) wants 2^15 buckets, a 32 MiB matrix: a
    50 MB L2 keeps it on the bucketed path; an 8 MB budget clamps it to
    8192 buckets of ~122 ids, some rows overflow 128 slots, escalation
    cannot grow within the budget, and the index invalidates."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *_: SimpleNamespace(L2_cache_size=l2_bytes))
    assert backend.bucket_budget_bytes("cuda") \
        == 1 << (l2_bytes.bit_length() - 1)
    rng = np.random.default_rng(7)
    ids = np.unique(rng.integers(0, 2**64, size=1_000_000, dtype=np.uint64))
    state = RingState(ids, device="cuda")
    state._enable_buckets()
    stats = state.bucket_stats()
    assert state._bkt_bits == bits
    assert stats["valid"] is valid
    if valid:
        assert stats["matrix_bytes"] == 32 << 20
        assert stats["max_occupancy"] < _BUCKET_ROW
