"""Port K1/K2 plain versions against repro's Pallas ring-lookup kernels
(interpret mode): exact equality on the id generators of
test_bucket_lookup.py (uniform, clustered hi words, all-equal hi words,
wraparound keys, quarantine, churn sequences), at n < capacity, and on a
one-bucket (B = 1) directory.  Data crosses between the packages as
numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.edra import Event
from repro.core.ringstate import RingState as JRingState
from repro.kernels.ring_lookup.kernel import (ring_lookup64_pallas,
                                              ring_lookup_bucketed_pallas)
from repro_torch.kernels.ring_lookup import ops
from repro_torch.kernels.ring_lookup.ref import (ring_lookup64_ref,
                                                 ring_lookup_bucketed_ref)

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

RNG = np.random.default_rng(31)
_W = np.uint64(32)
_M = np.uint64(0xFFFFFFFF)


def _split(ids: np.ndarray):
    ids = np.asarray(ids, np.uint64)
    return (ids >> _W).astype(np.uint32), (ids & _M).astype(np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(words, copy=True).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _rand_ids(k: int) -> np.ndarray:
    return np.unique(RNG.integers(0, 2**64, size=2 * k, dtype=np.uint64))[:k]


def _clustered(k: int, words: int = 3) -> np.ndarray:
    """Ids sharing a handful of hi words: whole swaths of the ring land
    in the same radix partitions."""
    his = RNG.integers(0, 2**32, size=words, dtype=np.uint64)
    los = RNG.integers(0, 2**32, size=k, dtype=np.uint64)
    return np.unique((his[np.arange(k) % words] << _W) | los)


def _all_equal_hi(k: int) -> np.ndarray:
    return (np.uint64(0xDEADBEEF) << _W) | np.arange(1, k + 1, dtype=np.uint64)


def _keys_for(ids: np.ndarray, q: int = 256) -> np.ndarray:
    """Random keys plus every id, its neighbours, and both ring ends
    (keys past the last id wrap to index 0)."""
    one = np.uint64(1)
    return np.concatenate([
        RNG.integers(0, 2**64, size=q, dtype=np.uint64), ids, ids - one,
        ids + one, np.array([0, 2**64 - 1], np.uint64)])


GENERATORS = {
    "uniform": lambda: _rand_ids(700),
    "clustered": lambda: _clustered(500),
    "all_equal_hi": lambda: _all_equal_hi(600),
    "single": lambda: _rand_ids(1),
}


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_flat_plain_matches_pallas(gen):
    ids = np.sort(GENERATORS[gen]())
    n, cap = ids.size, 2048                     # n < capacity: padded table
    thi, tlo = np.zeros(cap, np.uint32), np.zeros(cap, np.uint32)
    thi[:n], tlo[:n] = _split(ids)
    thi[n:] = RNG.integers(0, 2**32, size=cap - n, dtype=np.uint32)  # junk
    khi, klo = _split(_keys_for(ids))
    n_arr = np.array([n], np.int32)
    want = np.asarray(ring_lookup64_pallas(
        jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(thi),
        jnp.asarray(tlo), jnp.asarray(n_arr), interpret=True))
    got = ring_lookup64_ref(_t(khi), _t(klo), _t(thi), _t(tlo),
                            torch.from_numpy(n_arr))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the public wrapper takes the plain version for CPU tensors and
    # never counts a kernel launch there
    before = ops.ring_lookup64.launches
    np.testing.assert_array_equal(
        ops.ring_lookup64(_t(khi), _t(klo), _t(thi), _t(tlo),
                          torch.from_numpy(n_arr)).numpy(), want)
    assert ops.ring_lookup64.launches == before


def _bucketed_both(khi, klo, bhi, blo, occ):
    want_hi, want_lo = ring_lookup_bucketed_pallas(
        jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(bhi),
        jnp.asarray(blo), jnp.asarray(occ), interpret=True)
    got_hi, got_lo = ring_lookup_bucketed_ref(
        _t(khi), _t(klo), _t(bhi), _t(blo), torch.from_numpy(np.array(occ)))
    np.testing.assert_array_equal(_u32(got_hi), np.asarray(want_hi))
    np.testing.assert_array_equal(_u32(got_lo), np.asarray(want_lo))


def _repro_bucket_table(state: JRingState):
    dev = state.device_bucket_table()
    assert dev is not None
    return tuple(np.asarray(a) for a in dev)


@pytest.mark.parametrize("gen", ["uniform", "clustered"])
def test_bucketed_plain_matches_pallas(gen):
    # 8 hi words of ~60 ids each: clustered, yet within a 128-slot row
    ids = _rand_ids(700) if gen == "uniform" else _clustered(500, words=8)
    state = JRingState(ids)
    bhi, blo, occ = _repro_bucket_table(state)
    khi, klo = _split(_keys_for(state.active_ids()))
    _bucketed_both(khi, klo, bhi, blo, occ)


def test_bucketed_plain_matches_pallas_under_quarantine():
    state = JRingState(_rand_ids(900))
    live = state.active_ids()
    for pid in np.unique(live[RNG.integers(0, live.size, size=150)]):
        state.set_quarantined(int(pid), True)
    bhi, blo, occ = _repro_bucket_table(state)
    khi, klo = _split(_keys_for(state.all_ids()))
    _bucketed_both(khi, klo, bhi, blo, occ)


def test_bucketed_plain_matches_pallas_through_churn():
    """Delta-maintained directories after each EDRA batch."""
    state = JRingState(_rand_ids(600))
    state.device_bucket_table()
    for i in range(4):
        live = state.active_ids()
        evs = [Event(subject_id=int(p), kind="leave", seq=i)
               for p in live[RNG.integers(0, live.size, size=20)]]
        evs += [Event(subject_id=int(p), kind="join", seq=i)
                for p in _rand_ids(20)]
        state.apply_events(evs)
        bhi, blo, occ = _repro_bucket_table(state)
        khi, klo = _split(_keys_for(state.active_ids(), q=64))
        _bucketed_both(khi, klo, bhi, blo, occ)


def test_bucketed_single_bucket_directory():
    """B = 1 (R = 0): every key reads row 0; the pad slots carry the
    ring's first id, so keys past the last id wrap to it."""
    ids = np.sort(_rand_ids(90))
    hi, lo = _split(ids)
    bhi = np.full((1, 128), hi[0], np.uint32)
    blo = np.full((1, 128), lo[0], np.uint32)
    bhi[0, :ids.size], blo[0, :ids.size] = hi, lo
    occ = np.array([ids.size], np.int32)
    keys = _keys_for(ids)
    khi, klo = _split(keys)
    _bucketed_both(khi, klo, bhi, blo, occ)
    got_hi, got_lo = ops.ring_lookup_bucketed(
        _t(khi), _t(klo), _t(bhi), _t(blo), torch.from_numpy(np.array(occ)))
    owners = (_u32(got_hi).astype(np.uint64) << _W) | _u32(got_lo)
    np.testing.assert_array_equal(
        owners, ids[np.searchsorted(ids, keys) % ids.size])
