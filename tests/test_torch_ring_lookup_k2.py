"""K2's in-row search (``csrc/ring_lookup.cu::ring_lookup_bucketed_kernel``)
as a numpy twin, held against the port's plain version and numpy's bisect
on the CPU.

The twin repeats the kernel's steps for every key: the bucket b = the top
R bits of the high word; occ[b]; the key's place in its bucket's range as
a 32-bit fraction, the guess frac * occ[b] and the aligned window of
kWindow slots around it, whose live slots below the key are counted; when
the window lies wholly at or above the key (and is not the row's start),
or wholly below it (and short of occ[b]), the branchless lower bound
(``count_below`` of the CUDA source) over the side it rules out, loading
the low word only where the high words tie; the count capped at the row
width - 1; the owner ``row[count]``.  The row width and the window are read
from the CUDA source, and the twin also runs at other windows, so that the
fallback searches on both sides are reached.  The directories are the
port's own ``RingState`` ones, through churn and quarantine, plus rows at
occupancy 0 and 127 and a one-bucket directory built by hand.  Batches of
at most ``kK2WarpKeys`` keys take the other route, a warp a key counting
the live slots below it with a ballot: the plain version's own count.
Both routes are held against the plain version on the card
(``tests/test_torch_cuda.py``, 32 keys and more than 4096).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.edra import Event
from repro_torch.core.ringstate import RingState
from repro_torch.kernels.ring_lookup import ops as rl_ops

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "ring_lookup.cu").read_text()
ROW = int(re.search(r"constexpr int kRowWidth = (\d+);", CU).group(1))
WINDOW = int(re.search(r"constexpr int kWindow = (\d+);", CU).group(1))
_W = np.uint64(32)
_M64 = np.uint64(2**64 - 1)


def _count_below(length, below):
    """``count_below`` of the CUDA source for each key at once (the same
    loop as K1's twin): lengths (Q,) >= 1; ``below(j)`` says, per key,
    whether entry j[q] < key q."""
    base = np.zeros_like(length)
    length = length.copy()
    while (length > 1).any():
        active = length > 1
        half = length >> 1
        mid = base + half
        base = np.where(active & below(np.where(active, mid, base)), mid, base)
        length = np.where(active, length - half, length)
    return base + below(base)


def k2_twin(keys_hi, keys_lo, bkt_hi, bkt_lo, occ, window=WINDOW):
    """(Q,) uint32 key words, (B, ROW) uint32 rows, (B,) occupancy ->
    ((Q,) owner hi, (Q,) owner lo, low-word loads of the fallback
    searches, keys that needed a fallback search)."""
    nb = bkt_hi.shape[0]
    bits = nb.bit_length() - 1
    kh = keys_hi.astype(np.uint64)
    kl = keys_lo.astype(np.uint64)
    key = (kh << _W) | kl
    rows = (kh >> np.uint64(32 - bits)).astype(np.int64) if bits \
        else np.zeros(kh.size, np.int64)
    live = occ[rows].astype(np.int64)
    frac = ((key << np.uint64(bits)) & _M64) >> _W
    guess = ((frac * live.astype(np.uint64)) >> _W).astype(np.int64)
    w0 = guess & ~(window - 1)
    at = w0[:, None] + np.arange(window)[None, :]
    ids = (bkt_hi[rows[:, None], at].astype(np.uint64) << _W) \
        | bkt_lo[rows[:, None], at]
    inside = ((at < live[:, None]) & (ids < key[:, None])).sum(axis=1)
    count = w0 + inside
    lo_loads = 0

    def search(run, first, length):
        """count_below over [first, first + length) for the keys ``run``."""
        nonlocal lo_loads

        def below(j):
            nonlocal lo_loads
            pos = first + j
            h = bkt_hi[rows[run], pos].astype(np.uint64)
            tie = h == kh[run]
            lo_loads += int(tie.sum())
            return (h < kh[run]) | (tie & (bkt_lo[rows[run], pos]
                                           .astype(np.uint64) < kl[run]))
        return _count_below(length, below)
    left = np.nonzero((inside == 0) & (w0 > 0))[0]
    right = np.nonzero((inside == window) & (count < live))[0]
    if left.size:
        count[left] = search(left, np.zeros(left.size, np.int64), w0[left])
    if right.size:
        count[right] += search(right, count[right], live[right] - count[right])
    count = np.minimum(count, ROW - 1)
    return (bkt_hi[rows, count], bkt_lo[rows, count], lo_loads,
            left.size + right.size)


def _words(ids):
    ids = np.asarray(ids, np.uint64)
    return ((ids >> _W).astype(np.uint32),
            (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _keys(ids, rng, extra=2048):
    one = np.uint64(1)
    return np.concatenate([rng.integers(0, 2**64, extra, dtype=np.uint64),
                           ids, ids + one, ids - one,
                           np.array([0, 2**64 - 1], np.uint64)])


def _check(state, keys, windows=(WINDOW, 4, 16, 32)):
    """Twin == plain version == bisect over the active ids, at the
    kernel's window and others; returns the first window's (low-word
    loads of the fallback searches, fallbacks)."""
    table = state.device_bucket_table()
    assert table is not None
    bhi, blo, occ = (t.numpy() for t in table)
    bhi, blo = bhi.view(np.uint32), blo.view(np.uint32)
    khw, klw = _words(keys)
    act = state.active_ids()
    want = act[np.searchsorted(act, keys) % act.size]
    plain = rl_ops.ring_lookup_bucketed(
        torch.from_numpy(khw.view(np.int32)),
        torch.from_numpy(klw.view(np.int32)), *table)
    stats = []
    for window in windows:
        oh, ol, lo_loads, fallbacks = k2_twin(khw, klw, bhi, blo, occ, window)
        np.testing.assert_array_equal((oh.astype(np.uint64) << _W) | ol, want)
        np.testing.assert_array_equal(plain[0].numpy().view(np.uint32), oh)
        np.testing.assert_array_equal(plain[1].numpy().view(np.uint32), ol)
        stats.append((lo_loads, fallbacks))
    return stats[0]


@pytest.mark.parametrize("n", [2048, 100_000])
def test_twin_through_churn_and_quarantine(n):
    rng = np.random.default_rng(n)
    ids = np.unique(rng.integers(0, 2**64, n + 64, dtype=np.uint64))[:n]
    state = RingState(ids, device="cpu")
    _check(state, _keys(ids, rng))
    gone = ids[rng.choice(n, n // 50, replace=False)]
    fresh = rng.integers(0, 2**64, n // 50, dtype=np.uint64)
    state.apply_events([Event(int(p), "leave", seq=1) for p in gone]
                       + [Event(int(p), "join", seq=1) for p in fresh])
    _check(state, _keys(state.active_ids(), rng))
    live = state.active_ids()
    for pid in live[::97]:
        assert state.set_quarantined(int(pid), True)
    assert len(state) == live.size - live[::97].size
    # the quarantined ids stay keys: their owner is the next active id
    lo_loads, fallbacks = _check(state, np.concatenate(
        [_keys(state.active_ids(), rng), live[::97]]))
    assert fallbacks > 0 and lo_loads > 0   # keys equal to ids tie
    assert state.bucket_stats()["valid"]


def _crowded(seed=0):
    """2048 ids over 64 buckets: 127 in bucket 0 (8 of them sharing one
    high word), none in bucket 1, the rest in buckets 2-63."""
    rng = np.random.default_rng(seed)
    crowded = rng.integers(0, 2**58, 127, dtype=np.uint64)
    crowded[:8] = (crowded[0] >> _W << _W) \
        + rng.integers(0, 2**32, 8, dtype=np.uint64)
    rest = rng.integers(2 << 58, 2**64, 2048 - 127, dtype=np.uint64)
    ids = np.unique(np.concatenate([crowded, rest]))
    assert ids.size == 2048
    return ids, rng


def test_twin_on_rows_at_occupancy_0_and_127():
    ids, rng = _crowded()
    state = RingState(ids, device="cpu")
    occ = state.device_bucket_table()[2].numpy()
    assert state.bucket_stats()["buckets"] == 64
    assert occ[0] == ROW - 1 and occ[1] == 0
    keys = np.concatenate([_keys(ids, rng),
                           np.array([1 << 58, (1 << 58) + 5, 2 << 58],
                                    np.uint64)])
    assert _check(state, keys)[1] > 0


def test_low_words_are_read_only_on_high_word_ties():
    """Outside the window a search reads a low word only where the high
    words tie: never for random keys, and for keys equal to ids that
    share one high word where a probe lands on that word."""
    ids, rng = _crowded(seed=1)
    state = RingState(ids, device="cpu")
    random = rng.integers(0, 2**64, 4096, dtype=np.uint64)
    assert not np.isin(random >> _W, ids >> _W).any()
    lo_loads, fallbacks = _check(state, random)
    assert fallbacks > 0 and lo_loads == 0
    words, counts = np.unique(ids >> _W, return_counts=True)
    shared = ids[(ids >> _W) == words[counts.argmax()]]
    assert shared.size == 8
    assert _check(state, shared, windows=(4,))[0] > 0


def test_the_window_holds_most_answers_on_uniform_ids():
    """Uniform ids (a hash ring) at 10^5 peers: the guess's window holds
    the answer for most keys, so most keys skip the fallback search."""
    rng = np.random.default_rng(5)
    ids = np.unique(rng.integers(0, 2**64, 100_064, dtype=np.uint64))
    state = RingState(ids[:100_000], device="cpu")
    keys = rng.integers(0, 2**64, 20_000, dtype=np.uint64)
    _, fallbacks = _check(state, keys, windows=(WINDOW,))
    assert fallbacks < 0.5 * keys.size


@pytest.mark.parametrize("occ", [0, 1, 2, 64, ROW - 1])
def test_twin_on_a_one_bucket_directory(occ):
    """bits 0: every key reads row 0.  Slack slots carry the successor,
    here the ring's first id (the wrap)."""
    rng = np.random.default_rng(occ)
    ids = np.sort(np.unique(rng.integers(0, 2**64, occ + 8,
                                         dtype=np.uint64))[:max(occ, 1)])
    row = np.full(ROW, ids[0], np.uint64)
    row[:occ] = ids[:occ]
    bhi, blo = (w[None, :] for w in _words(row))
    occ_a = np.array([occ], np.int32)
    keys = _keys(ids, rng, extra=512)
    khw, klw = _words(keys)
    if occ:
        want = ids[np.searchsorted(ids[:occ], keys) % occ]
    else:
        want = np.full(keys.size, ids[0], np.uint64)
    for window in (WINDOW, 4, 16, 32):
        oh, ol, _, _ = k2_twin(khw, klw, bhi, blo, occ_a, window)
        np.testing.assert_array_equal((oh.astype(np.uint64) << _W) | ol,
                                      want)
    oh, ol, _, _ = k2_twin(khw, klw, bhi, blo, occ_a)
    plain = rl_ops.ring_lookup_bucketed(
        *(torch.from_numpy(a.view(np.int32)) for a in (khw, klw)),
        torch.from_numpy(bhi.view(np.int32)),
        torch.from_numpy(blo.view(np.int32)), torch.from_numpy(occ_a))
    np.testing.assert_array_equal(plain[0].numpy().view(np.uint32), oh)
    np.testing.assert_array_equal(plain[1].numpy().view(np.uint32), ol)


def test_twin_reads_the_source():
    """The twin's steps are the kernel's, spelled as the source spells
    them: the row width, the window and its guess, the two fallbacks, the
    tie rule, the cap; and the launcher's choice of route by Q."""
    assert ROW == 128 and WINDOW == 8
    for line in (
            "const uint32_t frac = static_cast<uint32_t>((key << bits) >> 32);",
            "const int32_t guess = static_cast<int32_t>((static_cast<uint64_t>"
            "(frac) * live) >> 32);",
            "const int32_t w0 = guess & ~(kWindow - 1);",
            "in += w0 + j < live && id64(wh[j], wl[j]) < key;",
            "if (in == 0 && w0 > 0) {",
            "count = count_below(w0, below);",
            "} else if (in == kWindow && count < live) {",
            "return h < kh || (h == kh && row_lo[j] < kl);",
            "count = min(count, kRowWidth - 1);",
            "constexpr int64_t kK2WarpKeys = 4096;",
            "if (q <= kK2WarpKeys) {",
            "const bool lt = j < live && id64(row_hi[j], row_lo[j]) < key;"):
        assert line in CU, line
