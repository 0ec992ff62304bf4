"""K1's two-level search (``csrc/ring_lookup.cu::ring_lookup64_kernel``) as
a numpy twin, held against numpy's bisect on the CPU.

The twin repeats the kernel's index arithmetic step for step: the stride
s = 2^shift, the least power of two with n <= s * kSample; the sample of
entries 0, s, 2s, ... < n; the branchless lower bound over the sample
(c samples below the key); the segment [(c - 1) s + 1, min(c s, n)); the
branchless lower bound over it, which reads the low word only where the
high words tie; and count % n.  The sample size is read from the CUDA
source, and the twin also runs at small sample sizes, so that tables of a
few thousand entries reach the segment stage: an off-by-one in the
segment bounds fails here, before the card.  The kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.ring_lookup import ops as rl_ops

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "ring_lookup.cu").read_text()
SAMPLE = int(re.search(r"constexpr int kSample = (\d+);", CU).group(1))
_W = np.uint64(32)


def _count_below(length, below):
    """``count_below`` of the CUDA source for each key at once: lengths
    (Q,) >= 1; ``below(j)`` says, per key, whether entry j[q] < key q."""
    base = np.zeros_like(length)
    length = length.copy()
    while (length > 1).any():
        active = length > 1
        half = length >> 1
        mid = base + half
        base = np.where(active & below(np.where(active, mid, base)), mid, base)
        length = np.where(active, length - half, length)
    return base + below(base)


def k1_twin(table_hi, table_lo, n, keys_hi, keys_lo, sample=SAMPLE):
    """(CAP,) uint32 table words sorted in the first n slots, (Q,) uint32
    key words -> ((Q,) int64 counts % n as the kernel writes them, the
    stride, the number of low-word loads)."""
    th, tl = table_hi.astype(np.uint64), table_lo.astype(np.uint64)
    kh, kl = keys_hi.astype(np.uint64), keys_lo.astype(np.uint64)
    key = (kh << _W) | kl
    q = key.size
    if n <= 0:
        return np.zeros(q, np.int64), 0, 0
    shift = 0
    while (sample << shift) < n:
        shift += 1
    m = ((n - 1) >> shift) + 1
    at = np.arange(m, dtype=np.int64) << shift
    samp = (th[at] << _W) | tl[at]
    c = _count_below(np.full(q, m, np.int64), lambda j: samp[j] < key)
    lo = ((c - 1) << shift) + 1
    length = np.minimum(c << shift, n) - lo
    count = np.where(c > 0, lo, 0)
    run = np.nonzero((c > 0) & (length > 0))[0]
    lo_loads = 0

    def below(j):
        nonlocal lo_loads
        pos = lo[run] + j
        h = th[pos]
        tie = h == kh[run]
        lo_loads += int(tie.sum())
        return (h < kh[run]) | (tie & (tl[pos] < kl[run]))
    if run.size:
        count[run] += _count_below(length[run], below)
    return np.where(count == n, 0, count), 1 << shift, lo_loads


def _words(ids):
    ids = np.asarray(ids, np.uint64)
    return ((ids >> _W).astype(np.uint32),
            (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _case(n, seed, cap=None, hi_values=None):
    """n sorted unique ids in a capacity-padded table (junk past n), and
    keys: random, every id, each id +- 1, 0 and 2^64 - 1.  With
    ``hi_values`` the ids share that many high words, so probes tie."""
    rng = np.random.default_rng(seed)
    if hi_values:
        hi = rng.integers(0, 2**32, hi_values, dtype=np.uint64)
        pool = (rng.choice(hi, 2 * n + 8) << _W) \
            | rng.integers(0, 2**32, 2 * n + 8, dtype=np.uint64)
    else:
        pool = rng.integers(0, 2**64, 2 * n + 8, dtype=np.uint64)
    ids = np.unique(pool)[:n]
    assert ids.size == n
    one = np.uint64(1)
    keys = np.concatenate([rng.integers(0, 2**64, 512, dtype=np.uint64), ids,
                           ids + one, ids - one,
                           np.array([0, 2**64 - 1], np.uint64)])
    cap = cap or max(n, 1)
    table = np.concatenate([ids, rng.integers(0, 2**64, cap - n,
                                              dtype=np.uint64)])
    return ids, keys, table


@pytest.mark.parametrize("sample", [1, 2, 8, 64, SAMPLE])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 63, 64, 65, 255, 256, 257,
                               1000, 2047, 4095, 4096, 4097, 5003])
def test_twin_equals_bisect(n, sample):
    ids, keys, table = _case(n, seed=n, cap=n + 37)
    got, stride, _ = k1_twin(*_words(table), n, *_words(keys), sample=sample)
    assert stride >= 1 and stride & (stride - 1) == 0
    assert n <= stride * sample and (stride == 1 or n > stride // 2 * sample)
    np.testing.assert_array_equal(
        got, np.searchsorted(ids, keys, side="left") % n)


@pytest.mark.parametrize("n,hi_values", [(1000, 3), (5000, 40), (70_000, 9)])
def test_twin_reads_low_words_only_on_ties(n, hi_values):
    """Ids that share high words make the segment search tie, and the
    low word decides; random ids and keys never tie."""
    ids, keys, table = _case(n, seed=hi_values, hi_values=hi_values)
    got, _, lo_loads = k1_twin(*_words(table), n, *_words(keys), sample=64)
    assert lo_loads > 0
    np.testing.assert_array_equal(
        got, np.searchsorted(ids, keys, side="left") % n)
    ids, keys, table = _case(n, seed=n)
    rnd = keys[:512]
    got, _, lo_loads = k1_twin(*_words(table), n, *_words(rnd), sample=64)
    assert lo_loads == 0
    np.testing.assert_array_equal(
        got, np.searchsorted(ids, rnd, side="left") % n)


@pytest.mark.parametrize("n,cap,stride", [(1_000_000, 1 << 20, 256),
                                          (1 << 20, 1 << 20, 256),
                                          (4097, 8192, 2), (4096, 4096, 1)])
def test_twin_at_the_card_sizes(n, cap, stride):
    """The chip's table (10^6 live of 2^20, s = 256: 3907 samples and a
    last segment cut by n), a full table, and both sides of the sample
    size; equal to the port's plain version on the CPU too."""
    ids, keys, table = _case(n, seed=7, cap=cap)
    thw, tlw = _words(table)
    khw, klw = _words(keys)
    got, s, _ = k1_twin(thw, tlw, n, khw, klw)
    assert s == stride
    np.testing.assert_array_equal(
        got, np.searchsorted(ids, keys, side="left") % n)
    t = [torch.from_numpy(w.view(np.int32)) for w in (khw, klw, thw, tlw)]
    plain = rl_ops.ring_lookup64(*t, torch.tensor([n], dtype=torch.int32))
    np.testing.assert_array_equal(plain.numpy(), got)


def test_twin_reads_the_source():
    """The twin's constants are the kernel's: the sample size, and the
    stride rule spelled as the source spells it."""
    assert SAMPLE == 4096
    assert "while ((static_cast<int64_t>(kSample) << shift) < n) ++shift;" in CU
    assert "const int32_t m = ((n - 1) >> shift) + 1;" in CU
    assert "const int32_t lo = ((c - 1) << shift) + 1;" in CU
