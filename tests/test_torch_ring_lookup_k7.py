"""Port K7 (single-word ring lookup) plain version against repro's Pallas
``ring_lookup_pallas`` in interpret mode, as ``tests/test_kernels.py``
runs it: exact equality on its sweep shapes, its boundary keys, tables
with duplicate words, and against numpy's ``searchsorted(..., "left") %
N``.  An empty table raises ``LookupError`` in both packages.  Words
cross between the packages as numpy uint32; the port carries them as
int32 tensors holding the same bits."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ring_lookup.kernel import ring_lookup_pallas
from repro.kernels.ring_lookup.ops import ring_lookup as repro_ring_lookup
from repro_torch.kernels.ring_lookup import kernel as rk
from repro_torch.kernels.ring_lookup import ops
from repro_torch.kernels.ring_lookup.ref import ring_lookup_ref

torch.set_num_threads(1)

RNG = np.random.default_rng(42)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words, np.uint32).view(np.int32).copy())


def _both(keys: np.ndarray, table: np.ndarray) -> np.ndarray:
    """K7's plain version and the public wrapper on CPU tensors, held to
    repro's Pallas kernel in interpret mode and to numpy; returns the
    indices."""
    keys, table = np.asarray(keys, np.uint32), np.asarray(table, np.uint32)
    want = np.asarray(ring_lookup_pallas(jnp.asarray(keys), jnp.asarray(table),
                                         interpret=True))
    got = ring_lookup_ref(_t(keys), _t(table))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, np.searchsorted(table, keys, side="left") % table.size)
    before = ops.ring_lookup.launches
    np.testing.assert_array_equal(ops.ring_lookup(_t(keys), _t(table)).numpy(),
                                  want)
    assert ops.ring_lookup.launches == before     # no kernel on the CPU
    return want


@pytest.mark.parametrize("n,q", [(7, 3), (100, 257), (4096, 1024),
                                 (50_000, 2048)])
def test_ring_lookup_sweep(n, q):
    table = np.sort(RNG.choice(2**32 - 1, size=n, replace=False)
                    ).astype(np.uint32)
    keys = RNG.integers(0, 2**32, size=q, dtype=np.uint32)
    _both(keys, table)


def test_ring_lookup_boundary_keys():
    table = np.sort(RNG.choice(2**32 - 1, size=64, replace=False)
                    ).astype(np.uint32)
    keys = np.concatenate([table, table + 1, table - 1,
                           [0, 2**32 - 1]]).astype(np.uint32)
    _both(keys, table)


DUPLICATE_TABLES = {
    "runs": lambda: np.sort(np.repeat(
        RNG.integers(0, 2**32, size=40, dtype=np.uint32), 1 + np.arange(40) % 5)),
    "all_equal": lambda: np.full(33, 0xDEADBEEF, np.uint32),
    "ends": lambda: np.array([0, 0, 0, 5, 5, 2**32 - 1, 2**32 - 1], np.uint32),
    "single": lambda: np.array([2**31], np.uint32),
}


@pytest.mark.parametrize("name", sorted(DUPLICATE_TABLES))
def test_ring_lookup_duplicate_words(name):
    """A run of equal words gives its first index (bisect_left), and the
    top half of the uint32 range sorts above the bottom."""
    table = DUPLICATE_TABLES[name]()
    keys = np.concatenate([table, table + 1, table - 1, [0, 1, 2**31 - 1,
                           2**31, 2**32 - 1],
                           RNG.integers(0, 2**32, size=64, dtype=np.uint32)]
                          ).astype(np.uint32)
    idx = _both(keys, table)
    first = {int(w): int(np.argmax(table == w)) for w in np.unique(table)}
    hit = np.isin(keys, table)
    np.testing.assert_array_equal(idx[hit],
                                  [first[int(k)] for k in keys[hit]])


def test_ring_lookup_empty_table_raises_in_both():
    keys = np.arange(4, dtype=np.uint32)
    empty = np.zeros(0, np.uint32)
    with pytest.raises(LookupError, match="empty routing table"):
        repro_ring_lookup(jnp.asarray(keys), jnp.asarray(empty))
    with pytest.raises(LookupError, match="empty routing table"):
        ops.ring_lookup(_t(keys), _t(empty))
    # before any device work: a table on the meta device never reaches
    # a launcher
    with pytest.raises(LookupError, match="empty routing table"):
        ops.ring_lookup(torch.empty(4, dtype=torch.int32, device="meta"),
                        torch.empty(0, dtype=torch.int32, device="meta"))


# -- the sampled route of csrc/ring_lookup.cu, twinned in torch --------------
#
# ``k7_twin`` repeats the kernel's index arithmetic on int64 tensors holding
# the uint32 words: the route (one level up to K7_SAMPLE_KEYS keys); the
# stride s = 2^shift, the least power of two with N <= s * kK7Sample; the
# tree of the samples (entries 0, s, 2s, ... < N, then 2^32 - 1 up to
# kK7Sample = 2^kK7Levels - 1 nodes) laid out breadth-first by the rank
# formula of ``tree_node``; the walk down its levels (c samples below the
# key, and the samples on either side); the segment [(c - 1) s + 1,
# min(c s, N)]; the interpolated guess, the aligned window of kK7Window
# words holding it, and the branchless lower bound on the side the window
# rules out.  The constants are read from the CUDA source (the crossover
# from the wrapper, ``kernel.K7_SAMPLE_KEYS``, which picks the route), and
# the twin also runs with shallow trees and forced guesses, so every branch
# of the segment step is reached at test sizes.  The kernel itself is held against
# the plain version on the card (``tests/test_torch_cuda.py``).

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "ring_lookup.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr (?:int|int64_t) {name} = (\d+);",
                         CU).group(1))


K7_LEVELS = _const("kK7Levels")
K7_SAMPLE = _const("kK7Sample")
K7_WINDOW = _const("kK7Window")
K7_SAMPLE_KEYS = rk.K7_SAMPLE_KEYS
M32 = 0xFFFFFFFF


def _count_below(length, below):
    """``count_below`` of the CUDA source for each key at once: lengths
    (Q,) >= 1 where active (0 elsewhere); ``below(j)`` says, per key,
    whether entry j[q] of that key's range is below it."""
    base = torch.zeros_like(length)
    length = length.clone()
    while bool((length > 1).any()):
        active = length > 1
        half = length >> 1
        mid = torch.where(active, base + half, base)
        base = torch.where(active & below(mid), mid, base)
        length = torch.where(active, length - half, length)
    return base + (below(base) & (length > 0)).long()


def tree_words(table, m, shift, levels):
    """``ring_lookup32_tree_kernel``'s output: word k (1 <= k < 2^levels,
    depth d = floor(log2 k)) holds the sample of in-order rank
    r = ((2 (k - 2^d) + 1) << (levels - 1 - d)) - 1, or 2^32 - 1 past m;
    word 0 is a pad."""
    tree = torch.full((1 << levels,), M32, dtype=torch.int64)
    for d in range(levels):
        k = torch.arange(1 << d, 2 << d)
        r = ((((k - (1 << d)) << 1) + 1) << (levels - 1 - d)) - 1
        live = r < m
        tree[k[live]] = table[r[live] << shift]
    return tree


def k7_twin(keys, table, *, levels=K7_LEVELS, window=K7_WINDOW,
            sample_keys=K7_SAMPLE_KEYS, guess="interpolated", seed=0,
            second_window=True):
    """(Q,) and sorted (N,) uint32 words as int64 tensors -> ((Q,) counts %
    N as the kernel writes them, the route, the stride, the keys the first
    window resolved).  ``guess`` replaces the interpolation by the
    segment's first or last word or a random one, and ``second_window``
    switches the neighbouring window off: the answer must not change."""
    q, n = keys.numel(), table.numel()
    if q <= sample_keys:
        count = _count_below(torch.full((q,), n, dtype=torch.int64),
                             lambda j: table[j] < keys)
        return torch.where(count == n, 0, count), "one_level", 0, 0
    sample = (1 << levels) - 1
    shift = 0
    while (sample << shift) < n:
        shift += 1
    m = ((n - 1) >> shift) + 1
    tree = tree_words(table, m, shift, levels)
    k = torch.ones(q, dtype=torch.int64)
    a = torch.zeros(q, dtype=torch.int64)
    b = torch.full((q,), M32, dtype=torch.int64)
    for _ in range(levels):
        v = tree[k]
        lt = v < keys
        a = torch.where(lt, v, a)
        b = torch.where(lt, b, v)
        k = 2 * k + lt.long()
    c = k - (1 << levels)
    seg = c > 0
    lo = (c - 1) << shift
    hi = torch.clamp(c << shift, max=n)
    count = torch.where(seg, hi, 0)
    run = seg & (hi - lo > 1)
    if guess == "interpolated":
        frac = (keys - a).float() / ((b - a).float() + 1.0)
        g = lo + (frac * (hi - lo).float()).long()
    elif guess == "low":
        g = lo
    elif guess == "high":
        g = hi - 1
    else:
        gen = torch.Generator().manual_seed(seed)
        g = lo + (torch.rand(q, generator=gen, dtype=torch.float64)
                  * (hi - lo)).long()
    g = torch.minimum(g, hi - 1)
    j = torch.arange(window)

    def window_below(w0, wn, live):
        inside = j[None, :] < wn[:, None]
        words = table[torch.where(inside & live[:, None], w0[:, None] + j, 0)]
        return (inside & (words < keys[:, None])).sum(dim=1)
    w0 = g & ~(window - 1)
    wn = torch.clamp(n - w0, max=window)
    below_w = window_below(w0, wn, run)
    resolved = int((run & (below_w > 0) & (below_w < wn)).sum())
    if second_window:                  # the aligned neighbour on the side
        back = run & (below_w == 0) & (w0 > lo + 1)     # ruled out
        ahead = run & ~back & (below_w == wn) & (w0 + wn < hi)
        w0 = torch.where(back, w0 - window, torch.where(ahead, w0 + window,
                                                        w0))
        wn = torch.where(back | ahead, torch.clamp(n - w0, max=window), wn)
        moved = back | ahead
        below_w = torch.where(moved, window_below(w0, wn, moved), below_w)
    past = w0 + wn
    left = run & (below_w == 0) & (w0 > lo + 1)
    right = run & ~left & (below_w == wn) & (past < hi)
    out = torch.where(run, w0 + below_w, count)
    start = torch.where(left, lo + 1, past)
    fell = left | right
    length = torch.where(fell, torch.where(left, w0 - lo - 1, hi - past), 0)
    found = _count_below(length, lambda jj: table[torch.where(
        fell, start + jj, 0)] < keys)
    out = torch.where(fell, start + found, out)
    return torch.where(out == n, 0, out), "sampled", 1 << shift, resolved


def _k7_keys(table: np.ndarray, rng, q: int = 4096, stride: int = 1):
    """Random keys, every word and its neighbours, the sample entries at
    the stride, 0 and 2^32 - 1."""
    samp = table[::stride]
    return np.concatenate([rng.integers(0, 2**32, q, dtype=np.uint32), table,
                           table + 1, table - 1, samp, samp + 1,
                           np.array([0, 2**32 - 1], np.uint32)]
                          ).astype(np.uint32)


def _twin_check(keys, table, **kw):
    keys, table = np.asarray(keys, np.uint32), np.asarray(table, np.uint32)
    want = np.searchsorted(table, keys, side="left") % table.size
    got, route, stride, resolved = k7_twin(
        torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(table.astype(np.int64)), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ring_lookup_ref(_t(keys), _t(table)).numpy(),
                                  want)
    return route, stride, resolved


@pytest.mark.parametrize("levels", [1, 2, 4, 15])
def test_k7_tree_is_the_sorted_sample_breadth_first(levels):
    """Every rank appears once, and an in-order walk of the tree gives the
    samples in order, then the pads."""
    n = 3 * (1 << levels)
    table = torch.arange(n, dtype=torch.int64) * 7
    m = (1 << levels) - 5 if levels > 2 else (1 << levels) - 1
    tree = tree_words(table, m, 1, levels)
    order = []

    def walk(k):
        if k < (1 << levels):
            walk(2 * k)
            order.append(int(tree[k]))
            walk(2 * k + 1)
    if levels <= 12:
        walk(1)
        want = [int(w) for w in table[torch.arange(m) << 1]]
        assert order == want + [M32] * ((1 << levels) - 1 - m)
    assert int(tree[0]) == M32
    live = tree[1:][tree[1:] != M32]
    assert torch.equal(torch.sort(live).values, table[torch.arange(m) << 1])


@pytest.mark.parametrize("levels", [1, 2, 3, 6, K7_LEVELS])
@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 31, 32, 33, 255, 256, 257, 1000,
                               4097, 20_011])
@pytest.mark.parametrize("route", ["one_level", "sampled"])
def test_k7_twin_equals_bisect(n, levels, route):
    """Both routes of the crossover on unique and on duplicated words, at
    tree depths that put the segment step in reach of small tables."""
    rng = np.random.default_rng(n * 7 + levels)
    table = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))
    if n > 8:
        table[n // 3:n // 3 + 5] = table[n // 3]          # a run of 5
        table = np.sort(table)
    sample = (1 << levels) - 1
    keys = _k7_keys(table, rng, stride=max(1, n // sample))
    got_route, stride, _ = _twin_check(
        keys, table, levels=levels,
        sample_keys=2**62 if route == "one_level" else 0)
    assert got_route == route
    if route == "sampled":
        assert n <= stride * sample and (stride == 1
                                         or n > stride // 2 * sample)


@pytest.mark.parametrize("q", [1, K7_SAMPLE_KEYS, K7_SAMPLE_KEYS + 1,
                               4 * K7_SAMPLE_KEYS])
def test_k7_twin_route_by_q(q):
    """The wrapper's crossover: one level up to K7_SAMPLE_KEYS keys, the
    sampled search above, the same answers on either side."""
    rng = np.random.default_rng(q)
    table = np.sort(rng.integers(0, 2**32, 50_000, dtype=np.uint32))
    keys = np.concatenate([table[:q // 2], rng.integers(
        0, 2**32, q - q // 2, dtype=np.uint32)]).astype(np.uint32)
    route, _, _ = _twin_check(keys, table)
    assert route == ("one_level" if q <= K7_SAMPLE_KEYS else "sampled")


@pytest.mark.parametrize("second", [True, False])
@pytest.mark.parametrize("guess", ["low", "high", "random"])
@pytest.mark.parametrize("n,levels", [(5003, 6), (70_000, 10), (1000, 3),
                                      (100_000, K7_LEVELS)])
def test_k7_twin_window_branches(n, levels, guess, second):
    """A guess at the segment's first word, its last, or anywhere: the
    window then lies wholly above or below the key, its neighbour on the
    other side is read, and the lower bound finishes where that misses
    too; with and without the neighbour, the answer never changes."""
    rng = np.random.default_rng(n)
    table = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))
    keys = _k7_keys(table, rng)
    _twin_check(keys, table, levels=levels, sample_keys=0, guess=guess,
                seed=n, second_window=second)


@pytest.mark.parametrize("window", [4, 8, 16, 32])
def test_k7_twin_other_windows(window):
    rng = np.random.default_rng(window)
    table = np.sort(rng.integers(0, 2**32, 9000, dtype=np.uint32))
    _twin_check(_k7_keys(table, rng), table, levels=8, window=window,
                sample_keys=0)


@pytest.mark.parametrize("n,stride", [(K7_SAMPLE - 1, 1), (K7_SAMPLE, 1),
                                      (K7_SAMPLE + 1, 2),
                                      (32 * K7_SAMPLE - 1, 32),
                                      (32 * K7_SAMPLE, 32),
                                      (32 * K7_SAMPLE + 1, 64)])
def test_k7_twin_at_stride_edges(n, stride):
    """N = s * kK7Sample - 1, s * kK7Sample and + 1: the stride steps up
    exactly past s * kK7Sample, and the last segment is cut by N."""
    rng = np.random.default_rng(n)
    table = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))
    keys = np.concatenate([rng.integers(0, 2**32, 8192, dtype=np.uint32),
                           table[-70:], table[-70:] + 1, table[::stride][:512],
                           np.array([0, 2**32 - 1], np.uint32)]
                          ).astype(np.uint32)
    _, got, _ = _twin_check(keys, table, sample_keys=0)
    assert got == stride


@pytest.mark.parametrize("levels", [3, 6])
def test_k7_twin_runs_straddle_sample_points(levels):
    """Runs of equal words that cross entries 0, s, 2s, ... give their
    first index whatever side of the sample point the key's run begins."""
    sample = (1 << levels) - 1
    n = 40 * sample
    stride = 1
    while stride * sample < n:
        stride *= 2
    words = np.arange(n, dtype=np.uint64) * 1000 + 5
    for p in range(stride, n - 4, stride * 3):       # runs over each point
        words[p - 2:p + 3] = words[p - 2]
    table = np.sort(words).astype(np.uint32)
    keys = np.concatenate([table, table + 1, table - 1,
                           np.array([0, 2**32 - 1], np.uint32)]
                          ).astype(np.uint32)
    for guess in ("interpolated", "low", "high"):
        _twin_check(keys, table, levels=levels, sample_keys=0, guess=guess)


def test_k7_twin_all_equal_and_extreme_words():
    for table in (np.full(300, 0xDEADBEEF, np.uint32),
                  np.array([0] * 40 + [2**32 - 1] * 40, np.uint32),
                  np.array([0, 0, 0, 5, 5, 2**32 - 1, 2**32 - 1], np.uint32)):
        keys = np.concatenate([table, table + 1, table - 1,
                               np.array([0, 1, 2**31, 2**32 - 1], np.uint32)]
                              ).astype(np.uint32)
        for levels in (1, 3, K7_LEVELS):
            _twin_check(keys, table, levels=levels, sample_keys=0)


def test_k7_twin_at_the_card_size():
    """The chip's table (the high words of 10^6 random 64-bit ids, with
    their duplicates): s = 32, 31,250 samples, and on uniform keys the
    window settles most keys with one read."""
    rng = np.random.default_rng(0)
    table = np.sort((rng.integers(0, 2**64, 10**6, dtype=np.uint64)
                     >> np.uint64(32)).astype(np.uint32))
    assert np.unique(table).size < table.size      # duplicates are kept
    keys = rng.integers(0, 2**32, 2 * K7_SAMPLE_KEYS, dtype=np.uint32)
    route, stride, resolved = _twin_check(keys, table)
    assert (route, stride) == ("sampled", 32)
    assert resolved >= 0.5 * keys.size
    _twin_check(np.concatenate([keys[:4096], table[::32], table[::32] + 1]),
                table, sample_keys=0)


def test_k7_twin_reads_the_source():
    """The twin's constants and rules are the kernel's, spelled as the
    source spells them, and the launcher's scratch holds the tree.  The
    route is picked once, in the wrapper: each route has a launcher of
    its own, and the CUDA source holds no crossover."""
    assert (K7_LEVELS, K7_SAMPLE, K7_WINDOW) == (15, 32767, 8)
    assert rk.K7_TREE_WORDS == K7_SAMPLE + 1
    assert rk.K7_SAMPLE_KEYS == K7_SAMPLE_KEYS == 65536
    assert rk.k7_route(K7_SAMPLE_KEYS) == "one_level"
    assert rk.k7_route(K7_SAMPLE_KEYS + 1) == "sampled"
    assert "SampleKeys" not in CU
    for line in (
            'extern "C" int ring_lookup_launch(const void* keys, '
            'const void* table, void* out,',
            'extern "C" int ring_lookup_sampled_launch(',
            "while ((static_cast<int64_t>(kK7Sample) << shift) < n) ++shift;",
            "const int32_t m = ((n - 1) >> shift) + 1;",
            "const int32_t r = ((((k - (1 << d)) << 1) + 1) << "
            "(kK7Levels - 1 - d)) - 1;",
            "return r < m ? table[static_cast<int64_t>(r) << shift] : "
            "0xFFFFFFFFu;",
            "k = 2 * k + lt;",
            "const int32_t c = k - (1 << kK7Levels);",
            "const int32_t lo = (c - 1) << shift;",
            "int32_t w0 = guess & ~(kK7Window - 1);",
            "int32_t wn = min(kK7Window, n - w0);",
            "w0 -= kK7Window;",
            "w0 += kK7Window;",
            "if (in == 0 && w0 > lo + 1)",
            "if (in == wn && past < hi)",
            "return count == n ? 0 : count;"):
        assert line in CU, line
