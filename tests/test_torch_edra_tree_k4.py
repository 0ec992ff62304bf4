"""K4's schedule (``csrc/edra_tree.cu::edra_tree_kernel``) as a torch twin,
held bit for bit against the port's plain version ``tree_math`` on the
CPU.

The twin repeats the kernel's steps: pairs in tiles of kTile, each tile
counting-sorted by hops (the popcount of the offset's low ``levels``
bits: a pair's slot is its bin's start plus its rank in the bin), the
sorted pairs walked, each result written back to its pair's own place;
the walk visits only the offset's set bits, high to low; the sender of a
hop is (r + cur) less n where that reaches n, with r = reporter % n taken
once, for pairs with offset < n and reporter + offset < 2^32, and
((reporter + cur) mod 2^32) % n at every hop for the others; Rule 8 is
min(ttl, levels, ceil(log2(n - offset))) where offset + 2^l cannot wrap,
else counted level by level on the wrapped sums.  The float steps are
``tree_math``'s own torch operations, so any difference is the schedule's.
kTile is read from the CUDA source.  The kernel is held bit-equal to the
plain version on the card (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.edra_tree.ref import (_h2, _i32, _mix, _u01, _u32,
                                               f32, phase_key, popcount32,
                                               tree_math)

torch.set_num_threads(1)

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "edra_tree.cu").read_text()
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", CU).group(1))
TILE = THREADS if "constexpr int kTile = kThreads;" in CU else int(
    re.search(r"constexpr int kTile = (\d+);", CU).group(1))
M32 = 0xFFFFFFFF


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bits of int64 values in [0, 2^32): 32 - clz."""
    out = torch.zeros_like(v)
    for b in range(32):
        out = torch.where((v >> b) != 0, b + 1, out)
    return out


def tile_order(hops: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """src[slot]: the pair each slot of the sorted tiles walks."""
    p = hops.numel()
    src = torch.empty(p, dtype=torch.int64)
    for base in range(0, p, tile):
        h = hops[base:base + tile]
        counts = torch.bincount(h, minlength=33)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(h)
        for b in torch.unique(h):
            where = (h == b).nonzero().flatten()
            rank[where] = torch.arange(where.numel())
        src[base + start[h] + rank] = base + torch.arange(h.numel())
    return src


def k4_twin(offset, n, reporter, t_detect, event_key, *, levels, theta,
            delta_avg, seed=0, fill_rate=0.0, e_cap=2.0, tile=TILE):
    """``tree_math``'s contract, by the kernel's schedule.  Also returns
    how many pairs took the one-modulo sender."""
    off, nn = _u32(offset), _u32(n)
    rep, key = _u32(reporter), _u32(event_key)
    mask = (1 << levels) - 1
    hops = popcount32(off & mask).to(torch.int64)
    src = tile_order(hops, tile)
    off, nn, rep, key = off[src], nn[src], rep[src], key[src]
    t = t_detect.to(torch.float32)[src]

    s = (nn - 1) & M32
    for sh in (1, 2, 4, 8, 16):
        s = s | (s >> sh)
    ttl = torch.where(off == 0, popcount32(s),
                      popcount32(((off & ((0 - off) & M32)) - 1) & M32))

    one_mod = (off < nn) & (rep + off <= M32)
    gap = torch.where(one_mod, nn - rep % nn, 0)
    pkey = torch.full_like(off, phase_key(seed))
    theta_f, inv_theta = f32(theta), f32(1.0 / theta) if theta > 0 else 0.0
    e_buf, e_cap_m1 = f32(fill_rate * theta), f32(e_cap - 1.0)
    inv_fill = f32(1.0 / fill_rate) if fill_rate > 0 else 0.0
    delta = f32(delta_avg)
    rem, cur = off & mask, torch.zeros_like(off)
    while bool((rem != 0).any()):
        live = rem != 0
        top = torch.zeros_like(rem)
        for b in range(32):
            top = torch.where(((rem >> b) & 1) != 0, b, top)
        bit = torch.where(live, 1 << top, 0)
        rem = rem ^ bit
        sender = torch.where(
            one_mod, torch.where(cur >= gap, cur - gap, cur + (nn - gap)),
            ((rep + cur) & M32) % nn)
        nxt = cur | bit
        h = _h2(key, nxt)
        if theta > 0.0:
            ph = _u01(_h2(pkey, sender)) * theta_f
            flush = ph + torch.ceil((t - ph) * inv_theta + f32(1e-5)) * theta_f
            if fill_rate > 0.0:
                u = torch.clamp(1.0 - (flush - t) * inv_theta, 0.0, 1.0)
                mean_b = u * e_buf
                z = (_u01(_mix(h ^ 0xB5297A4D)) + _u01(_mix(h ^ 0x68E31DA4))
                     + _u01(_mix(h ^ 0x1B56C4E9)) - 1.5) * 2.0
                buffered = mean_b + torch.sqrt(mean_b) * z
                need = torch.clamp(e_cap_m1 - buffered, min=0.0)
                flush = torch.minimum(flush, t + need * inv_fill)
        else:
            flush = t
        dly = -torch.log(_u01(h)) * delta
        t = torch.where(live, flush + dly, t)
        cur = torch.where(live, nxt, cur)

    lmax = torch.clamp(ttl.to(torch.int64), max=levels)
    closed = (lmax == 0) | (off + (1 << torch.clamp(lmax - 1, min=0))
                            <= M32)
    sends = torch.where(off < nn, torch.minimum(
        lmax, _bit_length((nn - off - 1).clamp(min=0))), 0)
    counted = torch.zeros_like(lmax)
    for l in range(levels):
        counted += (l < lmax) & (((off + (1 << l)) & M32) < nn)
    sends = torch.where(closed, sends, counted).to(torch.int32)

    outs = (t, ttl.to(torch.int32), popcount32(off),
            _i32(off & ((off - 1) & M32)), sends)
    back = []
    for o in outs:                      # each result to its pair's place
        dst = torch.empty_like(o)
        dst[src] = o
        back.append(dst)
    return tuple(back), int(one_mod.sum())


VARIANTS = [dict(theta=0.0), dict(theta=5.4947),
            dict(theta=5.4947, fill_rate=172.8, e_cap=7.0)]


def _pairs(words, t):
    """(offset, n, reporter, event_key) uint32 words and detection times
    -> tree_math's five (P,) inputs."""
    off, n, rep, key = (torch.from_numpy(np.asarray(w, np.uint64)
                                         .astype(np.uint32).view(np.int32))
                        for w in words)
    return off, n, rep, torch.from_numpy(np.asarray(t, np.float32)), key


def _random(p, n, seed):
    rng = np.random.default_rng(seed)
    ring = rng.integers(n - 400, n + 400, p, dtype=np.uint64)
    words = (rng.integers(0, ring), ring, rng.integers(0, ring),
             rng.integers(0, 2**32, p, dtype=np.uint64))
    return _pairs(words, rng.uniform(0, 2100, p))


def _assert_bit_equal(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("variant", range(3))
@pytest.mark.parametrize("p", [1, TILE - 1, TILE + 44, 3000])
def test_twin_equals_tree_math(variant, p):
    """Random pairs on rings of 10^6 +- 400, P = 1, a tile short of one,
    past a tile and not a multiple of it: bit-equal, all in the
    one-modulo domain."""
    args = _random(p, 10**6, seed=p + variant)
    kw = dict(levels=20, delta_avg=7e-5, seed=3, **VARIANTS[variant])
    got, one_mod = k4_twin(*args, **kw)
    _assert_bit_equal(got, tree_math(*args, **kw))
    assert one_mod == p


@pytest.mark.parametrize("variant", range(3))
def test_the_edges_of_the_one_modulo_domain(variant):
    """off = n - 1 and rep = n - 1; rep + off = 2^32 - 1 (inside the
    domain) and 2^32 (outside: the modulo at every hop); off >= n; n = 1;
    rep + cur = n at a hop (the sender wraps to 0);
    and rings of 2^32 - 5 whose rep + cur wraps: bit-equal either way,
    and both senders are taken."""
    big = 2**32 - 5
    rng = np.random.default_rng(variant)
    rows = [  # (offset, n, reporter)
        (10**6 - 1, 10**6, 10**6 - 1), (0, 10**6, 10**6 - 1),
        (10**6 - 1, 10**6, 0), (2**31, big, 2**31 - 1),
        (2**31, big, 2**31), (2**31 + 5, big, 2**31 - 1),
        (big - 1, big, big - 1), (big - 1, big, 4), (7, 5, 3), (0, 1, 0),
        (2**20, 2**20, 9),
        (2**19 + 5, 10**6, 10**6 - 2**19)]   # rep + cur reaches n exactly
    wrap = np.column_stack([rng.integers(big - 2**20, big, 64, np.uint64),
                            np.full(64, big, np.uint64),
                            rng.integers(big - 2**16, big, 64, np.uint64)])
    words = np.concatenate([np.array(rows, np.uint64), wrap])
    p = len(words)
    args = _pairs((words[:, 0], words[:, 1], words[:, 2],
                   rng.integers(0, 2**32, p, dtype=np.uint64)),
                  rng.uniform(0, 2100, p))
    kw = dict(levels=32, delta_avg=7e-5, seed=2**31 + 3, **VARIANTS[variant])
    got, one_mod = k4_twin(*args, **kw)
    _assert_bit_equal(got, tree_math(*args, **kw))
    assert 0 < one_mod < p


@pytest.mark.parametrize("levels", [1, 10, 20, 31, 32])
def test_rule8_in_closed_form(levels):
    """The closed form of the Rule-8 fan-out equals the count level by
    level on the wrapped sums, off the ring's range too (off >= n)."""
    rng = np.random.default_rng(levels)
    p = 4096
    n = rng.integers(1, 2**32, p, dtype=np.uint64)
    off = np.where(rng.random(p) < 0.8, rng.integers(0, n),
                   rng.integers(0, 2**32, p, dtype=np.uint64))
    words = (off, n, rng.integers(0, 2**32, p, dtype=np.uint64),
             rng.integers(0, 2**32, p, dtype=np.uint64))
    args = _pairs(words, rng.uniform(0, 50, p))
    kw = dict(levels=levels, theta=0.0, delta_avg=7e-5)
    got, _ = k4_twin(*args, **kw)
    _assert_bit_equal(got, tree_math(*args, **kw))


def test_the_tile_sort_groups_pairs_by_hops():
    """Within a tile the walked order is by hops, and every pair is
    walked once: the slots are a permutation of the tile."""
    rng = np.random.default_rng(5)
    hops = torch.from_numpy(rng.integers(0, 21, 3 * TILE + 17))
    src = tile_order(hops)
    assert torch.equal(torch.sort(src).values, torch.arange(hops.numel()))
    for base in range(0, hops.numel(), TILE):
        walked = hops[src[base:base + TILE]]
        assert bool((walked[1:] >= walked[:-1]).all())
        assert bool((src[base:base + TILE] >= base).all())
        assert bool((src[base:base + TILE] < base + TILE).all())

