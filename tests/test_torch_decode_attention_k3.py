"""K3's tensor-core route (``csrc/decode_attention_tc.cu``) on the CPU: a
Python twin of its chunk plan and a recipe of its arithmetic.

The plan: block (chunk, kv head, row) owns positions [c C, (c + 1) C) of
the row's own valid range (all S positions for a row of length 0), its 4
warps take the 16-position tiles w, w + 4, ... of the chunk, blocks past
the range exit, a row with one chunk writes its output in that block, and
otherwise the last block of the (row, kv head) to arrive merges the
partials and sets the counter back to 0.  The warp and tile sizes are read
from the CUDA source and C from the wrapper's ``chunk_positions``.

The recipe: scores from 16-bit q and K summed in f32 (products of two
16-bit values are exact in f32), in log2 units, positions past the
length at -1e30 and past the chunk at -inf, an online softmax over each
warp's tiles, p split into p_hi = T(p) and p_lo = T(p - p_hi) for p . v,
then the 4 warps' merge and the chunks' merge.  It is held against
``repro``'s Pallas kernel in interpret mode and against the port's plain
version.  The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``).
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

torch.set_num_threads(1)

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "decode_attention_tc.cu").read_text()
WARPS = int(re.search(r"constexpr int kWarps = (\d+);", CU).group(1))
ROWS = int(re.search(r"constexpr int kRows = (\d+);", CU).group(1))
NEG = -1e30
LOG2E = 1.4426950408889634
BF16_ATOL = 1.6e-2


def plan_twin(lengths, s, hkv, chunk, rng):
    """One call's blocks in a random order of arrival.  Returns, per
    (row, kv head), how often each position was covered and which blocks
    wrote the output, and the counters after the call."""
    b = len(lengths)
    n_chunks = -(-s // chunk)
    cover = np.zeros((b, hkv, s), np.int64)
    writers = {(r, h): [] for r in range(b) for h in range(hkv)}
    counters = np.zeros(b * hkv, np.int64)
    blocks = [(c, h, r) for r in range(b) for h in range(hkv)
              for c in range(n_chunks)]
    for i in rng.permutation(len(blocks)):
        c, h, r = blocks[i]
        eff = s if lengths[r] <= 0 else min(lengths[r], s)
        start = c * chunk
        if start >= eff:
            continue
        end = min(start + chunk, eff)
        n_live = -(-eff // chunk)
        for w in range(WARPS):
            for p0 in range(start + w * ROWS, end, WARPS * ROWS):
                pos = np.arange(p0, p0 + ROWS)
                cover[r, h, pos[pos < end]] += 1
        if n_live == 1:
            writers[r, h].append(c)
            continue
        prev = counters[r * hkv + h]
        counters[r * hkv + h] += 1
        if prev == n_live - 1:
            counters[r * hkv + h] = 0
            writers[r, h].append(c)
    return cover, writers, counters


LENGTHS = (0, 1, 31, 32, 33, -1, -2)      # -1: S - 1, -2: S


@pytest.mark.parametrize("s", [37, 2000, 2048])
@pytest.mark.parametrize("b", [1, 8, 16, 32])
def test_plan_covers_each_position_once_and_merges_once(b, s):
    rng = np.random.default_rng(b * s)
    hkv = 2
    lengths = rng.integers(0, s + 1, b)
    for i, n in enumerate(LENGTHS[:b]):
        lengths[i] = s - 1 if n == -1 else s if n == -2 else n
    chunk = dk.chunk_positions(b, hkv, s)
    assert chunk in dk.CHUNKS and chunk % (WARPS * ROWS) == 0
    counters = None
    for call in range(2):                 # the counters carry over
        cover, writers, counters = plan_twin(lengths, s, hkv, chunk, rng)
        assert not counters.any()
        for r, n in enumerate(lengths):
            eff = s if n <= 0 else min(n, s)
            want = np.zeros(s, np.int64)
            want[:eff] = 1
            for h in range(hkv):
                np.testing.assert_array_equal(cover[r, h], want)
                assert len(writers[r, h]) == 1


@pytest.mark.parametrize("chunk", [64, 128, 256, 512])
def test_plan_at_every_chunk(chunk):
    """Lengths around the chunk and tile edges, S not a multiple of 16."""
    s = 1000
    lengths = [0, 1, 15, 16, 17, chunk - 1, chunk, chunk + 1, 999, 1000]
    cover, writers, counters = plan_twin(lengths, s, 2, chunk,
                                         np.random.default_rng(chunk))
    assert not counters.any()
    for r, n in enumerate(lengths):
        eff = s if n <= 0 else n
        assert (cover[r, :, :eff] == 1).all() and not cover[r, :, eff:].any()
        assert all(len(writers[r, h]) == 1 for h in range(2))


def test_chunk_plan_grows_the_grid_with_the_work():
    blocks = {b: b * 2 * -(-2048 // dk.chunk_positions(b, 2, 2048))
              for b in (1, 8, 16, 32, 64)}
    assert all(blocks[b] >= blocks[a] for a, b in zip(blocks, list(blocks)[1:]))
    assert blocks[32] >= dk.TC_BLOCKS_TARGET
    assert dk.chunk_positions(1, 2, 2048) == min(dk.CHUNKS)


def test_route_picks_from_dtype_and_heads():
    assert dk.route(torch.bfloat16, 128, 8) == "tc"
    assert dk.route(torch.float16, 16, 16) == "tc"
    assert dk.route(torch.bfloat16, 48, 1) == "tc"
    assert dk.route(torch.float32, 128, 8) == "simt"
    assert dk.route(torch.bfloat16, 40, 8) == "simt"
    assert dk.route(torch.bfloat16, 256, 8) == "simt"
    assert dk.route(torch.bfloat16, 128, 17) == "simt"


def _merge(states):
    m = torch.stack([st[0] for st in states]).amax(dim=0)
    w = [torch.exp2(st[0] - m) for st in states]
    l = sum(st[1] * wi for st, wi in zip(states, w))
    acc = sum(st[2] * wi[:, None] for st, wi in zip(states, w))
    return m, l, acc


def k3_recipe(q, k, v, length, dtype, chunk, split=True):
    """The tensor-core route's arithmetic on the CPU; returns the f32
    output before its final rounding."""
    q, k, v = (torch.from_numpy(np.asarray(a, np.float32)).to(dtype).float()
               for a in (q, k, v))
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    pad = -(-s // ROWS) * ROWS - s
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale = LOG2E / math.sqrt(hd)
    out = torch.zeros((b, h, hd))
    for r in range(b):
        n = int(length[r])
        eff = s if n <= 0 else min(n, s)
        for kh in range(hkv):
            qg = q[r, kh * g:(kh + 1) * g]
            chunks = []
            for start in range(0, eff, chunk):
                end = min(start + chunk, eff)
                warps = []
                for w in range(WARPS):
                    m = torch.full((g,), NEG)
                    l = torch.zeros(g)
                    acc = torch.zeros((g, hd))
                    for p0 in range(start + w * ROWS, end, WARPS * ROWS):
                        kt = k[r, p0:p0 + ROWS, kh]
                        vt = v[r, p0:p0 + ROWS, kh]
                        pos = torch.arange(p0, p0 + ROWS)
                        sc = (qg @ kt.T) * scale
                        if n <= 0:
                            sc = torch.full_like(sc, NEG)
                        sc = torch.where(pos < end, sc, -math.inf)
                        m_new = torch.maximum(m, sc.amax(dim=1))
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(sc - m_new[:, None])
                        p_hi = p.to(dtype).float()
                        pv = p_hi @ vt
                        if split:
                            pv = pv + (p - p_hi).to(dtype).float() @ vt
                        l = l * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + pv
                        m = m_new
                    warps.append((m, l, acc))
                chunks.append(_merge(warps))
            _, l, acc = _merge(chunks)
            out[r, kh * g:(kh + 1) * g] = acc / l.clamp_min(1e-30)[:, None]
    return out


def _inputs(b, h, hkv, hd, s, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, s, hkv, hd)).astype(np.float32),
            np.asarray(lengths, np.int32))


# qwen2.5-3b's heads (16 / 2, hd 128) and its smoke() config's (4 / 2, hd
# 16); lengths 0, 1, across chunks and tiles, and S; S a multiple of the
# Pallas kernel's block
CASES = [(3, 16, 2, 128, 256, 128, [0, 1, 200]),
         (4, 4, 2, 16, 192, 64, [192, 65, 64, 17]),
         (2, 8, 1, 32, 160, 32, [159, 33])]


@pytest.mark.parametrize("b,h,hkv,hd,s,bs,lengths", CASES)
@pytest.mark.parametrize("chunk", [64, 128])
def test_recipe_matches_pallas_interpret(b, h, hkv, hd, s, bs, lengths,
                                         chunk):
    """In bf16, rounded to bf16 as the kernel's output is, within 1.6e-2
    of repro's Pallas kernel (interpret mode) on the same bf16 inputs."""
    q, k, v, length = _inputs(b, h, hkv, hd, s, lengths, seed=hd + s)
    want = decode_attention_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(length), interpret=True, bs=bs)
    got = k3_recipe(q, k, v, length, torch.bfloat16, chunk).to(torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,h,hkv,hd,s,bs,lengths", CASES)
def test_recipe_keeps_p_at_f32(dtype, b, h, hkv, hd, s, bs, lengths):
    """Before the final rounding, the split-p recipe is within 1e-3 of
    max |out| of the plain version (p in f32) on the same 16-bit inputs;
    p rounded once to the 16-bit type is at least ten times further off."""
    q, k, v, length = _inputs(b, h, hkv, hd, s, lengths, seed=hd * s)
    want = decode_attention_ref(
        *(torch.from_numpy(a).to(dtype).float() for a in (q, k, v)),
        torch.from_numpy(length))
    scale = float(want.abs().max())
    split = float((k3_recipe(q, k, v, length, dtype, 64) - want).abs().max())
    rounded = float((k3_recipe(q, k, v, length, dtype, 64, split=False)
                     - want).abs().max())
    assert split <= 1e-3 * scale
    assert split * 10 <= rounded


def test_recipe_row_of_length_zero_is_the_mean_of_v():
    q, k, v, length = _inputs(1, 4, 2, 16, 100, [0], seed=9)
    got = k3_recipe(q, k, v, length, torch.bfloat16, 64)
    vb = torch.from_numpy(v).to(torch.bfloat16).float()
    mean_v = vb[0].mean(dim=0).repeat_interleave(2, dim=0)
    torch.testing.assert_close(got[0], mean_v, atol=1e-5, rtol=0)


def test_recipe_reads_the_source():
    """The recipe's constants and steps are the kernel's."""
    assert (WARPS, ROWS) == (4, 16)
    assert "constexpr float kNeg = -1e30f;" in CU
    assert "alpha[r] = exp2f(m_r[r] - m_new);" in CU
    assert "split2<T>(s[0][0], s[0][1], ph[0], pl[0]);" in CU
    assert "const int eff = all_masked ? S : min(len, S);" in CU
    assert "last_s = prev == static_cast<unsigned>(n_live - 1);" in CU
