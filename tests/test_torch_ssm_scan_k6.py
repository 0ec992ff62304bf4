"""K6's schedule (``csrc/ssm_scan.cu::ssm_scan_kernel``) as a torch twin,
held against the port's plain version and repro's Pallas kernel in
interpret mode on the CPU.

The twin repeats the kernel's steps for every channel at once: the
sequence in tiles of kSegs * kItems positions, the tail past L padded
with the identity pair (dt = 0, x = 0, B = 0: decay 1, input 0); A log2(e)
formed once per (channel, state) and every decay as 2^(dt * A log2 e);
per state, each segment of kItems positions folded into the pair
(product of decays, taken as 2^(A log2 e * the segment's dt sum), and h
from 0), the first segment from the state carried
from the previous tile (h0, or 0, for the first); the inclusive scan of
the pairs over the kSegs segments in the kernel's steps (shuffles up by
1, 2, 4, ...: (a2 a1, a2 b1 + b2)); each segment's start state the end of
the one before (the carry for the first), the last segment's end the
carry into the next tile; then each segment walked again from its start
state with its decays, y = D x + sum over states of C h in the kernel's
order.  kItems and kSegs are read from the CUDA source; the twin also
runs at other values, so the scan is held at 2 to 16 segments.  The
kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.kernel import ssm_scan_pallas
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

torch.set_num_threads(1)

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "ssm_scan.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


ITEMS, SEGS, CHANNELS = _const("kItems"), _const("kSegs"), _const("kChannels")
TILE = ITEMS * SEGS
ATOL = 1e-4
LOG2E = np.float32(1.4426950408889634)


def k6_twin(x, dt, B, C, A, D, h0=None, items=ITEMS, segs=SEGS):
    """f32 tensors x, dt (Bb, L, Din), B, C (Bb, L, N), A (Din, N), D
    (Din,), h0 (Bb, Din, N) or None -> (y (Bb, L, Din), h_last)."""
    bb, l, din = x.shape
    n = A.shape[1]
    tile = items * segs
    pad = -l % tile

    def padded(t):
        return torch.cat([t, t.new_zeros((bb, pad, t.shape[2]))], dim=1)
    x, dt, B, C = (padded(t) for t in (x, dt, B, C))
    a2 = A * torch.tensor(LOG2E)                            # (Din, N)
    carry = torch.zeros((bb, din, n)) if h0 is None else h0.clone()
    ys = []
    for t0 in range(0, l + pad, tile):
        # (Bb, segs, items, Din) per position; (.., N) per state
        dtv = dt[:, t0:t0 + tile].reshape(bb, segs, items, din)
        xv = x[:, t0:t0 + tile].reshape(bb, segs, items, din)
        bv = B[:, t0:t0 + tile].reshape(bb, segs, items, n)
        cv = C[:, t0:t0 + tile].reshape(bb, segs, items, n)
        dtx = dtv * xv
        da = torch.exp2(dtv[..., None] * a2)                # (Bb,S,I,Din,N)
        inp = dtx[..., None] * bv[:, :, :, None, :]
        # the product of a segment's decays: one exponential of its dt sum
        P = torch.exp2(dtv.sum(dim=2)[..., None] * a2)      # (Bb,S,Din,N)
        H = torch.zeros((bb, segs, din, n))
        H[:, 0] = carry
        for i in range(items):
            H = da[:, :, i] * H + inp[:, :, i]
        d = 1
        while d < segs:                                     # shuffles up by d
            Pp = torch.cat([P[:, :d], P[:, :-d]], dim=1)
            Hp = torch.cat([H[:, :d], H[:, :-d]], dim=1)
            take = (torch.arange(segs) >= d)[None, :, None, None]
            H, P = torch.where(take, P * Hp + H, H), torch.where(take, P * Pp, P)
            d *= 2
        start = torch.cat([carry[:, None], H[:, :-1]], dim=1)
        carry = H[:, -1]
        h = start
        y = D * xv                                          # (Bb,S,I,Din)
        yn = torch.zeros_like(y)[..., None].repeat(1, 1, 1, 1, n)
        for i in range(items):
            h = da[:, :, i] * h + inp[:, :, i]
            yn[:, :, i] = cv[:, :, i, None, :] * h
        for s in range(n):                                  # the kernel's order
            y = y + yn[..., s]
        ys.append(y.reshape(bb, tile, din))
    return torch.cat(ys, dim=1)[:, :l], carry


def _inputs(bb, l, din, n, seed):
    """test_kernels.py's distributions, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {
        "x": (rng.standard_normal((bb, l, din)) * 0.1).astype(np.float32),
        "dt": (np.abs(rng.standard_normal((bb, l, din))) * 0.1
               ).astype(np.float32),
        "B": (rng.standard_normal((bb, l, n)) * 0.5).astype(np.float32),
        "C": (rng.standard_normal((bb, l, n)) * 0.5).astype(np.float32),
        "A": (-np.abs(rng.standard_normal((din, n))) - 0.1
              ).astype(np.float32),
        "D": rng.standard_normal(din).astype(np.float32),
        "h0": (rng.standard_normal((bb, din, n)) * 0.1).astype(np.float32),
    }


ORDER = ("x", "dt", "B", "C", "A", "D")


def test_the_schedule_reads_the_kernel_constants():
    """A block is kChannels channels of kSegs lanes each, a segment is
    read as float4s, and a channel's segments share one warp."""
    assert "constexpr int kThreads = kChannels * kSegs;" in CU
    assert CHANNELS * SEGS == 256
    assert 32 % SEGS == 0 and ITEMS % 4 == 0


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("din,n", [(40, 1), (37, 5), (64, 16), (33, 32)])
@pytest.mark.parametrize("l", [1, 7, TILE, TILE + 1, 3 * TILE])
def test_twin_matches_plain_and_repro(l, din, n, with_h0):
    """Lengths on and off the tile grid, Din ragged against the kernel's
    channel blocks, N from 1 to 32: the twin, the port's plain version and
    repro's Pallas kernel (interpret mode, one block of all channels)
    agree within repro's 1e-4 on y and h_last."""
    a = _inputs(2, l, din, n, seed=l * 100 + din + n)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    h0 = t["h0"] if with_h0 else None
    y, h = k6_twin(*(t[k] for k in ORDER), h0)
    wy, wh = ssm_scan_ref(*(t[k] for k in ORDER), h0)
    torch.testing.assert_close(y, wy, atol=ATOL, rtol=0)
    torch.testing.assert_close(h, wh, atol=ATOL, rtol=0)
    jh0 = jnp.asarray(a["h0"] if with_h0 else np.zeros_like(a["h0"]))
    ry, rh = ssm_scan_pallas(*(jnp.asarray(a[k]) for k in ORDER), jh0,
                             interpret=True, bd=din)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=ATOL, rtol=0)


@pytest.mark.parametrize("items,segs", [(4, 8), (16, 8), (8, 2), (8, 4),
                                        (4, 16)])
def test_the_scan_at_other_tiles(items, segs):
    """The segment scan is exact in structure: at other segment lengths
    and counts the twin still equals the plain version."""
    a = _inputs(1, 3 * items * segs + 5, 24, 16, seed=items * segs)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    y, h = k6_twin(*(t[k] for k in ORDER), t["h0"], items=items, segs=segs)
    wy, wh = ssm_scan_ref(*(t[k] for k in ORDER), t["h0"])
    torch.testing.assert_close(y, wy, atol=ATOL, rtol=0)
    torch.testing.assert_close(h, wh, atol=ATOL, rtol=0)


def test_the_carry_is_h_last():
    """The state carried out of a tile is the scan's h_last: the twin
    over the first tile, continued from its h_last over the rest (a
    ragged tail), equals the twin over the whole sequence."""
    a = _inputs(1, TILE + 3, 16, 4, seed=3)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    y, h = k6_twin(*(t[k] for k in ORDER), t["h0"])
    cut = {k: (t[k][:, :TILE], t[k][:, TILE:]) for k in ("x", "dt", "B", "C")}
    y1, h1 = k6_twin(*(cut[k][0] for k in ("x", "dt", "B", "C")), t["A"],
                     t["D"], t["h0"])
    y2, h2 = k6_twin(*(cut[k][1] for k in ("x", "dt", "B", "C")), t["A"],
                     t["D"], h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, atol=0, rtol=0)
    torch.testing.assert_close(h2, h, atol=0, rtol=0)
