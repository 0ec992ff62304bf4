"""K6b's schedule (``csrc/ssm_scan_bwd.cu::ssm_scan_bwd_kernel``) as a torch
twin, held against the port's plain backward ``ssm_scan_bwd_ref``; and the
plain backward against ``jax.vjp`` of repro's scan oracle, on the CPU.

The twin repeats the kernel's steps for every channel at once: the
sequence in tiles of kSegs * kItems positions, the tail past L padded with
the identity (dt = 0, x = 0, dy = 0: decay 1, input 0).  Pass 1 walks the
tiles forward, each segment folded to (product of decays, h from 0; the
first from the carried state), the pairs joined by the inclusive scan in
the kernel's steps (shifts by 1, 2, 4, ...), and keeps each tile's start
state.  Pass 2 walks the tiles in reverse: the states again from the
tile's start state (h_{t-1} and a_t kept a position), then the adjoint
q_t = a_t (C_t dy_t + q_{t+1}) folded a segment from q = 0, the last
segment from the carry (dh_last into the last tile), the pairs joined by
the suffix scan (shifts down by 1, 2, 4, ...), each segment walked back
from the q of the segment after it, and the gradients taken a position:
dx and ddt summed over the states, dA over the positions, dB and dC over
the channels; dh0 is the first segment's q after the first tile.
kItems, kSegs and kChannels are read from the CUDA source; the twin also
runs at other values, so the two scans are held at 2 to 16 segments.  The
kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_ssm_scan_ref
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref

torch.set_num_threads(1)

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "ssm_scan_bwd.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


ITEMS, SEGS, CHANNELS = _const("kItems"), _const("kSegs"), _const("kChannels")
RTOL = 1e-5                     # of each gradient's max |g|: f32 sums
LOG2E = np.float32(1.4426950408889634)


def _shift(t: torch.Tensor, d: int) -> torch.Tensor:
    """Segment s takes segment s - d's value (d < 0: s + |d|); zeros where
    there is none."""
    out = torch.zeros_like(t)
    if d > 0:
        out[:, d:] = t[:, :-d]
    else:
        out[:, :d] = t[:, -d:]
    return out


def k6b_twin(x, dt, B, C, A, D, h0, dy, dh, items=ITEMS, segs=SEGS):
    """f32 tensors as ``ssm_scan_bwd_ref``'s -> (dx, ddt, dB, dC, dA, dD,
    dh0), by the kernel's schedule."""
    bb, l, din = x.shape
    n = A.shape[1]
    tile = items * segs
    pad = -l % tile

    def padded(t):
        return torch.cat([t, t.new_zeros((bb, pad, t.shape[2]))], dim=1)
    x, dt, B, C, dy = (padded(t) for t in (x, dt, B, C, dy))
    tiles = x.shape[1] // tile
    a2 = A * LOG2E                                        # (Din, N)

    def cut(t, k):                                        # (Bb, segs, items, .)
        return t[:, k * tile:(k + 1) * tile].reshape(bb, segs, items, -1)

    def states(k, carry):
        """The tile's decays, inputs, segment start states and product of
        decays: (Bb, segs, items, Din, N) and (Bb, segs, Din, N)."""
        dtt, xt, bt = cut(dt, k), cut(x, k), cut(B, k)
        da = torch.exp2(dtt[..., None] * a2)
        u = (dtt * xt)[..., None] * bt[:, :, :, None, :]
        P = torch.exp2(a2 * dtt.sum(2)[..., None])
        H = torch.zeros((bb, segs, din, n))
        H[:, 0] = carry
        for i in range(items):
            H = da[:, :, i] * H + u[:, :, i]
        Pc = P.clone()
        d = 1
        while d < segs:                                   # inclusive scan
            Hp, Pp = _shift(H, d), _shift(Pc, d)
            on = (torch.arange(segs) >= d)[None, :, None, None]
            H = torch.where(on, Pc * Hp + H, H)
            Pc = torch.where(on, Pc * Pp, Pc)
            d *= 2
        start = torch.cat([carry[:, None], H[:, :-1]], dim=1)
        return da, u, start, P, H[:, -1]

    h = torch.zeros((bb, din, n)) if h0 is None else h0
    starts = []
    for k in range(tiles):                                # pass 1
        starts.append(h)
        h = states(k, h)[4]
    q_carry = torch.zeros((bb, din, n)) if dh is None else dh
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dA = torch.zeros((din, n))
    for k in range(tiles - 1, -1, -1):                    # pass 2
        da, u, start, P, _ = states(k, starts[k])
        dtt, xt, bt, ct, dyt = (cut(t, k) for t in (dt, x, B, C, dy))
        hp, hn = [], []
        h = start
        for i in range(items):
            hp.append(h)
            h = da[:, :, i] * h + u[:, :, i]
            hn.append(h)
        v = ct[:, :, :, None, :] * dyt[..., None]         # C dy
        Q = torch.zeros((bb, segs, din, n))
        for i in range(items - 1, -1, -1):
            Q = da[:, :, i] * (v[:, :, i] + Q)
        Q[:, -1] = P[:, -1] * q_carry + Q[:, -1]
        Pc = P.clone()
        d = 1
        while d < segs:                                   # suffix scan
            Qn, Pn = _shift(Q, -d), _shift(Pc, -d)
            on = (torch.arange(segs) + d < segs)[None, :, None, None]
            Q = torch.where(on, Pc * Qn + Q, Q)
            Pc = torch.where(on, Pc * Pn, Pc)
            d *= 2
        q = torch.cat([Q[:, 1:], q_carry[:, None]], dim=1)
        q_carry = Q[:, 0]
        sl = slice(k * tile, (k + 1) * tile)
        gx = torch.zeros((bb, segs, items, din))
        gdt = torch.zeros((bb, segs, items, din))
        gb = torch.zeros((bb, segs, items, n))
        gc = torch.zeros((bb, segs, items, n))
        for i in range(items - 1, -1, -1):
            g = v[:, :, i] + q
            g_dt = g * dtt[:, :, i, :, None]
            ah = da[:, :, i] * hp[i]
            gx[:, :, i] = (g_dt * bt[:, :, i, None, :]).sum(-1)
            gdt[:, :, i] = (g * (xt[:, :, i, :, None] * bt[:, :, i, None, :]
                                 + A * ah)).sum(-1)
            dA += (g_dt * ah).sum((0, 1))
            gb[:, :, i] = (g_dt * xt[:, :, i, :, None]).sum(2)
            gc[:, :, i] = (dyt[:, :, i, :, None] * hn[i]).sum(2)
            q = da[:, :, i] * g
        dx[:, sl] = gx.reshape(bb, tile, din)
        ddt[:, sl] = gdt.reshape(bb, tile, din)
        dB[:, sl] = gb.reshape(bb, tile, n)
        dC[:, sl] = gc.reshape(bb, tile, n)
    dx = dx[:, :l] + D * dy[:, :l]
    dD = (dy[:, :l] * x[:, :l]).sum((0, 1))
    return (dx, ddt[:, :l], dB[:, :l], dC[:, :l], dA, dD,
            None if h0 is None else q_carry)


def _inputs(bb, l, din, n, seed):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    return dict(x=arr(bb, l, din, scale=0.5), dt=arr(bb, l, din, scale=0.3).abs(),
                B=arr(bb, l, n), C=arr(bb, l, n), A=-arr(din, n).abs() - 0.1,
                D=arr(din), h0=arr(bb, din, n, scale=0.5), dy=arr(bb, l, din),
                dh=arr(bb, din, n))


def _close(got, want, name):
    for g, w, nm in zip(got, want, ("dx", "ddt", "dB", "dC", "dA", "dD",
                                    "dh0")):
        assert (g is None) == (w is None), (name, nm)
        if w is None:
            continue
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= RTOL * scale, (name, nm)


@pytest.mark.parametrize("with_h0,with_dh", [(True, True), (False, False),
                                             (False, True)])
@pytest.mark.parametrize("bb,l,din,n", [
    (1, 1, 5, 3),               # one position: a tile of padding
    (2, 70, 12, 8),             # a tile and a ragged second
    (1, 3 * ITEMS * SEGS, 7, 4),  # whole tiles
])
def test_twin_matches_the_plain_backward(with_h0, with_dh, bb, l, din, n):
    a = _inputs(bb, l, din, n, seed=l + din)
    h0 = a["h0"] if with_h0 else None
    dh = a["dh"] if with_dh else None
    args = (a["x"], a["dt"], a["B"], a["C"], a["A"], a["D"], h0, a["dy"], dh)
    _close(k6b_twin(*args), ssm_scan_bwd_ref(*args), "kernel's schedule")


@pytest.mark.parametrize("items,segs", [(4, 2), (8, 4), (4, 16), (16, 8)])
def test_twin_at_other_segment_counts(items, segs):
    """The two scans hold at 2 to 16 segments and other segment lengths."""
    a = _inputs(2, 90, 6, 5, seed=items * segs)
    args = (a["x"], a["dt"], a["B"], a["C"], a["A"], a["D"], a["h0"],
            a["dy"], a["dh"])
    _close(k6b_twin(*args, items=items, segs=segs), ssm_scan_bwd_ref(*args),
           (items, segs))


def test_wrapper_sizes_the_kernels_scratch_by_its_tile():
    """``ssm_scan_bwd_cuda`` sizes the scratch with the source's kTile and
    kChannels (the launcher refuses a smaller one)."""
    assert ssm_kernel.BWD_TILE == ITEMS * SEGS
    assert ssm_kernel.BWD_CHANNELS == CHANNELS
    assert "scratch_len < scratch_floats(Bb, L, Din, N)" in CU


@pytest.mark.parametrize("with_h0", [True, False])
def test_plain_backward_matches_jax_vjp_of_repros_oracle(with_h0):
    """The port's plain backward against ``jax.vjp`` of repro's
    ``ssm_scan_ref`` (the jnp oracle of its Pallas scan), with a nonzero
    dh_last: each gradient within 1e-5 of its max |g|."""
    a = _inputs(2, 50, 16, 8, seed=7)
    names = ("x", "dt", "B", "C", "A", "D") + (("h0",) if with_h0 else ())
    primals = [jnp.asarray(a[k].numpy()) for k in names]

    def f(*ps):
        return j_ssm_scan_ref(*ps)
    _, vjp = jax.vjp(f, *primals)
    want = vjp((jnp.asarray(a["dy"].numpy()), jnp.asarray(a["dh"].numpy())))
    got = ssm_scan_bwd_ref(a["x"], a["dt"], a["B"], a["C"], a["A"], a["D"],
                           a["h0"] if with_h0 else None, a["dy"], a["dh"])
    for g, w, nm in zip(got, want, names):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= RTOL * scale, nm
