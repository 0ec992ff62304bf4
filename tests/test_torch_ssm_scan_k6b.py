"""K6b's schedule (``csrc/ssm_scan_bwd.cu::ssm_scan_bwd_kernel``) as a torch
twin, held against the port's plain backward ``ssm_scan_bwd_ref``; the
forward's tile start states and ``SsmScanFn``'s use of them; and the plain
backward against ``jax.vjp`` of repro's scan oracle, on the CPU.

The twin repeats the kernel's steps for every channel at once: the
sequence in tiles of kSegs * kItems positions, the tail past L padded with
the identity (dt = 0, x = 0, dy = 0: decay 1, input 0).  Each tile starts
from the state the forward's plain scan had at its first position
(``ssm_scan_ref(..., state_tile=)``, what K6 writes for the kernel), and
the tiles are walked in reverse: the segment's decays once, each segment
folded to (product of decays, h from 0; the first from the tile's start
state), the pairs joined by the inclusive scan in the kernel's steps
(shifts by 1, 2, 4, ...), the segment walked again for h_t (h_{t-1} and
a_t kept a position); then the adjoint q_t = a_t (C_t dy_t + q_{t+1})
folded a segment from q = 0, the last segment from the carry (dh_last into
the last tile), the pairs joined by the suffix scan (shifts down by 1, 2,
4, ...), each segment walked back from the q of the segment after it, and
the gradients taken a position: sum_n g B and sum_n A g a h_{t-1} over the
states (dx and ddt from them at the tile's end), dA over the positions;
dB and dC over the channels in the kernel's order: a warp's four channels
as the butterfly pairs them, the block's eight warps in order, the
cluster's eight blocks in rank order (channels past Din are a padding
block's zeros), then the clusters in order; dh0 is the first segment's q
after the first tile.  kItems, kSegs, kChannels and kCluster are read from
the CUDA source; the twin also runs at other segment lengths and counts,
so the two scans are held at 2 to 16 segments.  The kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``).
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
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
CU = (CSRC / "ssm_scan_bwd.cu").read_text()
FWD_CU = (CSRC / "ssm_scan.cu").read_text()


def _const(name: str, text: str = CU) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


ITEMS, SEGS, CHANNELS = _const("kItems"), _const("kSegs"), _const("kChannels")
CLUSTER = _const("kCluster")
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


def _channel_sum(v: torch.Tensor) -> torch.Tensor:
    """(Bb, T, Din, N) per channel -> (Bb, T, N) summed over the channels
    in the kernel's order: channels past Din are zeros of a padding block;
    a warp's four channels (v0 + v1) + (v2 + v3), the block's warps in
    order, the cluster's blocks in rank order, then the clusters."""
    bb, t, din, n = v.shape
    per = CHANNELS * CLUSTER
    v = torch.cat([v, v.new_zeros((bb, t, -din % per, n))], dim=2)
    v = v.reshape(bb, t, -1, CLUSTER, CHANNELS // 4, 4, n)
    quad = (v[..., 0, :] + v[..., 1, :]) + (v[..., 2, :] + v[..., 3, :])
    block = torch.zeros_like(quad[..., 0, :])
    for w in range(CHANNELS // 4):
        block = block + quad[..., w, :]
    cluster = torch.zeros_like(block[..., 0, :])
    for r in range(CLUSTER):
        cluster = cluster + block[..., r, :]
    out = torch.zeros_like(cluster[:, :, 0])
    for k in range(cluster.shape[2]):
        out = out + cluster[:, :, k]
    return out


def k6b_twin(x, dt, B, C, A, D, h0, dy, dh, items=ITEMS, segs=SEGS):
    """f32 tensors as ``ssm_scan_bwd_ref``'s -> (dx, ddt, dB, dC, dA, dD,
    dh0), by the kernel's schedule."""
    bb, l, din = x.shape
    n = A.shape[1]
    tile = items * segs
    starts = ssm_scan_ref(x, dt, B, C, A, D, h0, state_tile=tile)[2]
    pad = -l % tile

    def padded(t):
        return torch.cat([t, t.new_zeros((bb, pad, t.shape[2]))], dim=1)
    x, dt, B, C, dy = (padded(t) for t in (x, dt, B, C, dy))
    tiles = x.shape[1] // tile
    a2 = A * LOG2E                                        # (Din, N)

    def cut(t, k):                                        # (Bb, segs, items, .)
        return t[:, k * tile:(k + 1) * tile].reshape(bb, segs, items, -1)

    q_carry = torch.zeros((bb, din, n)) if dh is None else dh
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    gb_all = torch.zeros((bb, x.shape[1], din, n))
    gc_all = torch.zeros((bb, x.shape[1], din, n))
    dA = torch.zeros((din, n))
    for k in range(tiles - 1, -1, -1):
        dtt, xt, bt, ct, dyt = (cut(t, k) for t in (dt, x, B, C, dy))
        carry = starts[:, k].transpose(1, 2)              # (Bb, Din, N)
        da = torch.exp2(dtt[..., None] * a2)              # once a position
        u = (dtt * xt)[..., None] * bt[:, :, :, None, :]
        P = torch.exp2(a2 * dtt.sum(2)[..., None])        # once a segment
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
        h = torch.cat([carry[:, None], H[:, :-1]], dim=1)
        hp, hn = [], []
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
        s1 = torch.zeros((bb, segs, items, din))          # sum_n g B
        s2 = torch.zeros((bb, segs, items, din))          # sum_n A g a h
        gb = torch.zeros((bb, segs, items, din, n))
        gc = torch.zeros((bb, segs, items, din, n))
        for i in range(items - 1, -1, -1):
            g = v[:, :, i] + q
            w = g * (da[:, :, i] * hp[i])
            s1[:, :, i] = (g * bt[:, :, i, None, :]).sum(-1)
            s2[:, :, i] = (A * w).sum(-1)
            dA += (dtt[:, :, i, :, None] * w).sum((0, 1))
            gb[:, :, i] = g * (dtt * xt)[:, :, i, :, None]
            gc[:, :, i] = dyt[:, :, i, :, None] * hn[i]
            q = da[:, :, i] * g
        sl = slice(k * tile, (k + 1) * tile)
        dx[:, sl] = (dtt * s1 + D * dyt).reshape(bb, tile, din)
        ddt[:, sl] = (xt * s1 + s2).reshape(bb, tile, din)
        gb_all[:, sl] = gb.reshape(bb, tile, din, n)
        gc_all[:, sl] = gc.reshape(bb, tile, din, n)
    dB, dC = _channel_sum(gb_all), _channel_sum(gc_all)
    dD = (dy[:, :l] * x[:, :l]).sum((0, 1))
    return (dx[:, :l], ddt[:, :l], dB[:, :l], dC[:, :l], dA, dD,
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
    """``ssm_scan_cuda`` sizes the tile states, and ``ssm_scan_bwd_cuda``
    its scratch, with the sources' kTile, kChannels and kCluster: K6's and
    K6b's tiles are one (the launcher refuses a smaller scratch)."""
    tile = ITEMS * SEGS
    assert ssm_kernel.STATE_TILE == tile
    assert _const("kItems", FWD_CU) * _const("kSegs", FWD_CU) == tile
    assert ssm_kernel.BWD_CHANNELS == CHANNELS
    assert ssm_kernel.BWD_CLUSTER == CLUSTER
    assert "scratch_len < scratch_floats(Bb, L, Din, N)" in CU
    assert "2LL * clusters_of(Din) * L * N" in CU


@pytest.mark.parametrize("l,tile", [(1, 128), (300, 128), (256, 128),
                                    (90, 8)])
def test_plain_scan_tile_states_are_the_prefix_states(l, tile):
    """``ssm_scan_ref(..., state_tile=)``: the state at each tile's first
    position, h0 first, is h_last of the scan over the positions before
    it, bit for bit; y and h_last are those of the call without."""
    a = _inputs(2, l, 6, 5, seed=l)
    args = (a["x"], a["dt"], a["B"], a["C"], a["A"], a["D"], a["h0"])
    y, h, states = ssm_scan_ref(*args, state_tile=tile)
    y0, h_0 = ssm_scan_ref(*args)
    assert torch.equal(y, y0) and torch.equal(h, h_0)
    assert states.shape == (2, -(-l // tile), 5, 6)
    assert torch.equal(states[:, 0], a["h0"].transpose(1, 2))
    for k in range(1, states.shape[1]):
        cut = [t[:, :k * tile] for t in args[:4]]
        want = ssm_scan_ref(*cut, a["A"], a["D"], a["h0"])[1]
        assert torch.equal(states[:, k], want.transpose(1, 2)), k


def test_scan_fn_asks_for_tile_states_only_under_grad(monkeypatch):
    """``SsmScanFn`` asks the forward for the tile start states only when
    an input needs a gradient, and saves them (the plain scan's own on the
    CPU); y, h_last and the gradients are those without them."""
    a = _inputs(2, 300, 6, 4, seed=3)
    asked = []
    plain = ssm_ops.ssm_scan_ref

    def spy(*args):
        asked.append(args[7])                # state_tile
        return plain(*args)
    monkeypatch.setattr(ssm_ops, "ssm_scan_ref", spy)
    args = (a["x"], a["dt"], a["B"], a["C"], a["A"], a["D"], a["h0"])
    with torch.no_grad():
        y0, h0 = ssm_ops.ssm_scan(*args)
    y1, h1 = ssm_ops.ssm_scan(*args)          # grad on, no input needs one
    leaves = [t.clone().requires_grad_() for t in args]
    y2, h2 = ssm_ops.ssm_scan(*leaves)
    assert asked == [None, None, ssm_kernel.STATE_TILE]
    assert y1.grad_fn is None
    for u, v in ((y0, y1), (y0, y2), (h0, h1), (h0, h2)):
        assert torch.equal(u, v)
    saved = y2.grad_fn.saved_tensors
    assert torch.equal(saved[7], plain(*args,
                                       state_tile=ssm_kernel.STATE_TILE)[2])
    got = torch.autograd.grad((y2 * a["dy"]).sum() + (h2 * a["dh"]).sum(),
                              leaves)
    want = ssm_scan_bwd_ref(*args, a["dy"], a["dh"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


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
