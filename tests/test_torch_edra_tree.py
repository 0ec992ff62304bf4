"""K4 parity: the port's ``edra_tree`` (its plain version on CPU tensors)
against ``repro``'s ``edra_tree`` (the Pallas kernel in interpret mode)
on ``tests/test_edra_tree.py``'s adversarial pair sets, in all three
variants (unbuffered 1h-Calot, buffered, Eq IV.4 early close).

Integer outputs must be equal.  Acknowledge times hold within
``rtol=3e-5, atol=1e-3``, ``repro``'s own kernel-vs-oracle tolerance:
torch's and XLA's float32 ``log`` differ in the last ulp, and a hop's
time carries it (observed gaps are a few ulps of a ~50 s time, < 1e-5).
The tree coordinates must also equal the port's ``core.edra``.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.edra_tree.ops import edra_tree as repro_edra_tree
from repro.kernels.edra_tree.ref import tree_math as repro_tree_math
from repro_torch.core import edra
from repro_torch.kernels.edra_tree import ops
from repro_torch.kernels.edra_tree.ref import tree_math

torch.set_num_threads(1)

NAMES = ("offset", "n", "reporter", "t_detect", "event_key")
VARIANTS = {"unbuffered": dict(theta=0.0),
            "buffered": dict(theta=7.5),
            "early_close": dict(theta=7.5, fill_rate=0.2, e_cap=4.0)}


def _levels(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def _pairs(n: int, seed: int):
    """``test_edra_tree._pairs``: the full ring when small, else
    boundaries + powers of two +- 1 + random fill."""
    rng = np.random.default_rng(seed)
    if n <= 1024:
        offs = np.arange(n, dtype=np.uint32)
    else:
        pow2 = 1 << np.arange(_levels(n), dtype=np.uint32)
        cand = np.concatenate([
            np.array([0, 1, n - 1], np.uint32), pow2, pow2 - 1,
            np.minimum(pow2 + 1, n - 1),
            rng.integers(0, n, 512).astype(np.uint32)])
        offs = np.unique(cand[cand < n])
    p = offs.size
    return {
        "offset": offs,
        "n": np.full(p, n, np.uint32),
        "reporter": rng.integers(0, n, p).astype(np.uint32),
        "t_detect": rng.uniform(0, 50, p).astype(np.float32),
        "event_key": rng.integers(0, 2**32, p, dtype=np.uint64
                                  ).astype(np.uint32),
    }


def _torch(args):
    return [torch.from_numpy(args[k].view(np.int32) if args[k].dtype
                             == np.uint32 else args[k]) for k in NAMES]


def _port(args, **kw):
    ack, ttl, depth, parent, sends = ops.edra_tree(*_torch(args), **kw)
    return (ack.numpy(), ttl.numpy(), depth.numpy(),
            parent.numpy().view(np.uint32), sends.numpy())


SIZES = [2, 3, 5, 48, 255, 256, 257, 1000, 1024, 12_345, 1_000_000]
LEVELS = _levels(max(SIZES))


@functools.lru_cache(maxsize=None)
def _repro_batch(variant: str):
    """Every size's pair set in one batch, through ``repro``'s kernel in
    interpret mode once per variant (per-pair ring sizes; ``levels``
    covers the largest ring, and higher levels than a ring needs change
    nothing: its offsets have no bit there and Rule 8 stops at n)."""
    parts = [_pairs(n, seed=n) for n in SIZES]
    args = {k: np.concatenate([a[k] for a in parts]) for k in NAMES}
    kw = dict(levels=LEVELS, delta_avg=0.02, seed=5, **VARIANTS[variant])
    want = repro_edra_tree(*(jnp.asarray(args[k]) for k in NAMES), **kw)
    bounds = np.cumsum([0] + [a["offset"].size for a in parts])
    return args, [np.asarray(x) for x in want], bounds, kw


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("n", SIZES)
def test_edra_tree_equals_repro(n, variant):
    all_args, all_want, bounds, kw = _repro_batch(variant)
    i = SIZES.index(n)
    seg = slice(bounds[i], bounds[i + 1])
    args = {k: all_args[k][seg] for k in NAMES}
    a_w, ttl_w, d_w, p_w, s_w = (w[seg] for w in all_want)
    a, ttl, d, par, s = _port(args, **dict(kw, levels=_levels(n)))
    np.testing.assert_array_equal(ttl, ttl_w)
    np.testing.assert_array_equal(d, d_w)
    np.testing.assert_array_equal(par, p_w)
    np.testing.assert_array_equal(s, s_w)
    np.testing.assert_allclose(a, a_w, rtol=3e-5, atol=1e-3)
    # tree coordinates == the port's numpy EDRA machinery
    offs64 = args["offset"].astype(np.uint64)
    np.testing.assert_array_equal(ttl, edra.ack_ttl(offs64, n))
    np.testing.assert_array_equal(d, edra.ack_depth(offs64))
    np.testing.assert_array_equal(par.astype(np.int64),
                                  edra.parent_offset(offs64))
    assert (a >= args["t_detect"] - 1e-3).all()
    if n <= 1024:
        # Theorem 1 (exactly-once): Rule-8 fan-outs over the full ring
        assert int(s.sum()) == n - 1


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_uint32_wraparound_equals_repro(variant):
    """n = 2^32 - 5, levels = 32, reporters near n: ``reporter + cur``
    and ``offset + 2^l`` wrap mod 2^32, and both packages must wrap
    alike (integers exact against ``repro``'s numpy ``tree_math``)."""
    n = 2**32 - 5
    rng = np.random.default_rng(11)
    p = 4096
    offs = np.concatenate([
        np.array([0, 1, n - 1, n - 2, 2**31, 2**31 - 1, 2**31 + 1], np.uint64),
        rng.integers(n - 2**20, n, p // 2, dtype=np.uint64),
        rng.integers(0, n, p // 2 - 7, dtype=np.uint64)]).astype(np.uint32)
    args = {
        "offset": offs,
        "n": np.full(p, n, np.uint32),
        "reporter": rng.integers(n - 2**16, n, p, dtype=np.uint64
                                 ).astype(np.uint32),
        "t_detect": rng.uniform(0, 50, p).astype(np.float32),
        "event_key": rng.integers(0, 2**32, p, dtype=np.uint64
                                  ).astype(np.uint32),
    }
    kw = dict(levels=32, delta_avg=0.02, seed=2**31 + 3, **VARIANTS[variant])
    want = repro_tree_math(np, *(args[k] for k in NAMES), **kw)
    got = _port(args, **kw)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0], want[0], rtol=3e-5, atol=1e-3)
    # the wrap is exercised: some Rule-8 targets pass 2^32 and wrap
    # below n, which an unwrapped sum would refuse
    wraps = (offs.astype(np.uint64)[:, None]
             + (1 << np.arange(32, dtype=np.uint64))[None, :]) >= 2**32
    assert wraps.any()


def test_ack_respects_tree_order():
    """Within one event, a child's ack is strictly after its parent's
    (``test_edra_tree.test_ack_respects_tree_order`` on the port)."""
    n = 512
    ones = torch.ones(n, dtype=torch.int32)
    offs = torch.arange(n, dtype=torch.int32)
    key = torch.full((n,), 0xABCD1234 - 2**32, dtype=torch.int32)  # u32 bits
    ack, ttl, depth, parent, _ = tree_math(
        offs, ones * n, ones * 17, torch.zeros(n), key,
        levels=_levels(n), theta=5.0, delta_avg=0.01, seed=1)
    assert (ack[1:] > ack[parent[1:].long()]).all()
    assert ack[0] == 0.0


def test_out_buffers_and_the_launch_count():
    """``out=`` writes slices of larger buffers; CPU calls run the plain
    version and never count as kernel launches."""
    args = _pairs(12_345, seed=3)
    kw = dict(levels=_levels(12_345), delta_avg=0.02, seed=5, theta=7.5,
              fill_rate=0.2, e_cap=4.0)
    want = ops.edra_tree(*_torch(args), **kw)
    p = want[0].numel()
    bufs = [torch.full((p + 10,), -7, dtype=w.dtype) for w in want]
    before = ops.edra_tree.launches
    got = ops.edra_tree(*_torch(args), out=[b[5:5 + p] for b in bufs], **kw)
    assert ops.edra_tree.launches == before
    for g, w, b in zip(got, want, bufs):
        assert torch.equal(g, w)
        assert (b[:5] == -7).all() and (b[5 + p:] == -7).all()


@pytest.mark.parametrize("n", [2, 5, 48, 257, 1000])
def test_edra_module_equals_repro(n):
    """The port's copy of ``core.edra``: the same tree, forwarding plan,
    Theorem-1 check and per-interval buffer flush as ``repro``'s."""
    from repro.core import edra as repro_edra

    got, want = edra.dissemination_tree(n), repro_edra.dissemination_tree(n)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert edra.acknowledged_exactly_once(n)
    for off in (0, 1, n // 3, n - 1):
        ttl = int(got["ttl"][off])
        assert edra.forward_targets(off, ttl, n) == \
            repro_edra.forward_targets(off, ttl, n)
    rho = int(got["ttl"][0])
    bufs = [edra.EventBuffer(rho), repro_edra.EventBuffer(rho)]
    for i in range(6):
        for buf, mod in zip(bufs, (edra, repro_edra)):
            ev = mod.Event(subject_id=i, kind="join", seq=i % 2)
            assert buf.acknowledge(ev, ttl=i % (rho + 1))
            assert not buf.acknowledge(ev, ttl=0)
    flushed = [{l: [e.subject_id for e in evs] for l, evs in b.flush().items()}
               for b in bufs]
    assert flushed[0] == flushed[1] and not len(bufs[0])
