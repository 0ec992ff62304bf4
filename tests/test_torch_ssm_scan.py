"""K6's plain version (``repro_torch.kernels.ssm_scan``) against repro's
selective scan: the Pallas kernel in interpret mode, its jnp oracle
``ssm_scan_ref``, and the model layer's chunked scan ``_scan_chunks_m1``,
at the shapes of ``tests/test_kernels.py``'s sweep, with and without an
initial state, within repro's 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels.ssm_scan.ops import ssm_scan as j_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_ssm_scan_ref
from repro.models.ssm import _scan_chunks_m1
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

ATOL = 1e-4
SHAPES = [(2, 64, 256, 16), (1, 128, 512, 8), (3, 32, 256, 4)]


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
        "D": np.ones((din,), np.float32),
        "h0": (rng.standard_normal((bb, din, n)) * 0.1).astype(np.float32),
    }


def _repro(oracle, a, h0):
    args = [jnp.asarray(a[k]) for k in ("x", "dt", "B", "C", "A", "D")]
    h = jnp.asarray(h0) if h0 is not None else None
    if oracle == "pallas":
        return j_ssm_scan(*args, h, interpret=True)
    if oracle == "ref":
        return j_ssm_scan_ref(*args, h)
    return _scan_chunks_m1(*args, j_smoke("falcon-mamba-7b"), h)


@pytest.mark.parametrize("oracle", ["pallas", "ref", "model_layer"])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("bb,l,din,n", SHAPES)
def test_plain_scan_matches_repro(oracle, with_h0, bb, l, din, n):
    a = _inputs(bb, l, din, n, seed=bb * l + n)
    h0 = a["h0"] if with_h0 else None
    want_y, want_h = _repro(oracle, a, h0)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    before = ssm_ops.ssm_scan.launches
    y, h = ssm_ops.ssm_scan(t["x"], t["dt"], t["B"], t["C"], t["A"], t["D"],
                            t["h0"] if with_h0 else None)
    assert ssm_ops.ssm_scan.launches == before       # the CPU runs no kernel
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert y.shape == (bb, l, din) and h.shape == (bb, din, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL,
                               rtol=0)


def test_bf16_inputs_match_repro_ref():
    """The model's types: x, B, C, D in bf16, dt and A in f32.  h_last is
    f32 from the same f32 maths (1e-4); y is rounded once to bf16 in
    both, so they agree within 2 bf16 ulps at |y| < 1 (2^-7)."""
    a = _inputs(2, 48, 96, 16, seed=5)
    bf = {k: jnp.asarray(v, jnp.bfloat16) if k in ("x", "B", "C", "D")
          else jnp.asarray(v) for k, v in a.items()}
    want_y, want_h = j_ssm_scan_ref(*(bf[k] for k in ("x", "dt", "B", "C",
                                                      "A", "D", "h0")))
    t = {k: torch.from_numpy(np.array(v.astype(jnp.float32)))
         for k, v in bf.items()}
    for k in ("x", "B", "C", "D"):
        t[k] = t[k].to(torch.bfloat16)
    y, h = ssm_scan_ref(t["x"], t["dt"], t["B"], t["C"], t["A"], t["D"],
                        t["h0"])
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_y.astype(jnp.float32)),
                               atol=2 ** -7, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL,
                               rtol=0)


def test_any_length_is_one_sequential_scan():
    """The port scans any L: a scan of 20 positions equals a scan of the
    first 13 continued from its h_last over the other 7 (repro's chunked
    layer keeps only whole ssm_chunk multiples)."""
    a = _inputs(2, 20, 64, 8, seed=9)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    y, h = ssm_scan_ref(t["x"], t["dt"], t["B"], t["C"], t["A"], t["D"],
                        t["h0"])
    cut = {k: (v[:, :13], v[:, 13:]) for k, v in t.items()
           if k in ("x", "dt", "B", "C")}
    y1, h1 = ssm_scan_ref(*(cut[k][0] for k in ("x", "dt", "B", "C")),
                          t["A"], t["D"], t["h0"])
    y2, h2 = ssm_scan_ref(*(cut[k][1] for k in ("x", "dt", "B", "C")),
                          t["A"], t["D"], h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(h2, h, atol=1e-6, rtol=0)
