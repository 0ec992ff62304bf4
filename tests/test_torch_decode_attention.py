"""Port K3 plain version against repro's Pallas decode-attention kernel
(interpret mode) in float32, within 2e-5 absolute (f32 sums taken in
another order): ragged lengths including 1 and S, GQA group sizes 1, 2
and 8, several tile sizes.  A row of length 0 gives the mean of V over
all S positions in both (the mask value is -1e30, so every position
weighs exp(0) = 1), where repro's jnp oracle gives NaN."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref as jref
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

ATOL = 2e-5


def _inputs(b, h, hkv, hd, s, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def _pallas(q, k, v, length, bs):
    return np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(length),
        interpret=True, bs=bs))


def _plain(q, k, v, length):
    return decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, length)))


@pytest.mark.parametrize("b,h,hkv,hd,s,bs,lengths", [
    (3, 4, 2, 16, 64, 16, [1, 37, 64]),
    (2, 8, 1, 32, 48, 16, [1, 48]),          # g = 8, lengths 1 and S
    (4, 4, 4, 16, 32, 32, [5, 1, 32, 17]),   # g = 1, one tile
    (1, 16, 2, 128, 256, 128, [200]),        # qwen2.5-3b's head layout
])
def test_plain_matches_pallas(b, h, hkv, hd, s, bs, lengths):
    q, k, v, length = _inputs(b, h, hkv, hd, s, lengths)
    want = _pallas(q, k, v, length, bs)
    got = _plain(q, k, v, length)
    assert got.dtype == torch.float32 and got.shape == (b, h, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    before = ops.decode_attention.launches
    got = ops.decode_attention(*(torch.from_numpy(a)
                                 for a in (q, k, v, length)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert ops.decode_attention.launches == before   # CPU: no kernel


def test_length_zero_is_mean_of_v_like_the_pallas_kernel():
    q, k, v, length = _inputs(2, 4, 2, 16, 32, [0, 9], seed=3)
    want = _pallas(q, k, v, length, 16)
    got = _plain(q, k, v, length).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    mean_v = v[0].mean(axis=0)                       # (Hkv, hd)
    np.testing.assert_allclose(got[0].reshape(2, 2, 16),
                               np.repeat(mean_v[:, None], 2, axis=1),
                               atol=ATOL, rtol=0)
    # repro's jnp oracle masks with -inf instead: NaN on that row
    assert np.isnan(np.asarray(jref(*(jnp.asarray(a)
                                      for a in (q, k, v, length))))[0]).all()


def test_plain_keeps_the_working_dtype():
    q, k, v, length = _inputs(2, 4, 2, 16, 32, [3, 32], seed=5)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    out = decode_attention_ref(*args, torch.from_numpy(length))
    assert out.dtype == torch.bfloat16
    ref = decode_attention_ref(*(a.float() for a in args),
                               torch.from_numpy(length))
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=1e-2)
