"""K5's plain version (``repro_torch.kernels.flash_attention``) against
repro's flash attention: the Pallas kernel in interpret mode at the
shapes of ``tests/test_kernels.py``'s sweep (f32 within 2e-5, bf16
within 2e-2), and the exact-softmax oracle ``attention_ref`` at ragged
lengths the TPU kernel does not take.  The tensor-core route's recipe
(q k^T of 16-bit values, p split into two 16-bit parts for p . v),
emulated in torch, against the Pallas kernel and against f32 p.  v
narrower than q and k (MLA's prefill) against repro's jnp flash path.
Then the path K5 serves: a qwen2.5-3b smoke() whole-prompt admit
(``prefill_chunk=None``) on the port's Replica gives repro's tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import Model as JModel
from repro.models import layers as JL
from repro.serve import Replica as JReplica
from repro.serve import Request as JRequest
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import Model
from repro_torch.serve import Replica, Request

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)


def _qkv(b, sq, sk, h, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, hd)).astype(np.float32))


def _port(q, k, v, causal, dtype=torch.float32):
    t = [torch.from_numpy(np.array(a, np.float32)).to(dtype)
         for a in (q, k, v)]
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(*t, causal=causal)
    assert fa_ops.flash_attention.launches == before  # the CPU runs no kernel
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,causal,dtype", [
    (2, 128, 128, 4, 2, 128, True, "float32"),
    (1, 256, 256, 8, 8, 64, True, "float32"),
    (2, 128, 256, 8, 2, 128, False, "float32"),
    (1, 128, 128, 4, 1, 128, True, "bfloat16"),
    (1, 128, 128, 4, 4, 112, True, "float32"),     # zamba2's head dim, g 1
    (1, 128, 256, 4, 2, 112, False, "bfloat16"),
])
def test_plain_matches_pallas_interpret(b, sq, sk, h, hkv, hd, causal, dtype):
    q, k, v = _qkv(b, sq, sk, h, hkv, hd, seed=sq + sk + h)
    jd = jnp.dtype(dtype)
    want = flash_attention_pallas(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                  jnp.asarray(v, jd), causal=causal,
                                  interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(a, jd).astype(jnp.float32))
                   for a in (q, k, v))
        got = _port(q, k, v, causal, torch.bfloat16)
        tol = 2e-2
    else:
        got = _port(q, k, v, causal)
        tol = 2e-5
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,causal", [
    (1, 200, 200, 4, 2, 32, True),      # ragged: crosses a 128 chunk
    (2, 200, 200, 6, 3, 16, False),
    (1, 70, 200, 4, 1, 64, False),      # Sq != Sk, no mask
    (1, 1, 1, 2, 2, 16, True),
])
def test_plain_matches_exact_softmax_at_ragged_lengths(b, sq, sk, h, hkv, hd,
                                                       causal):
    q, k, v = _qkv(b, sq, sk, h, hkv, hd, seed=sq * sk)
    want = np.asarray(attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(_port(q, k, v, causal), want, atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("b,sq,sk,h,hkv,dqk,dv,causal", [
    (1, 200, 200, 4, 4, 24, 16, True),      # deepseek-v2 smoke()'s prefill
    (2, 70, 200, 4, 2, 24, 16, False),
    (1, 130, 130, 2, 2, 192, 128, True),    # the full config's widths
    (1, 64, 300, 2, 1, 192, 128, False),
])
def test_plain_at_a_narrower_v_matches_repros_flash(b, sq, sk, h, hkv, dqk,
                                                    dv, causal):
    """MLA's prefill attention: q and k at qk_nope + qk_rope columns, v at
    v_head_dim.  K5's plain version against repro's jnp flash attention
    (``repro.models.layers.flash_attention``, which takes a v head dim of
    its own; the Pallas kernel and ``attention_ref`` assume v's is q's),
    in f32 within 2e-5, scaled by 1/sqrt(dqk)."""
    q, k, _ = _qkv(b, sq, sk, h, hkv, dqk, seed=sq + dv)
    v = np.random.default_rng(sk + dv).standard_normal(
        (b, sk, hkv, dv)).astype(np.float32)
    want = np.asarray(JL.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         chunk=128))
    got = _port(q, k, v, causal)
    assert got.shape == (b, sq, h, dv) == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_causal_mask_is_top_left_aligned():
    """Sq < Sk: query i sees keys 0..i, as the TPU kernel's qpos >= kpos
    (repro's jnp oracle aligns bottom-right, tril(k=Sk-Sq))."""
    q, k, v = _qkv(1, 40, 100, 2, 1, 16, seed=3)
    got = _port(q, k, v, True)
    want = np.asarray(attention_ref(jnp.asarray(q), jnp.asarray(k[:, :40]),
                                    jnp.asarray(v[:, :40]), causal=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _tc_recipe(q, k, v, causal, dtype, split=True):
    """K5's tensor-core route (``csrc/flash_attention_tc.cu``) emulated on
    the CPU: q, k and v in the kernel's tiles (hd 112 runs on the hd-128
    tiles, columns 112-127 filled with zeros by the TMA), q k^T of 16-bit
    values summed in f32 (their products are exact in f32) and scaled by
    1/sqrt(hd), an online softmax over kv tiles of 64 in f32, p split into
    p_hi = dtype(p) and p_lo = dtype(p - p_hi) (or, with ``split=False``,
    rounded once to dtype), p_hi v + p_lo v summed in f32, l from the f32
    p.  The padded output columns must come out 0 (the kernel does not
    store them).  Returns the f32 output of the true hd columns before its
    final rounding."""
    hd = q.shape[-1]
    width = 128 if hd == 112 else hd
    q, k, v = (torch.nn.functional.pad(
        torch.from_numpy(np.asarray(a, np.float32)).to(dtype).float(),
        (0, width - hd)) for a in (q, k, v))
    b, sq, h, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, width)
    q_pos = torch.arange(sq)
    m = torch.full((b, hkv, h // hkv, sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, h // hkv, sq, width))
    for j0 in range(0, sk, 64):
        kj, vj = k[:, j0:j0 + 64], v[:, j0:j0 + 64]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kj) / np.sqrt(hd)
        if causal:
            k_pos = j0 + torch.arange(kj.shape[1])
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        p_hi = p.to(dtype).float()
        pv = torch.einsum("bkgqs,bskd->bkgqd", p_hi, vj)
        if split:
            p_lo = (p - p_hi).to(dtype).float()
            pv = pv + torch.einsum("bkgqs,bskd->bkgqd", p_lo, vj)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    assert not out[..., hd:].any()
    return out[..., :hd].permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


# qwen2.5-3b smoke()'s heads (4 / 2, hd 16), and the tensor-core route's
# head dims 64, 112 (zamba2's shared block, g 1, on zero-padded hd-128
# tiles) and 128 at small Sq / Sk (multiples of the Pallas kernel's
# 128-wide blocks)
TC_CASES = [(1, 128, 128, 4, 2, 16, True), (2, 128, 256, 4, 2, 64, False),
            (1, 256, 256, 4, 1, 128, True), (1, 256, 256, 4, 4, 112, True),
            (2, 128, 256, 4, 2, 112, False)]


@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,causal", TC_CASES)
def test_tensor_core_recipe_matches_pallas_interpret(b, sq, sk, h, hkv, hd,
                                                     causal):
    """The split-p recipe in bf16, rounded to bf16 as the kernel's output
    is, against repro's Pallas kernel in interpret mode within repro's
    bf16 tolerance 2e-2."""
    q, k, v = _qkv(b, sq, sk, h, hkv, hd, seed=sq + sk + hd)
    want = flash_attention_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
        interpret=True)
    got = _tc_recipe(q, k, v, causal, torch.bfloat16).to(torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,causal", TC_CASES)
def test_tensor_core_recipe_keeps_p_at_f32(dtype, b, sq, sk, h, hkv, hd,
                                           causal):
    """Before the final rounding, the split-p recipe is within 1e-3 of
    max |out| of the plain version, which keeps p in f32, on the same
    16-bit inputs; p rounded once to the 16-bit type is at least ten times
    further off."""
    q, k, v = _qkv(b, sq, sk, h, hkv, hd, seed=sq * sk + hd)
    want = fa_ops.flash_attention(
        *(torch.from_numpy(a).to(dtype).float() for a in (q, k, v)),
        causal=causal)
    scale = float(want.abs().max())
    split = float((_tc_recipe(q, k, v, causal, dtype) - want).abs().max())
    rounded = float((_tc_recipe(q, k, v, causal, dtype, split=False)
                     - want).abs().max())
    assert split <= 1e-3 * scale
    assert split * 10 <= rounded


@pytest.mark.parametrize("fused", [True, False])
def test_whole_prompt_admit_matches_repro(fused):
    """qwen2.5-3b smoke() in f32, prompts of 37-200 tokens admitted whole
    (prefill attention through K5's plain version), then decode rounds:
    the same first tokens and streams as repro's Replica, KV within
    1e-4."""
    from repro.runtime import Membership as JMembership
    from repro_torch.runtime import Membership
    jcfg = j_smoke("qwen2.5-3b").with_overrides(dtype="float32")
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    m = Model(cfg)
    j = JReplica(jm, slots=4, max_len=256, prefill_chunk=None)
    j.attach_params(jp)
    t = Replica(m, slots=4, max_len=256, prefill_chunk=None, device="cpu")
    t.attach_params(m.load(jax.device_get(jp), device="cpu"))
    jmem = JMembership(t_q=60.0, now=lambda: 0.0)
    mem = Membership(t_q=60.0, now=lambda: 0.0, device="cpu")
    for i in range(3):
        jmem.request_join(f"10.4.0.{i}", 7000 + i)
        mem.request_join(f"10.4.0.{i}", 7000 + i)
    rng = np.random.default_rng(21)
    for i, n in enumerate((200, 37, 129)):
        prompt = rng.integers(0, cfg.vocab, n, dtype=np.int32)
        assert t.admit(Request(f"w{i}", prompt)) \
            == j.admit(JRequest(f"w{i}", prompt))
    for _ in range(3):
        jr = jmem.ring_state.device_bucket_table() if fused else None
        tr = mem.ring_state.device_bucket_table() if fused else None
        assert t.decode_round(route=tr) == j.decode_round(route=jr)
        assert t.routed_owners == j.routed_owners
    for name in ("k", "v"):
        np.testing.assert_allclose(t.cache[name].numpy(),
                                   np.asarray(j.cache[name]), atol=1e-4,
                                   rtol=0)
