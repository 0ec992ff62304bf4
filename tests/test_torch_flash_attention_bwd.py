"""K5b's plain version, ``flash_attention_bwd_ref`` (the flash backward from
the forward's o and lse), against torch.autograd through K5's plain
version and against ``jax.vjp`` of repro's jnp flash attention
(``repro.models.layers.flash_attention``, what repro's training
differentiates) in f32: GQA g 1, 2 and 4, causal and not, the Sq = Sk
that training uses, a non-causal Sq != Sk, and MLA's narrower v (also at
deepseek-v2's q . k 192 / v 128, the widths K5b's tensor cores take).  Then
``flash_attention_fwd_ref``'s lse, the wiring of ``FlashAttentionFn`` and
of ``layers.flash_attention`` on the CPU (no kernel counter moves), and
K5b's route function.  The on-card case is in ``test_torch_cuda.py``
(marked ``cuda``; that file imports no jax).

Tolerances: 2e-5 absolute on gradients of O(1) (two f32 algorithms of
the same sums in another order); the Function against the plain
functions it calls, exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref,
                                                     flash_attention_ref)
from repro_torch.models import layers as L

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

ATOL = 2e-5

CASES = [  # b, sq, sk, h, hkv, hd, hv, causal
    (2, 96, 96, 4, 4, 32, 32, True),        # g 1
    (1, 130, 130, 4, 2, 64, 64, True),      # g 2, a ragged last chunk
    (2, 64, 64, 8, 2, 16, 16, True),        # g 4
    (1, 80, 80, 8, 2, 32, 32, False),
    (1, 48, 144, 4, 1, 32, 32, False),      # Sq != Sk, no mask
    (1, 64, 64, 4, 4, 24, 16, True),        # MLA: v narrower than q . k
    (1, 40, 40, 2, 2, 192, 128, True),      # deepseek-v2's MLA widths
]


def _inputs(b, sq, sk, h, hkv, hd, hv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hv),
             (b, sq, h, hv))]


def _t(a, grad=False):
    return torch.from_numpy(a).requires_grad_(grad)


@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,hv,causal", CASES)
def test_bwd_ref_matches_autograd_and_repro_vjp(b, sq, sk, h, hkv, hd, hv,
                                                causal):
    q, k, v, do = _inputs(b, sq, sk, h, hkv, hd, hv, seed=sq + h + hd)
    o, lse = flash_attention_fwd_ref(_t(q), _t(k), _t(v), causal=causal)
    got = flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, lse, _t(do),
                                  causal=causal)
    # torch.autograd through the plain forward
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    want = torch.autograd.grad(flash_attention_ref(tq, tk, tv, causal=causal),
                               (tq, tk, tv), _t(do))
    # jax.vjp of repro's jnp flash attention
    jo, vjp = jax.vjp(lambda a, b_, c: JL.flash_attention(
        a, b_, c, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    jwant = vjp(jnp.asarray(do))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    for g, w, jw in zip(got, want, jwant):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(jw), atol=ATOL,
                                   rtol=0)


def test_fwd_ref_lse_is_the_rows_logsumexp():
    q, k, v, _ = _inputs(2, 70, 70, 4, 2, 32, 32, seed=3)
    o, lse = flash_attention_fwd_ref(_t(q), _t(k), _t(v), causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", _t(q), _t(np.repeat(k, 2, axis=2)))
    s = s / np.sqrt(32)
    mask = torch.ones(70, 70, dtype=torch.bool).tril()
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    assert lse.shape == (2, 4, 70) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(o, flash_attention_ref(_t(q), _t(k), _t(v),
                                              causal=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_wiring_on_the_cpu(dtype):
    """``FlashAttentionFn`` on CPU tensors runs the plain forward and
    backward exactly, and moves no kernel counter."""
    q, k, v, do = (_t(a).to(dtype) for a in _inputs(2, 40, 40, 4, 2, 16, 16,
                                                     seed=5))
    fn = fa_ops.flash_attention
    before = (fn.launches, fn.bwd_launches, fn.bwd_tc_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.FlashAttentionFn.apply(*leaves, True)
    grads = torch.autograd.grad(out, leaves, do)
    assert (fn.launches, fn.bwd_launches, fn.bwd_tc_launches) == before
    o, lse = flash_attention_fwd_ref(q, k, v, causal=True)
    assert torch.equal(out, o)
    for g, w, t in zip(grads, flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                      causal=True), (q, k, v)):
        assert g.dtype == t.dtype and torch.equal(g, w)


def test_layers_flash_attention_records_a_gradient_only_under_autograd():
    q, k, v, do = (_t(a) for a in _inputs(1, 33, 33, 4, 2, 16, 16, seed=7))
    plain = L.flash_attention(q, k, v, causal=True)
    assert plain.grad_fn is None
    with torch.no_grad():
        assert L.flash_attention(q.requires_grad_(), k, v,
                                 causal=True).grad_fn is None
    out = L.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert torch.equal(out.detach(), plain)


def test_bwd_route_and_refusals():
    for dt in (torch.bfloat16, torch.float16):
        for hd in (64, 112, 128):        # 112: zamba2, on the hd-128 tiles
            assert fa_kernel.bwd_route(dt, hd) == "tc"
            assert fa_kernel.bwd_route(dt, hd, hd) == "tc"
        assert fa_kernel.bwd_route(dt, 192, 128) == "tc"    # MLA
    assert fa_kernel.bwd_route(torch.float32, 128) == "simt"
    assert fa_kernel.bwd_route(torch.float32, 64, 64) == "simt"
    # f32 has no MLA or hd 112 backward: the SIMT kernels take hd 64 and
    # 128 only
    for dt, dqk, dv in ((torch.float32, 112, 112), (torch.bfloat16, 16, 16),
                        (torch.float32, 192, 128), (torch.float32, 16, 16),
                        (torch.float16, 32, 32), (torch.bfloat16, 128, 192),
                        (torch.int8, 64, 64)):
        with pytest.raises(ValueError, match="no kernel"):
            fa_kernel.bwd_route(dt, dqk, dv)
    cpu = torch.zeros((1, 4, 2, 64))
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_bwd_cuda(cpu, cpu, cpu, cpu, lse, cpu,
                                           causal=True)
