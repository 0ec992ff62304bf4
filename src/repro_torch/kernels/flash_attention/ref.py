"""Plain PyTorch version of flash attention (K5): what the TPU kernel
``_flash_kernel`` computes.

An online softmax over kv chunks of 128 (the TPU kernel's BK) with q, k
and v upcast to f32 and the probabilities p kept in f32 for p . v;
masked scores are NEG = -1e30 under the top-left-aligned causal mask
(query i sees keys 0..i); the output is acc / max(l, 1e-30) in q's
dtype.  (``repro``'s jnp flash path rounds p to v's dtype before p . v;
the kernel does not, and neither does this.)  GQA reads kv head
h // g without copying heads.  v may be narrower than q and k (MLA's
prefill: q . k over 192 columns, v 128), as in ``repro``'s jnp
``_flash_full``; the scale is 1/sqrt of q's head dim.

``flash_attention_fwd_ref`` also returns each row's logsumexp of its
scaled scores, m + log(l), f32 (B, H, Sq) (what K5 writes for training),
and ``flash_attention_bwd_ref`` is the plain version of K5b, the flash
backward from the forward's o and lse: D = rowsum(dO o), P = exp(S - lse)
(0 where masked), dV = P^T dO, dP = dO V^T, dS = P (dP - D), dQ = dS K
scale, dK = dS^T q scale, all in f32, dK and dV summed over each kv
head's g query heads; the gradients come back in the inputs' dtypes.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30
CHUNK = 128


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool) -> torch.Tensor:
    """q: (B,Sq,H,hd); k: (B,Sk,Hkv,hd); v: (B,Sk,Hkv,hv) -> (B,Sq,H,hv)."""
    return flash_attention_fwd_ref(q, k, v, causal=causal)[0]


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool):
    """``flash_attention_ref`` and the rows' logsumexp: (out (B,Sq,H,hv),
    lse f32 (B,H,Sq))."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    hv = v.shape[-1]
    g = h // hkv
    qg = q.float().reshape(b, sq, hkv, g, hd)
    kf, vf = k.float(), v.float()
    scale = 1.0 / math.sqrt(hd)
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, hv), dtype=torch.float32,
                      device=q.device)
    for j0 in range(0, sk, CHUNK):
        kj, vj = kf[:, j0:j0 + CHUNK], vf[:, j0:j0 + CHUNK]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kj) * scale
        if causal:
            k_pos = j0 + torch.arange(kj.shape[1], device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vj)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]                # (B,Hkv,g,Sq,hd)
    lse = (m + torch.log(l)).reshape(b, h, sq)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hv).to(q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, *, causal: bool):
    """(dq, dk, dv) of the flash forward at (q, k, v) from its output ``o``,
    its ``lse`` (B,H,Sq) and the output gradient ``do`` (B,Sq,H,hv)."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    hv = v.shape[-1]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(b, sq, hkv, g, hd)
    dog = do.float().reshape(b, sq, hkv, g, hv)
    kf, vf = k.float(), v.float()
    delta = (dog * o.float().reshape(b, sq, hkv, g, hv)).sum(-1)  # (B,Sq,Hkv,g)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    p = torch.exp(s - lse.reshape(b, hkv, g, sq)[..., None])
    if causal:
        keep = torch.arange(sq, device=q.device)[:, None] \
            >= torch.arange(sk, device=q.device)[None, :]
        p = torch.where(keep, p, 0.0)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
