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
"""
from __future__ import annotations

import math

import torch

NEG = -1e30
CHUNK = 128


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool) -> torch.Tensor:
    """q: (B,Sq,H,hd); k: (B,Sk,Hkv,hd); v: (B,Sk,Hkv,hv) -> (B,Sq,H,hv)."""
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
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hv).to(q.dtype)
