"""Plain PyTorch version of single-token decode attention (K3).

It follows the TPU kernel, not ``repro``'s jnp oracle, where the two
differ: masked positions score NEG = -1e30 (not -inf), and the output is
acc / max(l, 1e-30).  So a row of length 0 gives the mean of V over all
S positions (every position weighs exp(NEG - NEG) = 1), where the jnp
oracle gives NaN.  Computes in f32 and returns q's dtype.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         length: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); caches: (B,S,Hkv,hd); length: (B,) -> (B,H,hd)."""
    b, h, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, hd).float()
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    sc = sc * (1.0 / math.sqrt(hd))
    pos = torch.arange(s, device=q.device)
    valid = pos[None, None, None, :] < length.to(q.device)[:, None, None, None]
    sc = torch.where(valid, sc, NEG)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    o = o / l.clamp_min(1e-30)
    return o.reshape(b, h, hd).to(q.dtype)
