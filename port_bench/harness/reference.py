"""Plain PyTorch reference of the served models, in float32, with no
kernel, cache or batching: one sequence at a time, its whole causal
forward pass, a layer at a time.

It reads the configuration's published keys and the weights the
benchmark made (the port's parameter tree: ``embed``, ``layers`` stacked
over the layer axis, ``ln_f``), upcast a leaf or an expert at a time.  It
imports nothing of the port.  It computes what the port computes, which
departs from the published models where the configuration's
``not_modelled`` says so:

  * attention: MLA (``kv_lora_rank`` present) with q through its low-rank
    pair, the latent c and the shared rope key, k and v expanded per head,
    softmax scale 1 / sqrt(qk_nope + qk_rope); or GQA, query head i on kv
    head i // (heads / kv heads), scale 1 / sqrt(head_dim); rotary
    embedding on the two halves of the rope columns at ``rope_theta``, no
    YaRN, no latent or q/k norms;
  * MoE: softmax router in float32, greedy top-k over all experts (the
    lower index first among equals), the k weights renormalised, no
    routed scaling; per prompt each expert keeps its first
    ceil(P k 1.25 / E) (token, choice) slots in token order and drops the
    rest; a decoded token is alone in its row and drops nothing; the
    shared experts' FFN added; SiLU-gated FFNs;
  * RMSNorm at ``rms_norm_eps``; float32 logits of the final norm.

``precision="fp8"`` is the control: every product's two operands rounded
to float8 (e4m3, a scale a tensor) before an float32 product.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

QUERY_BLOCK = 512
HEAD_GROUP = 16


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = 448.0 / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Reference:
    def __init__(self, config: Dict[str, Any], weights: Dict[str, Any],
                 precision: str = "f32", capacity_factor: float = 1.25):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.c = config
        self.w = weights
        self.fp8 = precision == "fp8"
        self.cf = capacity_factor
        self.mla = "kv_lora_rank" in config
        self.experts = config.get("n_routed_experts", config.get("num_experts"))
        self.top_k = config["num_experts_per_tok"]
        self.eps = float(config["rms_norm_eps"])
        self.theta = float(config["rope_theta"])

    # -- pieces --------------------------------------------------------------
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return a @ b

    def leaf(self, *path, layer: Optional[int] = None) -> torch.Tensor:
        node = self.w
        for k in path:
            node = node[k]
        t = node if layer is None else node[layer]
        return t.float()

    def rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * scale

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (T, heads, d): position t rotates the pair (j, j + d/2) by
        t * theta^(-j / (d/2))."""
        t, d = x.shape[0], x.shape[-1]
        half = d // 2
        inv = self.theta ** (-torch.arange(half, dtype=torch.float64,
                                           device=x.device) / half)
        ang = (torch.arange(t, dtype=torch.float64, device=x.device)[:, None]
               * inv).float()[:, None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def causal(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float) -> torch.Tensor:
        """q, k (T, H, dk), v (T, H, dv) -> (T, H, dv); query t sees keys
        0..t; in blocks of queries."""
        t = q.shape[0]
        out = torch.empty(q.shape[0], q.shape[1], v.shape[-1],
                          dtype=torch.float32, device=q.device)
        if self.fp8:
            q, k, v = _fp8(q), _fp8(k), _fp8(v)
        q = q * scale
        for s in range(0, t, QUERY_BLOCK):
            e = min(s + QUERY_BLOCK, t)
            sc = torch.einsum("qhd,khd->hqk", q[s:e], k[:e])
            diag = torch.ones(e - s, e - s, dtype=torch.bool,
                              device=q.device).triu_(1)
            sc[..., s:e].masked_fill_(diag, float("-inf"))
            p = torch.softmax(sc, dim=-1)
            del sc
            if self.fp8:
                p = _fp8(p)
            out[s:e] = torch.einsum("hqk,khd->qhd", p, v[:e])
        return out

    def attention(self, h: torch.Tensor, i: int) -> torch.Tensor:
        """One layer's attention, HEAD_GROUP query heads at a time (MLA) or
        a kv head's query heads at a time (GQA), so that a 32k prompt's
        per-head tensors stay small."""
        c, t = self.c, h.shape[0]
        heads, d = c["num_attention_heads"], c["hidden_size"]
        a = lambda name: self.leaf("layers", "attn", name, layer=i)  # noqa
        out = torch.zeros(t, d, dtype=torch.float32, device=h.device)
        if self.mla:
            nope, rope_d = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
            vd, r = c["v_head_dim"], c["kv_lora_rank"]
            q_lat = self.mm(h, a("w_dq"))
            ckv = self.mm(h, a("w_dkv"))
            lat = ckv[:, :r]
            kr = self.rope(ckv[:, None, r:])
            w_uq = a("w_uq").reshape(-1, heads, nope + rope_d)
            w_ukv = a("w_ukv").reshape(r, heads, nope + vd)
            wo = a("wo").reshape(heads, vd, d)
            for h0 in range(0, heads, HEAD_GROUP):
                g = min(HEAD_GROUP, heads - h0)
                q = self.mm(q_lat, w_uq[:, h0:h0 + g].reshape(-1, g * (nope + rope_d)))
                q = q.reshape(t, g, nope + rope_d)
                q = torch.cat([q[..., :nope], self.rope(q[..., nope:])], dim=-1)
                kv = self.mm(lat, w_ukv[:, h0:h0 + g].reshape(r, g * (nope + vd)))
                kv = kv.reshape(t, g, nope + vd)
                k = torch.cat([kv[..., :nope], kr.expand(t, g, rope_d)], dim=-1)
                o = self.causal(q, k, kv[..., nope:],
                                1.0 / math.sqrt(nope + rope_d))
                out += self.mm(o.reshape(t, g * vd),
                               wo[h0:h0 + g].reshape(g * vd, d))
            return out
        kvh, hd = c["num_key_value_heads"], c["head_dim"]
        g = heads // kvh
        wq = a("wq").reshape(d, heads, hd)
        wk = a("wk").reshape(d, kvh, hd)
        wv = a("wv").reshape(d, kvh, hd)
        wo = a("wo").reshape(heads, hd, d)
        for j in range(kvh):
            q = self.rope(self.mm(h, wq[:, j * g:(j + 1) * g].reshape(d, g * hd))
                          .reshape(t, g, hd))
            k = self.rope(self.mm(h, wk[:, j]).reshape(t, 1, hd))
            v = self.mm(h, wv[:, j]).reshape(t, 1, hd)
            o = self.causal(q, k.expand(t, g, hd), v.expand(t, g, hd),
                            1.0 / math.sqrt(hd))
            out += self.mm(o.reshape(t, g * hd),
                           wo[j * g:(j + 1) * g].reshape(g * hd, d))
        return out

    def kept(self, ids: torch.Tensor, prompt_len: int) -> torch.Tensor:
        """(T, k) mask of the (token, choice) slots an expert computes: the
        prompt's first cap slots an expert in token order, every decoded
        token's slots."""
        e, k = self.experts, self.top_k
        keep = torch.ones_like(ids, dtype=torch.bool)
        p = min(prompt_len, ids.shape[0])
        cap = max(1, math.ceil(p * k * self.cf / e))
        flat = ids[:p].reshape(-1)
        order = torch.argsort(flat, stable=True)
        srt = flat[order]
        first = torch.searchsorted(srt, torch.arange(e, device=ids.device))
        rank = torch.arange(flat.numel(), device=ids.device) - first[srt]
        ok = torch.empty_like(rank, dtype=torch.bool)
        ok[order] = rank < cap
        keep[:p] = ok.reshape(p, k)
        return keep

    def moe(self, h: torch.Tensor, i: int, prompt_len: int) -> torch.Tensor:
        m = lambda name: self.leaf("layers", "moe", name, layer=i)  # noqa
        probs = torch.softmax(self.mm(h, m("router")), dim=-1)
        vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, ids = vals[:, :self.top_k], ids[:, :self.top_k]
        wts = vals / vals.sum(-1, keepdim=True)
        keep = self.kept(ids, prompt_len)
        out = torch.zeros_like(h)
        stack = self.w["layers"]["moe"]
        tok, choice = torch.nonzero(keep, as_tuple=True)
        expert = ids[tok, choice]
        order = torch.argsort(expert, stable=True)
        tok, choice, expert = tok[order], choice[order], expert[order]
        counts = torch.bincount(expert, minlength=self.experts).tolist()
        start = 0
        for e, n in enumerate(counts):
            if not n:
                continue
            t_e, c_e = tok[start:start + n], choice[start:start + n]
            start += n
            x = h[t_e]
            w1, w3, w2 = (stack[n_][i, e].float() for n_ in ("w1", "w3", "w2"))
            y = self.mm(torch.nn.functional.silu(self.mm(x, w1))
                        * self.mm(x, w3), w2)
            out.index_add_(0, t_e, y * wts[t_e, c_e, None])
        if "sw1" in stack:
            hs = torch.nn.functional.silu(self.mm(h, m("sw1"))) \
                * self.mm(h, m("sw3"))
            out = out + self.mm(hs, m("sw2"))
        return out

    # -- the forward pass ------------------------------------------------------
    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, prompt_len: int,
               positions: List[int]) -> torch.Tensor:
        """float32 logits (len(positions), vocab) of the sequence
        ``tokens`` (1-D), whose first ``prompt_len`` tokens were admitted as
        one prompt and the rest decoded one by one."""
        x = self.w["embed"]["embedding"][tokens.long()].float()
        for i in range(self.c["num_hidden_layers"]):
            x = x + self.attention(
                self.rms(x, self.leaf("layers", "ln1", layer=i)), i)
            x = x + self.moe(
                self.rms(x, self.leaf("layers", "ln2", layer=i)), i,
                prompt_len)
        h = self.rms(x[positions], self.leaf("ln_f"))
        return self.mm(h, self.leaf("embed", "lm_head"))
