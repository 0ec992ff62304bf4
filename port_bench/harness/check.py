"""What decides ``correct``: the program's outputs held against the plain
reference once the window has closed.

  * owners: every session the window admitted lives on a node of its
    key's replica set, worked out here from the nodes' addresses (a
    node's ring id is the first 8 bytes of SHA-1 of "host:port", a
    session's key those of "session/<id>"; the set is the key's first
    ``replication`` successors on the ring); limit 0 mismatches;
  * tokens: for a sample of the finished requests drawn from the seed,
    with the one that served the most tokens and the one with the longest
    prompt in it, the reference's float32 logits over the prompt and the
    served tokens; the mean, over the served (greedy) tokens, of the gap
    by which a token's logit lies below the reference's best at its
    position (``mean_gap``; the widest is reported as ``logit_gap``).

The control (``control=True``, the reference in float8 put in the
program's place) reads the same gaps for the token the float8 pass puts
first at each of those positions (``control_mean_gap``).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .reference import Reference


def ring_id(value: str) -> int:
    return int.from_bytes(hashlib.sha1(value.encode()).digest()[:8], "big")


def replica_set(node_ids: Sequence[int], sid: str, r: int) -> List[int]:
    ids = sorted(node_ids)
    key = ring_id(f"session/{sid}")
    j = int(np.searchsorted(np.array(ids, dtype=np.uint64), np.uint64(key)))
    return [ids[(j + i) % len(ids)] for i in range(min(r, len(ids)))]


def owner_mismatches(addrs: Sequence[Tuple[str, int]],
                     owners: Dict[str, int], replication: int) -> int:
    nodes = [ring_id(f"{h}:{p}") for h, p in addrs]
    return sum(owner not in replica_set(nodes, sid, replication)
               for sid, owner in owners.items())


def sample(finished: List[Dict[str, Any]], seed: int, min_tokens: int,
           max_requests: int) -> List[Dict[str, Any]]:
    """The finished requests to check: the most served tokens, the
    longest prompt, then others drawn from the seed, each with odds in
    proportion to its served tokens, until ``min_tokens`` served tokens
    or ``max_requests`` requests."""
    if not finished:
        return []
    most = max(finished, key=lambda q: (len(q["served"]), len(q["prompt"])))
    longest = max(finished, key=lambda q: (len(q["prompt"]), len(q["served"])))
    out = [most] + ([longest] if longest is not most else [])
    rng = np.random.default_rng([seed, 5])
    odds = np.array([len(q["served"]) for q in finished], np.float64)
    for j in rng.choice(len(finished), len(finished), replace=False,
                        p=odds / odds.sum()):
        if len(out) >= max_requests \
                or sum(len(q["served"]) for q in out) >= min_tokens:
            break
        if all(finished[j] is not q for q in out):
            out.append(finished[j])
    return out


TRIM = 0.02            # the share of largest gaps ``trimmed_mean_gap`` leaves out


def gap_stats(gaps: np.ndarray, prefix: str = "") -> Dict[str, Optional[float]]:
    """The mean, the widest and the share above 0 of the tokens' gaps, and
    their mean with the largest ``TRIM`` of them left out."""
    n = int(gaps.size)
    if not n:
        return {prefix + k: None for k in ("mean_gap", "logit_gap",
                                           "flip_share", "trimmed_mean_gap")}
    keep = np.sort(gaps)[:n - int(TRIM * n)]
    return {prefix + "mean_gap": float(gaps.mean()),
            prefix + "logit_gap": float(gaps.max()),
            prefix + "flip_share": float((gaps > 0).mean()),
            prefix + "trimmed_mean_gap": float(keep.mean())}


def logit_gaps(config: Dict[str, Any], weights, requests: List[Dict[str, Any]],
               device, control: bool = False,
               capacity_factor: float = 1.25) -> Dict[str, Optional[float]]:
    """``gap_stats`` of the served tokens under the float32 reference, and
    with ``control`` the same, prefixed ``control_``, of the tokens the
    float8 reference puts first at those positions; ``tokens`` checked."""
    import torch
    ref = Reference(config, weights, "f32", capacity_factor)
    low = Reference(config, weights, "fp8", capacity_factor) if control \
        else None
    gaps, gaps_c = [], []
    for q in requests:
        prompt = np.asarray(q["prompt"], np.int64)
        served = np.asarray(q["served"], np.int64)
        seq = torch.from_numpy(np.concatenate([prompt, served[:-1]])).to(device)
        pos = list(range(len(prompt) - 1, len(prompt) - 1 + len(served)))
        logits = ref.logits(seq, len(prompt), pos)
        best = logits.max(dim=-1).values
        got = logits.gather(1, torch.from_numpy(served).to(device)[:, None])[:, 0]
        gaps.append((best - got).cpu().numpy())
        if low is not None:
            pick = low.logits(seq, len(prompt), pos).argmax(dim=-1)
            gaps_c.append((best - logits.gather(1, pick[:, None])[:, 0])
                          .cpu().numpy())
        del logits
    flat = np.concatenate(gaps) if gaps else np.zeros(0)
    out = {"tokens": int(flat.size), **gap_stats(flat)}
    if control:
        out.update(gap_stats(np.concatenate(gaps_c) if gaps_c
                             else np.zeros(0), "control_"))
    return out
