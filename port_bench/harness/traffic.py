"""The one traffic generator: a mix file's parameters and a seed give the
requests of a run.

Every seed gets the same multiset of prompt lengths, output lengths and
(for an open loop) gaps between arrivals, in another order: the values
are the distribution's quantiles at (i + 0.5) / N, and they are dealt in
blocks of ``block`` requests that each hold one value of every stratum, so
any run of whole blocks has the same sizes.  A mix whose order changes
its work (a closed loop: which documents queue together sets the tail)
fixes the order with ``order_seed``.  An open loop sends
round(rate x seconds / block) whole blocks, its gaps scaled so that every
request is due inside the window.  The seed picks the tokens and, unless
the mix fixes it, the order.  Only the rate (open loop) and the client count (closed loop) set
the load.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, Optional

import numpy as np

CLOSED_POOL_BLOCKS = 256          # a closed loop's pool: block x 256 requests


@dataclass
class Plan:
    """A run's requests, in the order they are sent.  ``due`` holds the
    open loop's arrival times (seconds after the window opens); a closed
    loop has none: a client sends its next request when the last one
    completes, client c its first ``c * stagger`` seconds into the window."""
    seed: int
    vocab: int
    prompt_len: np.ndarray
    output_len: np.ndarray
    due: Optional[np.ndarray]
    clients: int = 0
    stagger: float = 0.0

    def __len__(self) -> int:
        return int(self.prompt_len.size)

    def tokens(self, i: int) -> np.ndarray:
        """Request ``i``'s prompt, drawn from the seed and ``i`` alone."""
        rng = np.random.default_rng([self.seed, 7, i])
        return rng.integers(0, self.vocab, int(self.prompt_len[i]),
                            dtype=np.int32)


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """The distribution's n quantiles at (i + 0.5) / n, ascending."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        v = dist["median"] * np.exp(dist["sigma"] * z)
        return np.clip(np.rint(v), dist["min"], dist["max"]).astype(np.int64)
    if kind == "uniform":
        lo, hi = int(dist["min"]), int(dist["max"])
        return lo + np.floor(u * (hi - lo + 1)).astype(np.int64)
    if kind == "exponential":
        return -np.log1p(-u) / float(dist["rate"])
    raise ValueError(f"distribution {kind!r}")


def dealt(values: np.ndarray, block: int, rng: np.random.Generator
          ) -> np.ndarray:
    """``values`` (ascending, a whole number of blocks) dealt into blocks
    that each take one value of each of ``block`` strata, the blocks' and
    each block's order drawn from ``rng``."""
    nb = values.size // block
    strata = values.reshape(block, nb)
    out = np.stack([rng.permutation(strata[s]) for s in range(block)], axis=1)
    return np.stack([rng.permutation(row) for row in out]).reshape(-1)


def make_plan(mix: Dict, seed: int, vocab: int, seconds: float,
              rate: Optional[float] = None) -> Plan:
    """The requests of one run of ``seconds`` under ``mix``; an open loop
    takes its ``rate`` (requests a second) from the cell."""
    block = int(mix["block"])
    # the order of the sizes: from the seed, or, where the mix fixes it
    # (``order_seed``), the same for every seed
    rng = np.random.default_rng([mix.get("order_seed", seed), 3])
    if mix["loop"] == "open":
        if not rate or rate <= 0:
            raise ValueError("an open loop needs a positive rate")
        # whole blocks, every one due inside the window: each seed's window
        # holds the same requests
        n = block * max(1, round(rate * seconds / block))
        gaps = dealt(quantiles({"dist": "exponential", "rate": 1.0}, n),
                     block, rng)
        gaps *= seconds / gaps.sum()
        due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
        clients, stagger = 0, 0.0
    elif mix["loop"] == "closed":
        n = block * CLOSED_POOL_BLOCKS
        due, clients = None, int(mix["clients"])
        stagger = float(mix.get("stagger_s", 0.0))
    else:
        raise ValueError(f"loop {mix['loop']!r}")
    prompt = dealt(quantiles(mix["prompt"], n), block, rng)
    output = dealt(quantiles(mix["output"], n), block, rng)
    return Plan(seed=seed, vocab=vocab, prompt_len=prompt, output_len=output,
                due=due, clients=clients, stagger=stagger)
