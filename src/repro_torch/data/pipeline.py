"""Deterministic synthetic token pipeline (host-sharded, prefetchable):
the port's copy of ``repro.data.pipeline``, numpy only, giving the same
batches for a seed.

Real deployments plug a file-backed reader into the same iterator
contract; for the reproduction the stream is a seeded Zipf-mixture
language so that training loss has structure to learn (unigram skew +
bigram dependency), which the train examples exploit.
"""
from __future__ import annotations

import threading
import queue as queue_mod
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    bigram_strength: float = 0.7
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    """Zipf unigram with a deterministic bigram transition overlay."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.host_count:
            raise ValueError("global_batch must divide across hosts")
        self.local_batch = cfg.global_batch // cfg.host_count
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self.unigram = p / p.sum()
        # each token deterministically prefers a successor
        self.next_tok = rng.permutation(cfg.vocab)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_index, 0xD1147))
        b, s = self.local_batch, cfg.seq_len
        base = rng.choice(cfg.vocab, size=(b, s + 1), p=self.unigram)
        follow = rng.random((b, s + 1)) < cfg.bigram_strength
        toks = base.copy()
        for t in range(1, s + 1):
            toks[:, t] = np.where(follow[:, t],
                                  self.next_tok[toks[:, t - 1]], base[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-N) over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def make_pipeline(model_cfg: ModelConfig, shape: ShapeConfig, *,
                  seed: int = 0, host_index: int = 0, host_count: int = 1,
                  prefetch: int = 2):
    dc = DataConfig(vocab=model_cfg.vocab, seq_len=shape.seq_len,
                    global_batch=shape.global_batch, seed=seed,
                    host_index=host_index, host_count=host_count)
    return Prefetcher(iter(SyntheticLM(dc)), depth=prefetch)
