"""Tensor-parallel replica groups: one ring node = a group of devices
(the port of ``repro.models.tp``).

A ``TPReplicaGroup`` runs an unmodified transformer on ``tp`` shards, one
persistent thread a shard, each on its entry of the group's device list
(entries may repeat: two shards on one card).  The sharding map is
``repro``'s, derived from the model's own logical-axis specs under
``TP_RULES``:

  * column-parallel: wq/wk/wv and their biases (heads), mlp w1/w3 (ff),
    expert w1/w3 (moe_ff), lm_head (vocab), embedding rows (vocab);
  * row-parallel:    wo (heads), mlp w2 (ff), expert w2 (moe_ff) — each
    followed by ONE psum (the ``psum_tp`` hooks in ``models.layers``);
  * KV cache:        k/v split on kv_heads, so a shard's cache bytes are
    1/TP (MLA's latent c/r caches replicate; only its heads shard);
  * MoE:             experts replicate (the router must pick the same
    slots on every shard) while the expert ff dim shards.

The model code stays unmodified: each shard runs the forward of a local
model whose config divides the head counts by tp (``head_dim`` pinned),
inside ``sharding.specs.tp_context``.  ``psum_tp`` hands the shard's
partial to the group's reduction, which waits for every shard at a
barrier and sums the partials in shard order, so the result does not
depend on which thread arrives first and every shard gets the same sum.
A shard that raises aborts the barrier: its siblings wake with
``BrokenBarrierError`` instead of waiting, and the first error
propagates.  Logits stay vocab-sharded inside the shards; the group
concatenates them in shard order and the caller takes the greedy pick.

On one card both shards of a group share its legacy default stream, so
a shard's reads of its sibling's partial are ordered after the kernels
that wrote it; across cards ``Tensor.to`` synchronises both streams.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..launch.mesh import DeviceGroup
from ..sharding import specs as sh
from . import transformer
from .model import Model

AXIS = "model"
# Logical-rule overrides for the group's one ("model",) axis; every other
# DEFAULT_RULES entry resolves naturally (heads/kv_heads/ff/vocab ->
# "model"; batch/embed/moe_embed name only absent axes: replicated).
TP_RULES: Dict[str, Any] = {"experts": None, "moe_ff": "model",
                            "moe_embed": None}

_TP_FAMILIES = ("dense", "moe")


def validate_tp(cfg, tp: int) -> None:
    """Reject configs a ``tp``-way group cannot shard exactly.  Partial
    shards would silently change math; every sharded dim must divide."""
    if tp < 1:
        raise ValueError(f"tp={tp} must be >= 1")
    if cfg.family not in _TP_FAMILIES:
        raise ValueError(
            f"tensor parallelism covers the transformer families "
            f"{_TP_FAMILIES}, not family={cfg.family!r}")

    def div(name: str, val: int) -> None:
        if val % tp:
            raise ValueError(
                f"tp={tp} must divide cfg.{name}={val} exactly "
                f"(a partial shard would change the math)")

    div("num_heads", cfg.num_heads)
    div("vocab", cfg.vocab)
    if not cfg.mla_kv_lora:
        div("num_kv_heads", cfg.num_kv_heads)
    if cfg.moe_experts:
        div("moe_d_ff", cfg.moe_d_ff)
    else:
        div("d_ff", cfg.d_ff)


def _tree_map(fn, tree, spec):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, spec[k]) for k, v in tree.items()}
    return fn(tree, spec)


def _split_dim(spec) -> Optional[int]:
    """The dimension a resolved spec puts on the group's axis (None:
    the leaf replicates)."""
    dims = [i for i, a in enumerate(spec) if a == AXIS]
    return dims[0] if dims else None


class _Reduce:
    """The group's psum: shard ``i`` deposits its partial, waits for its
    siblings at the barrier, and sums every partial in shard order on its
    own device.  Deposits alternate between two buffers, so a shard that
    runs ahead to its next psum cannot overwrite a partial a sibling has
    not read yet (it cannot pass the next barrier before that sibling
    has finished reading)."""

    def __init__(self, tp: int, timeout: float):
        self.tp = tp
        self.barrier = threading.Barrier(tp, timeout=timeout)
        self.clear()

    def clear(self) -> None:
        self.bufs = ([None] * self.tp, [None] * self.tp)
        self.calls = [0] * self.tp

    def __call__(self, i: int, x: torch.Tensor) -> torch.Tensor:
        buf = self.bufs[self.calls[i] & 1]
        self.calls[i] += 1
        buf[i] = x
        self.barrier.wait()
        out = buf[0].to(x.device)
        for part in buf[1:]:
            out = out + part.to(x.device)
        return out


def _serve(jobs: "queue.SimpleQueue", device: torch.device) -> None:
    """A shard's thread: its device current, grad mode off (both are
    thread-local), then one job at a time until ``None``."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with torch.inference_mode():
        while True:
            job = jobs.get()
            if job is None:
                return
            job()
            del job


def _stop(queues) -> None:
    for q in queues:
        q.put(None)


class TPReplicaGroup:
    """The execution plane of one replica group: the local model, each
    parameter's split axis, and one persistent thread a shard.

    ``devices`` is a ``launch.mesh.DeviceGroup`` (its ids are the pool
    indices ``device_ids`` reports) or a sequence of devices (ids 0..tp-1).
    Parameters and caches of a group are lists with one entry a shard.
    ``ServeCluster`` keeps one instance per group index, so a replica
    restarted onto the same group reuses its threads."""

    def __init__(self, model: Model, devices, *, timeout: float = 600.0):
        if isinstance(devices, DeviceGroup):
            devs, ids = devices.devices, devices.ids
        else:
            devs = tuple(torch.device(d) for d in devices)
            ids = tuple(range(len(devs)))
        if not devs:
            raise ValueError("a replica group needs at least one device")
        self.model = model
        self.devices = tuple(devs)
        self.ids = tuple(ids)
        self.tp = len(self.devices)
        cfg = model.cfg
        validate_tp(cfg, self.tp)
        over: Dict[str, Any] = {
            "num_heads": cfg.num_heads // self.tp,
            # pin head_dim: the default derives it from d_model/num_heads,
            # which would silently grow under the local head count
            "head_dim": cfg.resolved_head_dim,
        }
        if not cfg.mla_kv_lora:
            over["num_kv_heads"] = cfg.num_kv_heads // self.tp
        self.local_model = dataclasses.replace(
            model, cfg=cfg.with_overrides(**over))
        with sh.rules_context((AXIS,), TP_RULES):
            specs = model.param_pspecs()
            self._param_split = _tree_map(
                lambda t, _: _split_dim(sh.logical_spec(*t)), specs, specs)
        self._reduce = _Reduce(self.tp, timeout)
        self._queues = [queue.SimpleQueue() for _ in range(self.tp)]
        for i, (q, dev) in enumerate(zip(self._queues, self.devices)):
            threading.Thread(target=_serve, args=(q, dev), daemon=True,
                             name=f"tp-shard-{i}").start()
        weakref.finalize(self, _stop, list(self._queues))

    # -- execution -------------------------------------------------------------
    def map(self, fn: Callable[[int], Any]) -> List[Any]:
        """``fn(i)`` on every shard ``i``, each in its thread under the TP
        context; returns the results in shard order.  The first error
        raised in a shard propagates once every shard has returned."""
        results: List[Any] = [None] * self.tp
        errors: List[BaseException] = []
        done: "queue.SimpleQueue" = queue.SimpleQueue()
        reduce = self._reduce

        def job_for(i: int):
            def job():
                try:
                    with sh.tp_context(AXIS, i, reduce):
                        results[i] = fn(i)
                except BaseException as exc:   # noqa: B036 - re-raised
                    errors.append(exc)
                    reduce.barrier.abort()
                finally:
                    done.put(i)
            return job

        for i, q in enumerate(self._queues):
            q.put(job_for(i))
        for _ in range(self.tp):
            done.get()
        reduce.clear()
        if reduce.barrier.broken:
            reduce.barrier.reset()
        if errors:
            raise next((e for e in errors
                        if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return results

    def join_logits(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The shards' vocab slices joined in shard order on the first
        device."""
        return torch.cat([p.to(self.devices[0]) for p in parts], dim=-1)

    # -- parameters / cache ---------------------------------------------------
    def shard_params(self, params) -> List[Any]:
        """Lay global params out over the group: shard ``i`` receives only
        its row/column slice of every weight, copied onto its device."""
        def part(i: int):
            def cut(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
                if dim is not None:
                    n = t.shape[dim] // self.tp
                    t = t.narrow(dim, i * n, n)
                out = torch.empty(t.shape, dtype=t.dtype,
                                  device=self.devices[i])
                return out.copy_(t)
            return _tree_map(cut, params, self._param_split)
        return self.map(part)

    def init_cache(self, batch: int, max_len: int) -> List[Dict]:
        return self.map(lambda i: self.local_model.init_cache(
            batch, max_len, device=self.devices[i]))

    def _head_slice(self, i: int) -> slice:
        hl = self.model.cfg.num_kv_heads // self.tp
        return slice(i * hl, (i + 1) * hl)

    def cache_with_blocks(self, max_len: int, blocks) -> List[Dict]:
        """Host slab run -> fresh one-row caches, each shard receiving only
        its kv-head slice of every slab."""
        return self.map(lambda i: self.local_model.cache_with_blocks(
            max_len, [b[:, :, :, self._head_slice(i)] for b in blocks],
            device=self.devices[i]))

    def export_kv_block(self, caches, row: int, off: int,
                        chunk: int) -> np.ndarray:
        """The full (shard-concatenated) slab: the prefix cache's
        content-addressed format, importable by any tp degree."""
        return transformer.concat_kv_heads(
            self.export_kv_shards(caches, row, off, chunk))

    def export_kv_shards(self, caches, row: int, off: int,
                         chunk: int) -> List[np.ndarray]:
        """Per-shard slabs (shard s = the kv-head slice shard s holds):
        the per-shard KVB1 handoff wire format."""
        return self.map(lambda i: self.local_model.export_kv_block(
            caches[i], row, off, chunk))

    def per_shard_cache_bytes(self, caches) -> int:
        """Bytes one shard holds for ``caches`` (1/TP of the global cache
        for sharded k/v)."""
        return sum(t.numel() * t.element_size() for t in caches[0].values())

    def device_ids(self) -> List[int]:
        return list(self.ids)

    # -- forward ---------------------------------------------------------------
    def _on(self, i: int, x):
        return x.to(self.devices[i]) if isinstance(x, torch.Tensor) else x

    def prefill(self, params, batch: Dict[str, torch.Tensor], caches):
        """Whole-prompt prefill on every shard: (B, V) logits, caches."""
        outs = self.map(lambda i: self.local_model.prefill(
            params[i], {k: self._on(i, v) for k, v in batch.items()},
            caches[i]))
        return self.join_logits([o[0] for o in outs]), [o[1] for o in outs]

    def prefill_chunk(self, params, tokens: torch.Tensor, caches,
                      index: int):
        """One prefill segment from ``index``: (B, S, V) logits, caches."""
        outs = self.map(lambda i: self.local_model.prefill_chunk(
            params[i], self._on(i, tokens), caches[i], index))
        return self.join_logits([o[0] for o in outs]), [o[1] for o in outs]

    def decode_step(self, params, caches, tokens: torch.Tensor, index):
        """One token a row (``index`` an int or a (B,) tensor)."""
        outs = self.map(lambda i: self.local_model.decode_step(
            params[i], caches[i], self._on(i, tokens), self._on(i, index)))
        return self.join_logits([o[0] for o in outs]), [o[1] for o in outs]
