"""Dry run of every (arch × shape × mesh) cell on the ``meta`` device (the
port's counterpart of ``repro.launch.dryrun``).

``repro`` lowers and compiles each cell for its 256- or 512-chip TPU mesh
and reads XLA's memory and cost analyses.  The port has no compiler to
ask, so for each cell it reckons, with nothing allocated on any device:

  * shardings — the cell's preset (``launch.presets``) resolved over the
    model's logical axes (``Model.param_pspecs``, ``cache_pspecs``,
    ``launch.inputs.batch_pspecs``) and fitted to each tensor's dims with
    ``repro``'s ``_fit_spec`` (a mesh axis that does not divide its dim is
    dropped);
  * per-device argument bytes — parameters, the AdamW moments and step,
    the batch and the cache, each at its fitted shard shape: exact;
  * one ``meta`` trace of the step under ``hlo_cost.CostCounter``:
    ``make_train_step`` for train, ``Model.prefill`` for prefill,
    ``Model.decode_step`` (every row at position ``seq_len - 1``) for
    decode, at the local batch (the global batch over the fitted batch
    axes), with the full parameter tree.  It gives the matmul FLOPs, the
    HBM bytes, the kernels' charges and the temporaries' high-water mark
    (``temp_bytes``);
  * the model axis: where the preset puts ``heads``, ``kv_heads``, ``ff``
    or ``experts`` on a mesh axis that is not a batch axis, and a fitted
    parameter keeps it, the local-batch trace does the work of all of
    that axis's devices at once.  The record's FLOPs, bytes, charges and
    temporaries are then the trace's divided by that axis's size, and it
    says so: ``"per_device": "divided"`` with the divisor in
    ``model_divisor``.  Otherwise ``"per_device": "local_batch"`` and the
    trace's numbers are one device's.  (A true shard would trace under
    ``sharding.specs.tp_context``; the port's tensor parallelism takes
    neither the SSM, hybrid and encoder-decoder families nor head counts
    that 16 does not divide, so the dry run never does.)  The trace holds
    whole gradients, as one device of a replica would, so an FSDP cell's
    ``temp_bytes`` is an upper bound;
  * collective bytes, reckoned from the fitted specs per device, by
    ``repro``'s op names.  A parameter's batch-axis shards are FSDP: it is
    gathered over them before use, and its gradient reduced over them;
    its other mesh axes are tensor parallel and stay sharded.  The terms,
    each the bytes of the whole buffer the collective makes or consumes:
      - ``all-gather``: each FSDP-sharded parameter at its tensor-parallel
        shard size, once a step for prefill and decode, twice a
        microbatch for train (forward and backward);
      - ``reduce-scatter``: train, each FSDP-sharded parameter's gradient
        at that size, once a microbatch;
      - ``all-reduce``: train, each parameter's gradient shard over the
        batch axes it is not sharded on (data parallelism), once a
        microbatch; and every step, the output of each row-parallel
        product (a ``heads`` or ``ff`` input dim and a ``d_model`` output
        dim, its input dim on a tensor-parallel axis): the step's local
        tokens x d_model in the working dtype, a layer (the shared block:
        a site; the encoder: its frames), twice for train;
      - ``all-to-all``: a MoE layer whose ``experts`` are on a
        tensor-parallel axis sends each local token's d_model to its top-k
        experts and back, twice more for train.
    Not counted: activation reshards (``act_embed``), logit gathers, and
    the exchange a sequence-sharded KV cache (``kv_seq``) needs;
  * ``peak_memory_per_device`` = ``argument_bytes`` + ``temp_bytes``, and
    ``fits`` when it is at most ``HARDWARE["hbm_bytes"]`` (an H100's 80
    GB).

Deliberate differences from ``repro``: no HLO, a torch-trace count
(``hlo_cost``); ``trace_s`` in place of ``lower_s`` / ``compile_s``; no
``f32_twin_bytes`` (an artifact of XLA's CPU backend, which no torch trace
has) and no ``--attn-impl`` (K5 always skips masked tiles); ``--out`` is
required.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k --mesh single --out /tmp/dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --jobs 8 --out /tmp/dryrun.jsonl

``--jobs N`` traces the cells in N worker processes (``spawn``), the
longest first; the records are written in the cells' order all the same.
A trace is host work (``meta`` ops dispatched from Python): at full depth
a zamba2-7b prefill of 32k tokens dispatches its chunked scan's ops for
each of 81 layers and is the longest cell.
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs import SHAPES, get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..configs.registry import ARCH_IDS, shape_cells, skipped_cells
from ..models import Model
from ..models.hybrid import num_shared_sites
from ..models.layers import dt
from ..optim import adamw
from ..sharding import specs as sh
from ..train.step import TrainConfig, make_train_step
from . import presets
from .hlo_cost import CostCounter
from .inputs import batch_pspecs, input_specs
from .mesh import HARDWARE, DeviceMesh, make_production_mesh

META = torch.device("meta")
# logical axes of a parameter dim that tensor parallelism splits the
# compute on (the model axis of the "divided" rule)
COMPUTE_AXES = ("heads", "kv_heads", "ff", "experts")
SKIP_REASON = "requires sub-quadratic attention (pure full-attention arch)"


def _map(fn, *trees):
    """``fn`` over the leaves of parallel dict trees (the first's keys)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> List:
    """The leaves of a dict tree, keys sorted: parallel trees line up."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _fit_spec(mesh: DeviceMesh, spec, shape) -> Tuple:
    """Drop mesh axes that do not divide the tensor dim (whisper's 12
    heads or odd vocab on a 16-way axis would otherwise fail to shard):
    ``repro``'s ``_fit_spec``."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        size = math.prod(mesh.shape[a] for a in _axes(entry))
        out.append(entry if (size and shape[i] % size == 0) else None)
    return tuple(out)


def shard_bytes(mesh: DeviceMesh, spec, shape, itemsize: int) -> int:
    """Bytes of one device's shard of a tensor under a fitted spec."""
    n = math.prod(shape)
    for entry in spec:
        n //= math.prod(mesh.shape[a] for a in _axes(entry))
    return n * itemsize


class Cell:
    """One cell's shardings: the preset's rules over ``mesh``, and the
    fitted specs (with the logical tuples beside them) of the parameters,
    the batch and the cache, on the model's ``meta`` trees."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 mesh: DeviceMesh, microbatches: Optional[int] = None):
        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        self.model = Model(cfg)
        self.rules, preset_mb = presets.preset(cfg, shape)
        self.microbatches = preset_mb if microbatches is None \
            else microbatches
        with sh.rules_context(mesh.axis_names, self.rules):
            resolve = lambda axes: sh.logical_spec(*axes)  # noqa: E731
            self.params = self.model.abstract_params()
            self.param_logical = self.model.param_pspecs()
            self.param_specs = self._fit(_map(resolve, self.param_logical),
                                         self.params)
            self.batch = {k: torch.empty(s, dtype=d, device=META)
                          for k, (s, d) in input_specs(cfg, shape).items()}
            self.batch_specs = self._fit(
                {k: resolve(v) for k, v in batch_pspecs(cfg, shape).items()},
                self.batch)
            self.cache = self.cache_specs = None
            if shape.mode != "train":
                self.cache = self.model.cache_shapes(shape.global_batch,
                                                     shape.seq_len)
                self.cache_specs = self._fit(
                    _map(resolve, self.model.cache_pspecs()), self.cache)
        self.batch_axes = _axes(self.batch_specs["tokens"][0])
        self.local_batch = shape.global_batch // math.prod(
            mesh.shape[a] for a in self.batch_axes)

    def _fit(self, spec_tree, tensor_tree):
        return _map(lambda sp, t: _fit_spec(self.mesh, sp, t.shape),
                    spec_tree, tensor_tree)

    def _bytes(self, spec_tree, tensor_tree, itemsize=None) -> int:
        return sum(shard_bytes(self.mesh, sp, t.shape,
                               itemsize or t.element_size())
                   for sp, t in zip(_leaves(spec_tree),
                                    _leaves(tensor_tree)))

    def argument_bytes(self) -> Dict[str, int]:
        """Per-device bytes of each argument of the step, from the fitted
        specs: params, AdamW's m and v (``cfg.opt_dtype``) and its int32
        step, the batch, the cache, decode's int32 index."""
        out = {"params": self._bytes(self.param_specs, self.params),
               "batch": self._bytes(self.batch_specs, self.batch)}
        if self.shape.mode == "train":
            moment = torch.empty((), dtype=getattr(
                torch, self.cfg.opt_dtype)).element_size()
            out["opt_state"] = 2 * self._bytes(self.param_specs, self.params,
                                               moment) + 4
        else:
            out["cache"] = self._bytes(self.cache_specs, self.cache)
        if self.shape.mode == "decode":
            # repro's decode takes the tokens alone and a scalar index
            out["batch"] = self._bytes(self.batch_specs["tokens"],
                                       self.batch["tokens"]) + 4
        return out

    def model_divisor(self) -> int:
        """The size of the non-batch mesh axes that a fitted parameter
        keeps on a ``heads``/``kv_heads``/``ff``/``experts`` dim (1: none)."""
        axes = set()
        for logical, spec in zip(_leaves(self.param_logical),
                                 _leaves(self.param_specs)):
            for name, entry in zip(logical, spec):
                if name in COMPUTE_AXES:
                    axes.update(a for a in _axes(entry)
                                if a not in self.batch_axes)
        return math.prod(self.mesh.shape[a] for a in axes)

    def collectives(self) -> Dict[str, float]:
        """Per-device collective bytes by op, from the fitted specs (the
        terms in the module docstring)."""
        cfg, shape, mesh = self.cfg, self.shape, self.mesh
        train = shape.mode == "train"
        mb = self.microbatches if train else 1
        size = lambda axes: math.prod(mesh.shape[a] for a in axes)  # noqa: E731
        out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0,
               "all-to-all": 0.0}
        for logical, spec, t in zip(_leaves(self.param_logical),
                                    _leaves(self.param_specs),
                                    _leaves(self.params)):
            mine = [a for e in spec for a in _axes(e)]
            fsdp = [a for a in mine if a in self.batch_axes]
            tp = [a for a in mine if a not in self.batch_axes]
            gathered = t.numel() * t.element_size() / size(tp)
            if fsdp:
                out["all-gather"] += (2 * mb if train else 1) * gathered
                if train:
                    out["reduce-scatter"] += mb * gathered
            rest = [a for a in self.batch_axes if a not in fsdp]
            if train and rest:
                out["all-reduce"] += mb * gathered / size(fsdp)
        act = torch.empty((), dtype=dt(cfg)).element_size()
        tokens = self.local_batch * (1 if shape.mode == "decode"
                                     else shape.seq_len)
        passes = 2 if train else 1
        for path, logical, spec, t in self._param_rows():
            dims = [n for n in logical if n != "layers"]
            uses = t.shape[0] if logical and logical[0] == "layers" else 1
            if path[0] == "shared":
                uses = num_shared_sites(cfg)
            toks = self.local_batch * cfg.audio_frames \
                if path[0] == "encoder" else tokens
            inner = spec[len(logical) - len(dims):]
            if len(dims) == 2 and dims[0] in ("heads", "ff") \
                    and dims[1] == "embed" and any(
                        a not in self.batch_axes for a in _axes(inner[0])):
                out["all-reduce"] += passes * uses * toks * cfg.d_model * act
            if path[-1] == "w1" and dims and dims[0] == "experts" and any(
                    a not in self.batch_axes for a in _axes(inner[0])):
                out["all-to-all"] += passes * 2 * uses * toks \
                    * cfg.moe_top_k * cfg.d_model * act
        return {k: v for k, v in out.items() if v}

    def _param_rows(self):
        def walk(path, logical, spec, t):
            if isinstance(logical, dict):
                for k in logical:
                    yield from walk(path + (k,), logical[k], spec[k], t[k])
            else:
                yield path, logical, spec, t
        yield from walk((), self.param_logical, self.param_specs, self.params)

    def trace(self) -> Dict[str, Any]:
        """One ``meta`` trace of the step at the local batch under a
        ``CostCounter``: its ``result()``."""
        b = self.local_batch
        batch = {k: torch.empty((b,) + tuple(v.shape[1:]), dtype=v.dtype,
                                device=META) for k, v in self.batch.items()}
        model, shape = self.model, self.shape
        if shape.mode == "train":
            tcfg = TrainConfig(opt=adamw.OptConfig(
                moment_dtype=self.cfg.opt_dtype),
                microbatches=self.microbatches)
            state = adamw.init_state(self.params, tcfg.opt)
            step = make_train_step(model, tcfg)
            with CostCounter((self.params, state, batch)) as counter:
                step(self.params, state, batch)
        else:
            cache = model.cache_shapes(b, shape.seq_len)
            with CostCounter((self.params, batch, cache)) as counter:
                if shape.mode == "prefill":
                    model.prefill(self.params, batch, cache)
                else:
                    model.decode_step(self.params, cache, batch["tokens"],
                                      shape.seq_len - 1)
        return counter.result()


def run_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: DeviceMesh, *,
             microbatches: Optional[int] = None,
             tag: str = "baseline") -> Dict[str, Any]:
    """The record of one cell (``ok`` False with the error where it
    fails; it never raises)."""
    t0 = time.time()
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "x".join(str(n) for n in mesh.shape.values()),
        "microbatches": microbatches, "tag": tag,
    }
    try:
        cell = Cell(cfg, shape, mesh, microbatches)
        args = cell.argument_bytes()
        t1 = time.time()
        cost = cell.trace()
        trace_s = time.time() - t1
        div = cell.model_divisor()
        argument = sum(args.values())
        temp = cost["temp_bytes"] / div
        coll = cell.collectives()
        rec.update({
            "ok": True,
            "devices": mesh.size,
            "microbatches": cell.microbatches,
            "trace_s": trace_s,
            "local_batch": cell.local_batch,
            "per_device": "divided" if div > 1 else "local_batch",
            "model_divisor": div,
            "matmul_flops_per_device": cost["matmul_flops"] / div,
            "hbm_bytes_per_device": cost["hbm_bytes"] / div,
            "collective_bytes_per_device": sum(coll.values()),
            "collective_bytes_by_op": coll,
            "kernels": {k: {key: v / div if key != "calls" else v
                            for key, v in row.items()}
                        for k, row in cost["kernels"].items()},
            "peak_memory_per_device": argument + temp,
            "argument_bytes": argument,
            "argument_bytes_by_kind": args,
            "temp_bytes": temp,
            "fits": argument + temp <= HARDWARE["hbm_bytes"],
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "tokens": shape.global_batch * (shape.seq_len
                                            if shape.mode != "decode" else 1),
            "mode": shape.mode,
        })
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    rec["wall_s"] = time.time() - t0
    return rec


def skip_records(arch: str) -> List[Dict[str, Any]]:
    """``repro``'s records of the shapes an arch skips."""
    return [{"arch": arch, "shape": s, "ok": None, "skipped": SKIP_REASON}
            for s in skipped_cells(arch)]


def append_result(rec: Dict[str, Any], path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def summary_line(rec: Dict[str, Any]) -> str:
    if rec.get("ok") is None:
        return f"[SKIP] {rec['arch']:24s} {rec['shape']:12s} {rec['skipped']}"
    if not rec.get("ok"):
        return f"[FAIL] {rec['arch']} {rec['shape']} {rec['mesh']}: " \
               f"{rec.get('error')}"
    return (f"[OK ] {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
            f"mem/dev={rec['peak_memory_per_device'] / 2**30:.2f}GiB "
            f"fits={rec['fits']} "
            f"flops/dev={rec['matmul_flops_per_device']:.3e} "
            f"bytes/dev={rec['hbm_bytes_per_device']:.3e} "
            f"coll/dev={rec['collective_bytes_per_device']:.3e} "
            f"({rec['per_device']}) wall={rec['wall_s']:.1f}s")


def _cell_record(job: Tuple) -> Dict[str, Any]:
    """``run_cell`` of one (arch, shape, multi_pod, microbatches, tag): a
    worker's task."""
    arch, shape_name, multi_pod, microbatches, tag = job
    return run_cell(get_config(arch), SHAPES[shape_name],
                    make_production_mesh(multi_pod=multi_pod),
                    microbatches=microbatches, tag=tag)


def _trace_rank(job: Tuple) -> float:
    """A rough rank of a cell's trace time (its layers, times its mode's
    share, more for a Mamba-2 scan over chunks): the pool starts the
    longest first."""
    cfg, mode = get_config(job[0]), SHAPES[job[1]].mode
    rank = cfg.num_layers * {"train": 10.0, "prefill": 1.0,
                             "decode": 0.5}[mode]
    if cfg.mamba_version == 2 and mode != "decode":
        rank *= 8
    return rank


def run_cells(jobs: List[Tuple], workers: int = 1):
    """Yield each job's record in the jobs' order, traced in ``workers``
    spawned processes (in this one for 1)."""
    if workers <= 1:
        for job in jobs:
            yield _cell_record(job)
        return
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futures = {i: pool.submit(_cell_record, jobs[i])
                   for i in sorted(range(len(jobs)),
                                   key=lambda i: -_trace_rank(jobs[i]))}
        for i in range(len(jobs)):
            yield futures[i].result()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="gradient-accumulation splits (default: the "
                         "preset's)")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes that trace the cells")
    ap.add_argument("--out", required=True,
                    help="JSON-lines file the records are appended to")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]
    if args.all:
        cells = [(a, s.name) for a in ARCH_IDS for s in shape_cells(a)]
        for a in ARCH_IDS:
            for rec in skip_records(a):
                append_result(rec, args.out)
                print(summary_line(rec), flush=True)
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape required unless --all")
    jobs = [(arch, shape_name, mp, args.microbatches, args.tag)
            for arch, shape_name in cells for mp in meshes]
    failed = 0
    for rec in run_cells(jobs, args.jobs):
        append_result(rec, args.out)
        failed += not rec["ok"]
        print(summary_line(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
