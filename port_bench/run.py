#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's model (``configs/<config>.json``) with random bf16
weights made on the card from the seed, serves it through
``repro_torch``'s ``ServeCluster`` over the mix's ring nodes (one
``Replica`` a node, all on ``cuda:0``), warms up the mix's shapes, offers
the mix (``traffic/<traffic>.json``, at the cell's rate from
``cells/<cell>.json``) for ``--seconds``, then checks what the window
served against the plain reference (``harness/check.py``) and prints one
JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones, each
read by its reader under ``metrics/``), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), ``breakdown`` (``--trace 1``), and last
``checks``: each number compared, with its limit, also the last lines on
standard error.

Calibration only (never in the benchmark's own runs): ``--control 1``
puts the float8 reference in the program's place: the tokens it puts
first at the served positions go through the same comparison, so the
run reports ``correct`` false (the program's own gap is still printed,
under ``served``).  Exits 2, printing no result, without a CUDA card, with
fewer cards than the cell asks for, without the port, or where jax, flax
or ``repro`` is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """The port from the checkout, the harness beside this file, and every
    cache of the program at a fixed place inside the checkout."""
    for p in (str(BENCH), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False, t_start=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result's object (and,
    under ``"_run"``, what the readers read)."""
    import torch
    from harness import check
    from harness.serve import abstract_params, build_cluster, serve, warm_up
    from harness.trace import Tracer, installed
    from harness.traffic import make_plan
    from harness.weights import make_weights

    t_start = T_START if t_start is None else t_start
    cuda = device.type == "cuda"
    mix, kw = cell.traffic, cell.port_config_kwargs()
    vocab = int(kw["vocab"])
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    params = make_weights(abstract_params(kw), seed, device)
    cluster, mem, addrs = build_cluster(kw, mix["server"], params, device)
    warm_up(cluster, mix["warmup"], vocab, seed)
    plan = make_plan(mix, seed, vocab, seconds, cell.params.get("rate_per_s"))
    tracer = Tracer(cell.labels) if trace else None
    if tracer is not None:
        tracer.start()              # the profiler's own first start-up
        tracer.stop()
    span = None
    if trace:        # the window's last seconds: the profiler's stop stalls
        traced_s = min(mix["trace"]["seconds"], seconds)
        span = (seconds - traced_s, traced_s)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    with installed(tracer):
        win = serve(cluster, plan, seconds, trace_span=span, tracer=tracer)
    ended = time.perf_counter()
    summary = None
    if trace and win.traced is not None:
        summary = tracer.summary(win.traced[1] - win.traced[0])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the program's outputs, then its state freed before the reference
    owners = {r.sid: cluster.sessions[r.sid].owner for r in win.reqs
              if r.sid in cluster.sessions}
    finished = [{"prompt": r.prompt,
                 "served": list(cluster.sessions[r.sid].generated)}
                for r in win.reqs if r.done and r.sid in cluster.sessions]
    del cluster, mem
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    mismatches = check.owner_mismatches(addrs, owners,
                                        int(mix["server"]["replication"]))
    sampled = check.sample(finished, seed, mix["check"]["min_served_tokens"],
                           mix["check"]["max_requests"])
    gaps = check.logit_gaps(cell.config, params, sampled, device, control,
                            float(kw.get("moe_capacity_factor", 1.25)))
    del params
    check_s = time.perf_counter() - t_check

    run = SimpleNamespace(window=win, setup_s=setup_s, ended=ended,
                          config=cell.config, trace=summary,
                          spans=tracer.spans if tracer else {})
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    due = win.due_in_window()
    failed = sum(1 for r in due if r.failed or not r.tokens_t)
    limit = cell.params.get("limits", {}).get("mean_logit_gap")
    # the control's first choices stand where the served tokens stood
    gap = gaps["control_mean_gap"] if control else gaps["mean_gap"]
    checks = {"owner_mismatches": {"value": mismatches, "limit": 0},
              "mean_logit_gap": {"value": gap, "limit": limit}}
    correct = (mismatches == 0 and gaps["tokens"] > 0 and limit is not None
               and gap <= limit)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(due), "failed": failed,
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    late = sorted((r.queued - r.due) * 1e3 for r in due)
    out["generator_late_ms"] = {"p50": late[len(late) // 2] if late else None,
                                "max": late[-1] if late else None}
    out["served"] = {**{k: gaps[k] for k in gaps if k != "tokens"},
                     "check_s": check_s,
                     "backlog_at_close": win.backlog_at_close,
                     "live_at_close": win.live_at_close,
                     "checked_requests": len(sampled),
                     "checked_tokens": gaps["tokens"],
                     "finished": len(finished), "setup_s": setup_s}
    out["checks"] = checks
    out["_run"] = run
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _paths()
    import torch
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
        from harness.spec import load_cell
        cell = load_cell(args.workload)
    except (ImportError, OSError, KeyError) as exc:
        print(f"port_bench: {exc}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from repro_torch.kernels.backend import nvidia_smi_line
    print(f"port_bench: {nvidia_smi_line()}", file=sys.stderr, flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), bool(args.control))
    out.pop("_run")
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
