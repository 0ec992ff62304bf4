"""The traced run's instruments: ``record_function`` labels around the
harness's own calls and around the program functions a metric names,
``torch.profiler`` over part of the window, and the reduction of its
events to what the metrics read.

Labels the harness always sets: ``pb.submit`` (``ServeCluster.submit``),
``pb.step`` (``ServeCluster.step``), ``pb.admit`` (``Replica.admit``) and
``pb.decode_round`` (``Replica.decode_round``); the spans of the last two
are also timed by the host clock.  A metric's reader names further
labels in ``LABELS`` (label -> (module, function)); the function is
wrapped in its module for the traced run only, as a caller looks it up in
the module's globals.
"""
from __future__ import annotations

import contextlib
import importlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

TOP = 10
HOST_SPANS = {"pb.decode_round": "Replica.decode_round (host)",
              "pb.admit": "Replica.admit (host)",
              "pb.step": "ServeCluster.step outside the rounds",
              "pb.submit": "ServeCluster.submit outside the admit"}


class Tracer:
    def __init__(self, labels: Dict[str, tuple]):
        self.labels = dict(labels)
        self.spans: Dict[str, List[tuple]] = defaultdict(list)
        self._saved: List[tuple] = []
        self.prof = None

    @staticmethod
    def label(name: str):
        import torch
        return torch.profiler.record_function(name)

    def _wrap(self, owner, attr: str, label: str, timed: bool) -> None:
        fn = getattr(owner, attr)
        spans = self.spans[label]

        def wrapped(*args, **kwargs):
            with Tracer.label(label):
                if not timed:
                    return fn(*args, **kwargs)
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                spans.append((t0, time.perf_counter(), out))
                return out
        self._saved.append((owner, attr, fn))
        setattr(owner, attr, wrapped)

    def install(self) -> None:
        from repro_torch.serve.server import Replica
        self._wrap(Replica, "admit", "pb.admit", True)
        self._wrap(Replica, "decode_round", "pb.decode_round", True)
        for label, (module, fn) in self.labels.items():
            self._wrap(importlib.import_module(module), fn, label, False)

    def uninstall(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()

    def summary(self, window_s: float) -> Dict:
        """busy_s (the union of the device operations' intervals),
        window_s, device seconds by operation name and inside each label,
        and the device's idle gaps by the innermost harness span the host
        was in."""
        events = self.prof.events()
        labels = set(self.labels) | set(HOST_SPANS)
        dev, host = [], []
        for e in events:
            if e.device_type.name == "CUDA":
                if e.name not in labels:
                    dev.append((e.time_range.start, e.time_range.end, e.name))
            elif e.name in labels:
                host.append((e.time_range.start, e.time_range.end, e.name,
                             e.device_time_total))
        dev.sort()
        by_op: Dict[str, float] = defaultdict(float)
        busy, end, gaps = 0.0, None, []
        for a, b, name in dev:
            by_op[name] += (b - a) / 1e6
            if end is not None and a > end:
                gaps.append((end, a))
            if end is None or b > end:
                busy += b - (a if end is None else max(a, end))
                end = b
        label_s: Dict[str, float] = defaultdict(float)
        for _, _, name, device_us in host:
            label_s[name] += device_us / 1e6
        idle: Dict[str, float] = defaultdict(float)
        host.sort()
        starts = [h[0] for h in host]
        import bisect
        for a, b in gaps:
            mid = (a + b) / 2
            inner = "harness loop"
            j = bisect.bisect_right(starts, mid)
            best = None
            for h in host[max(0, j - 64):j]:
                if h[0] <= mid <= h[1] and h[2] in HOST_SPANS \
                        and (best is None or h[0] > best[0]):
                    best = h
            if best is not None:
                inner = HOST_SPANS[best[2]]
            idle[inner] += (b - a) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        return {"busy_s": busy / 1e6, "window_s": window_s,
                "device_s_by_op": dict(by_op), "label_device_s": dict(label_s),
                "device_ops": [[k[:160], v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:TOP]]}


@contextlib.contextmanager
def installed(tracer: Optional[Tracer]):
    if tracer is None:
        yield
        return
    tracer.install()
    try:
        yield
    finally:
        tracer.uninstall()
