"""Reductions the metric files share.  A reader takes the run's ``Run``
(``run.py``) and returns a number, or None where it finds nothing to read
(the harness then leaves the metric out of the line)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import work


def percentile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def in_window(run, t: float) -> bool:
    return run.window.t0 <= t <= run.window.t_end


def ttfts_ms(run) -> List[float]:
    """Every request due in the window, from due time to first token; one
    that never had it counts the whole wait, to the loop's end."""
    return [((r.tokens_t[0] if r.tokens_t and not r.failed else run.ended)
             - r.due) * 1e3 for r in run.window.due_in_window()]


def mfu(run) -> Optional[float]:
    """The model FLOPs of the tokens the window processed (each admit
    that began in it, each decoded token it produced) over the window
    and the chip's bf16 peak, in %."""
    c, flops = run.config, 0
    for r in run.window.reqs:
        if r.tokens_t and in_window(run, r.admit_start):
            flops += work.prefill_flops(c, r.prompt_len)
        for j, t in enumerate(r.tokens_t[1:], start=1):
            if in_window(run, t):
                flops += work.decode_flops(c, r.prompt_len + j)
    if not flops:
        return None
    return 100.0 * flops / (run.window.seconds * work.PEAK_BF16_FLOPS)


def label_share(run, label: str) -> Optional[float]:
    """The device time inside ``label`` over the device's busy time, %."""
    t = run.trace
    if not t or not t["busy_s"] or not t["label_device_s"].get(label):
        return None
    return 100.0 * t["label_device_s"][label] / t["busy_s"]


def device_idle(run) -> Optional[float]:
    """None where the trace holds no device operation at all (the
    profiler saw no device)."""
    t = run.trace
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
