"""p95 over every gap between two consecutive output tokens of a request,
both inside the window."""
from harness.readers import in_window, percentile


def read(run):
    gaps = [(b - a) * 1e3 for r in run.window.reqs
            for a, b in zip(r.tokens_t, r.tokens_t[1:])
            if in_window(run, a) and in_window(run, b)]
    return percentile(gaps, 95)
