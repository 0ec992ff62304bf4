"""Median wait before the cluster: from a request's due time to the start
of its admitting submit (the router's replica set had a free slot), over
the requests admitted in the window."""
from harness.readers import in_window, percentile


def read(run):
    return percentile([(r.admit_start - r.due) * 1e3
                       for r in run.window.reqs
                       if r.tokens_t and in_window(run, r.admit_start)], 50)
