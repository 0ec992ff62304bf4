"""Every output token the window produced (a first token from an admit,
the rest from decode rounds), over the window."""
from harness.readers import in_window


def read(run):
    n = sum(in_window(run, t) for r in run.window.reqs for t in r.tokens_t)
    return n / run.window.seconds if n else None
