"""Host milliseconds of whole-prompt admits (``ServeCluster.submit`` to its
first token) a thousand prompt tokens, over the admits the window began."""
from harness.readers import in_window


def read(run):
    done = [r for r in run.window.reqs
            if r.tokens_t and in_window(run, r.admit_start)]
    tokens = sum(r.prompt_len for r in done)
    if not tokens:
        return None
    return sum(r.admit_end - r.admit_start for r in done) * 1e3 \
        / (tokens / 1e3)
