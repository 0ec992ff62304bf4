"""p90 over every request due in the window, from its due time to its
first token; a request that never had one counts its whole wait."""
from harness.readers import percentile, ttfts_ms


def read(run):
    return percentile(ttfts_ms(run), 90)
