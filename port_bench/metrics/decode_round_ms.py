"""Host milliseconds of a replica's decode round (``Replica.decode_round``
that decoded at least one session), window total over count."""
from harness.readers import in_window


def read(run):
    rounds = [(b - a) for a, b, out in run.spans.get("pb.decode_round", [])
              if out and in_window(run, a) and in_window(run, b)]
    return sum(rounds) * 1e3 / len(rounds) if rounds else None
