"""Correctness tooling of the port: its repro-lint, the baseline ratchet,
the runtime sanitizer and the metering sites.

* ``python -m repro_torch.analysis``: the RL001-RL005 lint over
  ``src/repro_torch``, gated against the committed ``baseline.json``
  ratchet.
* ``REPRO_SANITIZE=1``: ``import repro_torch`` installs the runtime
  invariant wrappers over ``RingState`` / ``BlockStore`` / ``Replica``
  (``sanitize.install()``).
* ``metering``: ``@metered`` marks the sanctioned host syncs (one-time
  calibrations) and counts their calls.
"""
from .baseline import Baseline, Diff
from .lint import RULES, Finding, LintReport, run_lint
from .metering import is_metered, metered
from .sanitize import SanitizeError

__all__ = [
    "Baseline", "Diff", "Finding", "LintReport", "RULES", "run_lint",
    "metered", "is_metered", "SanitizeError",
]
