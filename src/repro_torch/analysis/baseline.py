"""Baseline ratchet of the port's repro-lint (a copy of
``repro.analysis.baseline``, DESIGN.md §14).

The committed ``baseline.json`` records the multiset of finding keys
(``rule:path:scope:message`` — deliberately line-free so unrelated edits
never churn it) that existed when the gate was introduced.  Semantics:

  * a finding whose key is in the baseline (within its recorded count)
    is **baselined**: reported, but does not fail the gate;
  * a finding whose key is absent (or exceeds its count) is **new** and
    fails the gate;
  * a baseline entry with no matching finding is **stale** — the
    offender was fixed; ``--update-baseline`` prunes it, so the baseline
    only ever shrinks unless a human deliberately re-records it.

The bar never silently moves backwards.
"""
from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

from .lint import Finding

__all__ = ["Baseline", "Diff"]


@dataclass
class Diff:
    new: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    stale: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.new


@dataclass
class Baseline:
    counts: Counter = field(default_factory=Counter)

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        path = Path(path)
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        entries: Dict[str, int] = data.get("findings", {})
        return cls(counts=Counter({k: int(v) for k, v in entries.items()}))

    def save(self, path: Path) -> None:
        payload = {
            "comment": "repro-lint ratchet: legacy findings allowed, new "
                       "findings fail CI. Keys are line-free "
                       "(rule:path:scope:message). Regenerate with "
                       "`python -m repro_torch.analysis --update-baseline` — "
                       "only after deciding a finding is a keeper.",
            "findings": {k: v for k, v in sorted(self.counts.items())},
        }
        Path(path).write_text(json.dumps(payload, indent=2) + "\n")

    @classmethod
    def from_findings(cls, findings: List[Finding]) -> "Baseline":
        return cls(counts=Counter(f.key for f in findings))

    def diff(self, findings: List[Finding]) -> Diff:
        budget = Counter(self.counts)
        d = Diff()
        for f in findings:
            if budget[f.key] > 0:
                budget[f.key] -= 1
                d.baselined.append(f)
            else:
                d.new.append(f)
        d.stale = sorted(k for k, v in budget.items() if v > 0)
        return d
