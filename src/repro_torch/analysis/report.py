# A copy of repro/analysis/report.py (pure Python), kept here so the port
# imports nothing of the JAX package.
"""Findings / severity model for the flcheck program auditor.

A rule emits :class:`Finding`\\ s; an audit run collects them into a
:class:`Report`.  Severities:

``error``   — an engine contract is violated (a second device->host
              transfer in a fused block, a dropped donation, an f64
              leak, a host callback inside a scan).  ``--strict`` CLI
              runs and ``build_experiment(..., audit=True)`` fail on
              these.
``warning`` — a hazard that does not break a contract outright
              (weakly-typed program outputs, paired host conversions
              that could batch into one ``device_get``).
``info``    — context the auditor records for the report (what it
              checked, why a rule was skipped).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

SEVERITIES = ("info", "warning", "error")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str                     # registry name, e.g. "one-sync-per-block"
    severity: str                 # one of SEVERITIES
    message: str
    subject: str = ""             # program/file the finding is about
    location: str = ""            # file:line / computation / eqn path
    details: Optional[dict] = None

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity={self.severity!r} not in {SEVERITIES}")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["details"] is None:
            del d["details"]
        return d


@dataclasses.dataclass
class Report:
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def extend(self, findings) -> "Report":
        self.findings.extend(findings)
        return self

    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> List[Finding]:
        return self.by_severity("error")

    @property
    def warnings(self) -> List[Finding]:
        return self.by_severity("warning")

    @property
    def ok(self) -> bool:
        return not self.errors

    def counts(self) -> Dict[str, int]:
        return {s: len(self.by_severity(s)) for s in SEVERITIES}

    def to_json(self) -> str:
        return json.dumps({"ok": self.ok, "counts": self.counts(),
                           "findings": [f.to_dict()
                                        for f in self.findings]},
                          indent=1)

    def render(self, show_info: bool = False) -> str:
        """Human-readable report, most severe first."""
        order = {"error": 0, "warning": 1, "info": 2}
        lines = []
        for f in sorted(self.findings, key=lambda f: order[f.severity]):
            if f.severity == "info" and not show_info:
                continue
            where = " ".join(x for x in (f.subject, f.location) if x)
            lines.append(f"[{f.severity:7s}] {f.rule}: {f.message}"
                         + (f"  ({where})" if where else ""))
        c = self.counts()
        lines.append(f"flcheck: {c['error']} error(s), "
                     f"{c['warning']} warning(s), {c['info']} info")
        return "\n".join(lines)


class AuditError(RuntimeError):
    """Raised by the opt-in audit hook when error-severity findings
    survive (``build_experiment(..., audit=True)`` / ``fl_train
    --audit`` / ``cli --strict``)."""

    def __init__(self, report: Report):
        self.report = report
        errs = "; ".join(f"{f.rule}: {f.message}" for f in report.errors)
        super().__init__(
            f"flcheck audit failed with {len(report.errors)} "
            f"error-severity finding(s): {errs}")
