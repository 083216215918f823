"""Findings and the machine-readable report the CLI emits (a copy of
``repro/analysis/findings.py``: the port keeps its own)."""
from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class Finding:
    """One rule violation.

    ``rule`` is a registered rule id (see ``rules.ALL_RULES``); ``where``
    locates it — ``path:line`` for lint findings, ``arch:entry_point`` for
    audit findings — and ``severity`` decides the exit code (any 'error'
    finding fails the gate; 'warning' findings are reported but pass).
    """

    rule: str
    severity: str  # 'error' | 'warning'
    where: str
    message: str

    def format(self) -> str:
        return f"{self.severity.upper():7s} {self.rule:18s} {self.where}: {self.message}"


@dataclasses.dataclass
class Report:
    """The full run: which passes ran, over what, and what they found."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    passes: list[str] = dataclasses.field(default_factory=list)
    audited_archs: list[str] = dataclasses.field(default_factory=list)
    linted_files: int = 0
    self_check: Optional[dict] = None

    def extend(self, findings: list[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_dict(self) -> dict:
        by_rule: dict[str, int] = {}
        for f in self.findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        return {
            "ok": self.ok,
            "passes": self.passes,
            "audited_archs": self.audited_archs,
            "linted_files": self.linted_files,
            "num_findings": len(self.findings),
            "num_errors": len(self.errors),
            "findings_by_rule": by_rule,
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "self_check": self.self_check,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)
