"""Finding and report records of the analysis passes: the port's copy of
the reference's ``repro/analysis/common.py`` (``Finding``, ``Report`` and
the severity order; the reference's suppression comments serve its lint
pass, which stays there)."""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Sequence

SEVERITIES = ("info", "warning", "error")  # ascending


def severity_rank(severity: str) -> int:
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        raise ValueError(
            f"unknown severity {severity!r}; expected one of {SEVERITIES}"
        ) from None


@dataclass(frozen=True)
class Finding:
    """One violation: where, which rule, how bad, and why it matters."""

    rule: str  # rule id, e.g. "RT003"
    severity: str  # "info" | "warning" | "error"
    path: str  # repo-relative file (or pseudo-path like "<trace:...>")
    line: int  # 1-based; 0 when not line-addressable (contracts/trace)
    message: str
    pass_name: str = "lint"  # which pass produced it

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.severity.upper()} [{self.rule}] {self.message}"


@dataclass
class Report:
    """All findings from one analysis run, with gating and serialization."""

    findings: List[Finding] = field(default_factory=list)
    passes_run: List[str] = field(default_factory=list)
    files_scanned: int = 0

    def extend(self, findings: Sequence[Finding]):
        self.findings.extend(findings)

    def count(self, severity: str) -> int:
        return sum(1 for f in self.findings if f.severity == severity)

    def worst_rank(self) -> int:
        return max((severity_rank(f.severity) for f in self.findings), default=-1)

    def failed(self, fail_on: str) -> bool:
        """True when any finding is at/above the ``fail_on`` severity."""
        if fail_on == "never":
            return False
        return self.worst_rank() >= severity_rank(fail_on)

    def to_json(self) -> Dict:
        return {
            "passes": sorted(self.passes_run),
            "files_scanned": self.files_scanned,
            "summary": {s: self.count(s) for s in SEVERITIES},
            "findings": [asdict(f) for f in sorted_findings(self.findings)],
        }

    def write_json(self, path: Path):
        Path(path).write_text(json.dumps(self.to_json(), indent=2) + "\n")

    def render(self) -> str:
        lines = [f.render() for f in sorted_findings(self.findings)]
        summary = ", ".join(f"{self.count(s)} {s}" for s in reversed(SEVERITIES))
        lines.append(
            f"analysis: {len(self.findings)} finding(s) ({summary}) across "
            f"{self.files_scanned} file(s); passes: "
            f"{', '.join(sorted(self.passes_run)) or 'none'}"
        )
        return "\n".join(lines)


def sorted_findings(findings: Sequence[Finding]) -> List[Finding]:
    """Stable order: worst first, then path / line / rule."""
    return sorted(
        findings,
        key=lambda f: (-severity_rank(f.severity), f.path, f.line, f.rule),
    )
