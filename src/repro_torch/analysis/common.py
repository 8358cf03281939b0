"""The finding record of the analysis passes: the port's copy of the
reference's ``repro/analysis/common.py`` ``Finding``."""
from __future__ import annotations

from dataclasses import dataclass


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
