"""The port's analysis passes over its own registries and simulators.

Two of the reference's four passes (``repro/analysis``) check things that
exist in each package separately, and have twins here:

* **contracts**: every registered ExchangeProtocol, PeerGraph and
  AllocationPolicy executed against its declared ClassVar contract
  (RC001–RC013), :mod:`repro_torch.analysis.contracts`;
* **trace**: the seeded simulators run twice with a
  :class:`~repro_torch.analysis.trace.TraceRecorder` attached, identical
  digests and the race and ordering invariants required,
  :mod:`repro_torch.analysis.trace`.

The lint and links passes scan files, not registries, and stay in the
reference: its lint pass already scans ``src/repro_torch/``. The CLI is
``python -m repro_torch.analysis``.
"""
from __future__ import annotations

from typing import Any, Sequence

from repro_torch.analysis.common import SEVERITIES, Finding, Report, sorted_findings
from repro_torch.analysis.trace import TraceRecorder, check_trace, diff_runs

ALL_PASSES = ("contracts", "trace")


def run_analysis(*, passes: Sequence[str] = ALL_PASSES, deep: bool = True,
                 device: Any = "cuda") -> Report:
    """Run the selected passes and return one merged :class:`Report`.
    ``deep=False`` leaves out the trace pass's cluster scenario, which
    trains on ``device`` (the card by default)."""
    unknown = set(passes) - set(ALL_PASSES)
    if unknown:
        raise ValueError(
            f"unknown analysis pass(es): {', '.join(sorted(unknown))}; "
            f"available: {', '.join(ALL_PASSES)}"
        )
    report = Report()
    if "contracts" in passes:
        from repro_torch.analysis.contracts import contracts_pass

        findings, _checks = contracts_pass()
        report.extend(findings)
        report.passes_run.append("contracts")
    if "trace" in passes:
        from repro_torch.analysis.trace import trace_pass

        findings, _scenarios = trace_pass(deep=deep, device=device)
        report.extend(findings)
        report.passes_run.append("trace")
    return report


__all__ = [
    "ALL_PASSES",
    "Finding",
    "Report",
    "SEVERITIES",
    "TraceRecorder",
    "check_trace",
    "diff_runs",
    "run_analysis",
    "sorted_findings",
]
