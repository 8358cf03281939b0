"""Trace recording and the dynamic determinism checks of the simulators.

The port's copy of the reference's ``repro/analysis`` trace pass
(:mod:`repro_torch.analysis.trace`); the lint, contracts and links passes
stay in the reference.
"""
from repro_torch.analysis.common import Finding
from repro_torch.analysis.trace import TraceRecorder, check_trace, diff_runs

__all__ = ["Finding", "TraceRecorder", "check_trace", "diff_runs"]
