"""Per-stage resource metrics — the paper's §III-B.8 instrumentation.

The paper records, per training stage (compute gradients / send / receive /
model update / convergence detection):
  * CPU usage      — psutil, real-time
  * memory         — tracemalloc (plus RSS)
  * processing time — time.perf_counter

``StageProbe`` is a context manager; ``StageMetrics`` aggregates means per
stage across epochs exactly like Table I. A copy of the reference's
``repro/metrics/resources.py``. The probe reads host clocks: a caller that
times device work synchronises the device before the probe closes.
"""
from __future__ import annotations

import time
import tracemalloc
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List

try:
    import psutil

    _PROC = psutil.Process()
except ImportError:  # psutil is optional: CPU share and RSS then read 0
    psutil = None
    _PROC = None


@dataclass
class StageRecord:
    seconds: float
    cpu_percent: float
    mem_mb: float
    rss_mb: float


class StageProbe:
    def __init__(self, metrics: "StageMetrics", stage: str):
        self.metrics = metrics
        self.stage = stage

    def __enter__(self):
        if not tracemalloc.is_tracing():
            tracemalloc.start()
        tracemalloc.reset_peak()
        if _PROC is not None:
            self._cpu0 = _PROC.cpu_times()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = max(time.perf_counter() - self._t0, 1e-9)
        _, peak = tracemalloc.get_traced_memory()
        cpu = 0.0
        rss = 0.0
        if _PROC is not None:
            c1 = _PROC.cpu_times()
            cpu = 100.0 * ((c1.user - self._cpu0.user) + (c1.system - self._cpu0.system)) / dt
            rss = _PROC.memory_info().rss / 1e6
        self.metrics.add(self.stage, StageRecord(dt, cpu, peak / 1e6, rss))
        return False


class StageMetrics:
    """Aggregates per-stage records; `table()` emits Table-I-shaped rows.

    Besides the probe-measured Table-I stages, the serverless runtime
    engine reports *simulated* stages (cold_start / queue_wait / retry):
    per-invocation time that exists only in simulated wall-clock, recorded
    via :meth:`add_simulated` with zero CPU/memory attribution.
    """

    STAGES = (
        "compute_gradients",
        "send_gradients",
        "receive_gradients",
        "model_update",
        "convergence_detection",
    )
    SIM_STAGES = (
        "cold_start",
        "queue_wait",
        "retry",
    )

    def __init__(self):
        self.records: Dict[str, List[StageRecord]] = defaultdict(list)

    def stage(self, name: str) -> StageProbe:
        return StageProbe(self, name)

    def add(self, stage: str, rec: StageRecord) -> None:
        self.records[stage].append(rec)

    def add_simulated(self, stage: str, seconds: float) -> None:
        """Record engine-simulated time (no CPU/memory — it never ran here)."""
        self.records[stage].append(StageRecord(float(seconds), 0.0, 0.0, 0.0))

    def mean(self, stage: str) -> StageRecord:
        rs = self.records.get(stage, [])
        if not rs:
            return StageRecord(0.0, 0.0, 0.0, 0.0)
        n = len(rs)
        return StageRecord(
            sum(r.seconds for r in rs) / n,
            sum(r.cpu_percent for r in rs) / n,
            sum(r.mem_mb for r in rs) / n,
            sum(r.rss_mb for r in rs) / n,
        )

    def table(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for s in self.STAGES + self.SIM_STAGES:
            m = self.mean(s)
            out[s] = {
                "cpu_percent": round(m.cpu_percent, 2),
                "memory_mb": round(max(m.mem_mb, m.rss_mb), 2),
                "time_s": round(m.seconds, 4),
            }
        return out
