"""Event-trace recording and dynamic determinism checks.

The port's copy of the reference's ``repro/analysis/trace.py``. The
simulators (``EventEngine``, ``ServerlessRuntime``, ``HostMailbox``,
``LocalP2PCluster``) accept an optional ``tracer``; when given a
:class:`TraceRecorder` they emit one canonical event per schedule / fire /
publish / consume / miss / blocked, the same events with the same fields
as the reference's, so a seeded run of the port has the reference's
digest. The checks over a trace:

* ``RT001`` **latest-wins-overwrite** (warning) — a publish replaced a
  same-epoch message in the same ``(peer, shard)`` register that no
  consumer ever read.
* ``RT002`` **same-instant-tie** (info) — two events fired at identical
  ``(time, priority)``; the engine breaks the tie by insertion sequence.
* ``RT003`` **trace-divergence** (error) — two same-seed runs of one
  scenario produced different digests.
* ``RT004`` **unseeded-engine** (error) — an engine joined the trace
  without announcing a seeded RNG.

Digests are sha256 over the canonical event tuples, so "identical trace"
means identical event kinds, orders, times, and payload metadata — not
just identical final metrics.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.common import Finding

PASS_NAME = "trace"


class TraceRecorder:
    """Append-only canonical event log with a stable digest.

    ``record(kind, **fields)`` canonicalizes the event as ``(kind, sorted
    (field, value) pairs)``; values must be hashable scalars (numbers,
    strings, bools, None, or tuples thereof). The digest is order- and
    value-sensitive by construction.
    """

    def __init__(self) -> None:
        self.events: List[Tuple[Any, ...]] = []

    def record(self, kind: str, **fields: Any) -> None:
        self.events.append((kind,) + tuple(sorted(fields.items())))

    def __len__(self) -> int:
        return len(self.events)

    def digest(self) -> str:
        h = hashlib.sha256()
        for ev in self.events:
            h.update(repr(ev).encode())
        return h.hexdigest()


def _fields(event: Tuple[Any, ...]) -> Dict[str, Any]:
    return dict(event[1:])


def check_trace(
    events: List[Tuple[Any, ...]], *, label: str = "<trace>"
) -> List[Finding]:
    """Static checks over one recorded trace (RT001 / RT002 / RT004)."""
    findings: List[Finding] = []
    # (peer, shard) -> index of the last unconsumed publish at that epoch
    live: Dict[Tuple[Any, Any], Tuple[int, Any]] = {}
    last_fire: Optional[Tuple[Any, Any]] = None
    for i, ev in enumerate(events):
        kind, f = ev[0], _fields(ev)
        if kind == "engine" and not f.get("seeded", False):
            findings.append(Finding(
                rule="RT004", severity="error", path=label, line=i + 1,
                message="event engine joined the trace without a seeded RNG; "
                        "same-seed reproducibility is impossible",
                pass_name=PASS_NAME,
            ))
        elif kind == "publish":
            key = (f.get("actor"), f.get("shard"))
            prev = live.get(key)
            if prev is not None and prev[1] == f.get("epoch"):
                findings.append(Finding(
                    rule="RT001", severity="warning", path=label, line=i + 1,
                    message=(
                        f"peer {f.get('actor')} shard {f.get('shard')!r} "
                        f"re-published epoch {f.get('epoch')} before any "
                        "consumer read the previous message — the earlier "
                        "gradient was silently overwritten (latest-wins race)"
                    ),
                    pass_name=PASS_NAME,
                ))
            live[key] = (i, f.get("epoch"))
        elif kind == "consume":
            live.pop((f.get("peer"), f.get("shard")), None)
        elif kind == "fire":
            tie = (f.get("time"), f.get("priority"))
            if last_fire is not None and tie == last_fire:
                findings.append(Finding(
                    rule="RT002", severity="info", path=label, line=i + 1,
                    message=(
                        f"two events fired at identical (time={tie[0]}, "
                        f"priority={tie[1]}); ordering relies on the "
                        "engine's insertion-sequence tie-break"
                    ),
                    pass_name=PASS_NAME,
                ))
            last_fire = tie
    return findings


# ---------------------------------------------------------------------------
# Double-run determinism differ
# ---------------------------------------------------------------------------


def diff_runs(
    scenario: str, run: Callable[[TraceRecorder], None]
) -> Tuple[List[Finding], TraceRecorder]:
    """Run ``run(tracer)`` twice with fresh recorders; RT003 on divergence.

    Returns the findings plus the first run's recorder so callers can
    layer :func:`check_trace` on the same trace without a third run.
    """
    first, second = TraceRecorder(), TraceRecorder()
    run(first)
    run(second)
    findings: List[Finding] = []
    if first.digest() != second.digest():
        line = 1 + next(
            (i for i, (a, b) in enumerate(zip(first.events, second.events))
             if a != b),
            min(len(first.events), len(second.events)),
        )
        findings.append(Finding(
            rule="RT003", severity="error", path=f"<trace:{scenario}>",
            line=line,
            message=(
                f"same-seed double run of {scenario!r} diverged: "
                f"{first.digest()[:12]} != {second.digest()[:12]} "
                f"(first differing event #{line} of "
                f"{len(first.events)}/{len(second.events)})"
            ),
            pass_name=PASS_NAME,
        ))
    return findings, first


def _run_serverless(tracer: TraceRecorder) -> None:
    """Serverless fan-out with every stochastic effect switched on."""
    from repro_torch.core.events import RuntimeConfig, ServerlessRuntime

    cfg = RuntimeConfig(
        concurrency_limit=3, cold_start_s=1.5, failure_rate=0.3,
        straggler_prob=0.3, straggler_slowdown=2.0, seed=7,
    )
    rt = ServerlessRuntime(cfg, tracer=tracer)
    for _ in range(3):  # warm pools + RNG stream persist across fan-outs
        rt.fanout([0.5, 1.0, 0.25, 0.75, 0.5, 1.25], memory_mb=1024)


def _run_cluster(tracer: TraceRecorder, *, device: Any = "cuda", init_params=None):
    """Async P2P cluster with churn on and a pinned virtual compute time,
    on ``device`` from ``init_params`` (the model's seeded init when None);
    returns the cluster."""
    from repro_torch.configs import get_config
    from repro_torch.core.simulate import LocalP2PCluster
    from repro_torch.data import make_dataset
    from repro_torch.optim import sgd

    cluster = LocalP2PCluster(
        get_config("squeezenet1.1"),
        make_dataset("mnist", size=64, image_hw=8, channels=1),
        num_peers=2, batch_size=8, batches_per_epoch=1,
        optimizer=sgd(momentum=0.0), lr=0.05, sync=False,
        churn_prob=0.3, churn_downtime_s=0.5,
        sim_compute_s=lambda rank, epoch: 0.1 + 0.01 * rank,
        tracer=tracer, seed=11, init_params=init_params, device=device,
    )
    for epoch in range(2):
        cluster.run_epoch_async(epoch)
    return cluster
