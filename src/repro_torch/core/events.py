"""Discrete-event ServerlessRuntime — the time model under both serverless
execution paths, and the async P2P cluster's event heap.

A numpy copy of the reference's ``repro/core/events.py``: the same classes,
the same seeded numpy streams drawn in the same order, so a seeded run
prices and orders events exactly as the reference does (held to it by
``tests/test_torch_events.py``, trace digest included). What real
serverless training is dominated by (arXiv:2105.07806): cold starts,
invocation-level variance, concurrency throttling, and failures
(arXiv:2309.14148, SPIRT):

* :class:`EventEngine` — a deterministic event heap ordered by
  ``(time, priority, insertion seq)``. The priority slot reproduces the old
  async loop's ``(clock, rank)`` tie-breaking bit-for-bit.
* :class:`RuntimeConfig` — the fault/cold-start/concurrency knobs. The
  default config is *ideal* (no faults, no cold starts, unbounded
  concurrency) and reproduces the old analytic wall-times exactly;
  :meth:`RuntimeConfig.aws_default` is a realistic Lambda preset.
* :class:`ServerlessRuntime` — simulates a per-peer Lambda fan-out on the
  engine: warm-container reuse pools keyed by ``(function, memory tier)``,
  concurrency caps with FIFO queueing, per-attempt failures retried with
  exponential backoff, and seeded straggler tail latency. Emits
  per-invocation :class:`InvocationRecord` stage timings (queue wait /
  cold start / retry) that feed ``StageMetrics``, ``ExecutionReport`` and
  ``ServerlessCost``.
* :class:`AllocationPolicy` registry — pluggable per-epoch Lambda memory
  re-sizing from the previous epoch's measured per-batch times: the
  paper's "dynamic resource allocation" made concrete. Mirrors the
  ``ExchangeProtocol`` registry pattern.

The module is dependency-light on purpose (numpy + stdlib): it knows
nothing about tensors, gradients, or dollars — callers translate.
"""
from __future__ import annotations

import abc
import bisect
import heapq
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, ClassVar, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np


# ---------------------------------------------------------------------------
# Event engine
# ---------------------------------------------------------------------------


class EventEngine:
    """Deterministic discrete-event scheduler.

    Events fire in ``(time, priority, insertion order)`` order; callbacks
    may schedule further events. ``rng`` is a seeded numpy Generator shared
    by every stochastic model riding on the engine, so a fixed seed fixes
    the whole simulation.
    """

    def __init__(
        self,
        *,
        seed: int = 0,
        rng: Optional[np.random.Generator] = None,
        tracer: Optional[Any] = None,
    ):
        self.now = 0.0
        self.processed = 0
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        # Optional repro_torch.analysis.trace.TraceRecorder: records every
        # schedule/fire for the happens-before / determinism checkers.
        # None (the default) keeps the hot loop allocation-free.
        self.tracer = tracer
        if tracer is not None:
            tracer.record("engine", time=self.now, seeded=True)
        self._heap: List[Tuple[float, int, int, Callable[[], None]]] = []
        self._seq = 0

    def schedule_at(self, time: float, fn: Callable[[], None], *, priority: int = 0):
        """Schedule ``fn`` at absolute ``time`` (clamped to not run in the past)."""
        t = max(float(time), self.now)
        if self.tracer is not None:
            self.tracer.record(
                "schedule", time=self.now, at=t, priority=priority, seq=self._seq
            )
        heapq.heappush(self._heap, (t, priority, self._seq, fn))
        self._seq += 1

    def schedule_in(self, delay: float, fn: Callable[[], None], *, priority: int = 0):
        self.schedule_at(self.now + delay, fn, priority=priority)

    def reset(self, now: float = 0.0):
        """Rewind the clock between independent simulation rounds."""
        if self._heap:
            raise RuntimeError("cannot reset an engine with pending events")
        self.now = float(now)

    def run(self) -> float:
        """Process events until the heap drains; returns the final clock."""
        while self._heap:
            t, prio, seq, fn = heapq.heappop(self._heap)
            self.now = t
            self.processed += 1
            if self.tracer is not None:
                self.tracer.record("fire", time=t, priority=prio, seq=seq)
            fn()
        return self.now


# ---------------------------------------------------------------------------
# Link model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkModel:
    """Wire time of one message on a simulated inter-peer link.

    Upload/download charging for event-driven simulations goes through
    ``transfer_s``: the P2P cluster charges one per publish and one per
    edge-respecting consume (``HostMailbox.download_time_s(link=...)``
    adds the S3 round trip on top for indirected payloads), so with a
    sparse overlay graph a peer's per-step wire time is O(degree) rather
    than O(P).
    """

    bandwidth_bps: float = 1e9
    per_message_overhead_s: float = 0.0  # broker hop / TLS / framing

    def transfer_s(self, nbytes: int) -> float:
        return nbytes * 8.0 / self.bandwidth_bps + self.per_message_overhead_s


# ---------------------------------------------------------------------------
# Runtime configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RuntimeConfig:
    """Fault/cold-start/concurrency model of the simulated Lambda service.

    The zero-argument default is the *ideal* runtime — no cold starts, no
    failures, no stragglers, unbounded concurrency — under which the engine
    reproduces the legacy closed-form accounting exactly (see the
    equivalence tests). Every effect is opt-in.
    """

    concurrency_limit: Optional[int] = None  # None = unbounded fan-out
    cold_start_s: float = 0.0  # container init time added to a cold invocation
    container_keepalive_s: float = 900.0  # warm pool idle TTL
    failure_rate: float = 0.0  # P(an attempt fails)
    failure_runtime_frac: float = 1.0  # fraction of the attempt burned before failing
    max_retries: int = 4  # retry budget per invocation
    retry_backoff_s: float = 0.5  # backoff = base * 2**(attempt-1)
    straggler_prob: float = 0.0  # P(invocation draws a tail latency)
    straggler_slowdown: float = 3.0  # mean extra slowdown (exponential tail)
    seed: int = 0

    @staticmethod
    def ideal() -> "RuntimeConfig":
        return RuntimeConfig()

    @staticmethod
    def aws_default() -> "RuntimeConfig":
        """Realistic Lambda figures: 1000 default account concurrency,
        seconds-scale cold starts, rare crashes, occasional stragglers."""
        return RuntimeConfig(
            concurrency_limit=1000,
            cold_start_s=2.5,
            failure_rate=0.005,
            straggler_prob=0.02,
        )


@dataclass(frozen=True)
class InstanceConfig:
    """Provisioning/boot/churn model of the simulated EC2 fleet — the
    conventional instance-based P2P baseline's counterpart to
    :class:`RuntimeConfig`.

    The zero-argument default is the *ideal* fleet — instant boot, no
    churn — under which :class:`repro_torch.core.instance.InstanceRuntime`
    reproduces the legacy closed-form Formula-(2) accounting exactly (see
    the equivalence tests). Every effect is opt-in, mirroring the
    serverless config.
    """

    boot_s: float = 0.0  # VM provision + boot delay before the first batch
    churn_prob: float = 0.0  # P(the VM dies while computing one batch)
    churn_downtime_s: float = 0.0  # detection + replacement gap (not billed)
    max_churn_redos: int = 5  # then the VM is forcibly kept up (epochs end)
    seed: int = 0

    @staticmethod
    def ideal() -> "InstanceConfig":
        return InstanceConfig()

    @staticmethod
    def aws_default() -> "InstanceConfig":
        """Realistic EC2 figures: tens-of-seconds boot (image pull + stack
        start), rare spot-style interruptions with a detection delay."""
        return InstanceConfig(
            boot_s=40.0,
            churn_prob=0.002,
            churn_downtime_s=30.0,
        )

    @staticmethod
    def gpu_default(boot_s: float = 90.0) -> "InstanceConfig":
        """GPU fleet preset: markedly slower provisioning (GPU AMI pull +
        driver/CUDA init) than a t2 boot, same interruption shape. The
        per-tier figure lives in :data:`repro_torch.core.cost.GPU_BOOT_S` —
        pass it here (this module stays dollar/tier-agnostic)."""
        return InstanceConfig(
            boot_s=float(boot_s),
            churn_prob=0.002,
            churn_downtime_s=30.0,
        )


@dataclass
class InstanceEpochResult:
    """Stage-level timing of one simulated instance-backend peer epoch.

    ``billed_s`` partitions cleanly: boot + compute + redo + wire + idle
    are billed (per-second EC2 billing runs whenever a VM exists, idle or
    not); ``downtime_s`` — the gap between a churn death and the
    replacement VM starting to boot — is the one unbilled component.
    ``makespan_s`` is the full wall-clock including that downtime.
    """

    makespan_s: float = 0.0  # epoch submit -> last event, incl. downtime
    boot_s: float = 0.0  # provisioning time paid (first boot + churn reboots)
    compute_s: float = 0.0  # productive batch execution (incl. split overhead)
    redo_s: float = 0.0  # partial batch work lost to churn, re-executed
    downtime_s: float = 0.0  # churn gaps with no VM running (NOT billed)
    wire_s: float = 0.0  # exchange upload + degree-many downloads on the link
    idle_s: float = 0.0  # billed-but-idle (e.g. sync-barrier wait)
    churn_drops: int = 0
    splits: int = 1  # micro-batches per batch under memory pressure

    @property
    def billed_s(self) -> float:
        """EC2-billed seconds: everything a running VM existed for."""
        return self.boot_s + self.compute_s + self.redo_s + self.wire_s + self.idle_s


# ---------------------------------------------------------------------------
# Per-invocation records
# ---------------------------------------------------------------------------


@dataclass
class InvocationRecord:
    """Stage-level timing of one simulated Lambda invocation."""

    index: int
    memory_mb: int
    submit_s: float
    start_s: float = 0.0  # first attempt's start
    end_s: float = 0.0  # successful completion
    exec_s: float = 0.0  # successful attempt's execution (incl. straggler factor)
    download_s: float = 0.0  # payload fetch time (e.g. shard pieces from S3)
    queue_wait_s: float = 0.0  # total time spent throttled, all attempts
    cold_start_s: float = 0.0  # container init time burned, all attempts
    cold_starts: int = 0
    straggler_factor: float = 1.0
    attempts: int = 0
    retries: int = 0
    backoff_s: float = 0.0  # total backoff waiting between attempts
    failed_s: float = 0.0  # post-init execution burned by failed attempts
    billed_s: float = 0.0  # Lambda-billed seconds across all attempts


@dataclass
class FanoutResult:
    """Outcome of one fan-out (one peer epoch) on the runtime."""

    makespan_s: float  # submit -> last completion
    memory_mb: int
    invocations: List[InvocationRecord]

    @property
    def num_cold_starts(self) -> int:
        return sum(r.cold_starts for r in self.invocations)

    @property
    def num_retries(self) -> int:
        return sum(r.retries for r in self.invocations)

    @property
    def cold_start_s_total(self) -> float:
        return sum(r.cold_start_s for r in self.invocations)

    @property
    def queue_wait_s_total(self) -> float:
        return sum(r.queue_wait_s for r in self.invocations)

    @property
    def retry_s_total(self) -> float:
        """Time burned recovering from failures: dead work + backoff."""
        return sum(r.failed_s + r.backoff_s for r in self.invocations)

    @property
    def billed_s_total(self) -> float:
        return sum(r.billed_s for r in self.invocations)

    @property
    def max_exec_s(self) -> float:
        return max((r.exec_s for r in self.invocations), default=0.0)


class FanoutTimeout(RuntimeError):
    """An invocation exhausted its retry budget against the hard timeout."""


# ---------------------------------------------------------------------------
# Warm-container pool
# ---------------------------------------------------------------------------


class _ContainerPool:
    """Warm containers keyed by (function, memory tier), AWS-style LIFO reuse.

    A container freed at ``t0`` can serve a new invocation at ``t`` iff
    ``t0 <= t <= t0 + keepalive``. Changing the memory tier (dynamic
    allocation) strands the old tier's pool — re-sizing pays cold starts
    again, which is exactly the trade-off an AllocationPolicy navigates.

    Each key's idle containers are a release-time-sorted list, so acquire
    is a bisect (most recent usable = LIFO) plus amortized-O(1) expiry
    from the stale end — the old implementation rebuilt the list and
    linearly scanned for the maximum on every acquire. ``stats`` counts
    warm hits, cold misses, and keepalive expiries for the micro-rails.
    """

    def __init__(self, keepalive_s: float):
        self.keepalive_s = keepalive_s
        self._idle: Dict[Tuple[Any, int], List[float]] = {}  # sorted ascending
        self.stats = {"hits": 0, "misses": 0, "expired": 0}

    def _expire(self, row: List[float], at: float) -> None:
        cut = bisect.bisect_left(row, at - self.keepalive_s)
        if cut:
            self.stats["expired"] += cut
            del row[:cut]

    def acquire(self, key: Tuple[Any, int], at: float) -> bool:
        """True -> warm container reused; False -> cold start."""
        row = self._idle.get(key)
        if row:
            self._expire(row, at)
            # most recently released container with release time <= at
            # (entries beyond are future releases pre-staged by the
            # batched fanout path; they are invisible until their time)
            i = bisect.bisect_right(row, at) - 1
            if i >= 0:
                row.pop(i)
                self.stats["hits"] += 1
                return True
        self.stats["misses"] += 1
        return False

    def take_available(self, key: Tuple[Any, int], at: float, want: int) -> int:
        """Batch form of ``want`` same-instant acquires: claims (and
        removes) up to ``want`` warm containers usable at ``at``, returns
        how many were claimed. Equivalent to ``want`` acquire() calls at
        the same timestamp."""
        got = 0
        row = self._idle.get(key)
        if row:
            self._expire(row, at)
            hi = bisect.bisect_right(row, at)
            got = min(want, hi)
            if got:
                del row[hi - got:hi]
        self.stats["hits"] += got
        self.stats["misses"] += want - got
        return got

    def release(self, key: Tuple[Any, int], at: float):
        row = self._idle.setdefault(key, [])
        if row and at < row[-1]:
            bisect.insort(row, at)  # rare: out-of-order release
        else:
            row.append(at)

    def release_many(self, key: Tuple[Any, int], times: Sequence[float]):
        """Batch release at ascending-sorted ``times`` (the batched fanout
        path stages a whole wave's completion releases at once)."""
        row = self._idle.setdefault(key, [])
        needs_sort = bool(row) and len(times) > 0 and row[-1] > times[0]
        row.extend(float(t) for t in times)
        if needs_sort:
            row.sort()


# ---------------------------------------------------------------------------
# ServerlessRuntime
# ---------------------------------------------------------------------------

# Fan-outs at least this large auto-select the batched (array-valued)
# engine when no tracer is attached; below it the scalar engine's
# per-event cost is negligible and its full trace stream is worth keeping.
BATCHED_FANOUT_MIN = 256


class ServerlessRuntime:
    """Simulates Lambda fan-outs on the event engine.

    One runtime instance persists warm pools and the RNG stream across
    fan-outs (epochs), so container reuse and fault sampling behave like a
    long-lived deployment; a fixed ``RuntimeConfig.seed`` makes the whole
    trajectory deterministic.
    """

    def __init__(
        self, config: Optional[RuntimeConfig] = None, *, tracer: Optional[Any] = None
    ):
        self.config = config or RuntimeConfig()
        self.rng = np.random.default_rng(self.config.seed)
        self.pool = _ContainerPool(self.config.container_keepalive_s)
        self.tracer = tracer  # optional repro_torch.analysis.trace.TraceRecorder
        self.fanouts_run = 0
        self.clock = 0.0  # deployment-lifetime clock; warm pools live on it

    def fanout(
        self,
        exec_times_s: Sequence[float],
        *,
        memory_mb: int,
        function_key: Any = 0,
        invoke_overhead_s: float = 0.0,
        timeout_s: Optional[float] = None,
        submit_time: Optional[float] = None,
        download_bytes: Optional[Sequence[int]] = None,
        link: Optional[LinkModel] = None,
        batched: Optional[bool] = None,
    ) -> FanoutResult:
        """Simulate one fan-out of ``len(exec_times_s)`` invocations.

        ``exec_times_s`` are warm, straggler-free execution times (already
        scaled to the memory tier's vCPU share). ``submit_time`` defaults
        to the runtime's own clock, which advances past each fan-out — so
        containers freed by one epoch are warm (within the keepalive TTL)
        for the next. ``download_bytes`` (with ``link``) charges each
        invocation a payload fetch — e.g. a sharded aggregator downloading
        its P-1 shard pieces before reducing them — billed like execution
        and re-paid on retries. Returns the makespan and per-invocation
        stage records; all record times are absolute on the runtime clock.

        Every stochastic choice (stragglers, per-attempt failures) is
        pre-drawn as index-keyed numpy vectors before simulation starts,
        so the two engines below consume identical randomness:

        * the *scalar* engine — one closure per invocation event on the
          :class:`EventEngine` heap (the legacy oracle; full per-event
          trace records);
        * the *batched* engine — array-valued waves with only the retry /
          completion frontier on a primitive heap, ~two orders of
          magnitude faster at P >= 10k.

        ``batched=None`` picks the batched engine for fan-outs of at
        least ``BATCHED_FANOUT_MIN`` invocations when no tracer is
        attached (the batched engine emits only the condensed ``fanout``
        trace record); pass True/False to force. Same seed, same config
        => both engines produce identical records and makespan (the
        equivalence rail in the tests).
        """
        cfg = self.config
        if submit_time is None:
            submit_time = self.clock
        submit_time = float(submit_time)
        n = len(exec_times_s)
        times = np.asarray(exec_times_s, dtype=np.float64)
        key = (function_key, int(memory_mb))
        # -- pre-draw all randomness, index-keyed (shared by both engines) --
        factors = np.ones(n, dtype=np.float64)
        if cfg.straggler_prob > 0.0:
            hits = self.rng.random(n) < cfg.straggler_prob
            k = int(hits.sum())
            if k:
                factors[hits] = 1.0 + self.rng.exponential(cfg.straggler_slowdown, k)
        # u_fail[a-1, i] decides attempt a of invocation i (attempts past
        # the retry budget never draw — they only fail by timeout)
        u_fail = None
        if cfg.failure_rate > 0.0 and cfg.max_retries > 0:
            u_fail = self.rng.random((cfg.max_retries, n))
        dl_s = np.zeros(n, dtype=np.float64)
        if download_bytes is not None and link is not None:
            dl_s = (
                np.asarray(download_bytes, dtype=np.float64).astype(np.int64)
                * 8.0 / link.bandwidth_bps
                + link.per_message_overhead_s
            )
        if batched is None:
            batched = self.tracer is None and n >= BATCHED_FANOUT_MIN
        run = self._fanout_batched if batched else self._fanout_scalar
        records, last_end = run(
            times, factors, u_fail, dl_s,
            memory_mb=int(memory_mb), key=key,
            invoke_overhead_s=invoke_overhead_s, timeout_s=timeout_s,
            submit_time=submit_time,
        )
        self.fanouts_run += 1
        self.clock = max(self.clock, last_end)
        if self.tracer is not None:
            self.tracer.record(
                "fanout",
                time=last_end,
                invocations=len(records),
                cold_starts=sum(r.cold_starts for r in records),
                retries=sum(r.retries for r in records),
            )
        return FanoutResult(
            makespan_s=last_end - submit_time,
            memory_mb=int(memory_mb),
            invocations=records,
        )

    def _fanout_scalar(
        self, times, factors, u_fail, dl_s, *,
        memory_mb, key, invoke_overhead_s, timeout_s, submit_time,
    ) -> Tuple[List[InvocationRecord], float]:
        """Legacy closure-per-event engine (oracle path, full tracing)."""
        cfg = self.config
        n = times.shape[0]
        engine = EventEngine(rng=self.rng, tracer=self.tracer)
        engine.now = submit_time
        records = [
            InvocationRecord(index=i, memory_mb=memory_mb, submit_s=submit_time)
            for i in range(n)
        ]
        capacity = cfg.concurrency_limit or math.inf
        state = {"running": 0, "last_end": submit_time}
        waiting: deque = deque()  # FIFO throttle queue of (index, enqueue time)

        def try_start(i: int):
            if state["running"] < capacity:
                state["running"] += 1
                start_attempt(i)
            else:
                waiting.append((i, engine.now))

        def release_slot():
            state["running"] -= 1
            if waiting:
                i, t_enq = waiting.popleft()
                records[i].queue_wait_s += engine.now - t_enq
                state["running"] += 1
                start_attempt(i)

        def start_attempt(i: int):
            rec = records[i]
            rec.attempts += 1
            if rec.attempts == 1:
                rec.start_s = engine.now
                rec.straggler_factor = float(factors[i])
            cold = not self.pool.acquire(key, engine.now)
            init_s = cfg.cold_start_s if cold else 0.0
            if cold:
                rec.cold_starts += 1
            exec_s = float(times[i] * rec.straggler_factor + dl_s[i])
            duration = init_s + invoke_overhead_s + exec_s
            out_of_retries = rec.attempts > cfg.max_retries
            timed_out = timeout_s is not None and duration > timeout_s
            failed = timed_out or (
                u_fail is not None
                and not out_of_retries
                and u_fail[rec.attempts - 1, i] < cfg.failure_rate
            )
            if failed and timed_out and out_of_retries:
                raise FanoutTimeout(
                    f"invocation {i} still exceeds the {timeout_s:.0f}s timeout "
                    f"after {cfg.max_retries} retries on a {memory_mb}MB function"
                )
            if failed:
                run_for = min(
                    duration * cfg.failure_runtime_frac,
                    timeout_s if timed_out else duration,
                )
                # split the burn so cold_start_s and failed_s partition the
                # attempt's time (no double-billing downstream): init burns
                # first, whatever remains was dead execution
                burned_init = min(run_for, init_s)
                rec.cold_start_s += burned_init
                rec.failed_s += run_for - burned_init
                rec.billed_s += run_for
                rec.retries += 1
                backoff = cfg.retry_backoff_s * (2.0 ** (rec.attempts - 1))
                rec.backoff_s += backoff
                # a crashed/timed-out container is not returned to the pool
                # the slot frees when the attempt dies; the retry re-enters
                # admission (FIFO) after its backoff
                engine.schedule_at(engine.now + run_for, release_slot)
                engine.schedule_at(engine.now + run_for + backoff, lambda i=i: try_start(i))
                # a straggler that burned its retry budget against the hard
                # timeout is forced back to nominal speed so the redo can fit
                if timed_out and rec.attempts >= cfg.max_retries:
                    rec.straggler_factor = 1.0
                return
            rec.cold_start_s += init_s
            rec.exec_s = float(exec_s)
            rec.download_s = float(dl_s[i])
            rec.billed_s += duration

            def complete(i=i, duration=duration):
                rec = records[i]
                rec.end_s = engine.now
                state["last_end"] = max(state["last_end"], engine.now)
                self.pool.release(key, engine.now)
                release_slot()

            engine.schedule_at(engine.now + duration, complete)

        for i in range(n):
            engine.schedule_at(submit_time, lambda i=i: try_start(i))
        engine.run()
        return records, state["last_end"]

    def _fanout_batched(
        self, times, factors, u_fail, dl_s, *,
        memory_mb, key, invoke_overhead_s, timeout_s, submit_time,
    ) -> Tuple[List[InvocationRecord], float]:
        """Array-valued fanout engine.

        The homogeneous first wave (every invocation admitted at the
        submit instant, i.e. capacity >= n) is computed as pure numpy —
        warm/cold split, durations, failure partition, completion times —
        with completion releases bulk-staged into the warm pool. Only the
        *frontier* then rides a primitive-tuple heap: retry re-arrivals
        and, under a concurrency cap, slot releases and completions. No
        Python closure is ever scheduled, and records materialize once at
        the end.

        Event ordering reproduces the scalar engine exactly: the heap is
        keyed ``(time, seq)`` and ``seq`` is advanced in the same order
        the scalar engine allocates its insertion sequence (including for
        events the batched path never needs to materialize), so ties
        resolve identically and the two engines agree to the last bit.
        """
        cfg = self.config
        n = times.shape[0]
        capacity = cfg.concurrency_limit or math.inf
        pool = self.pool
        factors = factors.copy()  # the forced-nominal rule mutates it
        rate = cfg.failure_rate
        TRY, RELEASE, COMPLETE = 0, 1, 2

        attempts = np.zeros(n, np.int64)
        start_s = np.zeros(n)
        end_s = np.zeros(n)
        exec_s = np.zeros(n)
        download_s = np.zeros(n)
        queue_wait = np.zeros(n)
        cold_s = np.zeros(n)
        cold_n = np.zeros(n, np.int64)
        retries = np.zeros(n, np.int64)
        backoff_tot = np.zeros(n)
        failed_tot = np.zeros(n)
        billed = np.zeros(n)

        heap: List[Tuple[float, int, int, int]] = []
        waiting: deque = deque()
        state = {"running": 0, "seq": 0, "last_end": submit_time}
        bounded = capacity < n  # slots can actually contend

        def timeout_msg(i: int) -> str:
            return (
                f"invocation {i} still exceeds the {timeout_s:.0f}s timeout "
                f"after {cfg.max_retries} retries on a {memory_mb}MB function"
            )

        def start_attempt(i: int, now: float):
            attempts[i] += 1
            a = int(attempts[i])
            if a == 1:
                start_s[i] = now
            cold = not pool.acquire(key, now)
            init_s = cfg.cold_start_s if cold else 0.0
            if cold:
                cold_n[i] += 1
            ex = times[i] * factors[i] + dl_s[i]
            duration = init_s + invoke_overhead_s + ex
            out_of_retries = a > cfg.max_retries
            timed_out = timeout_s is not None and duration > timeout_s
            failed = timed_out or (
                u_fail is not None
                and not out_of_retries
                and u_fail[a - 1, i] < rate
            )
            if failed and timed_out and out_of_retries:
                raise FanoutTimeout(timeout_msg(i))
            if failed:
                run_for = min(
                    duration * cfg.failure_runtime_frac,
                    timeout_s if timed_out else duration,
                )
                burned_init = min(run_for, init_s)
                cold_s[i] += burned_init
                failed_tot[i] += run_for - burned_init
                billed[i] += run_for
                retries[i] += 1
                backoff = cfg.retry_backoff_s * (2.0 ** (a - 1))
                backoff_tot[i] += backoff
                if bounded:
                    heapq.heappush(
                        heap, (now + run_for, state["seq"], RELEASE, -1)
                    )
                state["seq"] += 1  # scalar allocates this seq either way
                heapq.heappush(
                    heap, (now + run_for + backoff, state["seq"], TRY, i)
                )
                state["seq"] += 1
                if timed_out and a >= cfg.max_retries:
                    factors[i] = 1.0
                return
            cold_s[i] += init_s
            exec_s[i] = ex
            download_s[i] = dl_s[i]
            billed[i] += duration
            heapq.heappush(heap, (now + duration, state["seq"], COMPLETE, i))
            state["seq"] += 1

        def admit_next(now: float):
            state["running"] -= 1
            if waiting:
                j, t_enq = waiting.popleft()
                queue_wait[j] += now - t_enq
                state["running"] += 1
                start_attempt(j, now)

        if n and not bounded:
            # -- vectorized first wave: all n admitted at the submit instant
            warm = np.zeros(n, dtype=bool)
            warm[: pool.take_available(key, submit_time, n)] = True
            init = np.where(warm, 0.0, cfg.cold_start_s)
            cold_n += ~warm
            ex = times * factors + dl_s
            duration = init + invoke_overhead_s + ex
            if timeout_s is None:
                timed_out = np.zeros(n, dtype=bool)
            else:
                timed_out = duration > timeout_s
            oor = 1 > cfg.max_retries  # attempt 1 already out of retries
            fail_draw = (
                (u_fail[0] < rate)
                if (u_fail is not None and not oor)
                else np.zeros(n, dtype=bool)
            )
            failed = timed_out | fail_draw
            if oor and bool(np.any(failed & timed_out)):
                raise FanoutTimeout(
                    timeout_msg(int(np.argmax(failed & timed_out)))
                )
            attempts[:] = 1
            start_s[:] = submit_time
            ok = ~failed
            cold_s[ok] += init[ok]
            exec_s[ok] = ex[ok]
            download_s[ok] = dl_s[ok]
            billed[ok] += duration[ok]
            ends = submit_time + duration[ok]
            end_s[ok] = ends
            if ends.size:
                state["last_end"] = max(state["last_end"], float(ends.max()))
                pool.release_many(key, np.sort(ends))
            # seq parity with the scalar engine: n initial try_starts, then
            # (ascending index) 1 seq per success, 2 per failure
            costs = np.where(failed, 2, 1)
            seq_base = n + np.concatenate(([0], np.cumsum(costs)[:-1]))
            state["seq"] = n + int(costs.sum())
            fid = np.flatnonzero(failed)
            if fid.size:
                cap_arr = duration if timeout_s is None else np.where(
                    timed_out, timeout_s, duration
                )
                run_for = np.minimum(duration * cfg.failure_runtime_frac, cap_arr)
                burned = np.minimum(run_for, init)
                cold_s[fid] += burned[fid]
                failed_tot[fid] += (run_for - burned)[fid]
                billed[fid] += run_for[fid]
                retries[fid] += 1
                backoff = cfg.retry_backoff_s  # 2**(1-1)
                backoff_tot[fid] += backoff
                if timeout_s is not None and cfg.max_retries <= 1:
                    factors[np.flatnonzero(failed & timed_out)] = 1.0
                for i in fid:
                    heapq.heappush(
                        heap,
                        (
                            submit_time + float(run_for[i]) + backoff,
                            int(seq_base[i]) + 1,
                            TRY,
                            int(i),
                        ),
                    )
        else:
            # capacity-bound admission: same event algebra as the scalar
            # engine, but primitive heap tuples instead of closures
            heap = [(submit_time, i, TRY, i) for i in range(n)]
            heapq.heapify(heap)
            state["seq"] = n

        while heap:
            now, _seq, kind, i = heapq.heappop(heap)
            if kind == TRY:
                # when capacity >= n slots can never contend (an invocation
                # has at most one outstanding attempt), so admission is
                # unconditional and slot bookkeeping is skipped entirely
                if not bounded:
                    start_attempt(i, now)
                elif state["running"] < capacity:
                    state["running"] += 1
                    start_attempt(i, now)
                else:
                    waiting.append((i, now))
            elif kind == RELEASE:
                admit_next(now)
            else:  # COMPLETE
                end_s[i] = now
                state["last_end"] = max(state["last_end"], now)
                pool.release(key, now)
                if bounded:
                    admit_next(now)

        records = [
            InvocationRecord(
                index=i,
                memory_mb=memory_mb,
                submit_s=submit_time,
                start_s=float(start_s[i]),
                end_s=float(end_s[i]),
                exec_s=float(exec_s[i]),
                download_s=float(download_s[i]),
                queue_wait_s=float(queue_wait[i]),
                cold_start_s=float(cold_s[i]),
                cold_starts=int(cold_n[i]),
                straggler_factor=float(factors[i]),
                attempts=int(attempts[i]),
                retries=int(retries[i]),
                backoff_s=float(backoff_tot[i]),
                failed_s=float(failed_tot[i]),
                billed_s=float(billed[i]),
            )
            for i in range(n)
        ]
        return records, state["last_end"]


# ---------------------------------------------------------------------------
# AllocationPolicy registry (mirrors the ExchangeProtocol registry)
# ---------------------------------------------------------------------------


class AllocationPolicy(abc.ABC):
    """Per-epoch Lambda memory sizing — the paper's "dynamic resource
    allocation" as a pluggable policy.

    ``memory_mb`` sees the planner's static minimum (the smallest tier the
    model fits in) and the peer's fan-out history, and returns a memory
    suggestion; the executor clamps it to ``[planned_mb, LAMBDA cap]`` and
    rounds to the 64 MB tier grid. Lambda vCPU share scales linearly with
    memory, so raising memory buys wall-time at a dollar premium — the
    paper's headline time/cost trade-off.
    """

    name: ClassVar[str] = "?"  # set by @register_allocation

    @abc.abstractmethod
    def memory_mb(
        self, *, epoch: int, planned_mb: int, history: Sequence[FanoutResult]
    ) -> int:
        """Return the memory size for this epoch's fan-out."""

    def describe(self) -> str:
        return (self.__doc__ or "").strip().splitlines()[0] if self.__doc__ else ""


_ALLOC_REGISTRY: Dict[str, Type[AllocationPolicy]] = {}


def register_allocation(name: str):
    """Class decorator: make a policy reachable by name everywhere."""

    def deco(cls: Type[AllocationPolicy]) -> Type[AllocationPolicy]:
        if not issubclass(cls, AllocationPolicy):
            raise TypeError(f"{cls!r} must subclass AllocationPolicy")
        cls.name = name
        _ALLOC_REGISTRY[name] = cls
        return cls

    return deco


def available_allocations() -> Tuple[str, ...]:
    return tuple(sorted(_ALLOC_REGISTRY))


def get_allocation(name: str, **kwargs) -> AllocationPolicy:
    try:
        cls = _ALLOC_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown allocation policy {name!r}; registered policies: "
            f"{', '.join(available_allocations())}"
        ) from None
    return cls(**kwargs)


@register_allocation("static")
class StaticAllocation(AllocationPolicy):
    """The planner's static minimum-fit memory, every epoch (paper-faithful)."""

    def memory_mb(self, *, epoch, planned_mb, history):
        return planned_mb


@register_allocation("latency")
class LatencyTargetAllocation(AllocationPolicy):
    """Multiplicative sizing to hit a per-batch latency target.

    Lambda compute scales ~linearly with memory, so if the previous epoch's
    slowest batch ran in ``t`` seconds at ``m`` MB, hitting ``target``
    needs ``m * t / target`` MB. Shrinks (never below the planner's fit
    floor) when comfortably under target, trading wall-time back for cost.
    """

    def __init__(self, target_batch_s: float = 1.0, shrink_threshold: float = 0.6):
        self.target_batch_s = target_batch_s
        self.shrink_threshold = shrink_threshold

    def memory_mb(self, *, epoch, planned_mb, history):
        if not history:
            return planned_mb
        prev = history[-1]
        worst = prev.max_exec_s
        if worst <= 0.0:
            return prev.memory_mb
        if worst > self.target_batch_s or worst < self.shrink_threshold * self.target_batch_s:
            return int(round(prev.memory_mb * worst / self.target_batch_s))
        return prev.memory_mb


@register_allocation("aimd")
class AIMDAllocation(AllocationPolicy):
    """Additive-increase / multiplicative-decrease around a latency target.

    Conservative: grows one fixed step when the previous epoch missed the
    target (or paid retries), decays by ``decrease`` when comfortably
    under it. Converges near the cheapest tier that meets the target.
    """

    def __init__(
        self,
        target_batch_s: float = 1.0,
        increase_mb: int = 1024,
        decrease: float = 0.8,
    ):
        self.target_batch_s = target_batch_s
        self.increase_mb = increase_mb
        self.decrease = decrease

    def memory_mb(self, *, epoch, planned_mb, history):
        if not history:
            return planned_mb
        prev = history[-1]
        if prev.max_exec_s > self.target_batch_s or prev.num_retries > 0:
            return prev.memory_mb + self.increase_mb
        if prev.max_exec_s < 0.5 * self.target_batch_s:
            return int(round(prev.memory_mb * self.decrease))
        return prev.memory_mb
