"""The benchmark's driver: one cell, one seed, one process.

``run_cell`` builds the cell's ``P2PTrainer`` over weights and global
batches made from the seed, drives its first steps (the set-up, which
the reference follows), times ``P2PTrainer.step`` in a closed loop for
the window, optionally traces a few more steps, then frees the program
and holds what its first steps produced to the plain reference
(``reference/``). Everything that belongs to one configuration, cell or
metric is a file found by its name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py``.
"""
from __future__ import annotations

import bisect
import gc
import hashlib
import importlib
import importlib.util
import json
import math
import pkgutil
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from p2pbench import costs
from p2pbench.reference import p2p as ref_p2p
from p2pbench.reference.precision import exact_f32

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CHECKED_STEPS = 3  # the program's first steps, which the reference follows
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names


# -- the files ---------------------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT):
    """(BENCHMARK.json, the cell's file, its configuration's file) for the
    cell ``name``; raises if the three disagree."""
    manifest = load_manifest(root)
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(entries)}")
    entry = entries[name]
    cell = load_json(root / "p2pbench" / "workloads" / f"{name}.json")
    files = {c["name"]: c["file"] for c in manifest["configs"]}
    config = load_json(root / files[entry["config"]])
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: {key} {cell[key]!r} in its file, {entry[key]!r} in BENCHMARK.json")
    return manifest, cell, config


def checked_steps(cell: dict) -> int:
    """The program's first steps that the reference follows: three, or the
    cell's ``checked_steps`` where the reference of three would outlast the
    window."""
    return cell.get("checked_steps", CHECKED_STEPS)


def family(config: dict):
    return importlib.import_module(f"p2pbench.families.{config['family']}")


def part(kind: str, name: str):
    """The program's side of the ``kind`` ("exchanges", "optimizers",
    "schedules") that a cell names ``name``: ``<kind>/<name>.py``."""
    return importlib.import_module(f"p2pbench.{kind}.{name}")


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"p2pbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(manifest: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics the cell reports:
    those that list it, and those without a list whose ``moves`` it
    reports."""
    e2e = {m["name"] for m in manifest["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]}
    out = []
    for m in manifest[kind]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


# -- seeds, weights, batches -------------------------------------------------

def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of ``seed`` (weights, a batch, the codec)."""
    digest = hashlib.sha256(repr((int(seed), *tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_params(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``spec`` (``[(name, shape, init)]``) in f32 on
    ``device``: the normal ones cut from one draw of a generator on the
    device, scaled; the rest set."""
    numel = lambda shape: math.prod(shape)
    total = sum(numel(shape) for _, shape, init in spec if init[0] == "normal")
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    draw = torch.randn(total, generator=gen, device=device)
    params, at = {}, 0
    for name, shape, init in spec:
        if init[0] == "normal":
            n = numel(shape)
            params[name] = draw[at:at + n].view(shape).mul(init[1])
            at += n
        elif init[0] == "const":
            params[name] = torch.full(shape, float(init[1]), device=device)
        elif init[0] == "log_linspace":
            params[name] = torch.log(torch.linspace(init[1], init[2], shape[0], device=device))
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return params


def make_batches(fam, config: dict, cell: dict, seed: int, count: int, device) -> List[dict]:
    """Global batches 0 .. count-1 of the seed; batch i is the same whatever
    ``count``."""
    out = []
    for i in range(count):
        gen = torch.Generator(device=device).manual_seed(subseed(seed, "batch", i))
        out.append(fam.make_batch(config, cell, gen, device))
    return out


def codec_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, "codec"))


# -- the program ---------------------------------------------------------------

def build_trainer(config: dict, cell: dict, fam, device):
    """The cell's ``P2PTrainer`` (the system under test) on ``device``."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import Topology
    from repro_torch.train import P2PTrainer

    ex, opt, sch = cell["exchange"], cell["optimizer"], cell["schedule"]
    return P2PTrainer(ModelConfig(**config["model"]), part("optimizers", opt["name"]).program(opt),
                      Topology(**part("exchanges", ex["name"]).topology(ex)), cell["peers"],
                      part("schedules", sch["name"]).program(sch),
                      loss_fn=fam.program_loss(config), device=device)


def program_parameters(config: dict) -> Dict[str, torch.Tensor]:
    """The program's parameters for the configuration, on the meta device:
    their names and shapes, which the benchmark's weights must match."""
    from repro_torch import models
    from repro_torch.configs.base import ModelConfig

    model = models.init_model(ModelConfig(**config["model"]), generator=None, device="meta")
    return dict(model.named_parameters())


def initial_state(trainer, params, seed: int, device):
    from repro_torch.core import TrainState

    return TrainState(params=params, opt_state=trainer.optimizer.init(params), step=0,
                      key=codec_generator(seed, device))


def first_gradient(state, cell: dict) -> Dict[str, torch.Tensor]:
    """The first step's gradient as the optimizer got it, from its state
    after that step."""
    opt = cell["optimizer"]
    return part("optimizers", opt["name"]).first_gradient(state.opt_state, opt)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def read_counters() -> Dict[str, int]:
    """Every kernel wrapper's ``launches`` counter in the program's
    ``repro_torch.kernels`` modules, by the wrapper's name."""
    import repro_torch.kernels as kernels

    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        module = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for name, obj in vars(module).items():
            if callable(obj) and isinstance(getattr(obj, "launches", None), int):
                out[name] = obj.launches
    return out


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float32))) for k, v in tree.items()}


# -- the trace -------------------------------------------------------------

WINDOW_MARK = "p2pbench.window"
STEP_MARK = "p2pbench.step"


def _short(name: str, limit: int = 96) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."


def reduce_trace(device_events, host_events, window) -> dict:
    """The traced window's device activity: ``device_events`` and
    ``host_events`` are ``(name, start_s, end_s)``, ``window`` is (start_s,
    end_s) on the same clock. Returns the busy seconds (the union of the
    device's activities inside the window), the window's length, the
    activities, and the breakdown: the device operations with the most
    time, and the idle gaps' seconds summed by the host operation active
    at each gap's middle (the innermost one)."""
    w0, w1 = window
    acts = sorted((n, max(s, w0), min(e, w1)) for n, s, e in device_events if e > w0 and s < w1)
    spans = sorted((s, e) for _, s, e in acts)
    busy, gaps, cursor = 0.0, [], w0
    for s, e in spans:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < w1:
        gaps.append((cursor, w1))
    by_name: Dict[str, float] = {}
    for n, s, e in acts:
        by_name[_short(n)] = by_name.get(_short(n), 0.0) + (e - s)
    hosts = sorted((s, e, n) for n, s, e in host_events
                   if not n.startswith("p2pbench.") and e > w0 and s < w1)
    starts = [h[0] for h in hosts]
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid, label = (g0 + g1) / 2, "(host, between ops)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 256, -1), -1):
            if hosts[j][1] >= mid:
                label = _short(hosts[j][2])
                break
        idle[label] = idle.get(label, 0.0) + (g1 - g0)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy, "window_s": w1 - w0, "kernels": acts,
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}


def trace_steps(trainer, state, pool, start: int, steps: int, device):
    """``steps`` more steps under ``torch.profiler`` (one untraced-in-effect
    step first, then the window read), the trace reduced in memory.
    Returns (state, the reduced trace, launches per traced step)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = trainer.step(state, pool[start % len(pool)])
        sync(device)
        before = read_counters()
        with record_function(WINDOW_MARK):
            for i in range(steps):
                with record_function(STEP_MARK):
                    state, _ = trainer.step(state, pool[(start + 1 + i) % len(pool)])
            sync(device)
        after = read_counters()
    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9)
        if e.device_type() == cuda:
            if not e.name().startswith("p2pbench."):  # the marks' own ranges on the device
                dev.append(item)
        elif e.name() == WINDOW_MARK:
            window = item[1:]
        else:
            host.append(item)
    if window is None:
        raise RuntimeError("the profiler recorded no traced window")
    trace = reduce_trace(dev, host, window)
    trace["steps"] = steps
    launches = {k: (after[k] - before[k]) / steps for k in after}
    return state, trace, launches


# -- one run ---------------------------------------------------------------

class Context:
    """What a metric's ``read(ctx)`` sees: ``cell``, ``config``, ``family``,
    ``costs``, ``leaves`` {name: shape}, ``window`` (steps, seconds, units
    per step, each step's device ms and host ms, setup seconds), ``trace``
    (busy_s, window_s, kernels [(name, start_s, end_s)], steps) or None,
    ``launches`` {wrapper: launches per traced step} or None."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers held to their limits: the largest relative gap of a
    step's loss; the worst leaf's gap between the two sides' norms of the
    first gradient and of the params' change, each against the larger of
    the reference's norm of that leaf and of the median leaf. Leaves whose
    reference gradient has a root-mean-square under a thousandth of the
    median leaf's are left out of the change: Adam moves them by round-off
    alone."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))

    def worst(name, keep):
        median = statistics.median(ref[name][k] for k in keep)
        return max(abs(prog[name][k] - ref[name][k]) / max(ref[name][k], median, 1e-30)
                   for k in keep)

    rms = {k: ref["grad_norms"][k] / math.sqrt(ref["numel"][k]) for k in ref["grad_norms"]}
    floor = 1e-3 * statistics.median(rms.values())
    moved = [k for k in rms if rms[k] >= floor]
    return {"loss_gap": loss, "grad_norm_gap": worst("grad_norms", list(rms)),
            "change_norm_gap": worst("change_norms", moved)}


def reference_readings(fam, config, cell, seed: int, device, *, precision: str = "f32",
                       fault: Optional[str] = None) -> dict:
    """The reference's readings over the seed's weights and first batches
    (``reference.p2p.run_steps``), in ``precision``, with ``fault``."""
    spec = fam.reference.param_spec(config)
    params = make_params(spec, seed, device)
    batches = make_batches(fam, config, cell, seed, checked_steps(cell), device)
    with exact_f32():
        out = ref_p2p.run_steps(fam.reference_loss(config), params, batches, cell,
                                codec_generator(seed, device),
                                precision=precision, fault=fault)
    out["numel"] = {k: params[k].numel() for k in params}
    return out


def setup_program(config, cell, seed: int, device, log=lambda what: None):
    """The set-up: the trainer, its state over the seed's weights, the pool
    of global batches, and the first ``checked_steps`` steps through
    ``P2PTrainer.step`` with what they produced. Returns (trainer, state,
    pool, readings). ``log(what)`` is called after each stage."""
    fam = family(config)
    spec = fam.reference.param_spec(config)
    trainer = build_trainer(config, cell, fam, device)
    like = {k: tuple(v.shape) for k, v in program_parameters(config).items()}
    want = {name: tuple(shape) for name, shape, _ in spec}
    if like != want:
        diff = sorted(set(like.items()) ^ set(want.items()))[:6]
        raise ValueError(f"the program's parameters differ from the configuration's: {diff}")
    log("trainer built")
    params = make_params(spec, seed, device)
    pool = make_batches(fam, config, cell, seed, max(cell["pool"], checked_steps(cell)), device)
    state = initial_state(trainer, params, seed, device)
    del params
    log("weights and batches made")
    readings = {"losses": []}
    for i in range(checked_steps(cell)):
        state, metrics = trainer.step(state, pool[i])
        readings["losses"].append(float(metrics["loss"]))
        if i == 0:
            readings["grad_norms"] = norms(first_gradient(state, cell))
        log(f"step {i + 1} done")
    start = make_params(spec, seed, device)
    readings["change_norms"] = {k: float(torch.linalg.vector_norm(state.params[k] - start[k]))
                                for k in start}
    del start
    return trainer, state, pool, readings


def run_cell(name: str, cell: dict, config: dict, manifest: dict, *, seed: int, seconds: float,
             trace: bool, device, t0: float) -> dict:
    """One run of the cell: the result's keys (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with a trace ``breakdown``, and
    ``checks`` last). ``t0`` is the process's start on the host clock."""
    device = torch.device(device)
    fam = family(config)
    cuda = device.type == "cuda"
    log = lambda what: print(f"[{time.perf_counter() - t0:.3f} s] {what}", file=sys.stderr)
    trainer, state, pool, prog = setup_program(config, cell, seed, device, log)
    sync(device)

    # the window: a closed loop, the next step enqueued when step() returns
    marks, host_ms, losses = [], [], []
    stamp = _event if cuda else time.perf_counter
    retries = torch.cuda.memory_stats(device).get("num_alloc_retries", 0) if cuda else 0
    pauses = GcPauses()
    t_start = time.perf_counter()
    marks.append(stamp())
    i = checked_steps(cell)
    with pauses:
        while True:
            h0 = time.perf_counter()
            state, metrics = trainer.step(state, pool[i % len(pool)])
            h1 = time.perf_counter()
            marks.append(stamp())
            host_ms.append((h1 - h0) * 1e3)
            losses.append(metrics["loss"])
            i += 1
            if h1 - t_start >= seconds:
                break
        sync(device)
    t_end = time.perf_counter()
    if cuda:
        retries = torch.cuda.memory_stats(device).get("num_alloc_retries", 0) - retries
    steps = len(host_ms)
    step_ms = ([a.elapsed_time(b) for a, b in zip(marks, marks[1:])] if cuda else
               [(b - a) * 1e3 for a, b in zip(marks, marks[1:])])
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window = {"steps": steps, "seconds": t_end - t_start, "units": fam.units(cell),
              "step_ms": step_ms, "host_ms": host_ms, "setup_s": t_start - t0}

    traced, launches = None, None
    if trace:
        state, traced, launches = trace_steps(trainer, state, pool, i, cell["trace_steps"], device)
    leaves = {k: tuple(v.shape) for k, v in state.params.items()}
    del trainer, state, pool, metrics, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ctx = Context(cell=cell, config=config, family=fam, costs=costs, leaves=leaves,
                  window=window, trace=traced, launches=launches)
    values = {}
    for m in cell_metrics(manifest, name, "per_layer" if trace else "end_to_end"):
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    log(f"window: {steps} steps in {window['seconds']:.3f} s, host ms a step min "
        f"{min(host_ms):.1f} median {statistics.median(host_ms):.1f} max {max(host_ms):.1f}; "
        f"device ms a step median {statistics.median(step_ms):.1f} max {max(step_ms):.1f}; "
        f"{pauses.count} garbage collections took {pauses.seconds:.3f} s; "
        f"{retries} allocator retries; program freed")
    ref = reference_readings(fam, config, cell, seed, device)
    log("reference done")
    numbers = compare(prog, ref)
    checks = {k: {"value": numbers[k], "limit": limit} for k, limit in cell["limits"].items()}
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks.values())
    result = {"correct": correct, "attempted": steps, "failed": failed, "metrics": values,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if traced is not None:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = traced["breakdown"]
    result["checks"] = checks
    return result


class GcPauses:
    """Counts Python's garbage collections inside a ``with`` block and the
    seconds they took: a pause of the host that no profiler names."""

    def __init__(self):
        self.count, self.seconds, self._t = 0, 0.0, None

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.count += 1
            self.seconds += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
