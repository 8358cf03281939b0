"""Helpers of the metric readers in ``metrics/``: the window's and the
trace's numbers. The harness calls a reader in the cells that
``BENCHMARK.json`` lists for its metric; a reader that finds nothing to
read returns None, and the harness leaves its metric out."""
from __future__ import annotations

import importlib
import math
import statistics
from typing import Optional

def rate(ctx) -> float:
    """Units of work of every step completed in the window, over the window."""
    w = ctx.window
    return w["steps"] * w["units"] / w["seconds"]


def step_s(ctx) -> float:
    w = ctx.window
    return w["seconds"] / w["steps"]


def host_ms(ctx) -> float:
    """The median host time inside one ``step()`` call (no synchronise)."""
    return statistics.median(ctx.window["host_ms"])


def mfu(ctx) -> float:
    """Model FLOPs of a step over its time in the window, as a share of the
    peak of the precision the model computes in."""
    return 100.0 * ctx.family.train_flops(ctx.config, ctx.cell) / step_s(ctx) / ctx.family.PEAK_FLOPS


def idle_pct(ctx) -> Optional[float]:
    t = ctx.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_s_per_step(ctx, pattern) -> Optional[float]:
    """Device seconds a traced step spends in the kernels ``pattern``
    matches, or None where the trace holds none of them."""
    if ctx.trace is None:
        return None
    found = [e - s for name, s, e in ctx.trace["kernels"] if pattern.search(name)]
    return sum(found) / ctx.trace["steps"] if found else None


def codec(ctx):
    """The program's side of the cell's exchange (``exchanges/<name>.py``)."""
    return importlib.import_module(f"p2pbench.exchanges.{ctx.cell['exchange']['name']}")


def codec_s_per_step(ctx) -> Optional[float]:
    """Device seconds a traced step spends in the cell's codec kernels, by
    the symbols its exchange names (``KERNELS``), or None."""
    pattern = codec(ctx).KERNELS
    return None if pattern is None else kernel_s_per_step(ctx, pattern)


def codec_bound_s(ctx) -> float:
    """The least device time of a step's codec kernels: the cell's exchange's
    ``bound_s`` (``exchanges/<name>.py``) summed over the leaves, for the
    wrappers that launched in the traced steps."""
    ex, bound_s = ctx.cell["exchange"], codec(ctx).bound_s
    ran = {k for k, v in (ctx.launches or {}).items() if v > 0}
    return sum(bound_s(ctx.costs, ctx.cell["peers"], math.prod(shape), ex, ran)
               for shape in ctx.leaves.values())
