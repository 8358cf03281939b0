"""The 95th percentile of every step of the window, each step timed by the
CUDA events recorded on the stream at its boundaries."""
import statistics


def read(ctx):
    ms = ctx.window["step_ms"]
    return statistics.quantiles(ms, n=100)[94] if len(ms) >= 2 else None
