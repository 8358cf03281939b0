"""The codec kernels' share of their roofline: the least time their work
needs (`costs`, by the cell's exchange, for the wrappers that launched)
over their device time in the trace."""
from p2pbench import readers


def read(ctx):
    s = readers.codec_s_per_step(ctx)
    return None if s is None else 100.0 * readers.codec_bound_s(ctx) / s
