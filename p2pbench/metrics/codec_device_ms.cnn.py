"""Device milliseconds a step spends in the exchange codec's kernels (the
QSGD kernels of `qsgd.cu`, the select and scatter of `topk.cu`: the
symbols the cell's exchange names), from the profiler's trace."""
from p2pbench import readers


def read(ctx):
    s = readers.codec_s_per_step(ctx)
    return None if s is None else 1e3 * s
