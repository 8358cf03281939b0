"""Device milliseconds a traced step spends in Mamba-2's causal conv
kernels: the forward (`causal_conv_fwd_kernel`) and the backward's two
launches (`causal_conv_bwd_kernel`, `causal_conv_reduce_kernel`), by their
symbols in the profiler's trace. A program without them reads nothing."""
import re

from p2pbench import readers

CONV_KERNELS = re.compile(r"causal_conv_(fwd|bwd|reduce)_kernel")


def read(ctx):
    s = readers.kernel_s_per_step(ctx, CONV_KERNELS)
    return None if s is None else 1e3 * s
