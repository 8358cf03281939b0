"""The flash kernels' share of their roofline: the least time of the calls a
traced step launched (the frozen cost formulas at the cell's folded shape,
`families/zamba2.py` `flash_bound_s`, by the wrappers' `launches`) over the
kernels' device time in the trace."""
from p2pbench import readers
from p2pbench.families import zamba2


def read(ctx):
    s = readers.kernel_s_per_step(ctx, zamba2.FLASH_KERNELS)
    if s is None or not ctx.launches:
        return None
    return 100.0 * zamba2.flash_bound_s(ctx.config, ctx.cell, ctx.launches) / s
