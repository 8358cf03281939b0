"""Device milliseconds a traced step spends in the flash attention kernels:
the bf16 forward (`flash_attention_kernel_wgmma<D>`) and the backward's two
launches (`bwd_dq_wgmma<D>`, `bwd_dkdv_wgmma<D>`), by their symbols in the
profiler's trace."""
from p2pbench import readers
from p2pbench.families import zamba2


def read(ctx):
    s = readers.kernel_s_per_step(ctx, zamba2.FLASH_KERNELS)
    return None if s is None else 1e3 * s
