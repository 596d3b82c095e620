"""The program's kernels' share of their roofline: the least time a
block of the workload can take on the card (``benchmark/roofline.py``:
the workload's operations and bytes against the card's published peaks)
over the kernels' device time a block."""

from benchmark.trace import is_port_kernel


def read(ctx):
    ms = ctx.trace.device_ms(lambda n: is_port_kernel(n, ctx.port_kernels))
    if not ms or ctx.least_s_per_block is None:
        return None
    return 100.0 * ctx.least_s_per_block * 1e3 / (ms / ctx.blocks)
