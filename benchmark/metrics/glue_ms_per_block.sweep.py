"""Device milliseconds a block of every kernel that is not one of the
program's own (``csrc/*.cu``): the block loop's torch glue."""

from benchmark.trace import is_port_kernel


def read(ctx):
    ms = ctx.trace.device_ms(lambda n: not is_port_kernel(n, ctx.port_kernels))
    return ms / ctx.blocks if ms else None
