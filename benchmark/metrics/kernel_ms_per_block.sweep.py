"""Device milliseconds a block of the program's own kernels
(``engine/kernels``, ``csrc/*.cu``)."""

from benchmark.trace import is_port_kernel


def read(ctx):
    ms = ctx.trace.device_ms(lambda n: is_port_kernel(n, ctx.port_kernels))
    return ms / ctx.blocks if ms else None
