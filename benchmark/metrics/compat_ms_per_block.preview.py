"""Device milliseconds a block of the compat kernel (``compat_kernel``,
``csrc/compat.cu``) over the traced requests."""


def read(ctx):
    ms = ctx.trace.device_ms(lambda n: "compat_kernel" in n)
    return ms / ctx.blocks if ms else None
