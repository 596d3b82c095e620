"""Top-level aten operations the host issued in the traced job, a
block: the block loop's (``engine/fused.py``) host work."""


def read(ctx):
    return ctx.trace.aten_top / ctx.blocks if ctx.trace.aten_top else None
