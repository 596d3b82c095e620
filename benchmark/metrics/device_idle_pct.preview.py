"""The device's idle share of the traced stretch: 100 less the union of
device activity (kernels, copies, sets) over the stretch's length."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s else None
