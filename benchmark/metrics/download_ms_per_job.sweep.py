"""Device milliseconds of device-to-host copies a job: ``render_fused``'s
copy of the audio to the host."""


def read(ctx):
    ms = sum(d for n, _, d in ctx.trace.copies if "DtoH" in n) / 1e3
    return ms / ctx.jobs if ms else None
