"""Host milliseconds a request of the compat engine's inputs
(``engine/render.py``): the program's ``render.inputs`` span (the packed
parameters and the noise stream, built and uploaded), the median over
the run's unprofiled requests."""

from benchmark.program_spans import median


def read(ctx):
    return median("render.inputs", lambda r: r.dur_ns / 1e6)
