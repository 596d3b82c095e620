"""Host milliseconds a block of the cyclic engine's block loop
(``engine/cyclic.py``'s ``render_cyclic``): the program's
``cyclic.block_loop`` span over the blocks it counts, the median over the
run's unprofiled jobs.  A program without that span gives no reading."""

from benchmark.program_spans import median


def read(ctx):
    return median("cyclic.block_loop", lambda r: r.dur_ns / 1e6 / r.n)
