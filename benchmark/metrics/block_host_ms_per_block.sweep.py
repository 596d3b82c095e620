"""Host milliseconds a block of the block loop (``engine/fused.py``):
the program's ``fused.block_loop`` span over the blocks it counts, the
median over the run's unprofiled jobs."""

from benchmark.program_spans import median


def read(ctx):
    return median("fused.block_loop", lambda r: r.dur_ns / 1e6 / r.n)
