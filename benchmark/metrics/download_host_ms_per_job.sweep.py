"""Host milliseconds a job of ``render_fused``'s download: the program's
``fused.download`` span (the blocks' stack, the copies to the host, the
host concatenation, permute and reshape, ``.numpy()``), the median over
the run's unprofiled jobs."""

from benchmark.program_spans import median


def read(ctx):
    return median("fused.download", lambda r: r.dur_ns / 1e6)
