"""Blocks a job of ``render_cyclic``'s download left to wait for after
the block loop: the program's ``cyclic.download_tail`` span counts the
blocks not yet copied into the result when ``cyclic.block_loop`` closed
(the rest left the card while the loop ran, through ``render_fused``'s
``_Download``), the median over the run's unprofiled jobs.  A program
without that span gives no reading."""

from benchmark.program_spans import median


def read(ctx):
    return median("cyclic.download_tail", lambda r: r.n)
