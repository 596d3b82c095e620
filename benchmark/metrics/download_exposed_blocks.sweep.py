"""Blocks a job of ``render_fused``'s download left to wait for after
the block loop: the program's ``fused.download_tail`` span counts the
blocks not yet copied into the result when ``fused.block_loop`` closed
(the rest left the card while the loop ran), the median over the run's
unprofiled jobs.  A program without that span gives no reading."""

from benchmark.program_spans import median


def read(ctx):
    return median("fused.download_tail", lambda r: r.n)
