"""Median milliseconds of the Python compiler (``host/timeline.py``'s
``compile_script``) inside a request, from the harness's span around it
in every request of the traced run."""

import statistics


def read(ctx):
    return 1e3 * statistics.median(ctx.compile_s) if ctx.compile_s else None
