"""The program's own span records (``skred_tpu_torch/spans.py``), as the
per-layer readers take them at the end of a run.

A reader takes the median over the run's records of one span that were
taken with no profiler running: in a ``--trace 1`` run those are the
warm job or requests and every one after the traced stretch, so the
reading is free of the profiler's cost.  A program without the recorder
(an older tree) gives no reading, and neither does a run that recorded
no such span.
"""

from __future__ import annotations

import statistics


def median(name: str, value):
    """The median of ``value(record)`` over the unprofiled records of the
    span ``name``, or None where there is none."""
    try:
        from skred_tpu_torch import spans
    except ImportError:
        return None
    vals = [value(r) for r in spans.records()
            if r.name == name and not r.profiled]
    return statistics.median(vals) if vals else None
