"""The port's span recorder: named host intervals on its render paths.

``span(name, n=0)`` is a context manager.  On exit it appends one record
to a bounded ring in memory (the newest ``RING`` records; the oldest are
dropped): its ``name``, a sequential ``id``, the ``parent`` span's id on
this thread (None at the top level, so every span of one render or
request has that render's top-level span as its ancestor), ``start_ns``
and ``dur_ns`` from ``time.perf_counter_ns()``, an integer ``n`` the
span carries (a count that a reader or a print uses, such as the blocks
of a loop; the code inside may set it before the span closes) and
``profiled``, whether a ``torch.profiler`` was recording.  ``records()`` returns a copy of the ring; nothing else
exports it.

Under the profiler a span also opens ``torch.profiler.record_function``
with its name, so it is a ``user_annotation`` event of the same trace as
the device's kernels and copies.  Outside the profiler it does not: that
call costs about ten times the rest of a span.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch.autograd.profiler as _profiler

RING = 65536

_ring = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()


class span:
    """One span, and its record once it has closed."""

    __slots__ = ("name", "id", "parent", "start_ns", "dur_ns", "n",
                 "profiled", "_annotation")

    def __init__(self, name: str, n: int = 0):
        self.name = name
        self.n = n
        self.dur_ns = None

    def __enter__(self) -> "span":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self.profiled = _profiler._is_profiler_enabled
        self._annotation = None
        if self.profiled:
            self._annotation = _profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_ns = time.perf_counter_ns() - self.start_ns
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        _local.stack.pop()
        _ring.append(self)
        return False



def records() -> list:
    """The ring's records, oldest first (a copy of the ring)."""
    return list(_ring)
