"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
steady part of the window, reduced to what the per-layer readers take.

``Tracer`` runs calls under the profiler (CPU and CUDA activity) inside
one harness span, ``bench.window``, that ends after a device
synchronise; ``summary()`` exports the trace as Chrome JSON into a
temporary file, reads it back and reduces it to a ``Summary``.  Spans are
``record_function`` ranges: the harness's own (``bench.*``) around its
calls into each layer, and any the program records.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import tempfile
import time

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float                  # union of device activity in the window
    kernels: list                  # (name, start us, dur us)
    copies: list                   # (name, start us, dur us)
    aten_top: int                  # top-level aten ops issued
    spans: list                    # (name, start us, dur us)
    gaps: list                     # (label, seconds) of each idle gap

    def device_ms(self, keep) -> float:
        """Device milliseconds of the kernels whose name ``keep`` takes."""
        return sum(d for n, _, d in self.kernels if keep(n)) / 1e3

    def top_device_ops(self, n: int = 10) -> list:
        tot = {}
        for name, _, d in self.kernels + self.copies:
            tot[name] = tot.get(name, 0.0) + d / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> list:
        tot = {}
        for label, s in self.gaps:
            tot[label] = tot.get(label, 0.0) + s
        return [[k, v] for k, v in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:n]]


class Tracer:
    """Runs calls under the profiler, inside the ``bench.window`` span."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def _sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import record_function

        self._sync()
        self.prof.__enter__()
        self.span = record_function(WINDOW)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> Summary:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return reduce_events(events)


@contextlib.contextmanager
def span_calls(module, name: str, label: str, when=None, times=None):
    """While open, ``module.name`` runs inside a ``record_function`` span
    ``label`` (where ``when()`` holds, if given) and appends its host
    seconds to ``times`` (if given): the harness's spans around its
    calls into a layer."""
    from torch.profiler import record_function

    real = getattr(module, name)

    def inner(*a, **kw):
        t = time.perf_counter()
        try:
            if when is None or when():
                with record_function(label):
                    return real(*a, **kw)
            return real(*a, **kw)
        finally:
            if times is not None:
                times.append(time.perf_counter() - t)

    setattr(module, name, inner)
    try:
        yield
    finally:
        setattr(module, name, real)


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _top_level(ops):
    """The ops (start, dur, name) of one thread that no other contains."""
    out, end = [], -1.0
    for s, d, name in sorted(ops, key=lambda o: (o[0], -o[1])):
        if s >= end:
            out.append((s, d, name))
            end = s + d
    return out


def reduce_events(events) -> Summary:
    """A Summary of Chrome-trace events (the profiler's export)."""
    X = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in X if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("trace: no bench.window span in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    inside = lambda e: w0 <= float(e["ts"]) < w1
    dev = [e for e in X if e.get("cat") in DEVICE_CATS and inside(e)]
    kernels = [(e["name"], float(e["ts"]), float(e["dur"]))
               for e in dev if e["cat"] == "kernel"]
    copies = [(e["name"], float(e["ts"]), float(e["dur"]))
              for e in dev if e["cat"] != "kernel"]
    busy = _union([(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                         w1)) for e in dev])
    busy_us = sum(e - s for s, e in busy)
    by_tid = {}
    for e in X:
        if e.get("cat") == "cpu_op" and inside(e):
            by_tid.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["dur"]), e["name"]))
    top = [o for ops in by_tid.values() for o in _top_level(ops)]
    aten_top = sum(1 for _, _, n in top if n.startswith("aten::"))
    spans = [(e["name"], float(e["ts"]), float(e["dur"])) for e in X
             if e.get("cat") == "user_annotation" and inside(e)
             and e["name"] != WINDOW]
    host = sorted(top + [(float(e["ts"]), float(e["dur"]), e["name"])
                         for e in X if e.get("cat") == "cuda_runtime"
                         and inside(e)])
    gaps = []
    starts = [h[0] for h in host]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((_label((s + e) / 2, spans, host, starts),
                         (e - s) / 1e6))
    return Summary((w1 - w0) / 1e6, busy_us / 1e6, kernels, copies,
                   aten_top, spans, gaps)


def _label(t, spans, host, starts) -> str:
    """What the host was doing at time ``t``: the innermost span around
    it, and the op or runtime call that began last before it and holds
    it ("python" where none does)."""
    inner = None
    for name, s, d in spans:
        if s <= t < s + d and (inner is None or d < inner[1]):
            inner = (name, d)
    op = "python"
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 32, -1), -1):
        s, d, name = host[j]
        if s <= t < s + d:
            op = name
            break
    return f"{inner[0] if inner else WINDOW}: {op}"


def is_port_kernel(name: str, port_kernels) -> bool:
    """Whether a device kernel's name is one of the program's own
    (``void tier_keyed_kernel<...>(...)`` is ``tier_keyed_kernel``)."""
    return any(re.search(rf"\b{k}\b", name) for k in port_kernels)
