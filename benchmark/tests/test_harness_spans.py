"""The readers of the program's own spans (``benchmark/program_spans.py``
and the metrics that use it): the median of the unprofiled records, no
reading without one, and a reading in a traced run on the CPU.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import collections
import json
import sys

import pytest

from conftest import ROOT, tiny_cell

from benchmark import harness

# metric: (span it reads, the reading of a record of dur_ms and n)
READERS = {
    "block_host_ms_per_block.sweep":
        ("fused.block_loop", lambda ms, n: ms / n),
    "download_host_ms_per_job.sweep": ("fused.download", lambda ms, n: ms),
    "render_inputs_ms.preview": ("render.inputs", lambda ms, n: ms),
}


def _record(name, ms, n=4, profiled=False):
    from skred_tpu_torch import spans

    r = spans.span(name, n)
    r.id, r.parent, r.start_ns = 1, None, 0
    r.dur_ns, r.profiled = int(ms * 1e6), profiled
    return r


@pytest.fixture
def ring(monkeypatch):
    """The program's ring, emptied for the test; returns it."""
    from skred_tpu_torch import spans

    fresh = collections.deque(maxlen=spans.RING)
    monkeypatch.setattr(spans, "_ring", fresh)
    return fresh


@pytest.mark.parametrize("metric", sorted(READERS))
def test_median_of_the_unprofiled_records(metric, ring):
    name, reading = READERS[metric]
    read = harness.reader(metric)
    assert read(None) is None
    ring.extend([_record(name, 1000.0, profiled=True),
                 _record("fused.block", 999.0)])
    assert read(None) is None
    ring.extend([_record(name, ms) for ms in (8.0, 2.0, 4.0, 6.0, 30.0)])
    assert read(None) == pytest.approx(reading(6.0, 4))


def test_no_reading_from_a_program_without_spans(monkeypatch):
    import skred_tpu_torch

    monkeypatch.setitem(sys.modules, "skred_tpu_torch.spans", None)
    monkeypatch.delattr(skred_tpu_torch, "spans", raising=False)
    for metric in READERS:
        assert harness.reader(metric)(None) is None


def test_loaded_by_the_forbidden_module_check():
    """``test_harness_imports.test_loaded_modules_in_a_process`` loads
    every reader that ``BENCHMARK.json`` names: these are among them,
    each on the cells that record its span."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    layer = {m["name"]: m for m in bench["per_layer"]}
    for metric, (name, _) in READERS.items():
        kind = "preview" if name.startswith("render.") else "sweep"
        assert layer[metric]["source"] == "program_span"
        assert all(c.endswith("." + kind)
                   for c in layer[metric]["workloads"])


@pytest.mark.parametrize("cell,audio_s,metrics", [
    ("stress64.sweep", 0.02, ["block_host_ms_per_block.sweep",
                              "download_host_ms_per_job.sweep"]),
    ("stress64.preview", 0.024, ["render_inputs_ms.preview"])])
def test_read_in_a_traced_run_on_the_cpu(cell, audio_s, metrics, run_cpu):
    rc, res = run_cpu(tiny_cell(cell, audio_s), trace=True)
    assert rc == 0 and res["correct"]
    for m in metrics:
        assert res["metrics"][m]["unit"] == "ms"
        assert res["metrics"][m]["value"] > 0
