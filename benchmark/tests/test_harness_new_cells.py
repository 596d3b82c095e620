"""The cells ``czfb64.cyclic_sweep`` and ``stress64.sweep4`` driven on the
CPU, as ``test_harness_faults.py`` drives the sweeps: the sound run
reads ``correct`` true, a broken render and the control read false.

``cyclic_sweep.py`` runs on a cut of czfb64 (one template, v0, with its
fans v12-v14 and v56 and the LFO v48) at 2 rows and 2 blocks: the
program's plain cyclic engine is a Python loop over frames and voices,
~2 s a voice-block for two rows, so the cell's 64 voices would take
minutes a render.  ``sweep_mesh.py`` runs over ``make_mesh(4, "cpu")``.
"""

from __future__ import annotations

import dataclasses
import re

import pytest

from conftest import tiny_cell
from test_harness_faults import answer_altered, half_left_out

TWO_BLOCKS = 2 * 512 / 44100


def _cyclic_cut():
    c = tiny_cell("czfb64.cyclic_sweep", TWO_BLOCKS)
    keep = {0, 12, 13, 14, 48, 56}
    lines = [ln for ln in c.config["script_text"].splitlines()
             if ln.startswith("#")
             or int(re.match(r"v(\d+)", ln).group(1)) in keep]
    return dataclasses.replace(
        c, config=dict(c.config, script_text="\n".join(lines) + "\n"),
        traffic=dict(c.traffic, rows=2, compare_rows=2))


@pytest.fixture
def broken(monkeypatch):
    def use(module, name, fault):
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, **kw: fault(real(*a, **kw)))
    return use


@pytest.mark.parametrize("fault", [None, half_left_out, answer_altered],
                         ids=["sound", "half_left_out", "answer_altered"])
def test_cyclic_sweep(fault, run_cpu, broken):
    from skred_tpu_torch.engine import cyclic

    if fault is not None:
        broken(cyclic, "render_cyclic", fault)
    rc, res = run_cpu(_cyclic_cut())
    assert rc == 0
    assert res["correct"] is (fault is None), res["checks"]


def test_cyclic_sweep_control(capsys):
    """The reference for feedback loops in bfloat16 in the program's
    place: ``correct`` false, by the gap."""
    import json
    import time

    from benchmark.traffic import cyclic_sweep

    rc = cyclic_sweep.run(_cyclic_cut(), 4294967311, 0.0, False,
                          time.perf_counter(), device="cpu",
                          substitute=cyclic_sweep.bfloat16)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False
    gap = res["checks"]["gap_db"]
    assert gap["value"] > gap["limit"], gap


@pytest.mark.parametrize("metric,name,reading", [
    ("cyclic_block_host_ms_per_block.cyclic_sweep", "cyclic.block_loop",
     lambda ms, n: ms / n),
    ("cyclic_download_exposed_blocks.cyclic_sweep", "cyclic.download_tail",
     lambda ms, n: n)])
def test_span_readers(metric, name, reading, monkeypatch):
    """The new readers: the median of the unprofiled records of their
    span, nothing without one (a traced run on the CPU takes minutes
    here: the profiler records every op of the plain cyclic engine)."""
    import collections

    from benchmark import harness
    from skred_tpu_torch import spans

    ring = collections.deque(maxlen=spans.RING)
    monkeypatch.setattr(spans, "_ring", ring)

    def record(ms, n, profiled=False):
        r = spans.span(name, n)
        r.id, r.parent, r.start_ns = 1, None, 0
        r.dur_ns, r.profiled = int(ms * 1e6), profiled
        return r

    read = harness.reader(metric)
    assert read(None) is None
    ring.append(record(1000.0, 9, profiled=True))
    assert read(None) is None
    ring.extend(record(ms, n) for ms, n in ((8.0, 4), (2.0, 1), (6.0, 3)))
    assert read(None) == pytest.approx(reading(6.0, 3))


@pytest.mark.parametrize("fault", [None, half_left_out, answer_altered],
                         ids=["sound", "half_left_out", "answer_altered"])
def test_sweep_mesh(fault, run_cpu, broken):
    from skred_tpu_torch.engine import fused

    c = tiny_cell("stress64.sweep4", 0.03)
    if fault is not None:
        broken(fused, "render_fused", fault)
    rc, res = run_cpu(c)
    assert rc == 0
    assert res["correct"] is (fault is None), res["checks"]


def test_sweep_mesh_renders_over_the_mesh(run_cpu, monkeypatch):
    """Every render of the run is given the cell's mesh of four."""
    from skred_tpu_torch.engine import fused

    meshes = []
    real = fused.render_fused

    def spy(*a, **kw):
        meshes.append(kw.get("mesh"))
        return real(*a, **kw)

    monkeypatch.setattr(fused, "render_fused", spy)
    rc, res = run_cpu(tiny_cell("stress64.sweep4", 0.03))
    assert rc == 0 and res["correct"]
    assert len(meshes) >= 2
    assert all(m is not None and len(m) == 4 for m in meshes)
