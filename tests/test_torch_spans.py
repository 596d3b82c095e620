"""The port's span recorder (``skred_tpu_torch/spans.py``) on its render
paths, on the CPU.

A fused render and a REPL render record their trees of spans with the
counts their readers use; under ``torch.profiler`` every span is a
``user_annotation`` event nested as recorded, and outside it
``record_function`` is never entered; the ring keeps the newest records
at its bound; the spans change no sample of the audio.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from skred_tpu_torch import spans
from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.engine import fused
from skred_tpu_torch.engine import render as engine_render
from skred_tpu_torch.frontends import repl
from skred_tpu_torch.host import timeline
from skred_tpu_torch.parallel import batch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "corpus"
STRESS64 = (CORPUS / "stress64.sk").read_text().splitlines()
BLOCKS = 3
SHORT = ["v0 w0 f440 a2", "v1 w1 f220 a3 p0.5"]


class _NoSpan:
    """``spans.span`` replaced: records nothing, opens nothing."""

    def __init__(self, name, n=0):
        self.n, self.dur_ns = n, 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def stress64_batch():
    """stress64 at 2 rows (the script and a variant) and 3 blocks,
    packed: two tiers."""
    seconds = BLOCKS * 512 / 44100
    bank = WaveBank()
    tls = [timeline.compile_script(lines, seconds, bank=bank,
                                   script_dir=CORPUS)
           for lines in (STRESS64, STRESS64 + ["v0 a2"])]
    st = batch.pack_stacked(batch.stack_timelines(tls))
    assert st.num_blocks == BLOCKS and len(st.tiers) == 2
    return st


def _recorded(fn):
    """(result, the records ``fn`` added)."""
    last = max((r.id for r in spans.records()), default=0)
    out = fn()
    return out, [r for r in spans.records() if r.id > last]


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.id]


def _one(recs, name):
    got = [r for r in recs if r.name == name]
    assert len(got) == 1, (name, got)
    return got[0]


def test_fused_render_records_its_tree(stress64_batch):
    st = stress64_batch
    out, recs = _recorded(lambda: fused.render_fused(st, device="cpu"))
    top = [r for r in recs if r.parent is None]
    assert [r.name for r in top] == ["fused.render"]
    render = top[0]
    assert [r.name for r in _children(recs, render)] == [
        "fused.pack", "fused.prepare", "fused.block_loop", "fused.download"]
    loop = _one(recs, "fused.block_loop")
    assert loop.n == BLOCKS
    blocks = _children(recs, loop)
    assert [b.name for b in blocks] == ["fused.block"] * BLOCKS
    for b in blocks:
        inner = _children(recs, b)
        names = [r.name for r in inner]
        assert names[0] == "fused.ops" and names[-2:] == [
            "fused.mix", "fused.volume"]
        tiers = [r for r in inner if r.name == "fused.tier"]
        assert len(tiers) == len(st.tiers)
        for t in tiers:
            assert [r.name for r in _children(recs, t)] == ["kernel.tier"]
    assert out.shape == (st.batch, BLOCKS * st.block, 2)
    for r in recs:
        assert r.dur_ns >= 0 and not r.profiled
        if r.parent is not None:
            p = next(q for q in recs if q.id == r.parent)
            assert p.start_ns <= r.start_ns
            assert r.start_ns + r.dur_ns <= p.start_ns + p.dur_ns


def test_repl_render_records_its_tree(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    wav = tmp_path / "out.wav"
    _, recs = _recorded(lambda: repl._render(list(SHORT), 0.05, str(wav),
                                             WaveBank(), "cpu"))
    assert wav.exists()
    render = _one(recs, "repl.render")
    assert render.parent is None
    assert [r.name for r in _children(recs, render)] == [
        "repl.compile", "render.timeline", "repl.write_wav"]
    tl = timeline.compile_script(list(SHORT), 0.05, bank=WaveBank(),
                                 script_dir=tmp_path)
    assert _one(recs, "repl.compile").n == tl.num_segments
    rt = _one(recs, "render.timeline")
    names = [r.name for r in _children(recs, rt)]
    assert names[0] == "render.inputs"
    assert set(names[1:]) == {"render.chunk", "render.download"}
    inputs = _one(recs, "render.inputs")
    noise = _one(recs, "render.noise")
    assert noise.parent == inputs.id
    chunks = [r for r in recs if r.name == "render.chunk"]
    assert len(chunks) == -(-tl.num_blocks // engine_render.CHUNK)
    for c in chunks:
        assert [r.name for r in _children(recs, c)] == ["kernel.compat"]
    down = [r for r in recs if r.name == "render.download"]
    assert len(down) == len(chunks)
    said = capsys.readouterr().out
    assert f"in {render.dur_ns / 1e9:.2f}s ({tl.num_segments} segments)" \
        in said


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def test_spans_are_profiler_annotations_nested_as_recorded(
        stress64_batch, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, recs = _recorded(
            lambda: fused.render_fused(stress64_batch, device="cpu"))
    assert recs and all(r.profiled for r in recs)
    events = _annotations(prof, tmp_path)
    by_name = {}
    for e in sorted(events, key=lambda e: float(e["ts"])):
        by_name.setdefault(e["name"], []).append(e)
    at = {}
    for name in {r.name for r in recs}:
        mine = sorted((r for r in recs if r.name == name),
                      key=lambda r: r.start_ns)
        assert len(by_name.get(name, [])) == len(mine), name
        at.update({r.id: e for r, e in zip(mine, by_name[name])})
    for r in recs:
        if r.parent is None:
            continue
        e, p = at[r.id], at[r.parent]
        assert float(p["ts"]) <= float(e["ts"])
        assert (float(e["ts"]) + float(e["dur"])
                <= float(p["ts"]) + float(p["dur"]) + 1.0)


def test_no_annotation_outside_the_profiler(stress64_batch, monkeypatch):
    import torch.autograd.profiler as prof

    def refuse(*a, **k):
        raise AssertionError("record_function entered outside the profiler")

    monkeypatch.setattr(prof, "record_function", refuse)
    _, recs = _recorded(
        lambda: fused.render_fused(stress64_batch, device="cpu"))
    assert recs and not any(r.profiled for r in recs)


def test_ring_keeps_the_newest_at_its_bound():
    for i in range(spans.RING + 10):
        with spans.span("test.ring", i):
            pass
    recs = spans.records()
    assert len(recs) == spans.RING
    assert [r.n for r in recs[-3:]] == [spans.RING + 7, spans.RING + 8,
                                        spans.RING + 9]
    assert recs[0].n == 10
    assert [r.id for r in recs] == list(range(recs[0].id,
                                              recs[0].id + spans.RING))


def test_spans_change_no_sample(stress64_batch, monkeypatch, tmp_path):
    traced = fused.render_fused(stress64_batch, device="cpu")
    monkeypatch.chdir(tmp_path)
    repl._render(list(SHORT), 0.05, "traced.wav", WaveBank(), "cpu")
    monkeypatch.setattr(spans, "span", _NoSpan)
    _, recs = _recorded(
        lambda: fused.render_fused(stress64_batch, device="cpu"))
    assert recs == []
    bare = fused.render_fused(stress64_batch, device="cpu")
    assert traced.dtype == bare.dtype and np.array_equal(traced, bare)
    repl._render(list(SHORT), 0.05, "bare.wav", WaveBank(), "cpu")
    assert (tmp_path / "traced.wav").read_bytes() \
        == (tmp_path / "bare.wav").read_bytes()
