"""The port's batch entry and its chunk-to-host stream render, on the CPU.

``render_batch`` routes acyclic scripts by bucket to the fused engine and
each cyclic script to the cyclic engine; every row must equal the render
of its script alone.  ``render_fused_stream`` must equal ``render_fused``
bit for bit.
"""

import pathlib
import wave

import numpy as np
import pytest
import torch

from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.engine import cyclic as tc
from skred_tpu_torch.engine import fused as tf
from skred_tpu_torch.host.timeline import compile_script
from skred_tpu_torch.parallel import batch as tb

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
STRESS64 = ROOT / "corpus" / "stress64.sk"
FB1 = ROOT / "corpus" / "fb1.sk"
NOISE64 = ROOT / "skred_tpu_torch" / "scripts" / "noise64.sk"
SECONDS = 0.1


def _alone(path, cyclic):
    tl = compile_script(path.read_text().splitlines(), SECONDS,
                        bank=WaveBank(), script_dir=path.parent)
    st = tb.pack_stacked(tb.stack_timelines([tl]), cyclic=cyclic)
    render = tc.render_cyclic if cyclic else tf.render_fused
    return render(st, device="cpu")[0]


def test_render_batch_routes_every_script(tmp_path, capsys):
    """A mixed batch with one unreadable script: the rest render, each row
    equal to its script's own render, and ``outdir`` gets one WAV each."""
    missing = tmp_path / "missing.sk"
    scripts = [STRESS64, FB1, missing, NOISE64]
    out = tb.render_batch(scripts, SECONDS, outdir=tmp_path, device="cpu")
    assert "# skipping" in capsys.readouterr().out
    assert out.shape == (3, 9 * 512, 2) and out.dtype == np.float32
    assert np.isfinite(out).all()
    for row, (path, cyclic) in enumerate([(STRESS64, False), (FB1, True),
                                          (NOISE64, False)]):
        assert np.abs(out[row]).max() > 0.01, path.name
        assert np.array_equal(out[row], _alone(path, cyclic)), path.name
        with wave.open(str(tmp_path / (path.stem + ".wav"))) as f:
            assert f.getnframes() == out.shape[1] and f.getnchannels() == 2
    assert not np.array_equal(out[0], out[2])


def test_render_batch_without_a_readable_script(tmp_path):
    out = tb.render_batch([tmp_path / "none.sk"], SECONDS, device="cpu")
    assert out.shape == (0, 0, 2)


def test_render_batch_names_what_is_not_ported(monkeypatch, capsys):
    """A script the cyclic engine's gate refuses, and engine="compat",
    take the compat engine (ported since): the fall-back names the
    gate's reason on stderr (tests/test_torch_render_batch.py holds both
    renders to render_stacked)."""
    monkeypatch.setattr(tc, "cyclic_gate", lambda st: "forced-refusal")
    out = tb.render_batch([FB1], 0.02, device="cpu")
    err = capsys.readouterr().err
    assert "forced-refusal" in err and "compat scan engine" in err
    assert out.shape == (1, 2 * 512, 2) and np.abs(out).max() > 0.01
    out = tb.render_batch([STRESS64], 0.02, engine="compat", device="cpu")
    assert "WARNING" not in capsys.readouterr().err
    assert out.shape == (1, 2 * 512, 2) and np.isfinite(out).all()
    assert np.abs(out).max() > 0.01


def test_render_fused_stream_equals_render_fused():
    tl = compile_script(STRESS64.read_text().splitlines(), 0.06,
                        bank=WaveBank(), script_dir=STRESS64.parent)
    st = tb.pack_stacked(tb.stack_timelines([tl] * 3))
    full = tf.render_fused(st, device="cpu")
    chunks = list(tf.render_fused_stream(st, chunk_blocks=4, keep_rows=2,
                                         device="cpu"))
    assert [c.shape for c in chunks] == [(2, 4 * 512, 2), (2, 2 * 512, 2)]
    assert np.array_equal(np.concatenate(chunks, axis=1), full[:2])
