"""A run's ``correct`` against the faults a cell can have: the harness's
look for a card skipped, the rest of a run driven on the CPU at a cut
size, with the timed path broken underneath (the program's render
wrapped).  Each fault has to turn ``correct`` false; the unbroken run
reads true.  The cells run on one card, so no exchange between cards
can be left out."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import tiny_cell

N = 512


def state_unchanged(out):
    """Every block renders from the first block's state: the first block
    again and again."""
    out = np.array(out)
    reps = -(-out.shape[-2] // N)
    first = out[..., :N, :]
    out[...] = np.concatenate([first] * reps, axis=-2)[..., :out.shape[-2], :]
    return out


def half_left_out(out):
    """Half of the batch's rows never rendered."""
    out = np.array(out)
    out[out.shape[0] // 2:] = 0.0
    return out


def answer_altered(out):
    """One sample of every answer altered where it is produced: the
    quietest of samples 600-999 of the left channel, by 0.1 (a
    louder one may lie past full scale, where the 16-bit WAV clips it
    and the answer stays the same)."""
    out = np.array(out)
    x = out[..., 600:1000, 0]
    t = np.argmin(np.abs(x), axis=-1)[..., None]
    np.put_along_axis(x, t, np.take_along_axis(x, t, -1) + 0.1, -1)
    return out


def loud_altered(out):
    """The loudest sample of every answer altered by 0.1 where it is
    produced: past full scale a 16-bit WAV clips it alike, so only the
    float audio can show it."""
    out = np.array(out)
    x = out[..., 0]
    t = np.argmax(np.abs(x), axis=-1)[..., None]
    v = np.take_along_axis(x, t, -1)
    np.put_along_axis(x, t, v + 0.1 * np.sign(v), -1)
    return out


@pytest.fixture
def broken(monkeypatch):
    def use(module, name, fault):
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, **kw: fault(real(*a, **kw)))
    return use


@pytest.mark.parametrize("fault", [None, state_unchanged, half_left_out,
                                   answer_altered],
                         ids=["sound", "state_unchanged", "half_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("cell", ["stress64.sweep", "noise64.sweep"])
def test_sweep(cell, fault, run_cpu, broken):
    from skred_tpu_torch.engine import fused

    c = tiny_cell(cell, 0.03)
    if fault is not None:
        broken(fused, "render_fused", fault)
    rc, res = run_cpu(c)
    assert rc == 0
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("fault", [None, state_unchanged, answer_altered,
                                   loud_altered],
                         ids=["sound", "state_unchanged", "answer_altered",
                              "loud_altered"])
def test_preview(fault, run_cpu, broken):
    import skred_tpu_torch.engine as engine

    c = tiny_cell("stress64.preview", 0.024)
    if fault is not None:
        broken(engine, "render_timeline", fault)
    rc, res = run_cpu(c)
    assert rc == 0
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res["checks"])[0] == "gap_db"
    if fault is loud_altered:
        assert res["checks"]["wav_gap_db"]["value"] \
            <= res["checks"]["wav_gap_db"]["limit"], res["checks"]


@pytest.mark.parametrize("cell,audio_s,layer", [
    ("stress64.sweep", 0.02, "aten_ops_per_block.sweep"),
    ("stress64.preview", 0.024, "compile_ms.preview")])
def test_traced_run_on_the_cpu(cell, audio_s, layer, run_cpu):
    """The traced path end to end (no device activity on the CPU: the
    device readers find nothing and are left out)."""
    rc, res = run_cpu(tiny_cell(cell, audio_s), trace=True)
    assert rc == 0 and res["correct"]
    assert layer in res["metrics"]
    assert not any(k.startswith(("kernel", "compat_"))
                   for k in res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"
