"""The plain reference against the program on the CPU, and the control:
the reference in bfloat16 in the program's place has to fail each
cell's limit.  Sizes are cut so that a test run holds them; the chip
runs hold the same comparisons at the cells' own sizes."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import compare, synth
from benchmark.reference import control
from benchmark.traffic import variants
from conftest import tiny_cell

SWEEPS = ["stress64.sweep", "noise64.sweep"]


def _limit(cell):
    return json.loads((harness.HERE / "limits" / f"{cell}.json")
                      .read_text())["gap_db"]


def _texts(cell, n, seed=11):
    c = harness.load_cell(cell)
    lines = variants.wire_lines(c.config["script_text"])
    fac = variants.factors(variants.rng_for(seed, 0), n, lines, 0.2, 0.3)
    return [variants.variant(lines, f) for f in fac]


def test_noise_stream_is_the_compilers():
    from benchmark.reference.frozen.timeline import noise_stream

    assert np.array_equal(synth.noise_stream(5000), noise_stream(5000))


@pytest.mark.parametrize("cell", SWEEPS)
def test_reference_against_the_fused_engine(cell):
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine.fused import render_fused
    from skred_tpu_torch.host.native import compile_script_native
    from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

    texts = _texts(cell, 2)
    bank = WaveBank()
    tls = [compile_script_native(t, 0.05, bank=bank,
                                 script_dir=pathlib.Path(".")) for t in texts]
    out = render_fused(pack_stacked(stack_timelines(tls)), device="cpu")
    gap = compare.gap_db(out, compare.render(texts, 0.05))
    assert gap < _limit(cell) - 20, gap


def test_reference_against_the_compat_engine():
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine import render_timeline
    from skred_tpu_torch.host.timeline import compile_script

    text = _texts("stress64.preview", 1)[0]
    tl = compile_script(text, 0.012, bank=WaveBank())
    out = render_timeline(tl, device="cpu")
    ref = compare.render([text], 0.012)[0]
    assert compare.gap_db(out, ref) < _limit("stress64.preview") - 20
    assert compare.gap_db(compare.wav_16(out), compare.wav_16(ref)) \
        < _limit("stress64.preview") - 20


@pytest.mark.parametrize("cell", SWEEPS + ["stress64.preview"])
def test_control_fails_the_limit(cell, capsys):
    """The reference in bfloat16 in the program's place, through a run's
    own comparison (the card check skipped, a cut size): ``correct``
    false, by the gap."""
    c = tiny_cell(cell, 0.05 if cell in SWEEPS else 0.048)
    assert control.run(c, 4294967311, 0.0, device="cpu") == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False
    gap = res["checks"]["gap_db"]
    assert gap["value"] > gap["limit"], gap


def test_gap_reads_nan_and_shape_as_failures():
    a = np.zeros((1, 4, 2), np.float32)
    b = a.copy()
    b[0, 1, 0] = np.nan
    assert compare.gap_db(b, a) == compare.NOT_FINITE_DB
    assert compare.gap_db(a[:, :3], a) == compare.NOT_FINITE_DB
    assert compare.gap_db(a, a) < -290
