"""The port's command line (``python -m skred_tpu_torch.cli``) on the
CPU (``--device cpu``): each command writes what the library call it
wraps gives, the WAV byte for byte as ``write_wav_16`` writes that
call's audio; without a card the default device fails loudly; every
subcommand of ``skred_tpu.cli`` exists."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from skred_tpu import cli as jcli
from skred_tpu_torch import cli
from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.assets.bank import write_wav_16
from skred_tpu_torch.engine import render_timeline
from skred_tpu_torch.engine.fused import render_fused
from skred_tpu_torch.frontends.midi import midi_events
from skred_tpu_torch.host.timeline import compile_script
from skred_tpu_torch.parallel.batch import render_batch, stack_timelines
from tests.test_midi import make_test_midi

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "corpus"
STRESS64, FB1 = CORPUS / "stress64.sk", CORPUS / "fb1.sk"
SECONDS = "0.0232"
COMMANDS = ["render", "batch", "render-midi", "repl", "serve", "midi-in",
            "scope", "cz-show"]


def _tl(path, seconds=float(SECONDS), extra=()):
    lines = path.read_text().splitlines() + list(extra)
    return compile_script(lines, seconds, bank=WaveBank(),
                          script_dir=path.resolve().parent)


def _wav_of(audio, tmp_path, name):
    path = tmp_path / name
    write_wav_16(path, audio)
    return path.read_bytes()


@pytest.mark.parametrize("engine", ["compat", "fused"])
def test_render_writes_the_library_render(tmp_path, engine, capsys):
    out = tmp_path / "out.wav"
    rc = cli.main(["--device", "cpu", "render", str(STRESS64), "--seconds",
                   SECONDS, "--engine", engine, "-e", "v0 a2", "--out",
                   str(out)])
    assert rc == 0 and "# wrote" in capsys.readouterr().out
    tl = _tl(STRESS64, extra=["v0 a2"])
    if engine == "fused":
        want = render_fused(stack_timelines([tl]), device="cpu")[0]
    else:
        want = render_timeline(tl, device="cpu")
    assert np.abs(want).max() > 0.01
    assert out.read_bytes() == _wav_of(want, tmp_path, "want.wav")


def test_render_f32_and_cyclic_fused_falls_back(tmp_path):
    """``.f32`` writes the raw floats; ``--engine fused`` on a cyclic
    script renders with the compat engine, as the original does."""
    out = tmp_path / "out.f32"
    assert cli.main(["--device", "cpu", "render", str(FB1), "--seconds",
                     SECONDS, "--engine", "fused", "--out", str(out)]) == 0
    want = render_timeline(_tl(FB1), device="cpu")
    assert np.array_equal(np.fromfile(out, np.float32).reshape(-1, 2), want)


def test_batch_writes_the_library_batch(tmp_path, capsys):
    outdir = tmp_path / "renders"
    rc = cli.main(["--device", "cpu", "batch", str(STRESS64), str(FB1),
                   "--seconds", SECONDS, "--outdir", str(outdir)])
    assert rc == 0 and "realtime" in capsys.readouterr().out
    want = render_batch([STRESS64, FB1], float(SECONDS), device="cpu")
    for path, audio in zip((STRESS64, FB1), want):
        assert (outdir / f"{path.stem}.wav").read_bytes() == \
            _wav_of(audio, tmp_path, "want.wav"), path.name


def test_render_midi_writes_the_library_render(tmp_path):
    mid = tmp_path / "t.mid"
    make_test_midi(mid)
    out = tmp_path / "m.wav"
    assert cli.main(["--device", "cpu", "render-midi", str(mid),
                     "--seconds", SECONDS, "--out", str(out)]) == 0
    events = midi_events(mid)
    lines = [f"v{c} w0 a4 t0.005,0.05,0.7,0.2"
             for c in sorted({int(l.split()[0][1:]) for _, l in events})]
    tl = compile_script(lines, float(SECONDS), bank=WaveBank(),
                        script_dir=tmp_path, events=events)
    want = render_timeline(tl, device="cpu")
    assert out.read_bytes() == _wav_of(want, tmp_path, "want.wav")


def test_cz_show_prints_what_the_original_prints(capsys):
    args = ["cz-show", "--mode", "3", "--mode", "6", "--d", "0.2", "0.7",
            "--rows", "9", "--cols", "40"]
    assert jcli.main(args) == 0
    want = capsys.readouterr().out
    assert cli.main(args) == 0
    assert capsys.readouterr().out == want and "cz mode 6" in want


@pytest.mark.parametrize("command", [
    ["render", "x.sk"], ["batch", "x.sk"], ["render-midi", "x.mid"],
    ["repl"], ["serve"], ["scope", "x.sk"]])
def test_no_card_fails_without_falling_back(command, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(command) == 2
    assert "no CUDA card is visible" in capsys.readouterr().err


@pytest.mark.parametrize("command", COMMANDS)
def test_every_subcommand_of_the_original_exists(command, capsys):
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as ex:
            main([command, "--help"])
        assert ex.value.code == 0
    with pytest.raises(SystemExit):
        cli.main(["--platform", "cpu", command, "--help"])


def test_module_runs_as_a_script(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "skred_tpu_torch.cli", "--device", "cpu",
         "cz-show", "--mode", "1", "--rows", "5", "--cols", "16"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "cz mode 1" in res.stdout
