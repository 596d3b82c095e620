"""The card-parity tool (``skred_tpu_torch/tools/card_parity.py``) on
the CPU.

Its oracle, the compat engine, runs here as ``csrc/compat.cu`` itself,
built for the CPU by g++ under each render's key (``compat_on_cpu``: a
fiber a voice in one thread, ``__syncthreads`` and the warp vote a
switch through them) behind the launch wrapper: ``compat_block_plain``
repeats its per-sample ops and would take minutes for a quarter of a
second of stress64.  The build is first held bit for bit to the plain
version.

The tool's dB on stress64 and noise64 at 0.25 s must be within 0.5 dB of
the JAX package's own fused-against-compat comparison (``render_fused``
against ``render_timeline``) on the same script and length; the bucketed
mode must recover each head row's script; the record must hold every
key of ``TPU_PARITY.json``; a render that misses the target exits 1; the
tool imports with JAX and the JAX package blocked.

    python tests/test_torch_card_parity.py SECONDS ...

prints the JAX package's dB of stress64 and noise64 at each length, in
exact and fast mode (the reference numbers PERF.md sets beside the
card's).
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from skred_tpu_torch.assets import WaveBank  # noqa: E402
from skred_tpu_torch.engine import fused as tf  # noqa: E402
from skred_tpu_torch.engine import render as tr  # noqa: E402
from skred_tpu_torch.engine.kernels import compat as K  # noqa: E402
from skred_tpu_torch.host.timeline import compile_script  # noqa: E402
from skred_tpu_torch.tools import card_parity as cp  # noqa: E402
from tests.test_torch_compat_keyed import CpuCompat  # noqa: E402

torch.set_num_threads(1)

STRESS64 = ROOT / "corpus" / "stress64.sk"
NOISE64 = ROOT / "skred_tpu_torch" / "scripts" / "noise64.sk"


@pytest.fixture(scope="module")
def compat_on_cpu(tmp_path_factory):
    """The compat engine's renders on the CPU through ``csrc/compat.cu``
    built by g++ (-ffp-contract=off, a library per key:
    ``tests/test_torch_compat_keyed.py``'s ``CpuCompat``) behind the
    launch wrapper, held bit for bit to ``compat_block_plain`` on 2
    blocks of stress64 first."""
    cpu = CpuCompat(tmp_path_factory.mktemp("compat_fibers"))
    tl = compile_script(STRESS64.read_text().splitlines(), 2 * 512 / 44100.0,
                        bank=WaveBank(), script_dir=STRESS64.parent)
    want = tr.render_timeline(tl, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        cpu.patch(mp)
        mp.setattr(tr, "compat_block", K._launch)
        got = tr.render_timeline(tl, device="cpu")
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        yield cpu


def jax_db(path: pathlib.Path, seconds: float, exact=None) -> float:
    """The JAX package's fused render (``exact``: its arithmetic mode)
    against its compat render, max |error| in dB of full scale, as
    ``tools/tpu_parity.py`` reports it."""
    from skred_tpu.assets import WaveBank as JBank
    from skred_tpu.engine import render_timeline
    from skred_tpu.engine.fused import render_fused
    from skred_tpu.host.timeline import compile_script as jcompile
    from skred_tpu.parallel.batch import stack_timelines

    tl = jcompile(path.read_text().splitlines(), seconds, bank=JBank(),
                  script_dir=path.parent)
    ref = np.asarray(render_timeline(tl))
    out = np.asarray(render_fused(stack_timelines([tl]), exact=exact))[0]
    m = min(len(ref), len(out))
    return cp.db_of(float(np.abs(out[:m] - ref[:m]).max()))


@pytest.mark.parametrize("path", [STRESS64, NOISE64], ids=lambda p: p.stem)
def test_db_matches_the_jax_package(compat_on_cpu, tmp_path, path):
    """stress64 and noise64 at 0.25 s: the tool's dB within 0.5 dB of
    the JAX package's own comparison (measured -73.4 and -66.9 dB)."""
    rec = cp.card_parity(0.25, [path], device="cpu",
                         record=tmp_path / "rec.json")
    got = rec["scripts"][path.name]
    want = jax_db(path, 0.25)
    assert abs(got - want) <= 0.5, (got, want)
    assert rec["pass"] and got <= cp.TARGET_DB


# two small scripts of one fused bucket (one voice, the same features)
# bound to other tables, and a cyclic one
PAIR = {"sine.sk": ["v0 w0 f220 a3"],
        "saw.sk": ["v0 w2 f330 a2"]}


@pytest.fixture(scope="module")
def bucketed(compat_on_cpu, tmp_path_factory):
    d = tmp_path_factory.mktemp("scripts")
    for name, lines in PAIR.items():
        (d / name).write_text("\n".join(lines) + "\n")
    paths = [d / n for n in PAIR] + [ROOT / "corpus" / "fb1.sk"]
    rec = cp.card_parity(0.05, paths, bucketed=True, replicas=2,
                         device="cpu", max_rows=3, record=d / "rec.json")
    return rec, d / "rec.json"


def test_bucketed_recovers_each_scripts_row(bucketed):
    """Both scripts of the one fused bucket, whose head rows fill_bucket
    orders by table binding, and the cyclic script each come within the
    target of their own compat render: a row given the other script's
    name would be far off."""
    rec, _ = bucketed
    assert sorted(rec["scripts"]) == ["fb1.sk", "saw.sk", "sine.sk"]
    fused_b, cyc = rec["buckets"]
    assert (fused_b["rows"], fused_b["scripts"]) == (3, 2)
    assert cyc == {"voices": "cyclic-3v", "passes": 0, "rows": 3,
                   "scripts": 1}
    assert rec["pass"] and all(d <= cp.TARGET_DB
                               for d in rec["scripts"].values())


def test_record_has_the_keys_of_tpu_parity(bucketed):
    rec, path = bucketed
    assert json.loads(path.read_text()) == rec
    want = set(json.loads((ROOT / "TPU_PARITY.json").read_text()))
    assert want <= set(rec)
    assert rec["card"] == {"name": "cpu", "power_limit": None}
    assert (rec["bucketed"], rec["replicas"], rec["seconds"],
            rec["arith"], rec["target_db"]) == (True, 2, 0.05, "exact",
                                                -60.0)
    assert rec["n_scripts"] == 3 and rec["worst_script"] in rec["scripts"]


def test_a_mismatch_exits_1(compat_on_cpu, monkeypatch, tmp_path, capsys):
    """A fused render 0.01 off its compat render (-40 dB) is a FAIL line
    and exit 1."""
    real = tf.render_fused_device
    monkeypatch.setattr(tf, "render_fused_device",
                        lambda *a, **kw: real(*a, **kw) + 0.01)
    monkeypatch.setattr(cp, "RECORD", tmp_path / "rec.json")
    script = tmp_path / "sine.sk"
    script.write_text("\n".join(PAIR["sine.sk"]) + "\n")
    assert cp.main(["0.03", str(script), "--device", "cpu"]) == 1
    assert "FAIL sine.sk" in capsys.readouterr().out
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert not rec["pass"] and rec["worst_db"] == pytest.approx(-40.0,
                                                                abs=0.5)


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['skred_tpu'] = None; "
            "import skred_tpu_torch.tools.card_parity")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


if __name__ == "__main__":
    for s in sys.argv[1:]:
        for p in (STRESS64, NOISE64):
            for exact in (True, False):
                print(f"JAX package, CPU: {p.name} {float(s)} s "
                      f"{'exact' if exact else 'fast'} "
                      f"{jax_db(p, float(s), exact):.2f} dB", flush=True)
