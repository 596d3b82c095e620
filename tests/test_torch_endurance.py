"""The endurance tool (``skred_tpu_torch/tools/endurance.py``) on the
CPU at a small size: 0.5 s of a small acyclic script, 2 rows, a
4,410-sample window, 8-block chunks so that windows straddle chunks.

``run``'s windows must equal the same slices of a whole
``render_fused(device="cpu")`` (an oracle minted from those slices gives
no error at all); ``oracle``'s windows must equal the same slices of a
whole ``render_timeline(device="cpu")`` (the compat engine through
``csrc/compat.cu`` built for the CPU, ``test_torch_card_parity``'s
fixture); an oracle minted for another length is refused; the record
holds ``ENDURANCE.json``'s keys and the device memory's.
"""

import json

import numpy as np
import pytest
import torch

from skred_tpu_torch.engine import fused as tf
from skred_tpu_torch.engine import render as tr
from skred_tpu_torch.parallel.batch import stack_timelines
from skred_tpu_torch.tools import endurance as en
from tests.test_torch_card_parity import ROOT, compat_on_cpu  # noqa: F401

torch.set_num_threads(1)

SECONDS, ROWS, WIN = 0.5, 2, 4410
SCRIPT = ["v0 w0 f220 a3", "v1 w2 f3 a2", "v0 F1,0.4", "v2 w1 f330 a2 p0.7"]


@pytest.fixture
def script(tmp_path, monkeypatch):
    monkeypatch.setattr(en, "CHUNK", 8)
    p = tmp_path / "small.sk"
    p.write_text("\n".join(SCRIPT) + "\n")
    return p


def _slices(whole, total):
    offs = {"start": 0, "mid": total // 2, "end": total - WIN}
    return {k: whole[o:o + WIN] for k, o in offs.items()}


def test_run_cuts_the_windows_of_the_whole_render(script, tmp_path):
    tl = en.timeline(script, SECONDS)
    whole = tf.render_fused(stack_timelines([tl] * ROWS), device="cpu")[0]
    total = whole.shape[0]
    assert total == tl.num_blocks * 512 and tl.num_blocks > 3 * en.CHUNK
    np.savez(tmp_path / "o.npz", script=script.name, seconds=SECONDS,
             window=WIN, total=total, **_slices(whole, total))
    rec = en.run(script, SECONDS, ROWS, WIN, "cpu", tmp_path / "o.npz",
                 tmp_path / "rec.json")
    assert rec["window_parity_db"] == {k: 20 * np.log10(1e-30)
                                       for k in ("start", "mid", "end")}
    assert rec["chunks"] == -(-tl.num_blocks // en.CHUNK)
    assert rec["audio_s"] == ROWS * total / 44100.0
    assert json.loads((tmp_path / "rec.json").read_text()) == rec
    want = set(json.loads((ROOT / "ENDURANCE.json").read_text()))
    assert want <= set(rec)
    for k in ("device_mem_mb_first", "device_mem_mb_last",
              "device_mem_peak_mb"):
        assert k in rec and rec[k] is None          # no card here
    assert rec["card"] == {"name": "cpu", "power_limit": None}
    assert rec["rss_mb_first"] > 0 and rec["rss_growth_pct"] >= 0


def test_oracle_cuts_the_windows_of_the_compat_render(compat_on_cpu, script,
                                                      tmp_path):
    tl = en.timeline(script, SECONDS)
    whole = tr.render_timeline(tl, device="cpu")
    got = en.oracle(script, SECONDS, WIN, "cpu", tmp_path / "o.npz")
    want = _slices(whole, whole.shape[0])
    saved = np.load(tmp_path / "o.npz")
    for k in want:
        assert np.array_equal(got[k], want[k]) and got[k].shape == (WIN, 2)
        assert np.array_equal(saved[k], want[k])
    assert (str(saved["script"]), float(saved["seconds"]),
            int(saved["window"])) == (script.name, SECONDS, WIN)


def test_an_oracle_of_another_length_is_refused(script, tmp_path):
    np.savez(tmp_path / "o.npz", script=script.name, seconds=SECONDS,
             window=WIN, total=0)
    with pytest.raises(SystemExit, match="minted for"):
        en.run(script, 0.4, ROWS, WIN, "cpu", tmp_path / "o.npz",
               tmp_path / "rec.json")
    with pytest.raises(SystemExit, match="minted for"):
        en.run(script, SECONDS, ROWS, 441, "cpu", tmp_path / "o.npz",
               tmp_path / "rec.json")
    assert not (tmp_path / "rec.json").exists()
