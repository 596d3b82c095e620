"""The port's recorder and the fused engine's capture, on the CPU, against
the JAX package's.

``skred_tpu_torch.io.recorder.render_recordings`` renders through the
port's ``render_timeline(capture=True)``: its WAV files must equal the
JAX package's byte for byte (channel count, frames, PCM).
``render_fused(capture=True)`` returns each voice's post-pan stereo pair
before the voice sum, ``[num_blocks, B, Vp, block, 2]`` as the JAX
package's ``render_fused(capture=True, use_pallas=False)`` does, within
-100 dB of it.
"""

import wave

import numpy as np
import pytest
import torch

from skred_tpu.assets import WaveBank as JBank
from skred_tpu.engine.fused import render_fused as jax_render_fused
from skred_tpu.host import timeline as jt
from skred_tpu.io.recorder import render_recordings as jax_recordings
from skred_tpu.parallel import batch as jb
from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.engine.fused import render_fused
from skred_tpu_torch.engine.kernels import compat as K
from skred_tpu_torch.host import timeline as tt
from skred_tpu_torch.io.recorder import (render_recordings,
                                         save_wav_multichannel)
from skred_tpu_torch.parallel import batch as tb
from tests.test_recorder import LINES
from tests.test_torch_render import CORPUS, TWO_BLOCKS, db, lines_of

torch.set_num_threads(1)

# tests/test_recorder.py's recording, its 0.5 s wait cut to 0.02 s
SHORT = [ln.replace("~0.5", "~0.02") for ln in LINES]


def _wav(path):
    with wave.open(str(path)) as f:
        return (f.getnchannels(), f.getsampwidth(), f.getframerate(),
                f.getnframes(), f.readframes(f.getnframes()))


def test_recordings_equal_the_jax_packages(tmp_path):
    assert SHORT != LINES
    jtl = jt.compile_script(SHORT, 0.05, bank=JBank(), script_dir=CORPUS)
    ttl = tt.compile_script(SHORT, 0.05, bank=WaveBank(), script_dir=CORPUS)
    want = jax_recordings(jtl, tmp_path / "jax")
    before = K.compat_block.launches
    got = render_recordings(ttl, tmp_path / "port", device="cpu")
    assert K.compat_block.launches == before, "a CPU render launched"
    assert [(p.name, ch) for p, ch in got] == [(p.name, ch)
                                               for p, ch in want]
    assert len(got) == 1 and got[0][1] == 4      # two voices x stereo
    w, g = _wav(want[0][0]), _wav(got[0][0])
    assert g[:4] == w[:4] and g[3] > 0
    assert g[4] == w[4], "the PCM differs"
    assert np.abs(np.frombuffer(g[4], "<i2")).max() > 1000


def test_a_script_without_recordings_writes_nothing(tmp_path):
    ttl = tt.compile_script(["v0 w0 f440 a4"], 0.01, bank=WaveBank())
    assert render_recordings(ttl, tmp_path, device="cpu") == []
    assert not any(tmp_path.iterdir())
    cap = np.zeros((8, 64, 2), np.float32)
    assert save_wav_multichannel(tmp_path / "x.wav", cap,
                                 np.zeros(64, int)) == 0


# Measured: capture bit-equal (stress64), -144.8 dB (noise64); out
# -134.4 and -129.5 dB.
@pytest.mark.parametrize("name", ["stress64", "noise64"])
def test_fused_capture_matches_the_jax_package(name):
    tl = jt.compile_script(lines_of(name), TWO_BLOCKS, bank=JBank(),
                           script_dir=CORPUS)
    st = jb.pack_stacked(jb.stack_timelines([tl] * 8))
    want_out, want_cap = (np.asarray(a) for a in jax_render_fused(
        st, capture=True, use_pallas=False))
    torch.set_flush_denormal(True)
    try:
        out, cap = render_fused(st, capture=True, device="cpu")
    finally:
        torch.set_flush_denormal(False)
    assert cap.shape == want_cap.shape == (2, 8, 64, 512, 2)
    assert out.shape == want_out.shape == (8, 1024, 2)
    assert db(want_cap, cap) <= -100.0
    assert db(want_out, out) <= -100.0
    # capture turns the in-kernel mix and the fold off: the voice sum of
    # the capture is the mix, the volume gain aside
    plain = render_fused(tb.pack_stacked(tb.stack_timelines(
        [tt.compile_script(lines_of(name), TWO_BLOCKS, bank=WaveBank(),
                           script_dir=CORPUS)] * 8)), device="cpu")
    assert db(plain, out) <= -100.0
