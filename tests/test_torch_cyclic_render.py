"""The port's cyclic engine against the JAX package's compat engine.

``render_cyclic(device="cpu")`` at 2 rows must match
``skred_tpu.engine.render_timeline`` (the one-row per-sample oracle, to
which the JAX package's own tests hold its cyclic kernel bit-equal) on
the feedback scripts of corpus/ and on a multi-segment script.
tests/test_torch_cyclic.py holds the chunked stream to the one-shot
render.
"""

import numpy as np
import pytest
import torch

from skred_tpu.assets import WaveBank as JBank
from skred_tpu.engine import render_timeline
from skred_tpu.host import timeline as jt
from skred_tpu.parallel import batch as jb
from skred_tpu_torch.engine import cyclic as tc
from skred_tpu_torch.engine.kernels import cyclic as ck
from skred_tpu_torch.engine.kernels import cyclic_inputs as ci

torch.set_num_threads(1)

# mid-render parameter changes: the segment gather, the ops between
# blocks, a table swap and a CZ self edge that appears later
MULTI_SEGMENT = [
    "v0 w1 f110 a100 F1,0.8 J200 K4000 Q30",
    "v1 w2 f55 a80 F0,0.5 ~.1 v0 f220 w2 v1 f70 a60 "
    "~.1 v0 f165 c1,0.4 C0,0.5 ~.1 v1 f52 a90",
]


def _lines(name):
    return (ci.CORPUS / f"{name}.sk").read_text().splitlines()


def _jax_timeline(lines, seconds):
    return jt.compile_script(lines, seconds, bank=JBank(),
                             script_dir=ci.CORPUS)


def _render_cpu(st, **kw):
    # XLA's CPU runtime flushes denormals; render the port the same way
    torch.set_flush_denormal(True)
    try:
        return tc.render_cyclic(st, device="cpu", **kw)
    finally:
        torch.set_flush_denormal(False)


# Measured: fb1, fb3, fb5 and the multi-segment script bit-equal; fb2
# -138.0 dB of the peak (max |diff| 7.6e-06 at a peak of 61): its v1 is
# amp-modulated with its amp smoother on, and XLA's CPU compiler contracts
# the smoother's ``amp*ampmod - sg`` into one fma where the port, like
# the TPU kernel, rounds the product first (tests/test_torch_cyclic.py
# shows the site on one block); the feedback ring carries the last-bit
# difference on.
@pytest.mark.parametrize("name,lines,seconds", [
    ("fb1", _lines("fb1"), 0.1),
    ("fb2", _lines("fb2"), 0.1),
    ("fb3", _lines("fb3"), 0.1),
    ("fb5", _lines("fb5"), 0.1),
    ("multi_segment", MULTI_SEGMENT, 0.32),
])
def test_render_cyclic_matches_compat_engine(name, lines, seconds):
    tl = _jax_timeline(lines, seconds)
    assert tl.fused_passes is None
    if name == "multi_segment":
        assert tl.num_segments >= 3
    want = np.asarray(render_timeline(tl))
    st = jb.pack_stacked(jb.stack_timelines([tl] * 2), cyclic=True)
    before = ck.cyclic_block.launches
    got = _render_cpu(st)
    assert ck.cyclic_block.launches == before, "a CPU render launched"
    assert got.dtype == np.float32
    assert got.shape == (2, tl.num_blocks * tl.block, 2)
    peak = float(np.abs(want).max())
    assert peak > 0.01, "silent render compares nothing"
    for row in range(2):
        err = float(np.abs(got[row, :len(want)] - want).max())
        db = 20 * np.log10(max(err, 1e-30) / peak)
        print(f"{name} row {row}: {db:.1f} dB (max |diff| {err})")
        assert db <= -100.0, f"{name} row {row}: {db:.1f} dB"
