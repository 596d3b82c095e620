"""Fast mode (``exact=False``) of the port's engines against the JAX
package, on the CPU, over renders long enough for feedback to show.

On the CPU the JAX package's fast mode is one fma at each of the compat
engine's ``_fma`` sites: XLA's CPU compiler contracts ``a * b + c``, so
there the JAX fast render equals its exact render bit for bit.  The port
gives both feedback engines that arithmetic in fast mode (a correctly
rounded fma, the card's own multiply-add).  The feedback of fb1 and fb4
carries a last-bit difference on until a quantizer or index step flips,
so a render of one block shows nothing; five blocks (2,560 samples) do.

* the compat engine (``render_stacked``, fast by default): fast equals
  exact bit for bit, and both are within -60 dB of the JAX package;
* the cyclic engine (``render_cyclic(exact=False)``): within -60 dB of
  the JAX package's compat render;
* the fused engine's fast mode on stress64 and noise64 (no feedback
  between blocks beyond the carry): within -60 dB of the JAX package's
  exact fused render, and over a quarter of a second its dB against the
  compat engine (``tools/card_parity.py --fast``) within 0.5 dB of the
  JAX package's own fast fused-against-compat dB.  The fused kernels'
  fast mode takes one fma at the JAX kernels' ``a*b + c`` sites too:
  rounded apart, the FM increment's error integrates into the phase.
"""

import numpy as np
import pytest
import torch

from skred_tpu.assets import WaveBank as JBank
from skred_tpu.engine import fused as jf
from skred_tpu.host import timeline as jt
from skred_tpu.parallel import batch as jb
from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.engine import cyclic, fused
from skred_tpu_torch.host import timeline as tt
from skred_tpu_torch.parallel import batch as tb
from skred_tpu_torch.tools import card_parity as cp
from tests.test_torch_card_parity import (NOISE64, STRESS64,  # noqa: F401
                                          compat_on_cpu, jax_db)
from tests.test_torch_render import CORPUS, db, lines_of

torch.set_num_threads(1)

FIVE_BLOCKS = 5 * 512 / 44100.0


def _flushed(fn, *a, **kw):
    # XLA's CPU runtime flushes denormals; render the port the same way
    torch.set_flush_denormal(True)
    try:
        return fn(*a, **kw)
    finally:
        torch.set_flush_denormal(False)


def _stacks(name, seconds):
    lines = lines_of(name)
    jst = jb.stack_timelines([jt.compile_script(
        lines, seconds, bank=JBank(), script_dir=CORPUS)])
    tst = tb.stack_timelines([tt.compile_script(
        lines, seconds, bank=WaveBank(), script_dir=CORPUS)])
    assert tst.num_blocks == 5
    return jst, tst


# Measured with a separately rounded product in fast mode: compat fast
# -0.2 dB (fb1) and +0.4 dB (fb4).  With one fma: compat fast -138.0 dB
# (fb1) and bit-equal (fb4); cyclic fast bit-equal on both.
@pytest.mark.parametrize("name", ["fb1", "fb4"])
def test_feedback_fast_mode_within_60_db_of_jax(name):
    jst, tst = _stacks(name, FIVE_BLOCKS)
    want = np.asarray(jb.render_stacked(jst))
    fast = _flushed(tb.render_stacked, tst, device="cpu")
    assert fast.shape == want.shape == (1, 5 * 512, 2)
    assert db(want, fast) <= -60.0, f"compat fast at {db(want, fast):.1f}"
    exact = _flushed(tb.render_stacked, tst, exact=True, device="cpu")
    assert np.array_equal(fast, exact), "compat fast is not exact"
    st = tb.pack_stacked(tst, cyclic=True)
    cyc = _flushed(cyclic.render_cyclic, st, exact=False, device="cpu")
    assert db(want, cyc) <= -60.0, f"cyclic fast at {db(want, cyc):.1f}"


# Measured: stress64 -122.2 dB, noise64 -115.1 dB.
@pytest.mark.parametrize("name", ["stress64", "noise64"])
def test_fused_fast_mode_within_60_db_of_jax_exact(name):
    jst, tst = _stacks(name, FIVE_BLOCKS)
    want = np.asarray(jf.render_fused(jst, exact=True))
    got = _flushed(fused.render_fused, tst, exact=False, device="cpu")
    assert got.shape == want.shape == (1, 5 * 512, 2)
    assert db(want, got) <= -60.0


# Measured at 0.25 s with the fused kernels' fast mode rounding a*b + c
# apart: -48.69 dB (stress64) and -48.88 dB (noise64), against the JAX
# package's -73.39 and -66.86 dB (equal to its exact mode on the CPU).
@pytest.mark.parametrize("path", [STRESS64, NOISE64], ids=lambda p: p.stem)
def test_fused_fast_mode_parity_matches_jax(compat_on_cpu, tmp_path, path):
    rec = cp.card_parity(0.25, [path], fast=True, device="cpu",
                         record=tmp_path / "rec.json")
    got = rec["scripts"][path.name]
    want = jax_db(path, 0.25, exact=False)
    assert abs(got - want) <= 0.5, (got, want)
    assert rec["arith"] == "fast" and got <= cp.TARGET_DB
