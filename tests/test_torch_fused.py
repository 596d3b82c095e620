"""The port's control plane and fused renderer against the JAX package.

Packing must give the same arrays field for field; renders on the CPU
(stress64 through the tier kernel's plain version, noise64 and other
noise-voice batches through the noise pass's) must match
``skred_tpu.engine.fused.render_fused(use_pallas=False)`` to within
rounding; the package must import without JAX.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from skred_tpu.assets import WaveBank as JBank
from skred_tpu.engine import fused as jf
from skred_tpu.host import timeline as jt
from skred_tpu.parallel import batch as jb
from skred_tpu_torch.assets import WaveBank as TBank
from skred_tpu_torch.engine import cyclic as tcy
from skred_tpu_torch.engine import fused as tf
from skred_tpu_torch.engine.kernels import filt_smooth as tfs
from skred_tpu_torch.engine.kernels import lookup as tlk
from skred_tpu_torch.engine.kernels import phase_walk as tpw
from skred_tpu_torch.engine.kernels import tier as tt
from skred_tpu_torch.host import timeline as ttl
from skred_tpu_torch.parallel import batch as tb

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "corpus"
SCRIPTS = ROOT / "skred_tpu_torch" / "scripts"
NOISE64 = (SCRIPTS / "noise64.sk").read_text().splitlines()

# pan-mod, pan, disconnect (test_mega's in-kernel mix script)
PAN_MOD = ["v0 w2 f2 a2", "v1 w0 f330 a3 p-0.4",
           "v2 w0 f220 a3 p0.3 P0 Q0.9", "v3 w5 f110 a2 x1"]
# one tier (no cross-voice reads), plain and with self-fm / self-am edges
ONE_TIER = ["v0 w0 f440 a2", "v1 w1 f220 a3 p0.5 h3 q4"]
SELF_MOD = ["v0 w0 f440 a2 F0,0.3", "v1 w2 f110 a2 A1,0.5"]
# mid-render rewiring: three segments (test_mega's fold-rewire script)
REWIRE = ["v1 w2 f2 a2", "v2 w4 f3 a2",
          "v0 w0 f330 a3 F1,0.5 ~.06 v0 F2,0.8 ~.06 v0 F1,0.2"]
# noise only in tier 0 (an S&H noise LFO), tier 1 takes the tier kernel
NOISE_MIXED = ["v1 w6 f3 a1 h40", "v0 w0 f220 a3 F1,0.5"]
# one tier: a filtered, smoothed noise voice
NOISE_ONE_TIER = ["v0 w6 f440 a2 J1 K2000 Q1 s0.1"]


def _compile(mod_timeline, bank, lines, seconds):
    return mod_timeline.compile_script(lines, seconds, bank=bank,
                                       script_dir=CORPUS)


def _assert_tree_equal(a, b, where):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("script", ["stress64.sk", "fb1.sk", "fb2.sk",
                                    "fb3.sk", "fb4.sk", "fb5.sk",
                                    "noise64.sk"])
def test_compile_and_pack_match_jax_package(script):
    """Field for field, rosters included (noise64's med_map_t1 and
    big_map_t1 bind its 8,186- and 60,406-sample PCM voices)."""
    path = CORPUS / script
    if not path.exists():
        path = SCRIPTS / script
    lines = path.read_text().splitlines()
    jtl = _compile(jt, JBank(), lines, 0.05)
    ttl_ = _compile(ttl, TBank(), lines, 0.05)
    for f in ("num_blocks", "block", "seg_of_block", "seg_is_start",
              "params", "ops", "table_buffer", "table_offsets",
              "table_arrays", "mod_passes", "fused_passes"):
        _assert_tree_equal(getattr(ttl_, f), getattr(jtl, f), f)
    assert ttl.Timeline is not jt.Timeline
    jst = jb.stack_timelines([jtl] * 3)
    tst = tb.stack_timelines([ttl_] * 3)
    packs = [(jb.pack_stacked(jst), tb.pack_stacked(tst))]
    if jtl.fused_passes is None:
        packs.append((jb.pack_stacked(jst, cyclic=True),
                      tb.pack_stacked(tst, cyclic=True)))
    else:
        assert tb.bucket_key(ttl_)[:2] == jb.bucket_key(jtl)[:2]
        assert tuple(tb.bucket_key(ttl_)[2]) == tuple(jb.bucket_key(jtl)[2])
    for js, ts in packs:
        js, ts = jb.pad_segments_pow2(js), tb.pad_segments_pow2(ts)
        for f in dataclasses.fields(jb.StackedTimelines):
            _assert_tree_equal(getattr(ts, f.name), getattr(js, f.name),
                               f.name)
        _assert_tree_equal(tb._prep_params(ts), jb._prep_params(js),
                           "prep")


def _jax_packed(lines, rows, seconds):
    tl = _compile(jt, JBank(), lines, seconds)
    return jb.pack_stacked(jb.stack_timelines([tl] * rows))


def _render_cpu(st):
    # XLA's CPU runtime flushes denormals; render the port the same way
    torch.set_flush_denormal(True)
    try:
        return tf.render_fused(st, device="cpu")
    finally:
        torch.set_flush_denormal(False)


@pytest.mark.parametrize("name,lines,seconds", [
    ("stress64", (CORPUS / "stress64.sk").read_text().splitlines(), 0.1),
    ("pan_mod", PAN_MOD, 0.1),
    ("one_tier", ONE_TIER, 0.1),
    ("self_mod", SELF_MOD, 0.1),
    ("rewire", REWIRE, 0.2),
    ("noise64", NOISE64, 0.1),              # measured -131.8 dB
    ("noise_mixed", NOISE_MIXED, 0.05),     # measured -132.6 dB
    ("noise_one_tier", NOISE_ONE_TIER, 0.05),  # measured -133.6 dB
])
def test_render_fused_matches_jax_package(name, lines, seconds):
    """Same packed batch (the JAX package's own StackedTimelines) through
    both renderers.  Not bit for bit: XLA's CPU compiler contracts some
    multiply-adds of the JAX glue into fmas (the voice mix's
    ``sum(samples * pan)`` for narrow tiers, the volume smoother's scan
    combine ``lb * ra + rb``), which the port rounds separately.  Every
    voice's samples and state match exactly (test_torch_tier, and the
    volume scan uses the JAX combine tree), so what remains is rounding
    in the final sums: measured about -130 dB against the peak on
    stress64, asserted at -100 dB.  Batches with noise voices take the
    noise pass; the same contractions (and, in the smoother, XLA's fma of
    ``amp*env*amod - sg``) leave them at -130 to -134 dB."""
    st = _jax_packed(lines, 4, seconds)
    want = jf.render_fused(st, use_pallas=False)
    got = _render_cpu(st)
    assert got.shape == want.shape and got.dtype == np.float32
    peak = float(np.abs(want).max())
    assert peak > 0.01, "silent render compares nothing"
    err = float(np.abs(got - want).max())
    db = 20 * np.log10(max(err, 1e-30) / peak)
    assert db <= -100.0, f"{name}: {db:.1f} dB (max |diff| {err})"


def _launch_counts():
    return (tt.tier.launches, tlk.lookup.launches,
            tpw.phase_walk_warp.launches, tfs.filt_smooth_noise.launches)


def _check_stream_checksum(lines, seconds):
    st = _jax_packed(lines, 2, seconds)
    out = _render_cpu(st)
    chunk = 3
    nb = st.num_blocks // chunk * chunk
    want = np.abs(out[:, (nb - chunk) * st.block:nb * st.block]) \
        .astype(np.float64).sum()
    before = _launch_counts()
    torch.set_flush_denormal(True)
    try:
        got = tf.render_fused_stream_device(st, chunk_blocks=chunk,
                                            device="cpu")
    finally:
        torch.set_flush_denormal(False)
    assert _launch_counts() == before, "a CPU render launched a kernel"
    assert got > 0 and np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-12)


def test_stream_checksum_matches_render():
    _check_stream_checksum((CORPUS / "stress64.sk").read_text().splitlines(),
                           0.1)


def test_stream_checksum_matches_render_noise64():
    """The streamed render's noise stream covers only whole chunks; its
    blocks line up with the one-shot render's."""
    _check_stream_checksum(NOISE64, 0.05)


def test_from_stacked_fields():
    st = _jax_packed(PAN_MOD, 2, 0.05)
    d = tf.from_stacked(st, device="cpu")
    assert sorted(d) == ["carry", "ops", "params", "seg_is_start",
                         "seg_of_block", "table_buffer"]
    np.testing.assert_array_equal(d["params"]["na1"].numpy(),
                                  -st.params["flt_a1"])
    assert d["table_buffer"].dtype == torch.float32
    assert d["carry"]["phase"].shape == st.params["amp"].shape[::2]
    assert isinstance(d["seg_of_block"], np.ndarray)


def test_out_of_scope_inputs_raise():
    cyc = _jax_packed((CORPUS / "fb1.sk").read_text().splitlines(), 2,
                      0.05)
    with pytest.raises(ValueError, match="render_cyclic"):
        tf.render_fused(cyc, device="cpu")
    with pytest.raises(ValueError, match="render_cyclic"):
        next(tf.render_fused_stream(cyc, device="cpu"))
    # noise-voice tiers render now (through the noise pass)
    noisy = _jax_packed(["v0 w6 f440 a2"], 2, 0.05)
    out = tf.render_fused(noisy, device="cpu")
    assert out.shape == (2, noisy.num_blocks * noisy.block, 2)
    assert np.isfinite(out).all() and np.abs(out).max() > 0.01


def test_entry_points_default_to_the_card():
    """No silent CPU fallback: without device="cpu" the render goes to
    CUDA, and on a machine without a card that fails."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    st = _jax_packed(PAN_MOD, 2, 0.05)
    with pytest.raises((RuntimeError, AssertionError)):
        tf.render_fused(st)
    with pytest.raises((RuntimeError, AssertionError)):
        tf.render_fused_stream_device(st, chunk_blocks=2)
    with pytest.raises((RuntimeError, AssertionError)):
        next(tf.render_fused_stream(st, chunk_blocks=2))
    cyc = jb.pack_stacked(jb.stack_timelines(
        [_compile(jt, JBank(), (CORPUS / "fb1.sk").read_text().splitlines(),
                  0.05)] * 2), cyclic=True)
    with pytest.raises((RuntimeError, AssertionError)):
        tcy.render_cyclic(cyc)
    with pytest.raises((RuntimeError, AssertionError)):
        next(tcy.render_cyclic_stream(cyc))
    with pytest.raises((RuntimeError, AssertionError)):
        tcy.render_cyclic_stream_device(cyc, chunk_blocks=2)
    with pytest.raises((RuntimeError, AssertionError)):
        tb.render_batch([CORPUS / "fb1.sk"], 0.05)
    with pytest.raises((RuntimeError, AssertionError)):
        tb.render_batch([CORPUS / "stress64.sk"], 0.05)


def test_package_imports_without_jax():
    code = ("import sys, skred_tpu_torch, skred_tpu_torch.engine.fused, "
            "skred_tpu_torch.parallel.batch, skred_tpu_torch.host.wire, "
            "skred_tpu_torch.engine.cyclic, "
            "skred_tpu_torch.engine.kernels.cyclic, "
            "skred_tpu_torch.engine.kernels.cyclic_inputs, "
            "skred_tpu_torch.engine.kernels.build, "
            "skred_tpu_torch.engine.kernels.tier_inputs, "
            "skred_tpu_torch.engine.kernels.noise_inputs\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'skred_tpu' or "
            "m.startswith('skred_tpu.')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
