"""The fused renderer with the tier kernel's mix and fold on, and the
repeat-passes layout, against the JAX package, on the CPU.

Renders go through ``render_fused(device="cpu")`` (the kernels' plain
versions) and are held to the JAX package's
``render_fused(use_pallas=False)`` at -100 dB of the peak, as
tests/test_torch_fused.py holds the unfolded render and for its reason:
every voice's samples match bit for bit, the final sums round in another
order.  Folded and unfolded renders of the port itself are bit-equal;
the in-kernel mix sums a tier's voices in ascending order where torch's
``sum`` picks its own, which moves the last bits only.
"""

import pathlib

import numpy as np
import pytest
import torch

from skred_tpu.assets import WaveBank as JBank
from skred_tpu.engine import fused as jf
from skred_tpu.host import timeline as jt
from skred_tpu.parallel import batch as jb
from skred_tpu_torch.assets import WaveBank as TBank
from skred_tpu_torch.engine import fused as tf
from skred_tpu_torch.host import timeline as ttl
from skred_tpu_torch.parallel import batch as tb

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "corpus"
STRESS64 = (CORPUS / "stress64.sk").read_text().splitlines()
NOISE64 = (ROOT / "skred_tpu_torch" / "scripts" / "noise64.sk") \
    .read_text().splitlines()
# a delayed fm edge, an am edge and a cz-mod edge on one tier-0 LFO
# (test_mega's three-stream fold script), plus a pan and a pan-mod lane
THREE_STREAMS = ["v0 w0 f330 a3 F1,0.5", "v1 w2 f2 a2",
                 "v2 w0 f220 a3 A1,0.4 p-0.4",
                 "v3 w4 f110 a3 c1,0.5 C1,0.3 P1 Q0.7"]
# mid-render rewiring: the fm edge retargets and changes depth
REWIRE = ["v1 w2 f2 a2", "v2 w4 f3 a2",
          "v0 w0 f330 a3 F1,0.5 ~.03 v0 F2,0.8 ~.03 v0 F1,0.2"]
# a delayed read across a segment start that resets the modulator: its
# sample is set to 0 before the reader's t = 0 takes it
RESET_MOD = ["v0 w0 f330 a3 F1,0.5", "v1 w2 f2 a2 ~.03 S1 v1 w2 f3 a2"]
# an am stream with a self-read beside a cross-tier am read: the port
# folds this tier, the JAX package does not
AM_SELF = ["v0 w2 f3 a2", "v1 w0 f220 a3 A0,0.5",
           "v2 w0 f330 a2 A2,0.4 F0,0.2"]
# noise in tier 0, the tier kernel (folded) in tier 1
NOISE_MIXED = ["v1 w6 f3 a1 h40", "v0 w0 f220 a3 F1,0.5"]
ONE_TIER = ["v0 w0 f440 a2", "v1 w1 f220 a3 p0.5 h3 q4"]
# each segment's graph is acyclic, their union is not: no tiers
UNION_CYCLE = ["v0 w0 f330 a3 F1,0.5", "v1 w2 f2 a2", "v2 w0 f220 a2 p0.3 "
               "~.06 v0 F1,0 v1 F0,0.4"]
# the same with a noise voice, a pan-mod lane and a third pass
UNION_CYCLE_NOISE = ["v0 w0 f330 a3 F1,0.5", "v1 w2 f2 a2 A3,0.3",
                     "v3 w6 f5 a1 h30", "v2 w0 f220 a2 P1 Q0.5 "
                     "~.06 v0 F1,0 v1 F0,0.4"]


def _jax_packed(lines, rows, seconds):
    tl = jt.compile_script(lines, seconds, bank=JBank(), script_dir=CORPUS)
    return jb.pack_stacked(jb.stack_timelines([tl] * rows))


def _render_cpu(st, **kw):
    # XLA's CPU runtime flushes denormals; render the port the same way
    torch.set_flush_denormal(True)
    try:
        return tf.render_fused(st, device="cpu", **kw)
    finally:
        torch.set_flush_denormal(False)


def _db(got, want):
    peak = float(np.abs(want).max())
    assert peak > 0.01, "silent render compares nothing"
    err = float(np.abs(got - want).max())
    return 20 * np.log10(max(err, 1e-30) / peak)


@pytest.mark.parametrize("name,lines,seconds", [
    ("stress64", STRESS64, 0.1),
    ("three_streams", THREE_STREAMS, 0.1),
    ("rewire", REWIRE, 0.1),
    ("reset_mod", RESET_MOD, 0.1),
    ("am_self", AM_SELF, 0.1),
    ("noise_mixed", NOISE_MIXED, 0.05),
])
def test_mix_fold_render_matches_jax_package(name, lines, seconds):
    st = _jax_packed(lines, 4, seconds)
    fts = tf._feat_tiers(st)
    assert tf._fold_tiers(st, fts) is not None, "the fold did not engage"
    want = jf.render_fused(st, use_pallas=False)
    got = _render_cpu(st)                     # mix and fold on by default
    assert got.shape == want.shape and got.dtype == np.float32
    db = _db(got, want)
    print(f"{name}: mix+fold vs the JAX package {db:.1f} dB")
    assert db <= -100.0, f"{name}: {db:.1f} dB"


@pytest.mark.parametrize("name,lines,seconds", [
    ("stress64", STRESS64, 0.05),
    ("three_streams", THREE_STREAMS, 0.05),
    ("rewire", REWIRE, 0.1),
    ("reset_mod", RESET_MOD, 0.1),
    ("am_self", AM_SELF, 0.05),
    ("noise64", NOISE64, 0.03),
])
def test_folded_render_equals_unfolded(name, lines, seconds):
    """The fold changes where a stream is read, not what is read: bit for
    bit.  The mix changes the order of the voice sum: -120 dB or better
    (measured -134 dB on stress64, bit-equal on the narrow scripts)."""
    st = _jax_packed(lines, 2, seconds)
    plain = _render_cpu(st, mix=False, fold=False)
    folded = _render_cpu(st, mix=False, fold=True)
    assert np.array_equal(folded.view(np.int32), plain.view(np.int32)), \
        f"{name}: fold {_db(folded, plain):.1f} dB"
    both = _render_cpu(st)
    mixed = _render_cpu(st, mix=True, fold=False)
    assert np.array_equal(both.view(np.int32), mixed.view(np.int32))
    db = _db(both, plain)
    print(f"{name}: in-kernel mix vs torch sum {db:.1f} dB")
    assert db <= -120.0, f"{name}: {db:.1f} dB"


def test_segment_start_sample_reaches_the_delayed_read():
    """RESET_MOD's second segment sets the modulator's sample; a bank
    whose t = -1 row were taken before the segment-start ops would leave
    the reader's first sample of that block on the old value.  Hold the
    block to the JAX package sample for sample (bitwise but for the
    final sums), and check the op is really there."""
    st = _jax_packed(RESET_MOD, 2, 0.1)
    assert st.ops["set_sample"].any() and st.params["fm_delayed"].any()
    want = jf.render_fused(st, use_pallas=False)
    got = _render_cpu(st)
    k = int(np.argmax(st.seg_is_start[0, 1:])) + 1     # the reset's block
    blk = slice(k * st.block, (k + 1) * st.block)
    assert np.abs(want[:, blk]).max() > 0.01
    assert _db(got[:, blk], want[:, blk]) <= -100.0


def _fold_both(lines, rows=2, seconds=0.05):
    jst = _jax_packed(lines, rows, seconds)
    tl = ttl.compile_script(lines, seconds, bank=TBank(), script_dir=CORPUS)
    tst = tb.pack_stacked(tb.stack_timelines([tl] * rows))
    jfold = jf._fold_tiers(jst, jf._feat_tiers(jst), True)
    tfold = tf._fold_tiers(tst, tf._feat_tiers(tst))
    return jst, tst, jfold, tfold


def test_fold_tiers_decisions():
    """stress64 at 1024 rows (the JAX package's fold needs whole
    1024-row sub-blocks), noise64 and a one-tier script: the same
    decisions.  Where the port folds and the JAX package does not: any
    row count that is no multiple of 1024, and a tier whose am stream
    holds a self-read."""
    tl = jt.compile_script(STRESS64, 0.02, bank=JBank(), script_dir=CORPUS)
    jst = jb.pack_stacked(jb.stack_timelines([tl] * 1024))
    jfold = jf._fold_tiers(jst, jf._feat_tiers(jst), True)
    tfold = tf._fold_tiers(jst, tf._feat_tiers(jst))
    assert jfold == tfold == (False, True)
    # fewer rows: the TPU layout's gate refuses, the port folds
    jst, tst, jfold, tfold = _fold_both(STRESS64)
    assert jfold is None and tfold == (False, True)
    # noise64: tier 1 holds the noise voices, nothing folds
    _, tst, jfold, tfold = _fold_both(NOISE64)
    assert len(tst.tiers) == 2 and jfold is None and tfold is None
    # one tier: nothing to fold
    _, tst, jfold, tfold = _fold_both(ONE_TIER)
    assert len(tst.tiers) == 1 and jfold is None and tfold is None
    # an am self-read in the tier: the port's kernel handles it
    tl = jt.compile_script(AM_SELF, 0.02, bank=JBank(), script_dir=CORPUS)
    jst = jb.pack_stacked(jb.stack_timelines([tl] * 1024))
    assert jf._fold_tiers(jst, jf._feat_tiers(jst), True) is None
    assert tf._fold_tiers(jst, tf._feat_tiers(jst)) == (False, True)
    # noise in tier 0 only: tier 1 folds over the noise pass's output
    _, tst, _, tfold = _fold_both(NOISE_MIXED)
    assert tfold == (False, True)


@pytest.mark.parametrize("name,lines", [("union_cycle", UNION_CYCLE),
                                        ("union_cycle_noise",
                                         UNION_CYCLE_NOISE)])
def test_repeat_passes_layout_matches_jax_package(name, lines):
    jtl = jt.compile_script(lines, 0.2, bank=JBank(), script_dir=CORPUS)
    ttl_ = ttl.compile_script(lines, 0.2, bank=TBank(), script_dir=CORPUS)
    assert jtl.fused_passes == ttl_.fused_passes and jtl.fused_passes >= 2
    jst = jb.pack_stacked(jb.stack_timelines([jtl] * 3))
    tst = tb.pack_stacked(tb.stack_timelines([ttl_] * 3))
    assert jst.tiers is None and tst.tiers is None
    assert tst.n_src == jst.n_src > 0
    if name == "union_cycle":       # estimate passes over a prefix only
        assert jst.n_src < jst.params["amp"].shape[-1]
    for k in jst.params:
        assert np.array_equal(tst.params[k], jst.params[k]), k
    want = jf.render_fused(jst, use_pallas=False)
    got = _render_cpu(tst)
    db = _db(got, want)
    print(f"{name}: repeat-passes vs the JAX package {db:.1f} dB")
    assert db <= -100.0, f"{name}: {db:.1f} dB"
    # the mix option changes the voice sum's order only
    assert _db(_render_cpu(tst, mix=False), got) <= -120.0


def test_repeat_passes_without_a_source_prefix():
    """Every voice a modulator source (n_src == Vp): the estimate passes
    run over all voices."""
    lines = ["v0 w0 f330 a3 F1,0.5", "v1 w2 f2 a2 ~.06 v0 F1,0 v1 F0,0.4"]
    st = _jax_packed(lines, 2, 0.2)
    assert st.tiers is None and st.n_src == st.params["amp"].shape[-1]
    want = jf.render_fused(st, use_pallas=False)
    assert _db(_render_cpu(st), want) <= -100.0


def test_render_batch_routes_a_repeat_passes_script(tmp_path):
    path = tmp_path / "union.sk"
    path.write_text("\n".join(UNION_CYCLE) + "\n")
    out = tb.render_batch([path], 0.1, device="cpu")
    st = _jax_packed(UNION_CYCLE, 1, 0.1)
    want = jf.render_fused(st, use_pallas=False)
    assert out.shape == want.shape
    assert _db(out, want) <= -100.0
