"""The tier kernel's in-kernel stereo mix and modulator-bank fold against
the JAX package's ``tier_pallas`` (interpret mode), on the CPU.

``tier_plain`` with ``mixw`` and with ``fold`` must give ``out``,
``out_last`` and every end state of ``tier_pallas(mixw=, b_rows=)`` /
``tier_pallas(bank=, srow_*=)`` bit for bit.  The accumulators are held
to 2e-6 of the largest |acc| (measured: 1.5e-5 of 146 and 3.8e-6 of 47,
one ulp of the largest sums, 13-22% of the cells differing): the TPU
kernel adds the voices of one grid step to each other before it adds
them onto the accumulator, an order that follows its step width, while
the port sums in ascending voice order.  The CUDA kernel itself is held against
``tier_plain`` on the card (tests/test_torch_tier_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skred_tpu.engine import kernels as jk
from skred_tpu_torch.engine import fused as tf
from skred_tpu_torch.engine.kernels import tier as tt
from skred_tpu_torch.engine.kernels.tier_inputs import (STRESS64_TIER1,
                                                        random_fold_inputs,
                                                        random_mix_weights,
                                                        random_tier_inputs)

torch.set_num_threads(1)

# filter + smoother only (test_mega's mix feature set)
FLT_SM = (False, False, False, False, True, True, False, False, False,
          False, False, False, (), False)
# all three cross-tier streams, hoisted am.  No smoother: XLA's CPU
# compiler contracts the interpreted kernel's ``gain * amod - sg`` into an
# fma when a per-sample amp-mod feeds the smoother (tests/test_torch_tier)
FOLD3 = (True, True, True, True, True, False, True, True, True, False,
         True, True, (1, 2, 3, 4, 5, 6, 7), False)
# the same with am_self lanes: the JAX package keeps such a tier unfolded
FOLD3_SELF = FOLD3[:9] + (True,) + FOLD3[10:]


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _td(d):
    return {k: _t(v) for k, v in d.items()}


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    bad = a != b
    assert not bad.any(), f"{what}: {bad.sum()} of {bad.size} differ"


def _jx(v):
    if isinstance(v, tuple):
        return tuple(jnp.asarray(x) for x in v)
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


def _pallas(args, feat, n, **kw):
    """tier_pallas in interpret mode on numpy inputs → numpy results."""
    table, cbase, inc, dm, amod, vecs, states = args
    j = lambda a: None if a is None else jnp.asarray(a)
    old = jk.INTERPRET
    jk.INTERPRET = True
    jax.clear_caches()
    try:
        out, res = jk.tier_pallas(
            j(table.reshape(-1, 128)), j(vecs["base_off"] // 32768),
            j(np.array([cbase], np.int32)), j(inc), j(dm), j(amod),
            {k: j(v) for k, v in vecs.items()},
            {k: j(v) for k, v in states.items()},
            feat=feat, exact=True, n=n,
            **{k: _jx(v) for k, v in kw.items()})
        return np.asarray(out), {k: np.asarray(v) for k, v in res.items()}
    finally:
        jk.INTERPRET = old
        jax.clear_caches()


def _plain(args, feat, n, **kw):
    """tier_plain with XLA's CPU denormal flush."""
    table, cbase, inc, dm, amod, vecs, states = args
    torch.set_flush_denormal(True)
    try:
        out, res = tt.tier_plain(_t(table), cbase, _t(inc), _t(dm), _t(amod),
                                 _td(vecs), _td(states), feat=feat,
                                 exact=True, n=n, **kw)
    finally:
        torch.set_flush_denormal(False)
    return out.numpy(), {k: v.numpy() for k, v in res.items()}


@pytest.mark.parametrize("B,V,cap,feat", [
    (1024, 3, 32, STRESS64_TIER1),    # a TPU grid step spans the voices
    (2048, 2, 8, FLT_SM)])            # a voice spans several grid steps
def test_mix_plain_matches_tier_pallas_interpret(B, V, cap, feat):
    n, m = 64, B * V
    args = random_tier_inputs(feat, n, m, seed=11)
    wl, wr = random_mix_weights(m, seed=11)
    old_cap = jk.MEGA_SUB_MAX
    jk.MEGA_SUB_MAX = cap
    try:
        want, wres = _pallas(args, feat, n, mixw=(wl, wr), b_rows=B // 128)
    finally:
        jk.MEGA_SUB_MAX = old_cap
    assert "acc_l" in wres, "the JAX kernel's mix did not engage"
    got, gres = _plain(args, feat, n, b=B, mixw=(_t(wl), _t(wr)))
    assert (want != 0).mean() > 0.5, "too few live samples to compare"
    _same(got, want, "out")
    assert sorted(gres) == sorted(wres)
    for k in wres:
        if k in ("acc_l", "acc_r"):
            scale = float(np.abs(wres[k]).max())
            err = float(np.abs(gres[k] - wres[k]).max())
            print(f"{k}: max |diff| {err:.3g} of {scale:.3g}, "
                  f"{(gres[k] != wres[k]).mean():.2%} of cells differ")
            assert gres[k].shape == (n, B)
            assert err <= 2e-6 * scale, f"{k}: {err} of {scale}"
        else:
            _same(gres[k], wres[k], k)
    _same(gres["out_last"], got[-1], "out_last is out's last row")


@pytest.mark.parametrize("streams", [("fm",), ("cz",), ("am",),
                                     ("fm", "cz", "am")],
                         ids=lambda s: "+".join(s))
def test_fold_plain_matches_tier_pallas_interpret(streams):
    """The JAX kernel takes one source per voice (a bank-row map entry per
    1024-lane sub-block at 1024 rows) and row 0 of its bank is the
    previous block's last samples.  Sources stay inside the bank and the
    bank holds no -0.0 here: the JAX kernel clamps a source past the bank
    to another voice, and passes a -0.0 sample on where the unfolded path
    (and the port) reads +0.0."""
    n, B, V, W = 64, 1024, 2, 2
    m = B * V
    feat = FOLD3
    table, cbase, inc, dm, amod, vecs, states = random_tier_inputs(
        feat, n, m, seed=12)
    bank, prev, fv = random_fold_inputs(n, m, B, W, seed=12, streams=streams,
                                        per_voice=True, bad_frac=0.0,
                                        zeros=False)
    given = {"fm": inc, "cz": dm, "am": amod}
    for k in streams:
        given[k] = None
    jvecs = dict(vecs)
    srow = {}
    for k in streams:
        jvecs[k + "_del"] = fv[k + "_del"]
        srow["srow_" + k] = (fv[k + "_src"][::B] * (B // 128)) \
            .astype(np.int32)
    want, wres = _pallas(
        (table, cbase, given["fm"], given["cz"], given["am"], jvecs, states),
        feat, n, bank=np.concatenate([prev[None], bank]), **srow)
    got, gres = _plain(
        (table, cbase, given["fm"], given["cz"], given["am"],
         {**vecs, **fv}, states), feat, n, b=B,
        fold=tt.Fold(_t(bank), _t(prev), W, streams))
    assert (want != 0).mean() > 0.4, "too few live samples to compare"
    _same(got, want, "out")
    assert sorted(gres) == sorted(wres)
    for k in wres:
        _same(gres[k], wres[k], k)


@pytest.mark.parametrize("feat", [FOLD3, FOLD3_SELF],
                         ids=["hoisted_am", "am_self"])
@pytest.mark.parametrize("streams", [("fm",), ("cz",), ("am",),
                                     ("fm", "cz", "am")],
                         ids=lambda s: "+".join(s))
def test_fold_plain_equals_unfolded_with_read_vm(streams, feat):
    """Folded = unfolded fed the renderer's ``_read_vm`` streams, bit for
    bit, with per-lane sources, sources outside the bank on both sides,
    exact and negative zeros in the bank, and the bank a column slice of
    a wider buffer that the pass writes its own columns of."""
    n, b, v, w = 48, 8, 6, 4
    m = b * v
    table, cbase, inc, dm, amod, vecs, states = random_tier_inputs(
        feat, n, m, seed=13)
    bank, prev, fv = random_fold_inputs(n, m, b, w, seed=13, streams=streams)
    buf = torch.zeros((n, (w + v) * b))
    buf[:, :w * b] = _t(bank)
    reads = {}
    for k in streams:
        osc = _t(fv[k + "_src"]).view(v, b).T      # [B, V]
        dly = _t(fv[k + "_del"]).view(v, b).T
        reads[k] = tf._read_vm(buf[:, :w * b], _t(prev), osc, dly, n, b)
    tv, ts = _td({**vecs, **fv}), _td(states)
    want, wres = tt.tier_plain(
        _t(table), cbase, reads.get("fm", _t(inc)), reads.get("cz", _t(dm)),
        reads.get("am", _t(amod)), tv, ts, feat=feat, n=n)
    given = {"fm": _t(inc), "cz": _t(dm), "am": _t(amod)}
    for k in streams:
        given[k] = None
    got, gres = tt.tier_plain(
        _t(table), cbase, given["fm"], given["cz"], given["am"], tv, ts,
        feat=feat, n=n, b=b, out=buf[:, w * b:],
        fold=tt.Fold(buf[:, :w * b], _t(prev), w, streams))
    assert got.data_ptr() == buf[:, w * b:].data_ptr()
    _same(got.numpy(), want.numpy(), "out")
    _same(buf[:, :w * b].numpy(), bank, "the bank's columns")
    assert sorted(gres) == sorted(wres)
    for k in wres:
        _same(gres[k].numpy(), wres[k].numpy(), k)


def test_fold_source_outside_the_bank_reads_zero():
    n, b, w = 16, 4, 3
    src = np.repeat(np.array([-1, -7, w, w + 1, 1], np.int32), b)
    m = src.shape[0]
    rng = np.random.default_rng(5)
    bank = rng.uniform(0.5, 1, (n, w * b)).astype(np.float32)
    prev = rng.uniform(0.5, 1, w * b).astype(np.float32)
    dly = (rng.uniform(0, 1, m) < 0.5).astype(np.int32)
    rd = tt.fold_read_plain(_t(bank), _t(prev), _t(src), _t(dly), w, b,
                            n).numpy()
    zero = rd[:, :4 * b]
    assert not zero.any() and not np.signbit(zero).any(), \
        "a source outside [0, w) must read +0.0, never another voice"
    want = np.where(dly[4 * b:, None] != 0,
                    np.concatenate([prev[None, b:2 * b], bank[:-1, b:2 * b]]
                                   ).T, bank[:, b:2 * b].T).T
    _same(rd[:, 4 * b:], want, "the one valid voice")
    # no bank at all (a first tier): every read is +0.0
    rd0 = tt.fold_read_plain(None, _t(prev[:0]), _t(src), _t(dly), 0, b, n)
    assert rd0.shape == (n, m) and not rd0.numpy().any()


def test_mix_plain_sums_in_ascending_voice_order():
    """Product and sum rounded once each, voices ascending from +0.0,
    then the earlier tiers' accumulators plus this tier's sum."""
    n, b, v = 8, 5, 7
    rng = np.random.default_rng(6)
    out = rng.standard_normal((n, v * b)).astype(np.float32)
    wl, wr = random_mix_weights(v * b, seed=6)
    prior = [rng.standard_normal((n, b)).astype(np.float32) for _ in (0, 1)]
    want = []
    for w, pr in zip((wl, wr), prior):
        s = np.zeros((n, b), np.float32)
        for k in range(v):
            s = (s + (out[:, k * b:(k + 1) * b]
                      * w[k * b:(k + 1) * b]).astype(np.float32)) \
                .astype(np.float32)
        want.append((s, (pr + s).astype(np.float32)))
    got = tt.mix_plain(_t(out), _t(wl), _t(wr), b)
    got_acc = tt.mix_plain(_t(out), _t(wl), _t(wr), b, acc=_td(
        {"l": prior[0], "r": prior[1]}).values())
    for c in (0, 1):
        _same(got[c].numpy(), want[c][0], f"channel {c}")
        _same(got_acc[c].numpy(), want[c][1], f"channel {c} onto acc")


def test_tier_cpu_mix_and_fold_take_plain_version_in_place():
    """On CPU tensors ``tier`` runs the plain version (no launch), writes
    ``out`` into the view it is given and adds onto ``acc`` in place."""
    feat, n, b, v, w = FOLD3_SELF, 16, 4, 3, 2
    m = b * v
    table, cbase, inc, dm, amod, vecs, states = random_tier_inputs(
        feat, n, m, seed=14)
    bank, prev, fv = random_fold_inputs(n, m, b, w, seed=14)
    wl, wr = random_mix_weights(m, seed=14)
    buf = torch.zeros((n, (w + v) * b))
    buf[:, :w * b] = _t(bank)
    acc = (torch.full((n, b), 0.5), torch.full((n, b), -0.25))
    before = tt.tier.launches
    out, res = tt.tier(_t(table), cbase, None, None, None,
                       _td({**vecs, **fv}), _td(states), feat=feat, n=n, b=b,
                       mixw=(_t(wl), _t(wr)), acc=acc, out=buf[:, w * b:],
                       fold=tt.Fold(buf[:, :w * b], _t(prev), w))
    assert tt.tier.launches == before, "a CPU tensor launched the kernel"
    assert res["acc_l"] is acc[0] and res["acc_r"] is acc[1]
    _same(buf[:, w * b:].numpy(), out.numpy(), "out written in place")
    sums = tt.mix_plain(out, _t(wl), _t(wr), b)
    _same(acc[0].numpy(), (0.5 + sums[0]).numpy(), "acc_l")
    _same(acc[1].numpy(), (-0.25 + sums[1]).numpy(), "acc_r")
    _same(res["out_last"].numpy(), out[-1].numpy(), "out_last")
    with pytest.raises(ValueError, match="need b"):
        tt.tier(_t(table), cbase, None, None, None, _td({**vecs, **fv}),
                _td(states), feat=feat, n=n,
                fold=tt.Fold(buf[:, :w * b], _t(prev), w))
