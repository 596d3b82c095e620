"""The keyed noise kernels' plain versions against the noise pass's
stage sequence and against the JAX package's noise branch.

``phase_walk_warp_plain`` (the modulator reads, the FM increment, the
walk, the CZ warp and clip, the alive count) and
``filt_smooth_noise_plain`` (the noise select, the dead mask, the
envelope, the am stream and the serial stages) are what the keyed CUDA
kernels compute; the card holds each kernel to them bit for bit
(tests/test_torch_noise_cuda.py, chip_smoke.py).  Here, on seeded numpy
inputs over every key family, they must equal bit for bit

* the stage sequence the noise pass ran before the glue moved into the
  kernels (written out below as ``_stages_walk`` and ``_stages_fs``), and
* the JAX package's noise branch of ``_voice_block_pass`` built from its
  own pieces: ``_read_block``, the FM increment, ``phase_walk_pallas`` and
  ``filt_smooth_pallas`` in interpret mode, ``_cz_phasor`` and
  ``_envelope_block``, in the JAX package's exact and fast mode.  The
  port's kernels have no arithmetic mode: they take one fma at each
  ``a*b + c`` site (the FM increment, the biquad, the smoother), which is
  the JAX exact mode's ``_kfma`` and what XLA's CPU compiler contracts
  the fast mode's jitted FM increment and smoother into.  Inside the
  interpreted fast-mode kernel XLA contracts the biquad's four sites
  where it chooses, not at each, and in either mode the kernel's
  ``amp*env*amod - sg`` (ROADMAP §3): the fast-mode comparison of the
  serial stages leaves out the biquad, and both leave out the smoother
  where a gain stream feeds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skred_tpu.engine import fused as jf
from skred_tpu.engine import kernels as jk
from skred_tpu_torch.engine.kernels import filt_smooth as fs
from skred_tpu_torch.engine.kernels import phase_walk as pw
from skred_tpu_torch.engine.kernels.noise_inputs import (
    NOISE64_FSN0, NOISE64_FSN1, NOISE64_WARP0, NOISE64_WARP1,
    random_noise_fs_inputs, random_warp_inputs)
from skred_tpu_torch.engine.kernels.tier import Fold, fold_read_plain
from skred_tpu_torch.engine.numerics import cz_phasor, div32, fma32

torch.set_num_threads(1)

ALL = (1, 2, 3, 4, 5, 6, 7)
# (fm, finish, direction, cz, czm, cz_modes, ts_pow2)
WARP = {
    "noise64_tier0": NOISE64_WARP0,
    "noise64_tier1": NOISE64_WARP1,
    "fm_dir_czm_all": (True, True, True, True, True, ALL, False),
    "fm_czm_pow2": (True, False, False, True, True, (1, 4, 6), True),
    "cz_no_fm": (False, True, False, True, False, (2, 3, 5, 7), False),
    "czm_no_fm": (False, False, False, True, True, ALL, False),
}
# (flt, sm, hold, quant, am_self, env, am, finish)
FSN = {
    "noise64_tier0": NOISE64_FSN0,
    "noise64_tier1": NOISE64_FSN1,
    "noise64_tier1_without_sm": (True, False, True, True, False, True, True,
                                 True),
    "am_self_env_am": (True, False, True, True, True, True, True, False),
    "sm_without_gain_streams": (True, True, True, True, False, False, False,
                                True),
    "none": (False,) * 8,
}
N, B, V, W = 32, 64, 8, 3              # samples, rows, voices, bank voices
M = B * V                              # 512: the JAX kernels' lane quantum


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _same(a, b, what):
    """Bit for bit, except that two NaNs agree whatever their payload; a
    NaN against a number still differs."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    both_nan = np.zeros(a.shape, bool)
    if a.dtype == np.float32:
        both_nan = np.isnan(a) & np.isnan(b)
        a, b = a.view(np.int32), b.view(np.int32)
    bad = (a != b) & ~both_nan
    assert not bad.any(), f"{what}: {bad.sum()} of {bad.size} differ"


def _flushed(fn, *args, **kw):
    # XLA's CPU runtime flushes denormals; run the torch side the same
    torch.set_flush_denormal(True)
    try:
        return fn(*args, **kw)
    finally:
        torch.set_flush_denormal(False)


def _interpret(fn, *args, **kw):
    old = jk.INTERPRET
    jk.INTERPRET = True
    try:
        return jax.tree_util.tree_map(np.asarray, fn(*args, **kw))
    finally:
        jk.INTERPRET = old


def _warp_inputs(feat, seed):
    bank, prev, vecs, ph0, fin0 = random_warp_inputs(feat, N, M, B, W,
                                                     seed=seed)
    return (Fold(_t(bank), _t(prev), W), {k: _t(x) for k, x in vecs.items()},
            _t(ph0), _t(fin0)), (bank, prev, vecs, ph0, fin0)


def _fs_inputs(feat, seed):
    f, nz, cnt, cbase, bank, prev, vecs, states = random_noise_fs_inputs(
        feat, N, M, B, W, seed=seed)
    return ((_t(f), _t(nz), _t(cnt), cbase, Fold(_t(bank), _t(prev), W),
             {k: _t(x) for k, x in vecs.items()},
             {k: _t(x) for k, x in states.items()}),
            (f, nz, cnt, cbase, bank, prev, vecs, states))


# ---- the noise pass's stage sequence before its glue moved into the
# keyed kernels (engine/fused.py) ----

def _stages_walk(bank, v, phase0, fin0, feat):
    fm, finish, direction, cz, czm, modes, _ = feat
    fma = fma32                     # in both modes (phase_walk.fm_increment)
    on = lambda k: v[k] != 0
    read = lambda k: fold_read_plain(bank.bank, bank.prev, v[k + "_src"],
                                     v[k + "_del"], bank.w, B, N)
    if fm:
        g = read("fm") * v["fm_depth"]
        inc = torch.where(on("use_fm"), fma(v["mis"], g, v["pinc"]),
                          v["pinc"])
        if direction:
            inc = torch.where(on("dirneg"), -inc, inc)
    else:
        inc = v["inc"]
    ph, dead, ph_end, fin_end = pw.phase_walk_plain(
        inc, phase0, fin0, v["lo"], v["hi"], v["L"], v.get("osn"),
        v.get("one_shot"), v["adv"], v["act"], fm=fm, finish=finish, n=N)
    if cz:
        if czm:
            dm = torch.where(on("cm_ge0"), read("cz") * v["cz_depth"], 1.0)
        else:
            dm = v["dm"]
        cz_idx = cz_phasor(v["cz_mode"], ph, v["cz_dist"] + dm, v["tsize"],
                           modes=modes)
        idx_f = torch.where(v["cz_mode"] != 0, cz_idx, ph)
    else:
        idx_f = ph
    idx = torch.minimum(torch.clamp(idx_f.to(torch.int32), min=0),
                        v["clip_i"])
    if finish:
        cnt = (dead == 0).sum(dim=0, dtype=torch.int32)
    else:
        cnt = torch.where(on("act"), N, 0).to(torch.int32)
    return idx, cnt, ph_end, fin_end


def _stages_fs(f, noise_blk, cnt, cbase, bank, v, states, feat):
    flt, sm, hold, quant, am_self, env_a, am_a, finish = feat
    on = lambda k: v[k] != 0
    f = torch.where(on("is_noise"), noise_blk[:, None], f)
    alive = torch.arange(N)[:, None] < cnt[None]
    if finish:
        f = torch.where(alive, f, 0.0)
        alive_in = alive.to(torch.int32)
    else:
        f = torch.where(cnt != 0, f, 0.0)
        alive_in = (cnt != 0).to(torch.int32)
    env = amod = None
    if env_a:
        counts = cbase + torch.arange(N, dtype=torch.int32)[:, None]
        t = (counts - v["env_start"]).to(torch.float32)
        tr = (counts - v["env_rel_at"]).to(torch.float32)
        att, dec, sus, rel = v["att"], v["dec"], v["sus"], v["rel"]
        e = torch.where(
            t < att, div32(t, att),
            torch.where(t < att + dec,
                        fma32(-div32(t - att, dec), 1.0 - sus, 1.0),
                        torch.where(v["env_rel_at"] == 0, sus,
                                    torch.where(tr < rel,
                                                sus * (1.0 - div32(tr, rel)),
                                                0.0))))
        e = torch.where(on("env_active"), e, 0.0)
        env = torch.where(on("use_env"), e * v["vel"], 1.0)
    if am_a:
        read = fold_read_plain(bank.bank, bank.prev, v["am_src"], v["am_del"],
                               bank.w, B, N)
        amod = torch.where(on("am_ge0"), read * v["am_depth_a"], 1.0)
    st = lambda k, used: states[k] if used else None
    return fs.filt_smooth_plain(
        f, env, amod, alive_in, *(v.get(k) for k in fs._FS_ARG_VECS),
        st("x1", flt), st("x2", flt), st("y1", flt), st("y2", flt),
        st("smoother", sm), st("hold_count", hold), st("hold_val", hold),
        feat=feat)


@pytest.mark.parametrize("seed", [71, 171])
@pytest.mark.parametrize("family", sorted(WARP))
def test_walk_warp_plain_matches_stage_sequence(family, seed):
    feat = WARP[family]
    args, _ = _warp_inputs(feat, seed=seed)
    got = pw.phase_walk_warp_plain(*args, feat=feat, n=N, b=B)
    want = _stages_walk(*args, feat)
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
        else:
            _same(g.numpy(), w.numpy(), f"output {k}")
    assert (got[0] > 0).float().mean() > 0.5


@pytest.mark.parametrize("seed", [72, 172])
@pytest.mark.parametrize("family", sorted(FSN))
def test_filt_smooth_noise_plain_matches_stage_sequence(family, seed):
    feat = FSN[family]
    args, _ = _fs_inputs(feat, seed=seed)
    out, ends = fs.filt_smooth_noise_plain(*args, feat=feat, b=B)
    want = _stages_fs(*args, feat)
    _same(out.numpy(), want[0].numpy(), "out")
    names = dict(zip(fs._END_NAMES, want[1:]))
    for k, x in ends.items():
        _same(x.numpy(), names[k].numpy(), k)
    kept = {"flt": ("x1", "x2", "y1", "y2"), "sm": ("smoother",),
            "hold": ("hold_count", "hold_val")}
    assert sorted(ends) == sorted(k for st, on in zip(("flt", "sm", "hold"),
                                                      feat[:3]) if on
                                  for k in kept[st])
    assert (out != 0).float().mean() > 0.5


# ---- the JAX package's noise branch, from its pieces ----

def _jax_read(bank, prev, src, dly):
    """``_read_block`` on the bank in the JAX layout, back to [N, M]."""
    est = jnp.asarray(bank.reshape(N, W, B).transpose(2, 1, 0))
    last = jnp.asarray(prev.reshape(W, B).T)
    osc = jnp.asarray(src.reshape(V, B).T)
    dl = jnp.asarray(dly.reshape(V, B).T)
    out = np.asarray(jf._read_block(est, last, osc, dl))     # [B, V, N]
    return out.transpose(2, 1, 0).reshape(N, M)


def _jax_walk(raw, feat, exact):
    bank, prev, v, ph0, fin0 = raw
    fm, finish, direction, cz, czm, modes, _ = feat
    if fm:
        g = _jax_read(bank, prev, v["fm_src"], v["fm_del"]) * v["fm_depth"]
        # jitted, as the engine runs it: fast mode's mis*g + pinc is then
        # the one fma XLA's CPU compiler contracts it into
        fm_inc = jax.jit(jf._fma, static_argnums=3)
        inc = jnp.where(v["use_fm"] != 0,
                        fm_inc(jnp.asarray(v["mis"]), jnp.asarray(g),
                               jnp.asarray(v["pinc"]), exact),
                        jnp.asarray(v["pinc"]))
        if direction:
            inc = jnp.where(v["dirneg"] != 0, -inc, inc)
    else:
        inc = jnp.asarray(v["inc"])
    zero = np.zeros(M, np.int32)
    ph, dead, ph_end, fin_end = _interpret(
        jk.phase_walk_pallas, inc, jnp.asarray(ph0),
        jnp.asarray(fin0 if finish else zero), jnp.asarray(v["lo"]),
        jnp.asarray(v["hi"]), jnp.asarray(v["L"]),
        jnp.asarray(v.get("osn", zero)), jnp.asarray(v.get("one_shot", zero)),
        jnp.asarray(v["adv"]), jnp.asarray(v["act"]), fm=fm, finish=finish,
        n=N)
    if cz:
        if czm:
            rd = _jax_read(bank, prev, v["cz_src"], v["cz_del"])
            dm = jnp.where(v["cm_ge0"] != 0, rd * v["cz_depth"], 1.0)
        else:
            dm = jnp.asarray(v["dm"])
        cz_idx = jf._cz_phasor(jnp.asarray(v["cz_mode"]), jnp.asarray(ph),
                               jnp.asarray(v["cz_dist"]) + dm,
                               jnp.asarray(v["tsize"]), modes=modes)
        idx_f = jnp.where(v["cz_mode"] != 0, cz_idx, ph)
    else:
        idx_f = jnp.asarray(ph)
    idx = np.asarray(jnp.clip(idx_f.astype(jnp.int32), 0, v["clip_i"]))
    cnt = (dead == 0).sum(axis=0).astype(np.int32) if finish \
        else np.where(v["act"] != 0, N, 0).astype(np.int32)
    return idx, cnt, ph_end, fin_end


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("family", sorted(WARP))
def test_walk_warp_plain_matches_jax_noise_branch(family, exact):
    feat = WARP[family]
    args, raw = _warp_inputs(feat, seed=73)
    got = _flushed(pw.phase_walk_warp_plain, *args, feat=feat, n=N, b=B)
    want = _jax_walk(raw, feat, exact)
    if feat[1]:
        assert 0 < (want[1] < N).mean() < 1, "no lane died or every one did"
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None or not feat[1] and k == 3:
            assert g is None
        else:
            _same(g.numpy(), np.asarray(w).reshape(g.shape), f"output {k}")


def _jax_fs(raw, feat, exact):
    f, nz, cnt, cbase, bank, prev, v, states = raw
    flt, sm, hold, quant, am_self, env_a, am_a, finish = feat
    alive = np.arange(N)[:, None] < cnt[None]
    x = jnp.where(v["is_noise"] != 0, jnp.asarray(nz)[:, None],
                  jnp.asarray(f))
    if finish:
        x = jnp.where(alive, x, 0.0)
        alive_in = jnp.asarray(alive.astype(np.int32))
    else:
        x = jnp.where(cnt != 0, x, 0.0)
        alive_in = jnp.asarray((cnt != 0).astype(np.int32))
    env = amod = None
    if env_a:
        p = {"env_start": v["env_start"], "env_attack": v["att"],
             "env_decay": v["dec"], "env_sustain": v["sus"],
             "env_release": v["rel"], "env_rel_at": v["env_rel_at"],
             "env_active": v["env_active"]}
        p = {k: jnp.asarray(a) for k, a in p.items()}
        counts = jnp.asarray(cbase + np.arange(N, dtype=np.int32))
        e = jf._envelope_block(counts, p)[0].T             # [N, M]
        env = jnp.where(v["use_env"] != 0, e * v["vel"], 1.0)
    if am_a:
        rd = _jax_read(bank, prev, v["am_src"], v["am_del"])
        amod = jnp.where(v["am_ge0"] != 0, rd * v["am_depth_a"], 1.0)
    j = lambda k: jnp.asarray(v[k]) if k in v else None
    zf = jnp.zeros(M, jnp.float32)
    zi = jnp.zeros(M, jnp.int32)
    s = lambda k, z: jnp.asarray(states[k]) if k in states else z
    return _interpret(
        jk.filt_smooth_pallas, x, env, amod, alive_in,
        *(j(k) if j(k) is not None else zf for k in ("b0", "b1", "b2", "na1",
                                                     "na2")),
        j("use_flt"), j("use_sm"), j("amp"), j("smoothing"), j("am_self"),
        j("am_depth"), j("hold_on"), j("hold_max"), j("quant_on"),
        j("levels"), j("inv_levels"), s("x1", zf), s("x2", zf), s("y1", zf),
        s("y2", zf), s("smoother", zf), s("hold_count", zi),
        s("hold_val", zf), exact=exact, feat=feat)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("family", sorted(FSN))
def test_filt_smooth_noise_plain_matches_jax_noise_branch(family, exact):
    feat = FSN[family]
    flt, sm, hold, quant, am_self, env_a, am_a, finish = feat
    if sm and (env_a or am_a or am_self):
        # the interpreted kernel's amp*env*amod - sg: XLA contracts it
        feat = (flt, False) + feat[2:]
    if not exact:
        # the interpreted fast biquad's a*b + c: XLA contracts some of its
        # four sites, not each (the fast smoother it contracts, as here)
        feat = (False,) + feat[1:]
    args, raw = _fs_inputs(feat, seed=74)
    out, ends = _flushed(fs.filt_smooth_noise_plain, *args, feat=feat, b=B)
    want = _jax_fs(raw, feat, exact)
    assert (want[0] != 0).mean() > 0.5, "too few live samples to compare"
    _same(out.numpy(), want[0], "out")
    for k, x in ends.items():
        _same(x.numpy(), want[1 + fs._END_NAMES.index(k)], k)


# ---- the wrappers, the keys and the argument structs ----

def test_cpu_tensors_take_the_plain_versions():
    before = (pw.phase_walk_warp.launches, fs.filt_smooth_noise.launches)
    feat = WARP["fm_dir_czm_all"]
    args, _ = _warp_inputs(feat, seed=75)
    got = pw.phase_walk_warp(*args, feat=feat, n=N, b=B)
    want = pw.phase_walk_warp_plain(*args, feat=feat, n=N, b=B)
    for g, w in zip(got, want):
        _same(g.numpy(), w.numpy(), "phase_walk_warp")
    feat = FSN["am_self_env_am"]
    args, _ = _fs_inputs(feat, seed=75)
    buf = torch.full((N, M + 5), 3.0)
    out, ends = fs.filt_smooth_noise(*args, feat=feat, b=B, out=buf[:, 5:])
    want, want_ends = fs.filt_smooth_noise_plain(*args, feat=feat, b=B)
    _same(buf[:, 5:].numpy(), want.numpy(), "into out")
    assert (buf[:, :5] == 3.0).all()
    assert (pw.phase_walk_warp.launches, fs.filt_smooth_noise.launches) \
        == before, "a CPU tensor launched a kernel"


def test_keys_name_only_what_a_build_depends_on():
    a = pw.phase_walk_key((False, True, True, False, True, ALL, True))
    b = pw.phase_walk_key((False, True, False, False, False, (), False))
    assert a == b                  # no fm: direction drops; no cz: the rest
    assert "PW_CZ_MASK=254" in pw.phase_walk_key(NOISE64_WARP1)
    assert fs.filt_smooth_key(NOISE64_FSN1[:7] + (False,)) \
        == fs.filt_smooth_key(NOISE64_FSN1)          # finish compiles away
    # the keys name no arithmetic mode: one build serves exact and fast
    assert not any("EXACT" in d for d in pw.phase_walk_key(NOISE64_WARP1)
                   + fs.filt_smooth_key(NOISE64_FSN0))
