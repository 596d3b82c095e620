"""Random inputs for the noise pass's three kernels, from a numpy seed.

The tests hand the same arrays to the JAX package's ``phase_walk_pallas``,
``table_lookup_grouped`` / ``table_lookup_pallas`` and
``filt_smooth_pallas`` and to the port's plain versions; ``chip_smoke.py``
hands them to the CUDA kernels and to the plain versions on the card.
Values stay in the ranges a render produces (see ``tier_inputs``): phases
inside their tables, one-shot lanes near their ends, a few non-finite
increments, stable biquads and slow smoothers that keep every state out
of the f32 denormal range over a block.
"""

from __future__ import annotations

import numpy as np

# noise64.sk's two tiers (skred_tpu_torch/scripts/noise64.sk):
# phase walk (fm, finish) and FsFeat (flt, sm, hold, quant, am_self, env,
# am, alive_arr)
NOISE64_PW0 = (False, False)
NOISE64_PW1 = (True, True)
NOISE64_FS0 = (False, True, True, False, False, False, False, False)
NOISE64_FS1 = (True, True, True, True, False, True, True, True)


def _rng_helpers(rng, m):
    f = lambda lo, hi, shape=(m,): rng.uniform(lo, hi, shape).astype(
        np.float32)
    flag = lambda p, shape=(m,): (rng.uniform(0, 1, shape) < p).astype(
        np.int32)
    return f, flag


def random_phase_inputs(fm, finish, n, m, seed=0):
    """Returns the ten inputs of ``phase_walk`` in its argument order
    (inc, phase0, fin0, lo, hi, L, osn, one_shot, adv, act) as numpy."""
    rng = np.random.default_rng(seed)
    f, flag = _rng_helpers(rng, m)
    tsize = rng.choice(np.array([707, 2048, 4096, 8186, 60406], np.float32),
                       m)
    one_shot = flag(0.3) if finish else np.zeros(m, np.int32)
    loop_on = flag(0.3) * (1 - one_shot)
    lo = np.where(loop_on != 0, tsize * np.float32(0.25), 0) \
        .astype(np.float32)
    hi = np.where(loop_on != 0, tsize * np.float32(0.75), tsize) \
        .astype(np.float32)
    L = (hi - lo).astype(np.float32)
    osn = (one_shot * (1 - loop_on)).astype(np.int32)
    # one-shot lanes start near an end so some finish mid-block
    phase0 = np.where(one_shot != 0,
                      np.where(flag(0.5) != 0, hi - f(0.0, 400.0),
                               lo + f(0.0, 400.0)),
                      lo + f(0, 1) * L).astype(np.float32)
    if fm:
        inc = f(-60.0, 60.0, (n, m))
        inc[flag(0.002, (n, m)) != 0] = np.inf
    else:
        inc = f(-60.0, 60.0)
        inc[flag(0.01) != 0] = np.inf
    fin0 = flag(0.1) * one_shot
    adv = 1 - flag(0.1)
    act = 1 - flag(0.05)
    return (inc, phase0, fin0.astype(np.int32), lo, hi, L, osn,
            one_shot.astype(np.int32), adv.astype(np.int32),
            act.astype(np.int32))


def random_lookup_inputs(n, m, slot_size, seed=0, n_slots=4,
                         lane_major=True, out_of_range=False,
                         negative=False):
    """Returns (table [n_slots·slot_size] f32, slot [M] i32, idx i32) for
    the JAX-form lookups: idx is [M, N] (``lane_major``) or [N, M].
    Indices stay inside the slot unless ``out_of_range``, which puts some
    at or past its end, or ``negative``, which puts some below 0 (both
    read 0)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal(n_slots * slot_size).astype(np.float32)
    slot = rng.integers(0, n_slots, m).astype(np.int32)
    # runs of lanes share a slot, as voice-major lanes of one batch do
    slot = np.repeat(slot[: -(-m // 8)], 8)[:m].astype(np.int32)
    size = rng.integers(1, slot_size + 1, m)
    shape = (m, n) if lane_major else (n, m)
    sz = size[:, None] if lane_major else size[None, :]
    idx = (rng.uniform(0, 1, shape) * sz).astype(np.int32)
    if out_of_range:
        hit = rng.uniform(0, 1, shape) < 0.05
        idx = np.where(hit, slot_size + rng.integers(0, 3 * slot_size, shape),
                       idx).astype(np.int32)
    if negative:
        hit = rng.uniform(0, 1, shape) < 0.05
        idx = np.where(hit, -1 - rng.integers(0, 3 * slot_size, shape),
                       idx).astype(np.int32)
    return table, slot, idx


def random_fs_inputs(feat, n, m, seed=0):
    """Returns the 27 inputs of ``filt_smooth`` in its argument order as
    numpy (None for env/amod when ``feat`` has no such stream)."""
    flt, sm, hold, quant, am_self, env_a, am_a, alive_a = feat
    rng = np.random.default_rng(seed)
    f, flag = _rng_helpers(rng, m)
    x = f(-1, 1, (n, m))
    env = f(0, 1, (n, m)) if env_a else None
    # lanes without an am edge read the constant 1.0
    amod = np.where(flag(0.7)[None, :] != 0, f(-1.5, 1.5, (n, m)),
                    np.float32(1.0)).astype(np.float32) if am_a else None
    if alive_a:
        # dead is monotone within a block: alive is a prefix of each lane
        cnt = np.where(flag(0.7) != 0, n, rng.integers(0, n + 1, m))
        alive = (np.arange(n)[:, None] < cnt[None, :]).astype(np.int32)
    else:
        alive = 1 - flag(0.05)
    r, w = f(0.9, 0.98), f(0.05, 3.0)
    b0, b1, b2 = f(0.0, 0.5), f(-0.5, 0.5), f(0.0, 0.3)
    na1 = (np.float32(2) * r * np.cos(w)).astype(np.float32)
    na2 = (-(r * r)).astype(np.float32)
    hold_max = rng.integers(1, 2300, m).astype(np.int32)
    levels = ((1 << rng.integers(3, 9, m)) - 1).astype(np.float32)
    return (x, env, amod, alive.astype(np.int32), b0, b1, b2, na1, na2,
            flag(0.8), flag(0.8), f(0.1, 2.0), f(0.001, 0.05), flag(0.3),
            f(0.0, 1.0), flag(0.6), hold_max, flag(0.7), levels,
            (np.float64(1.0) / levels).astype(np.float32),
            f(-1, 1), f(-1, 1), f(-1, 1), f(-1, 1), f(0, 2),
            (rng.integers(0, 1 << 20, m) % hold_max).astype(np.int32),
            f(-1, 1))


# noise64.sk's two tiers for the keyed kernels: phase_walk_warp's
# (fm, finish, direction, cz, czm, cz_modes, ts_pow2) and
# filt_smooth_noise's (flt, sm, hold, quant, am_self, env, am, finish)
NOISE64_WARP0 = (False, False, False, False, False, (), True)
NOISE64_WARP1 = (True, True, False, True, False, (1, 2, 3, 4, 5, 6, 7),
                 False)
NOISE64_FSN0 = (False, True, True, False, False, False, False, False)
NOISE64_FSN1 = (True, True, True, True, False, True, True, True)


def random_warp_inputs(feat, n, m, b, w, seed=0, out_of_range=False):
    """Returns (bank [N, w·b], prev [w·b], vecs, phase0, fin0) as numpy
    for ``phase_walk_warp`` over M = V·b lanes (fin0 None without
    finish).  The bank holds audio-range samples; lane sources are drawn
    per lane, a tenth outside [0, w).  ``out_of_range`` adds operands
    the keyed kernel's fast wrap must hand to its exact pass: increments
    of 7.3 loop lengths (a tenth of the lanes), bank samples of ±1e30,
    ±inf and NaN, and NaN and infinite start phases."""
    from skred_tpu_torch.engine.kernels.tier_inputs import random_fold_inputs

    fm, finish, direction, cz, czm, modes, ts_pow2 = feat
    rng = np.random.default_rng(seed)
    f, flag = _rng_helpers(rng, m)
    sizes = [2048, 4096] if ts_pow2 and cz else [707, 2048, 4096, 8186,
                                                  60406]
    tsize = rng.choice(np.array(sizes, np.int32), m)
    tsz = tsize.astype(np.float32)
    one_shot = flag(0.3) if finish else np.zeros(m, np.int32)
    loop_on = flag(0.3) * (1 - one_shot)
    lo = np.where(loop_on != 0, tsz * np.float32(0.25), 0).astype(np.float32)
    hi = np.where(loop_on != 0, tsz * np.float32(0.75), tsz) \
        .astype(np.float32)
    L = (hi - lo).astype(np.float32)
    # one-shot lanes start near an end so some finish mid-block
    phase0 = np.where(one_shot != 0,
                      np.where(flag(0.5) != 0, hi - f(0.0, 400.0),
                               lo + f(0.0, 400.0)),
                      lo + f(0, 1) * L).astype(np.float32)
    vecs = {"lo": lo, "hi": hi, "L": L,
            "clip_i": np.maximum(tsize - 1, 0).astype(np.int32),
            "adv": 1 - flag(0.1), "act": 1 - flag(0.05)}
    fin0 = None
    if finish:
        vecs["osn"] = (one_shot * (1 - loop_on)).astype(np.int32)
        vecs["one_shot"] = one_shot.astype(np.int32)
        fin0 = (flag(0.1) * one_shot).astype(np.int32)
    streams = tuple(k for k, on in (("fm", fm), ("cz", cz and czm)) if on)
    bank, prev, fv = random_fold_inputs(n, m, b, w, seed=seed,
                                        streams=streams)
    vecs.update(fv)
    big = (L * np.float32(7.3)).astype(np.float32)
    if fm:
        vecs.update(use_fm=flag(0.8), mis=f(0.0, 60.0), pinc=f(0.5, 60.0),
                    fm_depth=f(0.0, 2.0))
        if direction:
            vecs["dirneg"] = flag(0.3)
        if out_of_range:
            vecs["pinc"] = np.where(flag(0.1) != 0, big, vecs["pinc"]) \
                .astype(np.float32)
    else:
        inc = f(-60.0, 60.0)
        inc[flag(0.01) != 0] = np.inf
        if out_of_range:
            u = rng.uniform(0, 1, m)
            inc = np.where(u < 0.1, big, inc).astype(np.float32)
            inc[(u >= 0.1) & (u < 0.13)] = np.nan
        vecs["inc"] = inc
    if cz:
        vecs.update(cz_mode=rng.choice(np.array((0,) + tuple(modes),
                                                np.int32), m),
                    cz_dist=f(0.0, 0.95), tsize=tsz)
        if czm:
            vecs.update(cm_ge0=flag(0.7), cz_depth=f(0.0, 0.6))
        else:
            vecs["dm"] = np.where(flag(0.5) != 0, 0.0, 1.0) \
                .astype(np.float32)
    if out_of_range:
        u = rng.uniform(0, 1, bank.shape)
        bank[u < 0.005] = np.inf
        bank[(u >= 0.005) & (u < 0.01)] = np.nan
        bank[(u >= 0.01) & (u < 0.02)] = np.float32(1e30)
        bank[(u >= 0.02) & (u < 0.03)] = np.float32(-1e30)
        u = rng.uniform(0, 1, m)
        phase0[u < 0.05] = np.nan
        phase0[(u >= 0.05) & (u < 0.1)] = np.inf
        phase0[(u >= 0.1) & (u < 0.15)] = -np.inf
    vecs = {k: np.ascontiguousarray(x) for k, x in vecs.items()}
    return bank, prev, vecs, phase0, fin0


def random_noise_fs_inputs(feat, n, m, b, w, seed=0):
    """Returns (f [N, M], noise_blk [N], cnt [M], cbase, bank, prev, vecs,
    states) as numpy for ``filt_smooth_noise`` over M = V·b lanes: the
    lookup's samples, the block's noise stream, alive counts (a lane
    with finish may die mid-block), the envelope's (with attacks of 0
    samples that give non-finite samples) and the am read's vectors and
    ``random_fs_inputs``' stages and states."""
    from skred_tpu_torch.engine.kernels.tier_inputs import random_fold_inputs

    flt, sm, hold, quant, am_self, env_a, am_a, finish = feat
    rng = np.random.default_rng(seed + 404)
    f, flag = _rng_helpers(rng, m)
    fs_in = random_fs_inputs((flt, sm, hold, quant, am_self, False, False,
                              finish), n, m, seed=seed)
    names = ("b0", "b1", "b2", "na1", "na2", "use_flt", "use_sm", "amp",
             "smoothing", "am_self", "am_depth", "hold_on", "hold_max",
             "quant_on", "levels", "inv_levels")
    vecs = dict(zip(names, fs_in[4:20]))
    states = dict(zip(("x1", "x2", "y1", "y2", "smoother", "hold_count",
                       "hold_val"), fs_in[20:]))
    act = 1 - flag(0.05)
    if finish:
        cnt = np.where(flag(0.7) != 0, n, rng.integers(0, n + 1, m))
        cnt = np.where(act != 0, cnt, 0)
    else:
        cnt = np.where(act != 0, n, 0)
    vecs["is_noise"] = flag(0.15)
    cbase = int(rng.integers(1, 30000))
    if env_a:
        i = lambda lo, hi: rng.integers(lo, hi, m).astype(np.int32)
        # a tenth of the lanes have an attack of 0 samples and start their
        # envelope inside the block: before it starts the envelope is
        # t/0 = -inf, and the gain, the smoother and the output reach
        # +-inf and NaN
        zero_att = flag(0.1) != 0
        vecs.update(use_env=flag(0.8), env_active=flag(0.9),
                    env_start=np.where(zero_att, cbase + i(0, n),
                                       i(0, 20000)).astype(np.int32),
                    env_rel_at=np.where(flag(0.5) != 0, i(1, 40000), 0)
                    .astype(np.int32),
                    att=np.where(zero_att, 0.0, f(1.0, 5000.0))
                    .astype(np.float32),
                    dec=f(1.0, 20000.0), sus=f(0.0, 1.0),
                    rel=f(1.0, 30000.0), vel=f(0.2, 1.0))
    bank, prev, fv = random_fold_inputs(n, m, b, w, seed=seed,
                                        streams=("am",) if am_a else ())
    if am_a:
        vecs.update(fv, am_ge0=flag(0.7), am_depth_a=f(0.0, 1.5))
    vecs = {k: np.ascontiguousarray(x) for k, x in vecs.items()}
    noise_blk = rng.uniform(-1, 1, n).astype(np.float32)
    return (fs_in[0], noise_blk, cnt.astype(np.int32), cbase, bank, prev,
            vecs, states)
