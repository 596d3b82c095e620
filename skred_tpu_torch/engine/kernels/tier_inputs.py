"""Random tier-kernel inputs from a numpy seed.

The tests hand the same arrays to the JAX package's ``tier_pallas`` and to
the port's ``tier_plain``; ``chip_smoke.py`` hands them to the CUDA kernel
and to ``tier_plain`` on the card.  Values stay in the ranges a render
produces: phases inside their tables, stable biquads, envelopes in
samples, hold counts below their periods.  Filter poles and smoothing
rates keep every state out of the f32 denormal range over a 512-sample
block even when the input or the gain is zero: there the f32 emulation
of an fma that the plain version uses and the card's hardware fma round
differently.
"""

from __future__ import annotations

import numpy as np

from skred_tpu_torch.engine.kernels.tier import (_FOLD_VECS, _flags,
                                                 _state_keys, _vec_keys)

# stress64's two tier feature sets (per-tier flags of corpus/stress64.sk)
STRESS64_TIER0 = (False, False, False, False, False, True, False, False,
                  False, False, False, False, (), True)
STRESS64_TIER1 = (True, True, False, False, True, True, True, True,
                  False, False, False, False, (1, 2, 3, 4, 5, 6, 7), True)


def random_tier_inputs(feat, n, m, seed=0, table_len=65536):
    """Returns (table [R], cbase, inc, dm, amod, vecs, states) as numpy
    arrays: f32 and i32, lanes along the last axis."""
    fl = _flags(feat)
    rng = np.random.default_rng(seed)
    f = lambda lo, hi, shape=(m,): rng.uniform(lo, hi, shape).astype(
        np.float32)
    i = lambda lo, hi: rng.integers(lo, hi, m).astype(np.int32)
    flag = lambda p: (rng.uniform(0, 1, m) < p).astype(np.int32)

    table = rng.standard_normal(table_len).astype(np.float32)
    if fl["ts_pow2"]:
        tsize = rng.choice(np.array([2048, 4096], np.int32), m)
    else:
        tsize = rng.choice(np.array([707, 2766, 4096, 8186], np.int32), m)
    base_off = (rng.integers(0, table_len // 8192, m) * 8192) \
        .astype(np.int32)
    tsz_f = tsize.astype(np.float32)
    one_shot = flag(0.3) if fl["finish"] else np.zeros(m, np.int32)
    loop_on = flag(0.3) * (1 - one_shot)
    lo = np.where(loop_on != 0, (tsz_f * np.float32(0.25)), 0) \
        .astype(np.float32)
    hi = np.where(loop_on != 0, (tsz_f * np.float32(0.75)), tsz_f) \
        .astype(np.float32)
    L = (hi - lo).astype(np.float32)
    vals = {
        "base_off": base_off, "clip_i": np.maximum(tsize - 1, 0),
        "adv": 1 - flag(0.05), "act": 1 - flag(0.05),
        "lo": lo, "hi": hi, "L": L, "amp": f(0.1, 2.0),
        "use_fm": flag(0.8), "mis": f(0.0, 60.0), "pinc": f(0.5, 60.0),
        "fm_depth": f(0.0, 2.0), "dirneg": flag(0.3),
        "cm_ge0": flag(0.7), "cz_depth": f(0.0, 0.6),
        "am_ge0": flag(0.7), "am_depth_a": f(0.0, 1.5),
        "osn": (one_shot * (1 - loop_on)).astype(np.int32),
        "one_shot": one_shot,
        "cz_mode": rng.choice(np.array((0,) + fl["cz_modes"], np.int32), m),
        "cz_dist": f(0.0, 0.95), "tsize": tsz_f,
        "use_env": flag(0.8), "env_active": flag(0.9),
        "env_start": i(0, 20000), "env_rel_at": np.where(
            flag(0.5) != 0, i(1, 40000), 0).astype(np.int32),
        "att": f(1.0, 5000.0), "dec": f(1.0, 20000.0), "sus": f(0.0, 1.0),
        "rel": f(1.0, 30000.0), "vel": f(0.2, 1.0),
        "use_flt": flag(0.8), "use_sm": flag(0.8),
        "smoothing": f(0.001, 0.05), "am_self": flag(0.3),
        "am_depth": f(0.0, 1.0), "hold_on": flag(0.6),
        "hold_max": i(1, 7), "quant_on": flag(0.7),
    }
    # stable biquads: poles at radius r < 1, angle w
    r, w = f(0.9, 0.98), f(0.05, 3.0)
    vals.update(b0=f(0.0, 0.5), b1=f(-0.5, 0.5), b2=f(0.0, 0.3),
                na1=(np.float32(2) * r * np.cos(w)).astype(np.float32),
                na2=(-(r * r)).astype(np.float32))
    levels = ((1 << i(3, 9)) - 1).astype(np.float32)
    vals.update(levels=levels, inv_levels=(np.float64(1.0) / levels)
                .astype(np.float32))
    vecs = {k: np.ascontiguousarray(vals[k], dtype=np.dtype(str(dt)[6:]))
            for k, dt in _vec_keys(fl)}
    # one-shot lanes start near their end so some finish mid-block
    phase = np.where(one_shot != 0, hi - f(0.0, 400.0), lo + f(0, 1) * L) \
        .astype(np.float32)
    st_vals = {
        "phase": phase, "finished": flag(0.1) * one_shot,
        "x1": f(-1, 1), "x2": f(-1, 1), "y1": f(-1, 1), "y2": f(-1, 1),
        "smoother": f(0, 2), "hold_val": f(-1, 1),
    }
    st_vals["hold_count"] = (rng.integers(0, 1 << 20, m)
                             % vals["hold_max"]).astype(np.int32)
    states = {k: np.ascontiguousarray(st_vals[k],
                                      dtype=np.dtype(str(dt)[6:]))
              for k, dt in _state_keys(fl)}
    cbase = int(rng.integers(1, 30000))
    inc = f(-1, 1, (n, m)) if fl["fm"] else f(0.5, 60.0)
    if fl["czm"]:
        dm = f(-1, 1, (n, m))
    elif fl["cz"]:
        dm = np.where(flag(0.5) != 0, 0.0, 1.0).astype(np.float32)
    else:
        dm = None
    amod = f(-1, 1, (n, m)) if fl["am"] else None
    return table, cbase, inc, dm, amod, vecs, states


def random_mix_weights(m, seed=0):
    """Per-lane stereo weights (wl, wr) [M] f32 as the renderer builds
    them: a pan pair in [0, 1], zero on about a fifth of the lanes
    (silent, disconnected or pan-modulated voices)."""
    rng = np.random.default_rng(seed + 101)
    pan = rng.uniform(0, 1, m).astype(np.float32)
    on = rng.uniform(0, 1, m) < 0.8
    wl = np.where(on, np.float32(1) - pan, 0).astype(np.float32)
    wr = np.where(on, pan, 0).astype(np.float32)
    return wl, wr


def random_fold_inputs(n, m, b, w, seed=0, streams=("fm", "cz", "am"),
                       per_voice=False, bad_frac=0.1, zeros=True):
    """A modulator bank for a folded tier pass: (bank [N, w*b], prev
    [w*b], {``*_src``/``*_del``: [M] i32} for ``streams``).

    Sources are drawn per lane (per voice with ``per_voice``, the JAX
    kernel's row-uniform topology); ``bad_frac`` of them lie outside
    [0, w) on either side and must read 0.0.  The bank holds audio-range
    samples, with ``zeros`` a few exact and negative zeros among them."""
    rng = np.random.default_rng(seed + 202)
    bank = rng.uniform(-1, 1, (n, w * b)).astype(np.float32)
    zero = rng.uniform(0, 1, bank.shape)
    if zeros:
        bank[zero < 0.01] = 0.0
        bank[zero > 0.99] = -0.0
    prev = rng.uniform(-1, 1, w * b).astype(np.float32)
    vecs = {}
    for k in streams:
        src_k, del_k = _FOLD_VECS[k]
        shape = m // b if per_voice else m
        src = rng.integers(0, max(w, 1), shape)
        bad = rng.uniform(0, 1, shape) < bad_frac
        src = np.where(bad, rng.choice(np.array([-1, w, w + 3]), shape), src)
        if per_voice:
            src = np.repeat(src, b)
        vecs[src_k] = src.astype(np.int32)
        vecs[del_k] = (rng.uniform(0, 1, m) < 0.4).astype(np.int32)
    return bank, prev, vecs


def out_of_range(feat, inputs, seed=0):
    """``random_tier_inputs``' tuple with phase-walk operands outside the
    fast range of the keyed kernel's wrap (``wrap_fmod``), which must take
    its exact slow path: increments of 7.3 loop lengths (10% of the
    lanes), with raw FM stream samples of ±1e30 (2% of the samples) and
    infinite or NaN ones (1% each), and start phases that are NaN, +inf
    or -inf (5% of the lanes each).  Indices stay clipped, so no read
    leaves a lane's table."""
    table, cbase, inc, dm, amod, vecs, states = inputs
    fl = _flags(feat)
    rng = np.random.default_rng(seed + 303)
    m = vecs["amp"].shape[0]
    pick = lambda p, shape=(m,): rng.uniform(0, 1, shape) < p
    vecs, states = dict(vecs), dict(states)
    big = (vecs["L"] * np.float32(7.3)).astype(np.float32)
    if fl["fm"]:
        vecs["pinc"] = np.where(pick(0.1), big, vecs["pinc"]) \
            .astype(np.float32)
    if fl["fm"] and inc is not None:        # None: the stream is folded
        inc = inc.copy()
        u = rng.uniform(0, 1, inc.shape)
        inc[u < 0.01] = np.inf
        inc[(u >= 0.01) & (u < 0.02)] = np.nan
        inc[(u >= 0.02) & (u < 0.03)] = np.float32(1e30)
        inc[(u >= 0.03) & (u < 0.04)] = np.float32(-1e30)
    elif not fl["fm"]:
        u = rng.uniform(0, 1, m)
        inc = np.where(u < 0.1, big, inc).astype(np.float32)
        inc[(u >= 0.1) & (u < 0.13)] = np.inf
        inc[(u >= 0.13) & (u < 0.16)] = np.nan
    phase = states["phase"].copy()
    u = rng.uniform(0, 1, m)
    phase[u < 0.05] = np.nan
    phase[(u >= 0.05) & (u < 0.1)] = np.inf
    phase[(u >= 0.1) & (u < 0.15)] = -np.inf
    states["phase"] = phase
    return table, cbase, inc, dm, amod, vecs, states
