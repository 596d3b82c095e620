"""The plain reference: the synthesizer's frame loop in NumPy.

The upstream engine (octetta/skred ``synth.c:502-630``) renders one
sample at a time, voice by voice: each voice's oscillator (``osc_next``),
sample and hold, bit quantizer, biquad (``mmf_process``), envelope,
amplitude modulation and smoother, and pan; then the master-volume
smoother and the stereo sum.  A voice reads a modulator's sample of this
frame where the modulator's index is lower than its own, and of the
previous frame otherwise.

The same arithmetic, arranged for NumPy: the voices go in tiers of the
modulation graph (a tier reads only lower tiers), and each tier renders
a stretch of up to ``CHUNK`` samples at once.  Only the oscillator's
phase is walked sample by sample (its wrap makes every step depend on the
float32 rounding of the last); the biquad and the smoothers are linear
recurrences, run by ``scipy.signal.lfilter`` in float64; the rest is
elementwise over the stretch.  Everything else is float32, as the
configuration states, with the upstream engine's fused multiply-adds
taken through float64 (``_fma``: the product of two float32 values is
exact there); voices are summed in float64.

The inputs are the frozen compiler's ``Timeline`` objects
(``reference/frozen``), one a row; nothing of the program is read.

``render(tls, "bfloat16")`` is the control (``reference/control.py``):
every value is rounded to bfloat16 after every operation, and the
recurrences walk sample by sample in that precision.
"""

from __future__ import annotations

import numpy as np

V = 64
NOISE_ALT = 6               # wave table slot of the noise voices (w6)
CHUNK = 16 * 512            # samples a stretch
F32 = np.float32
I32 = np.int32
_STATE_F = ("phase", "sample", "hold_val", "x1", "x2", "y1", "y2",
            "smoother", "pan_l", "pan_r")
_STATE_I = ("finished", "hold_count")
VOL_RATE = float(F32(0.002))  # the master-volume smoother (synth.c:616)


def _same(x):
    return x


def _bf16(x):
    """Round float32 values to bfloat16 (nearest, ties to even)."""
    x = np.asarray(x, F32)
    bits = x.view(np.uint32)
    lsb = (bits >> np.uint32(16)) & np.uint32(1)
    up = ((bits + np.uint32(0x7FFF) + lsb) & np.uint32(0xFFFF0000)).view(F32)
    return np.where(np.isnan(x), x, up).astype(F32)


def rounder(dtype: str):
    if dtype == "float32":
        return _same
    if dtype == "bfloat16":
        return _bf16
    raise ValueError(f"reference: no precision {dtype}")


def _fma(a, b, c):
    """a*b + c rounded once to float32."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def _f2i(x):
    """float32 -> int32 truncating, saturating out of range, NaN to 0."""
    with np.errstate(invalid="ignore"):
        y = np.clip(np.nan_to_num(np.asarray(x, F32), nan=0.0),
                    -2147483648.0, 2147483520.0)
    return y.astype(I32)


def _levels(q):
    """``(1 << q) - 1`` as float32 for a 32-bit int shift (a shift out of
    [0, 32) gives -1 levels)."""
    q = np.asarray(q, np.int64)
    ok = (q >= 0) & (q < 32)
    lv = np.where(ok, (np.int64(1) << np.clip(q, 0, 31)) - 1, -1)
    return lv.astype(I32).astype(F32)


def _fast_pow(a, b):
    """synth.c:140-147: powf by the exponent-bits trick."""
    i = np.ascontiguousarray(a, F32).view(I32)
    x = _fma(b, (i - 1065353216).astype(F32), F32(1065353216.0))
    r = _f2i(x).view(F32)
    return np.where(a <= 0.0, F32(0.0), r)


def noise_stream(total: int) -> np.ndarray:
    """The shared per-sample 'whiteish' stream (synth.c:508, 525): the
    Knuth MMIX LCG seeded 1, one draw a sample, its high 32 bits as a
    signed fraction of 2**31."""
    a, c, m = 6364136223846793005, 1442695040888963407, (1 << 64) - 1
    hi = np.empty(total, np.int64)
    s = 1
    for t in range(total):
        s = (s * a + c) & m
        hi[t] = s >> 32
    hi = np.where(hi >= 1 << 31, hi - (1 << 32), hi)
    return (hi.astype(F32) / F32(2147483648.0)).astype(F32)


class _Segment:
    """One segment's per-voice constants ([R, V]) for every row, worked
    out from the compiled parameters as synth.c reads them, and the
    tiers of its modulation graph."""

    def __init__(self, tls, segs, table_offs, rnd):
        p = {k: np.stack([np.asarray(tl.params[k][s])
                          for tl, s in zip(tls, segs)])
             for k in tls[0].params if k != "volume_final"}
        f = lambda k: rnd(np.asarray(p[k], F32))
        i = lambda k: np.asarray(p[k], I32)
        v_idx = np.arange(V, dtype=I32)
        self.vf = rnd(np.array([tl.params["volume_final"][s]
                                for tl, s in zip(tls, segs)], F32))
        self.pinc = f("phase_inc")
        fm = i("freq_mod_osc")
        mod_inc = np.take_along_axis(self.pinc, np.clip(fm, 0, V - 1), 1)
        self.mis = rnd(mod_inc * f("freq_scale"))
        self.fm_dep = f("freq_mod_depth")
        tsize_i = i("table_size")
        self.tsize = rnd(tsize_i.astype(F32))
        use_loop = (i("loop_enabled") != 0) & (i("loop_valid") != 0)
        self.lo = np.where(use_loop, f("loop_start_f"), F32(0.0))
        self.hi = np.where(use_loop, f("loop_end_f"), self.tsize)
        self.L = rnd(self.hi - self.lo)
        self.hi_os = rnd(self.hi - F32(1e-6))
        self.clip_hi = np.maximum(tsize_i - 1, 0)
        key = i("table_key")
        self.table_off = np.stack([offs[np.clip(k, 0, len(offs) - 1)]
                                   for offs, k in zip(table_offs, key)])
        self.use_fm = (fm >= 0) & (fm != v_idx)
        self.dirneg = i("direction") != 0
        self.one_shot = i("one_shot") != 0
        self.osn = self.one_shot & (i("loop_enabled") == 0)
        self.is_noise = i("table_index") == NOISE_ALT
        self.hold_max = i("hold_max")
        self.hold_on = self.hold_max != 0
        q = i("quantize")
        self.quant = q != 0
        self.levels = rnd(_levels(q))
        with np.errstate(divide="ignore", invalid="ignore"):
            self.inv_lev = rnd(F32(1.0) / self.levels)
        self.use_flt = i("filter_mode") != 0
        self.b0, self.b1, self.b2 = f("flt_b0"), f("flt_b1"), f("flt_b2")
        self.a1, self.a2 = f("flt_a1"), f("flt_a2")
        self.use_env = i("use_amp_envelope") != 0
        self.env_act = i("env_active") != 0
        self.att, self.dec = f("env_attack"), f("env_decay")
        self.att_dec = rnd(self.att + self.dec)
        self.sus, self.rel = f("env_sustain"), f("env_release")
        self.vel = f("env_velocity")
        self.env_start = i("env_start").astype(np.int64)
        self.env_rel_at = i("env_rel_at").astype(np.int64)
        self.no_rel = self.env_rel_at == 0
        self.amp = f("amp")
        self.amp_nz = self.amp != 0.0
        self.use_sm = i("smoother_enable") != 0
        self.smoothing = f("smoother_smoothing")
        self.disc = i("disconnect") != 0
        self.cz_mode = i("cz_mode")
        self.cz_on = self.cz_mode != 0
        self.cz_dist = f("cz_distortion")
        self.cz_dep = f("cz_mod_depth")
        am, pm, cm = i("amp_mod_osc"), i("pan_mod_osc"), i("cz_mod_osc")
        self.am_osc, self.pm_osc, self.cm_osc = am, pm, cm
        self.am_dep, self.pm_dep = f("amp_mod_depth"), f("pan_mod_depth")
        self.am_self = am == v_idx
        self.pm_self = pm == v_idx
        self.pan_on = (pm >= 0) & ~self.disc
        # a read of voice osc: this frame's sample where osc < reader,
        # the previous frame's otherwise (an index past the voices reads
        # the nearest voice)
        for name, osc in (("fm", fm), ("cm", cm), ("am", am), ("pm", pm)):
            setattr(self, name + "_at", np.clip(osc, 0, V - 1))
            setattr(self, name + "_cur", osc < v_idx)
        # the CZ curve reads its modulator only to add read*depth to its
        # distortion: with a depth of 0 its d is the distortion
        self.cz_reads = self.cz_on & (cm >= 0) & (self.cz_dep != 0)
        self.cz_varies = bool(self.cz_reads.any())
        self.modes = set(np.unique(self.cz_mode[self.cz_on]).tolist())
        if self.cz_on.any() and not self.cz_varies:
            self.cz_const = _cz_consts(self.cz_mode, self.cz_dist, rnd)
        edges = [(fm, self.use_fm), (am, (am >= 0) & ~self.am_self),
                 (cm, self.cz_reads), (pm, self.pan_on & ~self.pm_self)]
        self.read = np.zeros((len(tls), V), bool)
        for osc, on in edges:
            rr, vv = np.nonzero(on)
            self.read[rr, np.clip(osc[rr, vv], 0, V - 1)] = True
        self.depth = _depths(
            [(fm, self.use_fm), (am, (am >= 0) & ~self.am_self),
             (cm, self.cz_reads)])


def _depths(edges):
    """[R, V] depth of every voice in its row's modulation graph: 0 if it
    reads nothing, else one more than its deepest modulator."""
    R = edges[0][0].shape[0]
    depth = np.zeros((R, V), np.int64)
    for r in range(R):
        srcs = [set() for _ in range(V)]
        for osc, on in edges:
            for v in np.nonzero(on[r])[0]:
                srcs[v].add(int(np.clip(osc[r, v], 0, V - 1)))
        done = {}

        def walk(v, seen=()):
            if v in done:
                return done[v]
            if v in seen:
                raise ValueError("reference: a cyclic modulation graph")
            d = max((walk(m, seen + (v,)) + 1 for m in srcs[v]), default=0)
            done[v] = d
            return d
        depth[r] = [walk(v) for v in range(V)]
    return depth


def _cz_consts(mode, d, rnd):
    """Per-voice constants of the CZ curves (synth.c:149-215) for a
    distortion ``d``.  Curves 1, 2, 3 and 5 share one form, ``phase < t ?
    phase*a : (phase - x)*b + y``; 6 and 7 raise the phase to a power."""
    d = rnd(np.clip(d, F32(0.0), F32(0.999)))
    half, one = F32(0.5), F32(1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        sc2 = rnd(half / rnd(half - rnd(d * half)))
        sc5b = rnd(half / rnd(half + rnd(d * half)))
        a1 = rnd(half / d)
        b1 = rnd(half / rnd(one - d))
    m = mode
    t = np.where(m == 1, d, half)
    a = np.where(m == 1, a1, sc2)
    x = np.where(m == 1, d, np.where(m == 2, one, half))
    b = np.where(m == 1, b1, np.where(m == 5, sc5b, sc2))
    y = np.where(m == 2, one, half)
    e = rnd(one + rnd(np.where(m == 6, F32(4.0), F32(8.0)) * d))
    return t, a, x, b, y, e


def _cz_index(mode, modes, consts, ph, tsize, rnd):
    """The CZ-warped table index of phase ``ph``."""
    t, a, x, b, y, e = consts
    phase = rnd(ph / tsize)
    out = phase
    if modes & {1, 2, 3, 5}:
        lin = np.where(phase < t, rnd(phase * a),
                       rnd(_fma(rnd(phase - x), b, y)))
        sel = (mode == 1) | (mode == 2) | (mode == 3) | (mode == 5)
        out = np.where(sel, lin, out)
    if 4 in modes:
        out = np.where(mode == 4,
                       rnd(np.fmod(rnd(phase * F32(2.0)), F32(1.0))), out)
    if modes & {6, 7}:
        out = np.where((mode == 6) | (mode == 7), rnd(_fast_pow(phase, e)),
                       out)
    return rnd(out * tsize)


def _walk_phase(inc, c, s, cols, mine, rnd):
    """The oscillator's phase, sample by sample: (phase used at each
    sample, active at each sample, phase not finite at each sample; each
    [T, R, K]); updates ``c["phase"]`` and ``c["finished"]`` for the
    lanes ``cols`` of the tier (``mine``)."""
    T = inc.shape[0]
    g = lambda a: a[:, cols]
    lo, hi, L, hi_os = g(s.lo), g(s.hi), g(s.L), g(s.hi_os)
    osn, one_shot, amp_nz = g(s.osn), g(s.one_shot), g(s.amp_nz)
    adv_ok = ~g(s.is_noise)
    p = c["phase"][:, cols].copy()
    fin = c["finished"][:, cols].copy()
    out = np.empty(inc.shape, F32)
    act = np.empty(inc.shape, bool)
    bads = np.zeros(inc.shape, bool)
    with np.errstate(invalid="ignore", over="ignore"):
        quick = (rnd is _same and not ((fin == 0) & amp_nz
                                       & (osn | one_shot)).any()
                 and bool(np.isfinite(inc).all()) and not (inc < 0).any()
                 and bool((p >= lo).all()))
        if quick:
            # no lane can finish, no phase can go below its loop's start
            # or leave the finite numbers: the walk is add and wrap
            active = (fin == 0) & amp_nz
            adv = active & adv_ok
            q = p.copy()
            for t in range(T):
                q = q + inc[t]
                over = q >= hi
                if over.any():
                    q = np.where(over, lo + np.fmod(q - lo, L), q)
                out[t] = q
            act[:] = active
            p = np.where(adv, q, p)
        else:
            for t in range(T):
                active = (fin == 0) & amp_nz
                ph = rnd(p + inc[t])
                bad = ~np.isfinite(ph)
                over, under = ph >= hi, ph < lo
                wrap_o = rnd(lo + rnd(np.fmod(rnd(ph - lo), L)))
                wrap_u = rnd(hi - rnd(np.fmod(rnd(lo - ph), L)))
                ph2 = np.where(over, np.where(osn, hi_os, wrap_o),
                               np.where(under, np.where(osn, lo, wrap_u),
                                        ph))
                ph2 = np.where(bad, F32(0.0), ph2)
                fin_osc = (bad & one_shot) | ((over | under) & osn)
                adv = active & adv_ok
                p = np.where(adv, ph2, p)
                fin = np.where(adv & fin_osc, 1, fin).astype(I32)
                out[t] = ph2
                act[t] = active
                bads[t] = bad
    c["phase"][:, cols] = np.where(mine, p, c["phase"][:, cols])
    c["finished"][:, cols] = np.where(mine, fin, c["finished"][:, cols])
    return out, act, bads


def _prefix_len(act):
    """[R, K] count of leading active samples (a voice that finishes
    stays finished until its segment's state writes)."""
    return np.where(act.all(axis=0), act.shape[0], np.argmin(act, axis=0))


def _lfilter(x, b, a, state, n_act, lanes, y):
    """``y[:n, r, k] = lfilter(b, a, x[:n, r, k])`` in float64 from the
    direct-form state (x1, x2, y1, y2) for each lane of ``lanes``, over
    its first ``n = n_act[r, k]`` samples."""
    from scipy.signal import lfilter, lfiltic

    x1, x2, y1, y2 = state
    for r, k in zip(*np.nonzero(lanes & (n_act > 0))):
        n = int(n_act[r, k])
        bb = [float(c[r, k]) for c in b]
        aa = [1.0] + [float(c[r, k]) for c in a]
        zi = lfiltic(bb, aa, [float(y1[r, k]), float(y2[r, k])],
                     [float(x1[r, k]), float(x2[r, k])])
        y[:n, r, k] = lfilter(bb, aa, x[:n, r, k].astype(np.float64),
                              zi=zi)[0]


def _last_two(x, y, state, n_act):
    """The direct-form state (x1, x2, y1, y2) after each lane's first
    ``n_act`` samples."""
    x1, x2, y1, y2 = state
    xs = np.concatenate([np.stack([x2, x1]), x])
    ys = np.concatenate([np.stack([y2, y1]), y])
    at = n_act[None].astype(np.int64)
    pick = lambda a, j: np.take_along_axis(a, at + j, 0)[0]
    return pick(xs, 1), pick(xs, 0), pick(ys, 1), pick(ys, 0)


def _walk(step, x, state, coefs, n_act, lanes, y):
    """Walk ``step(x_t, state, coefs) -> (y_t, state)`` sample by sample
    on the lanes ``lanes`` over their first ``n_act`` samples, writing
    ``y``; ``state`` and ``coefs`` are [R, K] arrays, the state updated
    in place.
    Where a lane's input is constant over the stretch and its output has
    stopped changing, the rest of the stretch is that output."""
    T = x.shape[0]
    rr, kk = np.nonzero(lanes & (n_act > 0))
    if not len(rr):
        return
    xs = x[:, rr, kk]
    n = n_act[rr, kk]
    st = tuple(np.asarray(v[rr, kk]) for v in state)
    cs = tuple(np.asarray(c[rr, kk]) for c in coefs)
    flat = bool((xs == xs[:1]).all())
    last = None
    for t in range(T):
        yt, new = step(xs[t], st, cs)
        on = t < n
        st = tuple(np.where(on, a, b) for a, b in zip(new, st))
        y[t, rr, kk] = np.where(on, yt, y[t, rr, kk])
        if flat and t % 64 == 63:
            if last is not None and all(np.array_equal(a, b)
                                        for a, b in zip(st, last)):
                y[t + 1:, rr, kk] = np.where(np.arange(t + 1, T)[:, None]
                                             < n, yt, y[t + 1:, rr, kk])
                break
            last = st
    for v, a in zip(state, st):
        v[rr, kk] = a


def _biquad(x, s, cols, state, n_act, exact, rnd):
    """The biquad, direct form I (mmf_process, synth.c:349-364), on
    ``x`` [T, R, K] over each lane's first ``n_act`` samples.  The lanes
    ``exact`` (a voice that others read, and every lane of the control)
    walk in the configuration's precision in the upstream engine's order
    of operations; the others run in float64 (``lfilter``).  Returns y
    and the new state (x1, x2, y1, y2)."""
    g = lambda a: a[:, cols]
    b0, b1, b2 = g(s.b0), g(s.b1), g(s.b2)
    na1, na2 = rnd(-g(s.a1)), rnd(-g(s.a2))
    y = np.zeros(x.shape, F32)
    state = tuple(np.array(v, F32) for v in state)
    _lfilter(x, [b0, b1, b2], [g(s.a1), g(s.a2)], state, n_act, ~exact, y)
    out = _last_two(x, y, state, n_act)

    def step(xt, st, c):
        x1, x2, y1, y2 = st
        acc = rnd(c[1] * x1)
        acc = rnd(_fma(c[0], xt, acc))
        acc = rnd(_fma(c[2], x2, acc))
        acc = rnd(_fma(c[3], y1, acc))
        acc = rnd(_fma(c[4], y2, acc))
        return acc, (xt, x1, acc, y1)

    walked = tuple(np.array(v) for v in state)
    _walk(step, x, walked, (b0, b1, b2, na1, na2), n_act, exact, y)
    out = tuple(np.where(exact, w, o) for w, o in zip(walked, out))
    return y, out


def _smoother(final, a, sm0, n_act, exact, rnd):
    """The voice smoother, ``sm += a * (final - sm)`` (synth.c:589), on
    ``final`` [T, R, K] over each lane's first ``n_act`` samples, the
    lanes ``exact`` as in ``_biquad``.  Returns its output and state."""
    zero = np.zeros_like(sm0)
    y = np.zeros(final.shape, F32)
    state = (zero, zero, np.array(sm0, F32), zero)
    _lfilter(final, [a], [-(1.0 - a.astype(np.float64))], state, n_act,
             ~exact, y)
    last = _last_two(final, y, state, n_act)[2]

    def step(xt, st, c):
        sg = rnd(_fma(c[0], rnd(xt - st[0]), st[0]))
        return sg, (sg,)

    walked = (np.array(sm0, F32),)
    _walk(step, final, walked, (a,), n_act, exact, y)
    return y, np.where(exact, walked[0], last)


def _tier(k, c, s, so, act_so, prev, noise, count, table, rnd):
    """Render the voices of tier ``k`` over a stretch: their samples go
    into ``so`` [T, R, V] (every lower tier's are there already), whether
    each was active into ``act_so``; their state into ``c``.  ``prev`` [R, V]: every voice's last sample before
    the stretch."""
    T, R, _ = so.shape
    mine = s.depth == k
    cols = np.nonzero(mine.any(axis=0))[0]
    if not len(cols):
        return
    g = lambda a: a[:, cols]
    rows = np.arange(R)[:, None]
    shifted = np.concatenate([prev[None], so[:-1]])

    def read(name):
        at, cur = g(getattr(s, name + "_at")), g(getattr(s, name + "_cur"))
        return np.where(cur, so[:, rows, at], shifted[:, rows, at])

    # oscillator (osc_next, synth.c:217-275)
    pinc = g(s.pinc)
    inc = np.broadcast_to(pinc, (T,) + pinc.shape)
    if g(s.use_fm).any():
        gm = rnd(read("fm") * g(s.fm_dep))
        inc = np.where(g(s.use_fm), rnd(_fma(g(s.mis), gm, pinc)), inc)
    if g(s.dirneg).any():
        inc = np.where(g(s.dirneg), -inc, inc)
    ph, act, bad = _walk_phase(inc, c, s, cols, mine[:, cols], rnd)
    # a voice that others read walks its recurrences in float32 as the
    # upstream engine does: its rounding reaches their phases
    exact = np.ones(mine[:, cols].shape, bool) if rnd is not _same \
        else g(s.read)
    n_act = _prefix_len(act)
    idx_f = ph
    if g(s.cz_on).any():
        mode = g(s.cz_mode)
        if s.cz_varies:
            dm = np.where(g(s.cm_osc) >= 0,
                          rnd(read("cm") * g(s.cz_dep)), F32(1.0))
            consts = _cz_consts(mode, rnd(g(s.cz_dist) + dm), rnd)
        else:
            consts = tuple(a[:, cols] for a in s.cz_const)
        idx_f = np.where(g(s.cz_on),
                         _cz_index(mode, s.modes, consts, ph, g(s.tsize), rnd),
                         ph)
    idx = np.minimum(np.maximum(_f2i(idx_f), 0), g(s.clip_hi))
    f = table[g(s.table_off) + idx]
    f = np.where(bad, F32(0.0), f)
    if g(s.is_noise).any():
        f = np.where(g(s.is_noise), noise[:, None, None], f)

    # sample and hold (synth.c:560-571): the held value is taken where
    # the voice's counter is 0; the counter counts active samples
    s1 = f
    hold_on = g(s.hold_on)
    if hold_on.any():
        hm = np.maximum(g(s.hold_max), 1).astype(np.int64)
        c0 = g(c["hold_count"]).astype(np.int64)
        c0w = np.where(c0 < hm, c0, hm - 1)
        t_ = np.arange(T)[:, None, None]
        zero = ((c0w + t_) % hm) == 0
        zero[0] = c0 == 0
        zero &= hold_on
        last = np.maximum.accumulate(np.where(zero, t_, -1), axis=0)
        taken = np.take_along_axis(f, np.maximum(last, 0), 0)
        hv = np.where(last >= 0, taken, g(c["hold_val"]))
        s1 = np.where(hold_on, hv, f)
        at = np.maximum(n_act - 1, 0)[None]
        new_hv = np.where(n_act > 0, np.take_along_axis(hv, at, 0)[0],
                          g(c["hold_val"]))
        new_hc = np.where(n_act > 0, (c0w + n_act) % hm, c0)
        c["hold_count"][:, cols] = np.where(mine[:, cols] & hold_on, new_hc,
                                            g(c["hold_count"]))
        c["hold_val"][:, cols] = np.where(mine[:, cols], new_hv,
                                          g(c["hold_val"]))

    # bit quantizer (synth.c:341-345, :574)
    s2 = s1
    if g(s.quant).any():
        iv = _f2i(_fma(s1, g(s.levels), F32(0.5))).astype(F32)
        with np.errstate(invalid="ignore"):
            s2 = np.where(g(s.quant), rnd(iv * g(s.inv_lev)), s1)

    # biquad, direct form I (mmf_process, synth.c:349-364)
    s3 = s2
    use_flt = g(s.use_flt)
    if use_flt.any():
        n_f = np.where(use_flt & mine[:, cols], n_act, 0)
        st = tuple(g(c[n]) for n in ("x1", "x2", "y1", "y2"))
        y, new = _biquad(s2, s, cols, st, n_f, exact, rnd)
        s3 = np.where(use_flt, y, s2)
        for n, v in zip(("x1", "x2", "y1", "y2"), new):
            c[n][:, cols] = v

    # amplitude: envelope, amp-mod, smoother (synth.c:580-593)
    final = np.broadcast_to(g(s.amp), (T, R, len(cols)))
    if g(s.use_env).any():
        cnt = count[:, None, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = rnd((cnt - g(s.env_start)).astype(F32))
            att, dec, sus, rel = g(s.att), g(s.dec), g(s.sus), g(s.rel)
            attack = rnd(t / att)
            decay = rnd(_fma(-rnd(rnd(t - att) / dec), rnd(F32(1.0) - sus),
                             F32(1.0)))
            tr = rnd((cnt - g(s.env_rel_at)).astype(F32))
            release = rnd(sus * rnd(F32(1.0) - rnd(tr / rel)))
        env = np.where(t < att, attack,
                       np.where(t < g(s.att_dec), decay,
                                np.where(g(s.no_rel), sus,
                                         np.where(tr < rel, release,
                                                  F32(0.0)))))
        env = np.where(g(s.env_act), env, F32(0.0))
        final = rnd(final * np.where(g(s.use_env), rnd(env * g(s.vel)),
                                     F32(1.0)))
    if (g(s.am_osc) >= 0).any():
        am_read = np.where(g(s.am_self), s3, read("am"))
        final = rnd(final * np.where(g(s.am_osc) >= 0,
                                     rnd(am_read * g(s.am_dep)), F32(1.0)))
    final2 = final
    use_sm = g(s.use_sm)
    if use_sm.any():
        n_s = np.where(use_sm & mine[:, cols], n_act, 0)
        sm0 = g(c["smoother"])
        ys, new = _smoother(np.ascontiguousarray(final, F32),
                            g(s.smoothing), sm0, n_s, exact, rnd)
        final2 = np.where(use_sm, ys, final)
        c["smoother"][:, cols] = np.where(n_s > 0, new, sm0)
    out = np.where(act, rnd(s3 * final2), F32(0.0))
    so[:, :, cols] = np.where(mine[:, cols], out, so[:, :, cols])
    act_so[:, :, cols] = np.where(mine[:, cols], act, act_so[:, :, cols])


def _apply_ops(c, tls, segs, start, rnd):
    """A segment's state writes (phase, finished, sample, filter clear,
    smoother, pan, the copied hold counter) on the rows where it starts;
    the copied hold state is the source voice's before these writes."""
    o = {k: np.stack([np.asarray(tl.ops[k][s]) for tl, s in zip(tls, segs)])
         for k in tls[0].ops}
    on = start[:, None]
    w = lambda flag, new, old: np.where(on & (o[flag] != 0), new, old)
    n = {k: v.copy() for k, v in c.items()}
    n["phase"] = w("set_phase", rnd(o["phase"].astype(F32)), c["phase"])
    n["finished"] = w("set_finished", o["finished"].astype(I32),
                      c["finished"]).astype(I32)
    n["sample"] = w("set_sample", rnd(o["sample"].astype(F32)), c["sample"])
    for k in ("x1", "x2", "y1", "y2"):
        n[k] = w("clear_filter", F32(0.0), c[k])
    n["smoother"] = w("set_smoother", rnd(o["smoother"].astype(F32)),
                      c["smoother"])
    n["pan_l"] = w("set_pan", rnd(o["pan_left"].astype(F32)), c["pan_l"])
    n["pan_r"] = w("set_pan", rnd(o["pan_right"].astype(F32)), c["pan_r"])
    src = o["copy_hold_from"]
    do = on & (src >= 0)
    at = np.clip(src, 0, V - 1)
    n["hold_count"] = np.where(do, np.take_along_axis(c["hold_count"], at, 1),
                               n["hold_count"]).astype(I32)
    n["hold_val"] = np.where(do, np.take_along_axis(c["hold_val"], at, 1),
                             n["hold_val"])
    return n


def _stretches(seg_of, starts, nb, n):
    """(first block, blocks) of each stretch: blocks of one segment in
    every row, a segment starting only at a stretch's first block, at
    most ``CHUNK`` samples."""
    cap = max(CHUNK // n, 1)
    k = 0
    while k < nb:
        e = k + 1
        while (e < nb and e - k < cap and not starts[:, e].any()
               and np.array_equal(seg_of[:, e], seg_of[:, k])):
            e += 1
        yield k, e - k
        k = e


def render(tls, dtype: str = "float32") -> np.ndarray:
    """Render compiled timelines (one a row; the same length and block)
    -> ``[rows, num_blocks*block, 2]`` float32.  ``dtype`` "bfloat16"
    is the control."""
    with np.errstate(all="ignore"):
        return _render(tls, rounder(dtype))


def _render(tls, rnd) -> np.ndarray:
    tl0 = tls[0]
    nb, n = tl0.num_blocks, tl0.block
    if any(tl.num_blocks != nb or tl.block != n for tl in tls):
        raise ValueError("reference: rows of different lengths")
    R = len(tls)
    # every row's bound tables in one buffer, at offsets of its own
    chunks, offs, at = [], [], 0
    for tl in tls:
        buf = rnd(np.asarray(tl.table_buffer, F32))
        chunks.append(buf)
        offs.append(np.asarray(tl.table_offsets, np.int64) + at)
        at += buf.size
    table = np.concatenate(chunks)
    noise = rnd(noise_stream(nb * n))
    c = {k: np.zeros((R, V), F32) for k in _STATE_F}
    c.update({k: np.zeros((R, V), I32) for k in _STATE_I})
    vg = np.zeros(R, np.float64)
    out = np.empty((R, nb * n, 2), F32)
    seg_of = np.stack([np.asarray(tl.seg_of_block) for tl in tls])
    starts = np.stack([np.asarray(tl.seg_is_start) for tl in tls])
    s, key = None, None
    for k0, kn in _stretches(seg_of, starts, nb, n):
        segs = seg_of[:, k0]
        if key is None or not np.array_equal(segs, key):
            s, key = _Segment(tls, segs, offs, rnd), segs.copy()
        if starts[:, k0].any():
            c = _apply_ops(c, tls, segs, starts[:, k0].astype(bool), rnd)
        i0, T = k0 * n, kn * n
        count = np.arange(i0 + 1, i0 + T + 1, dtype=np.int64)
        so = np.zeros((T, R, V), F32)
        act_so = np.zeros((T, R, V), bool)
        prev = c["sample"].copy()
        for k in range(int(s.depth.max()) + 1):
            _tier(k, c, s, so, act_so, prev, noise[i0:i0 + T], count, table,
                  rnd)
        c["sample"] = so[-1].copy()
        # pan and pan modulation (synth.c:595-612)
        pl = np.broadcast_to(c["pan_l"], so.shape)
        pr = np.broadcast_to(c["pan_r"], so.shape)
        if s.pan_on.any():
            rows = np.arange(R)[:, None]
            shifted = np.concatenate([prev[None], so[:-1]])
            pm = np.where(s.pm_cur, so[:, rows, s.pm_at],
                          shifted[:, rows, s.pm_at])
            pm = np.where(s.pm_self, so, pm)
            pl = np.where(s.pan_on,
                          rnd(rnd(_fma(-pm, s.pm_dep, F32(1.0))) / F32(2.0)),
                          pl)
            pr = np.where(s.pan_on,
                          rnd(rnd(_fma(pm, s.pm_dep, F32(1.0))) / F32(2.0)),
                          pr)
            # the last active sample's pan stays in the state
            last = np.maximum.accumulate(
                np.where(act_so, np.arange(T)[:, None, None], -1),
                axis=0)[-1]
            keep = s.pan_on & (last >= 0)
            at = np.maximum(last, 0)[None]
            c["pan_l"] = np.where(keep, np.take_along_axis(pl, at, 0)[0],
                                  c["pan_l"])
            c["pan_r"] = np.where(keep, np.take_along_axis(pr, at, 0)[0],
                                  c["pan_r"])
        keep = ~s.disc
        left = np.where(keep, rnd(so * pl), F32(0.0))
        right = np.where(keep, rnd(so * pr), F32(0.0))
        # the master-volume smoother (synth.c:616-624), then the sum
        if rnd is _same:
            decay = (1.0 - VOL_RATE) ** np.arange(1, T + 1)
            vol = s.vf[None].astype(np.float64) \
                + (vg - s.vf)[None] * decay[:, None]
            vg = vol[-1]
            vol = vol.astype(F32)
        else:
            vol = np.empty((T, R), F32)
            g32 = vg.astype(F32)
            for t in range(T):
                g32 = rnd(_fma(F32(VOL_RATE), rnd(s.vf - g32), g32))
                vol[t] = g32
            vg = g32.astype(np.float64)
        for ch, x in ((0, left), (1, right)):
            out[:, i0:i0 + T, ch] = rnd(
                rnd(x.sum(axis=2, dtype=np.float64).astype(F32)) * vol).T
    return out
