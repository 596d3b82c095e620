"""The plain reference for scripts whose modulation graph has a cycle.

``synth.py`` renders a tier of the modulation graph a stretch at a time,
which needs a graph without cycles.  A feedback edge (a CZ self read, as
skred's ``synth.c:263-264`` allows, or a ring of FM, amp-mod or CZ-mod
edges) makes every voice of its strongly connected component depend on
its own past output one sample back, so those voices can only be walked
sample by sample.  Here the graph is condensed: each component is one
node, and the condensed graph has levels as ``synth.py``'s tiers.  At
each level, the voices in a loop (a component of two or more voices, or
one that reads itself) walk sample by sample through the whole chain,
in float32 and in the upstream engine's order: oscillator with FM, CZ
warp with its modulator read, table lookup, sample and hold, quantizer,
biquad, envelope, amp-mod, smoother; ``synth.py``'s ``_fma`` at the
fused multiply-add sites, and no ``lfilter`` inside a loop.  Within one
sample, the loop voices that read another of their loop this frame (a
lower index) walk after it.  Every other voice renders as ``synth.py``
renders it, by its ``_tier``, a stretch at a time; pan and the stereo
sum are ``synth.py``'s.  The master-volume smoother walks in float32,
sample by sample, as the upstream engine's does, where a voice loops:
``synth.py`` takes it in float64 in closed form, whose gain the float32
walk never quite reaches (it stops within half an ulp's worth of a step
of the final volume, ~1e-5 of it), and a patch as loud as czfb64 (its
mix peaks near 100 times full scale) turns that into a gap of about
-53 dB, which would hide the program's own.  On a graph without a cycle
the render is ``synth.render``'s bit for bit.

``render(tls, "bfloat16")`` is the control, as ``synth.render``'s.
Nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import synth
from benchmark.reference.synth import (F32, I32, V, VOL_RATE, _apply_ops,
                                       _fma,
                                       _same, _stretches, _tier,
                                       noise_stream, rounder)


class _Segment(synth._Segment):
    """``synth._Segment`` with the condensed graph: ``level`` [R, V] (the
    level of each voice's component), ``loop`` [R, V] (the voice walks
    sample by sample) and ``wave`` [R, V] (its turn within a sample).
    ``comp`` [R, V] names each voice's component by its lowest member.
    ``depth`` is the level for the voices ``synth._tier`` renders and -1
    for the loop voices, which it then leaves alone."""

    def __init__(self, tls, segs, offs, rnd):
        try:
            super().__init__(tls, segs, offs, rnd)
        except ValueError as e:
            # synth._Segment sets its graph's depth last, after every
            # other attribute: on a cycle it raises there
            if "cyclic" not in str(e):
                raise
        fm, am, cm = self.fm_at, self.am_at, self.cm_at
        edges = [(fm, self.use_fm, self.fm_cur),
                 (am, (self.am_osc >= 0) & ~self.am_self, self.am_cur),
                 (cm, self.cz_reads, self.cm_cur)]
        self.level, self.loop, self.wave, self.comp = _condense(edges)
        self.depth = np.where(self.loop, -1, self.level)


def _condense(edges):
    """(level, loop, wave, comp), each [R, V], of every row's modulation
    graph (``edges``: (source [R, V], on [R, V], this frame's [R, V]))."""
    R = edges[0][0].shape[0]
    comps = np.zeros((R, V), np.int64)
    level = np.zeros((R, V), np.int64)
    loop = np.zeros((R, V), bool)
    wave = np.zeros((R, V), np.int64)
    for r in range(R):
        reads = np.zeros((V, V), bool)     # reads[v, m]: v reads m
        now = np.zeros((V, V), bool)       # ... this frame's sample
        for src, on, cur in edges:
            vv = np.nonzero(on[r])[0]
            reads[vv, src[r, vv]] = True
            now[vv, src[r, vv]] |= cur[r, vv]
        reach = reads.copy()
        while True:
            more = reach | ((reach.astype(np.int64)
                             @ reach.astype(np.int64)) > 0)
            if np.array_equal(more, reach):
                break
            reach = more
        loop[r] = np.diag(reach)
        same = (reach & reach.T) | np.eye(V, dtype=bool)
        comp = comps[r] = np.argmax(same, axis=1)     # its lowest member
        lv = {}

        def walk(c):
            if c not in lv:
                members = np.nonzero(comp == c)[0]
                srcs = {int(comp[m]) for v in members
                        for m in np.nonzero(reads[v])[0]} - {c}
                lv[c] = max((walk(s) + 1 for s in srcs), default=0)
            return lv[c]
        level[r] = [walk(int(comp[v])) for v in range(V)]
        for v in range(V):
            inner = np.nonzero(now[v] & (comp == comp[v]))[0]
            wave[r, v] = max((wave[r, m] + 1 for m in inner), default=0)
    return level, loop, wave, comps


def _trunc(x):
    """``synth._f2i`` of float32 values (NaN to 0, saturating,
    truncating), in fewer operations: the walk takes it every sample."""
    x = np.where(np.isnan(x), F32(0.0), x)
    return np.minimum(np.maximum(x, F32(-2147483648.0)),
                      F32(2147483520.0)).astype(I32)


def _fma32(a, b, c):
    """``synth._fma`` of a float32 array ``a``, in fewer operations."""
    return (np.multiply(a, b, dtype=np.float64) + c).astype(F32)


class _Warp:
    """``synth._cz_consts`` and ``synth._cz_index`` for fixed lanes,
    taken a sample at a time: the same operations on the same values,
    with what depends only on the lanes' modes worked out once."""

    def __init__(self, mode, modes, tsize, rnd):
        half, one = F32(0.5), F32(1.0)
        self.m1, self.m5 = mode == 1, mode == 5
        self.x = np.where(mode == 2, one, half)      # x and y off mode 1
        self.e_fac = np.where(mode == 6, F32(4.0), F32(8.0))
        self.lin = ((mode == 1) | (mode == 2) | (mode == 3) | (mode == 5)
                    if modes & {1, 2, 3, 5} else None)
        self.fold = mode == 4 if 4 in modes else None
        self.pow = (mode == 6) | (mode == 7) if modes & {6, 7} else None
        self.tsize, self.rnd = tsize, rnd

    def index(self, ph, d):
        """The warped table index of phase ``ph`` at distortion ``d``."""
        rnd, half, one = self.rnd, F32(0.5), F32(1.0)
        d = rnd(np.clip(d, F32(0.0), F32(0.999)))
        phase = rnd(ph / self.tsize)
        out = phase
        if self.lin is not None:
            m1, dh = self.m1, rnd(d * half)
            sc2 = rnd(half / rnd(half - dh))
            a = np.where(m1, rnd(half / d), sc2)
            b = np.where(m1, rnd(half / rnd(one - d)),
                         np.where(self.m5, rnd(half / rnd(half + dh)), sc2))
            lin = np.where(phase < np.where(m1, d, half), rnd(phase * a),
                           rnd(_fma32(rnd(phase - np.where(m1, d, self.x)),
                                      b, self.x)))
            out = np.where(self.lin, lin, out)
        if self.fold is not None:
            out = np.where(self.fold,
                           rnd(np.fmod(rnd(phase * F32(2.0)), one)), out)
        if self.pow is not None:
            e = rnd(one + rnd(self.e_fac * d))
            i = np.ascontiguousarray(phase, F32).view(I32)
            x = _fma32(e, (i - 1065353216).astype(F32), F32(1065353216.0))
            r = np.where(phase <= 0.0, F32(0.0), _trunc(x).view(F32))
            out = np.where(self.pow, rnd(r), out)
        return rnd(out * self.tsize)


def _envelope(s, cols, count, rnd):
    """[T, R, K] amplitude envelope times velocity of the lanes ``cols``
    (1 where the envelope is off), as ``synth._tier`` computes it."""
    g = lambda a: a[:, cols]
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
    return np.where(g(s.use_env), rnd(env * g(s.vel)), F32(1.0))


def _walk_loops(k, c, s, so, act_so, prev, noise, count, table, rnd):
    """Walk the loop voices of level ``k`` sample by sample over the
    stretch, writing their samples into ``so`` and ``act_so`` and their
    state into ``c``."""
    T, R, _ = so.shape
    mine_all = s.loop & (s.level == k)
    cols = np.nonzero(mine_all.any(axis=0))[0]
    if not len(cols):
        return
    g = lambda a: np.asarray(a)[:, cols]
    mine = g(mine_all)
    waves = g(s.wave)
    rows = np.arange(R)[:, None]

    pinc, use_fm, mis, fm_dep = g(s.pinc), g(s.use_fm), g(s.mis), \
        g(s.fm_dep)
    dirneg = g(s.dirneg)
    lo, hi, L, hi_os = g(s.lo), g(s.hi), g(s.L), g(s.hi_os)
    osn, one_shot, amp_nz = g(s.osn), g(s.one_shot), g(s.amp_nz)
    adv_ok = ~g(s.is_noise)
    cz_on, mode, tsize = g(s.cz_on), g(s.cz_mode), g(s.tsize)
    cz_dist, cz_dep, cm_ge = g(s.cz_dist), g(s.cz_dep), g(s.cm_osc) >= 0
    toff, clip_hi, is_noise = g(s.table_off), g(s.clip_hi), g(s.is_noise)
    hold_on = g(s.hold_on)
    hm = np.maximum(g(s.hold_max), 1).astype(np.int64)
    quant, levels, inv_lev = g(s.quant), g(s.levels), g(s.inv_lev)
    use_flt = g(s.use_flt)
    coefs = (g(s.b0), g(s.b1), g(s.b2), rnd(-g(s.a1)), rnd(-g(s.a2)))
    amp, am_on, am_self, am_dep = g(s.amp), g(s.am_osc) >= 0, \
        g(s.am_self), g(s.am_dep)
    use_sm, smoothing = g(s.use_sm), g(s.smoothing)
    envs = _envelope(s, cols, count, rnd) if g(s.use_env).any() else None
    reads = {name: (g(getattr(s, name + "_at")), g(getattr(s, name + "_cur")))
             for name in ("fm", "cm", "am")}
    has = {"fm": bool(use_fm.any()), "cz": bool(cz_on.any()),
           "noise": bool(is_noise.any()), "hold": bool(hold_on.any()),
           "quant": bool(quant.any()), "flt": bool(use_flt.any()),
           "am": bool(am_on.any()), "sm": bool(use_sm.any())}
    warp = _Warp(mode, s.modes, tsize, rnd) if has["cz"] else None
    if has["cz"] and not s.cz_varies:
        # no lane reads a CZ modulator: synth.py's hoisted constants'
        # distortion
        const_d = cz_dist
    # the hold counter's zeros do not depend on the audio
    c0 = g(c["hold_count"]).astype(np.int64)
    c0w = np.where(c0 < hm, c0, hm - 1)
    take = ((c0w + np.arange(T)[:, None, None]) % hm) == 0
    take[0] = c0 == 0
    take &= hold_on
    ons = [mine & (waves == w)
           for w in range(int(waves[mine].max()) + 1)]

    # the state, lane by lane
    p = g(c["phase"]).copy()
    fin = g(c["finished"]).copy()
    hv = g(c["hold_val"]).copy()
    hv_last = hv.copy()
    flt = [g(c[n]).copy() for n in ("x1", "x2", "y1", "y2")]
    sm = g(c["smoother"]).copy()

    def read(name, t):
        at, cur = reads[name]
        before = so[t - 1, rows, at] if t else prev[rows, at]
        return np.where(cur, so[t, rows, at], before) if cur.any() \
            else before

    # where no lane's FM read comes from its own loop, the increments are
    # known for the whole stretch, and the phase walks as synth.py's
    comp = g(s.comp)
    fm_at = reads["fm"][0]
    inner_fm = use_fm & (np.take_along_axis(s.comp, fm_at, 1) == comp)
    walked = None
    if not inner_fm.any():
        at, cur = reads["fm"]
        shifted = np.concatenate([prev[None], so[:-1]])
        inc = np.broadcast_to(pinc, (T,) + pinc.shape)
        if has["fm"]:
            fm = np.where(cur, so[:, rows, at], shifted[:, rows, at])
            inc = np.where(use_fm, rnd(_fma(mis, rnd(fm * fm_dep), pinc)),
                           inc)
        inc = np.where(dirneg, -inc, inc)
        walked = synth._walk_phase(inc, c, s, cols, mine, rnd)

    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        for t in range(T):
            for on in ons:
                # oscillator (osc_next, synth.c:217-275)
                if walked is not None:
                    ph2, active, bad = (a[t] for a in walked)
                else:
                    inc = pinc
                    if has["fm"]:
                        gm = rnd(read("fm", t) * fm_dep)
                        inc = np.where(use_fm, rnd(_fma(mis, gm, pinc)), inc)
                    inc = np.where(dirneg, -inc, inc)
                    active = (fin == 0) & amp_nz
                    ph = rnd(p + inc)
                    bad = ~np.isfinite(ph)
                    over, under = ph >= hi, ph < lo
                    wrap_o = rnd(lo + rnd(np.fmod(rnd(ph - lo), L)))
                    wrap_u = rnd(hi - rnd(np.fmod(rnd(lo - ph), L)))
                    ph2 = np.where(over, np.where(osn, hi_os, wrap_o),
                                   np.where(under,
                                            np.where(osn, lo, wrap_u), ph))
                    ph2 = np.where(bad, F32(0.0), ph2)
                    fin_osc = (bad & one_shot) | ((over | under) & osn)
                    adv = on & active & adv_ok
                    p = np.where(adv, ph2, p)
                    fin = np.where(adv & fin_osc, 1, fin).astype(I32)
                # CZ warp, with its modulator read (synth.c:263-264)
                idx_f = ph2
                if warp is not None:
                    if s.cz_varies:
                        dm = np.where(cm_ge, rnd(read("cm", t) * cz_dep),
                                      F32(1.0))
                        d = rnd(cz_dist + dm)
                    else:
                        d = const_d
                    idx_f = np.where(cz_on, warp.index(ph2, d), ph2)
                idx = np.minimum(np.maximum(_trunc(idx_f), 0), clip_hi)
                f = np.where(bad, F32(0.0), table[toff + idx])
                if has["noise"]:
                    f = np.where(is_noise, noise[t], f)
                # sample and hold (synth.c:560-571)
                s1 = f
                if has["hold"]:
                    hv = np.where(on & take[t], f, hv)
                    s1 = np.where(hold_on, hv, f)
                    hv_last = np.where(on & active, hv, hv_last)
                # bit quantizer (synth.c:341-345, :574)
                s2 = s1
                if has["quant"]:
                    iv = _trunc(_fma32(s1, levels, F32(0.5))).astype(F32)
                    s2 = np.where(quant, rnd(iv * inv_lev), s1)
                # biquad, direct form I (mmf_process, synth.c:349-364)
                s3 = s2
                if has["flt"]:
                    x1, x2, y1, y2 = flt
                    b0, b1, b2, na1, na2 = coefs
                    acc = rnd(b1 * x1)
                    acc = rnd(_fma32(b0, s2, acc))
                    acc = rnd(_fma32(b2, x2, acc))
                    acc = rnd(_fma32(na1, y1, acc))
                    acc = rnd(_fma32(na2, y2, acc))
                    step = on & active & use_flt
                    flt = [np.where(step, a, b) for a, b in
                           zip((s2, x1, acc, y1), flt)]
                    s3 = np.where(use_flt, np.where(active, acc, F32(0.0)),
                                  s2)
                # amplitude: envelope, amp-mod, smoother (synth.c:580-593)
                final = amp
                if envs is not None:
                    final = rnd(final * envs[t])
                if has["am"]:
                    am_read = np.where(am_self, s3, read("am", t))
                    final = rnd(final * np.where(am_on,
                                                 rnd(am_read * am_dep),
                                                 F32(1.0)))
                final2 = final
                if has["sm"]:
                    sg = rnd(_fma32(smoothing, rnd(final - sm), sm))
                    sm = np.where(on & active & use_sm, sg, sm)
                    final2 = np.where(use_sm,
                                      np.where(active, sg, F32(0.0)), final)
                out = np.where(active, rnd(s3 * final2), F32(0.0))
                so_t, act_t = so[t], act_so[t]
                so_t[:, cols] = np.where(on, out, so_t[:, cols])
                act_t[:, cols] = np.where(on, active, act_t[:, cols])

    # the lanes' state after the stretch, as synth._tier leaves it
    def put(name, new, lanes):
        c[name][:, cols] = np.where(lanes, new, g(c[name]))

    if walked is None:
        put("phase", p, mine)
        put("finished", fin, mine)
    if has["hold"]:
        n_act = act_so[:, :, cols].sum(axis=0)
        put("hold_count", np.where(n_act > 0, (c0w + n_act) % hm, c0),
            mine & hold_on)
        put("hold_val", hv_last, mine)
    if has["flt"]:
        for name, v in zip(("x1", "x2", "y1", "y2"), flt):
            put(name, v, mine)
    if has["sm"]:
        put("smoother", sm, mine & use_sm)


def render(tls, dtype: str = "float32") -> np.ndarray:
    """Render compiled timelines (one a row; the same length and block)
    -> ``[rows, num_blocks*block, 2]`` float32.  ``dtype`` "bfloat16"
    is the control."""
    with np.errstate(all="ignore"):
        return _render(tls, rounder(dtype))


def _render(tls, rnd) -> np.ndarray:
    """``synth._render`` with the condensed graph's levels in place of
    its tiers, each level's loop voices walked before its other voices."""
    tl0 = tls[0]
    nb, n = tl0.num_blocks, tl0.block
    if any(tl.num_blocks != nb or tl.block != n for tl in tls):
        raise ValueError("reference: rows of different lengths")
    R = len(tls)
    chunks, offs, at = [], [], 0
    for tl in tls:
        buf = rnd(np.asarray(tl.table_buffer, F32))
        chunks.append(buf)
        offs.append(np.asarray(tl.table_offsets, np.int64) + at)
        at += buf.size
    table = np.concatenate(chunks)
    noise = rnd(noise_stream(nb * n))
    c = {k: np.zeros((R, V), F32) for k in synth._STATE_F}
    c.update({k: np.zeros((R, V), I32) for k in synth._STATE_I})
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
        for k in range(int(s.level.max()) + 1):
            _walk_loops(k, c, s, so, act_so, prev, noise[i0:i0 + T], count,
                        table, rnd)
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
        # the master-volume smoother (synth.c:616-624), then the sum:
        # where a voice loops it walks in float32, as the upstream engine
        # does (see the module docstring)
        if rnd is _same and not s.loop.any():
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
