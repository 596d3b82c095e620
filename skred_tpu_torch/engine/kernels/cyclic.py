"""The cyclic kernel: one block of the per-frame voice loop.

``cyclic_block`` is the port of ``skred_tpu.engine.cyclic.
cyclic_block_pallas``: the reference's serial frame loop (synth.c:526-612)
for scripts whose modulation graph has a cycle (1-sample feedback).  One
lane is one batch row; per frame the ``k`` packed voices run in order
(ascending original index), each through the whole chain: oscillator with
FM, CZ warp (self-modulation too), table lookup, sample & hold, quantizer,
biquad, envelope, amp-mod, smoother, per-sample pan, stereo mix; then the
master-volume smoother.  A modulator read takes this frame's sample of a
voice already rendered and the previous frame's otherwise (the packed
``*_del`` flags carry the rule).

Layout: per-voice vectors contiguous ``[k, B]``; states ``[k, B]`` too,
either contiguous or the transposed view of a contiguous ``[B, k]``
tensor (the renderer's carry: the kernel reads and writes it through
strides, and the new states come back in the same layout); ``vf`` and
``vol_gain`` ``[B]``; the outputs ``[B, n]`` as views of time-major
``[n, B]`` buffers.  Tables stay in the flat buffer; voice
``v`` reads ``table[table_off[v] + idx]``.  A CPU tensor runs
``cyclic_block_plain``, the same arithmetic in torch ops; a CUDA tensor
launches one of ``csrc/cyclic.cu``'s two variants or raises:
``cyclic_fixed`` (voice count, features, CZ modes and arithmetic mode
compiled in; one library per ``fixed_key``, built at first use) for ``k``
up to ``FIXED_K_MAX``, ``cyclic_general`` (all of them run-time
arguments) above it.  The general variant renders a frame's voices at
once, in waves by their same-frame reads (``cyclic_levels``): the
caller's schedule, or one derived from ``vecs``.

Timing ablation (``CYC_ABLATE``): the port of the JAX package's
``SKRED_CYC_ABLATE`` (``skred_tpu/engine/cyclic.py:66-72``), a comma list
over ``CYC_PHASES``, read once at import.  Each named phase that a key
compiles in (``cyclic_phases``) adds one ``CYC_ABLATE_<PHASE>=1`` define
to the keyed build, which stubs it (``csrc/cyclic.cu``); the empty set
adds nothing.  An ablated render is invalid by design.  The plain version
and the general variant have no stubs: ``cyclic_block`` refuses a
nonempty set on a CPU tensor or for the general variant.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from skred_tpu_torch import spans
from skred_tpu_torch.engine.kernels import cuda_call
from skred_tpu_torch.engine.numerics import (cz_scales, cz_warp_k, f32,
                                             kdiv_inv, kfma)

F32 = torch.float32
I32 = torch.int32

# the phases SKRED_CYC_ABLATE may name, in the order of their defines
CYC_PHASES = ("reads", "lookup", "cz", "dsp", "pan", "all")
CYC_ABLATE = cuda_call.ablate_env("SKRED_CYC_ABLATE", CYC_PHASES)

_FLAG_NAMES = ("fm", "cz", "czm", "am", "am_self", "pm", "pm_self", "env",
               "flt", "sm", "hold", "quant", "noise", "finish", "direction",
               "disc")

# per-voice vectors by feature: (key, dtype); "cz_const" is cz without an
# effective cz-mod edge
_VEC_BASE = [("amp", F32), ("pinc", F32), ("lo", F32), ("hi", F32),
             ("L", F32), ("clip_i", I32)]
_VEC_FEAT = {
    "fm": [("fm_osc", I32), ("fm_del", I32), ("use_fm", I32), ("mis", F32),
           ("fm_dep", F32)],
    "direction": [("dirneg", I32)],
    "cz": [("cz_mode", I32), ("cz_dist", F32), ("tsize", F32),
           ("inv_ts", F32)],
    "czm": [("cm_osc", I32), ("cm_del", I32), ("cm_ge", I32),
            ("cm_dep", F32)],
    "cz_const": [("dm_row", F32)],
    "noise": [("is_noise", I32)],
    "finish": [("one_shot", I32), ("osn", I32)],
    "hold": [("hold_on", I32), ("hmax", I32)],
    "quant": [("quant_on", I32), ("levels", F32), ("inv_lev", F32)],
    "flt": [("b0", F32), ("b1", F32), ("b2", F32), ("na1", F32),
            ("na2", F32), ("use_flt", I32)],
    "env": [("use_env", I32), ("env_act", I32), ("env_start", I32),
            ("env_relat", I32), ("att", F32), ("dec", F32), ("sus", F32),
            ("rel", F32), ("vel", F32)],
    "am": [("am_osc", I32), ("am_del", I32), ("am_dep", F32)],
    "pm": [("pm_osc", I32), ("pm_del", I32), ("pm_dep", F32)],
    "pm_self": [("pm_self", I32)],
    "disc": [("disconn", I32)],
    "sm": [("use_sm", I32), ("smoothing", F32)],
}
_VEC_ORDER = ("fm", "direction", "cz", "czm", "cz_const", "noise", "finish",
              "hold", "quant", "flt", "env", "am", "pm", "pm_self", "disc",
              "sm")
_STATE_BASE = [("phase", F32), ("sample", F32)]
_STATE_FEAT = {
    "finish": [("finished", I32)],
    "hold": [("hold_count", I32), ("hold_val", F32)],
    "flt": [("x1", F32), ("x2", F32), ("y1", F32), ("y2", F32)],
    "sm": [("smoother", F32)],
}
_STATE_TAIL = [("pan_l", F32), ("pan_r", F32)]


def _flags(feat):
    """The kernel's feature flags from the renderer's ``Feat``."""
    fl = {name: bool(getattr(feat, name)) for name in _FLAG_NAMES}
    fl["czm"] = fl["czm"] and fl["cz"]
    fl["cz_const"] = fl["cz"] and not fl["czm"]
    fl["cz_modes"] = tuple(int(m) for m in feat.cz_modes)
    return fl


def _vec_keys(fl):
    keys = list(_VEC_BASE)
    for name in _VEC_ORDER:
        if fl[name]:
            keys += _VEC_FEAT[name]
    return keys


def _state_keys(fl):
    """The per-voice states the kernel reads and writes back."""
    keys = list(_STATE_BASE)
    for name in ("finish", "hold", "flt", "sm"):
        if fl[name]:
            keys += _STATE_FEAT[name]
    return keys + _STATE_TAIL


def cyclic_levels(reads, k) -> np.ndarray:
    """The wave of each of ``k`` packed voices in a frame: 0 for a voice
    that reads no other voice's sample of the same frame, else 1 + the
    highest wave among those it does.  A read is of the same frame
    exactly where ``read_mod`` (``csrc/cyclic.cu``) says so: not delayed
    and from a lower voice (a voice's read of itself stays in its own
    thread).  ``reads``: (source, delayed) integer array pairs, the voice
    on the last axis and any leading axes (rows, segments); the waves
    take the union of their edges, so one schedule serves every row and
    segment.  Returns int32 ``[k]``; the wave count is its max + 1."""
    same = np.zeros((k, k), bool)             # same[m, v]: v reads m
    lower = np.arange(k)
    for src, delayed in reads:
        src = np.asarray(src).reshape(-1, k)
        hit = ((np.asarray(delayed).reshape(-1, k) == 0) & (src >= 0)
               & (src < lower))
        same[src[hit], np.nonzero(hit)[1]] = True
    wave = np.zeros(k, np.int32)
    for v in range(k):
        up = wave[:v][same[:v, v]]
        wave[v] = up.max() + 1 if up.size else 0
    return wave


def wave_reads(vecs, feat) -> list:
    """The general variant's modulator reads of ``vecs`` (any shape
    ``[k, ...]``, any device) as ``cyclic_levels`` takes them, each read
    whose value the voice discards taken out: the fm read without
    ``use_fm``, the cz-mod read of a voice whose CZ mode is 0, the
    pan-mod read of a disconnected voice.  The kernel resolves such a
    read to none too, so its result does not change."""
    fl = _flags(feat)
    host = lambda key: vecs[key].T.cpu().numpy()
    reads = []
    if fl["fm"]:
        reads.append((np.where(host("use_fm") != 0, host("fm_osc"), -1),
                      host("fm_del")))
    if fl["czm"]:
        reads.append((np.where(host("cz_mode") != 0, host("cm_osc"), -1),
                      host("cm_del")))
    if fl["am"]:
        reads.append((host("am_osc"), host("am_del")))
    if fl["pm"]:
        pm = host("pm_osc")
        if fl["disc"]:
            pm = np.where(host("disconn") == 0, pm, -1)
        reads.append((pm, host("pm_del")))
    return reads


def schedule_of(vecs, feat, k, device):
    """The general variant's schedule for ``vecs`` (``[k, ...]``; a copy
    to the host where they lie on the card): (wave ``[k]`` int32 on
    ``device``, wave count)."""
    wave = cyclic_levels(wave_reads(vecs, feat), k)
    return (torch.from_numpy(wave).to(device),
            int(wave.max(initial=-1)) + 1)


def cyclic_block_plain(table, table_off, cbase, noise_blk, vecs, states, vf,
                       feat, k, n, exact=True, schedule=None):
    """The kernel's arithmetic in torch ops on any device: a loop over the
    block's frames and, inside each, over the voices.  A stage that no
    row of a voice has on is skipped for that voice: its selects would
    discard what it computes.  Takes ``cyclic_block``'s arguments (the
    voices run in order, so ``schedule`` goes unused) and returns what it
    returns."""
    fl = _flags(feat)
    modes = fl["cz_modes"]
    dev = vf.device
    B = vf.shape[0]
    rng = range(k)
    offs = [int(o) for o in table_off.tolist()]
    col = lambda name: [vecs[name][v] for v in rng]
    on = lambda name: [vecs[name][v] != 0 for v in rng]
    some = lambda masks: [bool(m.any()) for m in masks]
    zero = torch.zeros(B, dtype=F32, device=dev)

    amp, pinc, lo, hi, Lw, clip_i = (col(x) for x in (
        "amp", "pinc", "lo", "hi", "L", "clip_i"))
    amp_nz = [a != 0.0 for a in amp]

    def reader(osc, dly):
        """Per voice: the (source j, lanes reading j) pairs of its edge
        and the lanes that read the previous frame."""
        plan = []
        for v in rng:
            m = vecs[osc][v]
            hits = [(j, m == j) for j in rng]
            plan.append(([(j, h) for j, h in hits if bool(h.any())],
                         vecs[dly][v] != 0))
        return plan

    def read_mod(plan_v, cur, prev):
        pairs, use_prev = plan_v
        val = zero
        for j, hit in pairs:
            val = torch.where(hit, torch.where(use_prev, prev[j], cur[j]),
                              val)
        return val

    if fl["fm"]:
        fm_plan = reader("fm_osc", "fm_del")
        use_fm, mis, fm_dep = on("use_fm"), col("mis"), col("fm_dep")
        has_fm = some(use_fm)
    if fl["direction"]:
        dirneg = on("dirneg")
        has_dir = some(dirneg)
    if fl["cz"]:
        cz_mode, cz_dist, tsize, inv_ts = (col(x) for x in (
            "cz_mode", "cz_dist", "tsize", "inv_ts"))
        cz_on = [m != 0 for m in cz_mode]
        has_cz = some(cz_on)
        if fl["czm"]:
            cm_plan = reader("cm_osc", "cm_del")
            cm_ge, cm_dep = on("cm_ge"), col("cm_dep")
        else:
            scales = [cz_scales(cz_dist[v] + vecs["dm_row"][v], exact, modes)
                      for v in rng]
    if fl["noise"]:
        is_noise = on("is_noise")
        has_noise = some(is_noise)
    if fl["finish"]:
        one_shot, osn = on("one_shot"), on("osn")
        hi_os = [h - f32(1e-6) for h in hi]
    if fl["hold"]:
        hold_on, hmax = on("hold_on"), col("hmax")
        has_hold = some(hold_on)
    if fl["quant"]:
        quant_on, levels, inv_lev = on("quant_on"), col("levels"), \
            col("inv_lev")
        has_quant = some(quant_on)
    if fl["flt"]:
        b0, b1, b2, na1, na2 = (col(x) for x in ("b0", "b1", "b2", "na1",
                                                 "na2"))
        use_flt = on("use_flt")
        has_flt = some(use_flt)
    if fl["env"]:
        use_env, env_act = on("use_env"), on("env_act")
        env_start, env_relat = col("env_start"), col("env_relat")
        att, dec, sus, rel, vel = (col(x) for x in ("att", "dec", "sus",
                                                    "rel", "vel"))
        att_dec = [att[v] + dec[v] for v in rng]
        no_rel = [e == 0 for e in env_relat]
        has_env = some(use_env)
    if fl["am"]:
        am_plan = reader("am_osc", "am_del")
        am_ge = [vecs["am_osc"][v] >= 0 for v in rng]
        am_dep = col("am_dep")
        has_am = some(am_ge)
        if fl["am_self"]:
            am_is_self = [vecs["am_osc"][v] == v for v in rng]
    if fl["pm"]:
        pm_plan = reader("pm_osc", "pm_del")
        pm_dep = col("pm_dep")
        pan_on = [vecs["pm_osc"][v] >= 0 for v in rng]
        if fl["pm_self"]:
            pm_self = on("pm_self")
    if fl["disc"]:
        dc0 = [vecs["disconn"][v] == 0 for v in rng]
        if fl["pm"]:
            pan_on = [pan_on[v] & dc0[v] for v in rng]
    if fl["pm"]:
        has_pan = some(pan_on)
    if fl["sm"]:
        use_sm, smoothing = on("use_sm"), col("smoothing")
        has_sm = some(use_sm)

    st = lambda name: [states[name][v] for v in rng]
    ph, prev, pnl, pnr = st("phase"), st("sample"), st("pan_l"), st("pan_r")
    fin = st("finished") if fl["finish"] else None
    if fl["hold"]:
        hc, hv = st("hold_count"), st("hold_val")
    if fl["flt"]:
        x1, x2, y1, y2 = st("x1"), st("x2"), st("y1"), st("y2")
    if fl["sm"]:
        sg = st("smoother")
    vg = states["vol_gain"]
    out_l = torch.empty((n, B), dtype=F32, device=dev)
    out_r = torch.empty((n, B), dtype=F32, device=dev)

    for t in range(n):
        if fl["noise"]:
            whiteish = noise_blk[t]
        cur = list(prev)
        mix_l = zero
        mix_r = zero
        for v in rng:
            active = amp_nz[v]
            if fl["finish"]:
                active = ~(fin[v] != 0) & amp_nz[v]
            # ---- oscillator (osc_next, synth.c:217-275) ----
            inc = pinc[v]
            if fl["fm"] and has_fm[v]:
                g = read_mod(fm_plan[v], cur, prev) * fm_dep[v]
                inc = torch.where(use_fm[v], kfma(mis[v], g, pinc[v]),
                                  pinc[v])
            if fl["direction"] and has_dir[v]:
                inc = torch.where(dirneg[v], -inc, inc)
            phv = ph[v] + inc
            bad = ~torch.isfinite(phv)
            over = phv >= hi[v]
            under = phv < lo[v]
            r = torch.fmod(phv - lo[v], Lw[v])
            wrap_over = lo[v] + r
            wrap_under = hi[v] + r
            if fl["finish"]:
                ph2 = torch.where(
                    over, torch.where(osn[v], hi_os[v], wrap_over),
                    torch.where(under, torch.where(osn[v], lo[v],
                                                   wrap_under), phv))
            else:
                ph2 = torch.where(over, wrap_over,
                                  torch.where(under, wrap_under, phv))
            ph2 = torch.where(bad, 0.0, ph2)
            # ---- CZ warp, index, lookup ----
            idx_f = ph2
            if fl["cz"] and has_cz[v]:
                if fl["czm"]:
                    rdm = read_mod(cm_plan[v], cur, prev)
                    dm = torch.where(cm_ge[v], rdm * cm_dep[v], 1.0)
                    d3, sc = cz_dist[v] + dm, None
                else:
                    d3, sc = None, scales[v]
                if exact:
                    phase3 = kdiv_inv(ph2, inv_ts[v], tsize[v])
                else:
                    phase3 = ph2 / tsize[v]
                warped = cz_warp_k(cz_mode[v], ph2, d3, tsize[v], exact, sc,
                                   phase3, modes)
                idx_f = torch.where(cz_on[v], warped, ph2)
            idx = torch.minimum(torch.clamp(idx_f.to(I32), min=0), clip_i[v])
            f = table[(idx + offs[v]).long()]
            f = torch.where(bad, 0.0, f)
            adv = active
            if fl["noise"] and has_noise[v]:
                f = torch.where(is_noise[v], whiteish, f)
                adv = active & ~is_noise[v]
            ph[v] = torch.where(adv, ph2, ph[v])
            if fl["finish"]:
                fin_osc = (bad & one_shot[v]) | ((over | under) & osn[v])
                fin[v] = torch.where(adv & fin_osc, 1, fin[v]).to(I32)
            # ---- sample & hold (synth.c:560-571) ----
            s1 = f
            if fl["hold"] and has_hold[v]:
                hv2 = torch.where(hold_on[v] & (hc[v] == 0), f, hv[v])
                s1 = torch.where(hold_on[v], hv2, f)
                hcn = hc[v] + 1
                hc[v] = torch.where(active & hold_on[v],
                                    torch.where(hcn >= hmax[v], 0, hcn),
                                    hc[v]).to(I32)
                hv[v] = torch.where(active, hv2, hv[v])
            # ---- bit quantizer (synth.c:341-345) ----
            s2 = s1
            if fl["quant"] and has_quant[v]:
                iv = kfma(s1, levels[v], 0.5).to(I32).to(F32)
                s2 = torch.where(quant_on[v], iv * inv_lev[v], s1)
            # ---- biquad (mmf_process, synth.c:349-364) ----
            s3 = s2
            if fl["flt"] and has_flt[v]:
                fv = b1[v] * x1[v]
                fv = kfma(b0[v], s2, fv)
                fv = kfma(b2[v], x2[v], fv)
                fv = kfma(na1[v], y1[v], fv)
                fv = kfma(na2[v], y2[v], fv)
                s3 = torch.where(use_flt[v], fv, s2)
                upd = active & use_flt[v]
                x1[v], x2[v] = (torch.where(upd, s2, x1[v]),
                                torch.where(upd, x1[v], x2[v]))
                y1[v], y2[v] = (torch.where(upd, fv, y1[v]),
                                torch.where(upd, y1[v], y2[v]))
            # ---- amp, envelope, amp-mod, smoother ----
            final = amp[v]
            if fl["env"] and has_env[v]:
                count = cbase + t
                tf = (count - env_start[v]).to(F32)
                trf = (count - env_relat[v]).to(F32)
                ev = torch.where(
                    tf < att[v], tf / att[v],
                    torch.where(
                        tf < att_dec[v],
                        kfma(-((tf - att[v]) / dec[v]), 1.0 - sus[v], 1.0),
                        torch.where(
                            no_rel[v], sus[v],
                            torch.where(trf < rel[v],
                                        sus[v] * (1.0 - trf / rel[v]),
                                        0.0))))
                ev = torch.where(env_act[v], ev, 0.0)
                final = amp[v] * torch.where(use_env[v], ev * vel[v], 1.0)
            if fl["am"] and has_am[v]:
                amr = read_mod(am_plan[v], cur, prev)
                if fl["am_self"]:
                    amr = torch.where(am_is_self[v], s3, amr)
                final = final * torch.where(am_ge[v], amr * am_dep[v], 1.0)
            final2 = final
            if fl["sm"] and has_sm[v]:
                sg2 = kfma(smoothing[v], final - sg[v], sg[v])
                final2 = torch.where(use_sm[v], sg2, final)
                sg[v] = torch.where(active & use_sm[v], sg2, sg[v])
            sample_out = torch.where(active, s3 * final2, 0.0)
            cur[v] = sample_out
            # ---- pan (+ pan-mod) and mix (synth.c:595-612) ----
            plv, prv = pnl[v], pnr[v]
            if fl["pm"] and has_pan[v]:
                pmr = read_mod(pm_plan[v], cur, prev)
                if fl["pm_self"]:
                    pmr = torch.where(pm_self[v], sample_out, pmr)
                one_m_q = kfma(-pmr, pm_dep[v], 1.0)
                one_p_q = kfma(pmr, pm_dep[v], 1.0)
                plv = torch.where(pan_on[v], one_m_q * 0.5, pnl[v])
                prv = torch.where(pan_on[v], one_p_q * 0.5, pnr[v])
                pnl[v] = torch.where(active & pan_on[v], plv, pnl[v])
                pnr[v] = torch.where(active & pan_on[v], prv, pnr[v])
            contrib = active & dc0[v] if fl["disc"] else active
            mix_l = mix_l + torch.where(contrib, sample_out * plv, 0.0)
            mix_r = mix_r + torch.where(contrib, sample_out * prv, 0.0)
        prev = cur
        # ---- master-volume smoother (synth.c:616-624) ----
        vg = kfma(0.002, vf - vg, vg)
        out_l[t] = mix_l * vg
        out_r[t] = mix_r * vg

    new = {"phase": ph, "sample": prev, "pan_l": pnl, "pan_r": pnr}
    if fl["finish"]:
        new["finished"] = fin
    if fl["hold"]:
        new.update(hold_count=hc, hold_val=hv)
    if fl["flt"]:
        new.update(x1=x1, x2=x2, y1=y1, y2=y2)
    if fl["sm"]:
        new["smoother"] = sg
    new_states = {name: torch.stack(new[name]) for name, _ in _state_keys(fl)}
    new_states["vol_gain"] = vg
    return out_l.T, out_r.T, new_states


# ---- the CUDA launch: one C struct mirrors csrc/cyclic.cu's CyclicArgs ----

_INT_FIELDS = (("n", "rows", "k", "cbase", "exact")
               + tuple("has_" + name for name in _FLAG_NAMES)
               + ("cz_mask", "st_sv", "st_sb", "n_waves"))
_VEC_FIELDS = tuple(key for key, _ in _VEC_BASE) + tuple(
    key for name in _VEC_ORDER for key, _ in _VEC_FEAT[name])
_STATE_FIELDS = tuple(key for key, _ in (
    _STATE_BASE + _STATE_FEAT["finish"] + _STATE_FEAT["hold"]
    + _STATE_FEAT["flt"] + _STATE_FEAT["sm"] + _STATE_TAIL))
_PTR_FIELDS = (("table", "table_off", "noise", "vf", "wave") + _VEC_FIELDS
               + tuple(key + "_0" for key in _STATE_FIELDS) + ("vol_gain_0",)
               + tuple(key + "_e" for key in _STATE_FIELDS) + ("vol_gain_e",)
               + ("out_l", "out_r"))


class CyclicArgs(ctypes.Structure):
    _fields_ = ([(key, ctypes.c_int) for key in _INT_FIELDS]
                + [(key, ctypes.c_void_p) for key in _PTR_FIELDS])


def _check_states(items, dev, k, B):
    """The pointers and the shared (voice, row) strides of ``[k, B]``
    states that are either contiguous or the transposed view of a
    contiguous ``[B, k]`` tensor."""
    ptrs, layouts = {}, set()
    for name, x, dt in items:
        if isinstance(x, torch.Tensor) and x.dim() == 2 \
                and not x.is_contiguous() and x.T.is_contiguous():
            ptrs[name] = cuda_call.check("cyclic", name, x.T, dev, dt,
                                         (B, k))
            layouts.add((1, k))
        else:
            ptrs[name] = cuda_call.check("cyclic", name, x, dev, dt, (k, B))
            layouts.add((B, 1))
    if len(layouts) != 1:
        raise ValueError("cyclic: states mix [k, B] and transposed [B, k] "
                         "layouts")
    return ptrs, layouts.pop()


def _cz_mask(fl):
    return sum(1 << m for m in fl["cz_modes"] if 1 <= m <= 7)


def _pack_args(table, table_off, cbase, noise_blk, vecs, states, vf, feat,
               k, n, exact, schedule=None):
    """Check the CUDA tensors and fill the kernel's argument struct;
    ``schedule`` (``schedule_of``'s pair) for the general variant, derived
    from ``vecs`` where None.  Returns (CyclicArgs, out_l, out_r,
    new_states); the struct keeps the schedule's tensor alive."""
    fl = _flags(feat)
    dev = vf.device
    B = vf.shape[0]
    chk = lambda *x: cuda_call.check("cyclic", *x)
    a = CyclicArgs()
    a.n, a.rows, a.k, a.cbase, a.exact = n, B, k, int(cbase), \
        int(bool(exact))
    for name in _FLAG_NAMES:
        setattr(a, "has_" + name, int(fl[name]))
    a.cz_mask = _cz_mask(fl)
    if table.dim() != 1:
        raise ValueError("cyclic: table must be the flat [R] buffer")
    a.table = chk("table", table, dev, F32, tuple(table.shape))
    a.table_off = chk("table_off", table_off, dev, I32, (k,))
    a.vf = chk("vf", vf, dev, F32, (B,))
    if fl["noise"]:
        a.noise = chk("noise_blk", noise_blk, dev, F32, (n,))
    for key, dt in _vec_keys(fl):
        if key not in vecs:
            raise KeyError(f"cyclic: feat needs vecs[{key!r}]")
        setattr(a, key, chk(key, vecs[key], dev, dt, (k, B)))
    for key, _ in _state_keys(fl):
        if key not in states:
            raise KeyError(f"cyclic: feat needs states[{key!r}]")
    ptrs, (a.st_sv, a.st_sb) = _check_states(
        [(key, states[key], dt) for key, dt in _state_keys(fl)], dev, k, B)
    new_states = {}
    for key, ptr in ptrs.items():
        setattr(a, key + "_0", ptr)
        # same layout as the input: empty_like keeps a dense tensor's strides
        new_states[key] = torch.empty_like(states[key])
        setattr(a, key + "_e", new_states[key].data_ptr())
    a.vol_gain_0 = chk("vol_gain", states["vol_gain"], dev, F32, (B,))
    new_states["vol_gain"] = torch.empty(B, dtype=F32, device=dev)
    a.vol_gain_e = new_states["vol_gain"].data_ptr()
    out = torch.empty((2, n, B), dtype=F32, device=dev)
    a.out_l, a.out_r = out[0].data_ptr(), out[1].data_ptr()
    wave, a.n_waves = schedule or schedule_of(vecs, feat, k, dev)
    a.wave = chk("wave", wave, dev, I32, (k,))
    a.keep = wave
    return a, out[0].T, out[1].T, new_states


# The keyed variant's cap: its per-voice states live in registers, so the
# voice count is bounded by the register file.  The rule, from ptxas's
# report and the SASS of the all-features key: at every count up to the
# cap it stays clear of the 255-register ceiling (below 248) and spills
# nothing inside its frame loops (ptxas may spill a few bytes in the
# once-per-block prologue); at 9 voices it reaches the ceiling (PERF.md,
# the kernel table).
FIXED_K_MAX = 8


def cyclic_phases(feat) -> tuple:
    """The ``CYC_PHASES`` a keyed build of ``feat`` compiles in: the fm
    modulator read with fm (the cz-mod read belongs to the CZ warp, the
    am read to the pipeline and the pan-mod read to the pan, each stubbed
    with its phase alone); the lookup and the voice body always; the CZ
    warp with cz; the hold / quantizer / filter / envelope / am /
    smoother pipeline with any of those; the per-sample pan with
    pan-mod."""
    fl = _flags(feat)
    have = {"reads": fl["fm"], "lookup": True, "cz": fl["cz"],
            "dsp": any(fl[x] for x in ("hold", "quant", "flt", "env", "am",
                                       "sm")),
            "pan": fl["pm"], "all": True}
    return tuple(p for p in CYC_PHASES if have[p])


def fixed_key(feat, k, exact=True, ablate=CYC_ABLATE):
    """The build key (``-D`` defines) of the keyed variant for ``feat``
    at ``k`` voices: one library per key, as the JAX package compiles
    one kernel per (features, CZ modes, k).  Deterministic; the CZ mode
    mask counts only where CZ is on.  ``ablate`` (default
    ``CYC_ABLATE``; a comma string or a collection): the phases to stub,
    one ``CYC_ABLATE_<PHASE>=1`` define each, in ``CYC_PHASES`` order,
    for those the build compiles in (``cyclic_phases``); none for the
    empty set."""
    fl = _flags(feat)
    key = ((f"CYC_K={int(k)}", f"CYC_EXACT={int(bool(exact))}",
            f"CYC_CZ_MASK={_cz_mask(fl) if fl['cz'] else 0}")
           + tuple(f"CYC_HAS_{name.upper()}={int(fl[name])}"
                   for name in _FLAG_NAMES))
    if not ablate:
        return key
    ablate = cuda_call.ablate_set(ablate, CYC_PHASES, "cyclic")
    return key + tuple(f"CYC_ABLATE_{p.upper()}=1"
                       for p in cyclic_phases(feat) if p in ablate)


def variant_for(k):
    """The rule: the keyed variant up to the cap, the general one above
    it (and for a block with no voice)."""
    return "fixed" if 1 <= k <= FIXED_K_MAX else "general"


def cyclic_fixed(args, key, dev):
    """Launch the keyed variant built under ``key`` (built at first use;
    a failed build raises)."""
    cuda_call.launch("cyclic", args, dev, key, "cyclic_fixed_launch")
    cyclic_fixed.launches += 1


def cyclic_general(args, dev):
    """Launch the general variant."""
    cuda_call.launch("cyclic", args, dev, (), "cyclic_general_launch")
    cyclic_general.launches += 1


def cyclic_block(table, table_off, cbase, noise_blk, vecs, states, vf, feat,
                 k, n, exact=True, variant=None, schedule=None):
    """One block of the cyclic engine over all batch rows.

    table: [R] f32 flat table buffer; table_off: [k] i32, each voice's
    table base in it; cbase: int, the 1-based global sample count of the
    block's first frame (envelope); noise_blk: [n] f32 or None (one noise
    value per frame serves every noise voice and row); vecs / states:
    dicts of [k, B] per-voice tensors (vecs contiguous; see the module
    docstring for the states' layouts), states["vol_gain"] [B]; vf: [B]
    volume_final; feat: the renderer's ``Feat``.  The kernel reads
    ``table_off[v] + [0, clip_i]`` unchecked: the caller keeps those
    inside the buffer (the cyclic renderer checks once per render, on the
    host).  ``variant``:
    None takes ``variant_for(k)``; "fixed" or "general" names one (the
    tests and chip_smoke.py hold both to the plain version).
    ``schedule``: the general variant's waves, ``(wave [k] int32 on the
    device, wave count)`` from ``cyclic_levels`` over edges that include
    every same-frame read of ``vecs`` (the renderer builds it once per
    batch); None derives it from ``vecs`` with a copy to the host
    (``schedule_of``).  The keyed variant ignores it.  A nonempty
    ``CYC_ABLATE`` stubs the keyed variant's phases (timing only); the
    plain version and the general variant refuse it.  Returns
    ``(out_l [B, n], out_r [B, n], new_states)``; new_states holds the
    states that ``feat`` lets the block change, and vol_gain.  The
    argument building and the launch (or the plain version) run inside
    the span ``kernel.cyclic``, ``n`` = ``k``: a reader tells the variant
    by it."""
    with spans.span("kernel.cyclic", k):
        dev = vf.device
        if CYC_ABLATE and (dev.type == "cpu"
                           or (variant or variant_for(k)) == "general"):
            raise ValueError(
                f"cyclic: ablation {sorted(CYC_ABLATE)} stubs phases of the "
                f"keyed kernel only; the "
                + ("plain version (a CPU tensor)" if dev.type == "cpu"
                   else "general variant") + " has no stubs")
        if dev.type == "cpu":
            return cyclic_block_plain(table, table_off, cbase, noise_blk, vecs,
                                      states, vf, feat, k, n, exact)
        if dev.type != "cuda":
            raise ValueError(f"cyclic: no kernel for device {dev}")
        variant = variant or variant_for(k)
        if variant == "fixed" and not 1 <= k <= FIXED_K_MAX:
            raise ValueError(f"cyclic: the keyed variant takes 1 to "
                             f"{FIXED_K_MAX} voices, not {k}")
        if variant not in ("fixed", "general"):
            raise ValueError(f"cyclic: no variant {variant!r}")
        args, out_l, out_r, new_states = _pack_args(
            table, table_off, cbase, noise_blk, vecs, states, vf, feat, k, n,
            exact, schedule)
        if variant == "fixed":
            cyclic_fixed(args, fixed_key(feat, k, exact, CYC_ABLATE), dev)
        else:
            cyclic_general(args, dev)
        cyclic_block.launches += 1
        return out_l, out_r, new_states


cyclic_block.launches = 0
cyclic_fixed.launches = 0
cyclic_general.launches = 0
