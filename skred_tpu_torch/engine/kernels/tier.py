"""The tier kernel: one block of one tier's per-voice DSP chain.

``tier`` is the port of ``skred_tpu.engine.kernels.tier_pallas``, with its
modulator-bank fold and its in-kernel stereo mix.  Per lane and per
sample it runs:

  0. the FM increment from the raw modulator-read stream;
  1. the serial phase walk (osc_next, synth.c:217-258) and alive count;
  2. the CZ warp (synth.c:149-215) and the index clip;
  3. the table lookup at global flat indices into the packed buffer;
  3.5 the gain amp·envelope·amp-mod;
  4. the serial sample&hold, quantizer, biquad and amp smoother
     (synth.c:560-592), with exact fmas at gcc's contracted sites;
  5. with ``mixw``: the static-pan stereo mix, the sum over the tier's
     voices of out·weight into an ``[N, B]`` accumulator pair, in
     ascending voice order, plus ``out_last``, the block's last samples.

With ``fold`` the fm / cz / am modulator streams are not passed in: the
kernel reads them from a bank of the earlier tiers' output (``Fold``),
lane ``v*B + b`` with source voice ``s`` taking column ``s*B + b``, one
sample late where the lane's delay flag is set.  The per-lane source and
delay vectors ride in ``vecs`` (``fm_src``/``fm_del``, ``cz_src``/
``cz_del``, ``am_src``/``am_del``).

Layout: time-major ``[N, M]`` streams over voice-major lanes (lane
``v*B + b``), per-lane ``[M]`` parameters and states, as the JAX kernel
takes them.  A CPU tensor runs ``tier_plain``, the same arithmetic in
torch ops; a CUDA tensor launches ``csrc/tier.cu`` or raises.

``csrc/tier.cu`` is built once per ``tier_key`` (the feature tuple,
the arithmetic mode, the mix and the folded streams, all compiled in);
a render builds its tiers' keys together before its first block
(``engine/fused.py``).

``feat`` is the JAX kernel's 14-tuple (fm, cz, czm, env, flt, sm, hold,
quant, am, am_self, finish, direction, cz_modes, ts_pow2).

Timing ablation (``MEGA_ABLATE``): the port of the JAX package's
``SKRED_MEGA_ABLATE`` (``skred_tpu/engine/kernels.py:245``), a comma list
over ``MEGA_PHASES``, read once at import.  Each named phase that a key
compiles in (``tier_phases``) adds one ``TIER_ABLATE_<PHASE>=1`` define to
the keyed build, which stubs that phase (``csrc/tier.cu``); the empty set
adds nothing, so every key is then the same as without the switch.  An
ablated render is invalid by design: it is for timing a phase's share
(``tools/mega_ablate.py``).  The plain version has no stubs, so
``tier`` refuses a nonempty set on a CPU tensor, as the JAX package's XLA
branch never reads it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from skred_tpu_torch import spans
from skred_tpu_torch.engine.kernels import cuda_call
from skred_tpu_torch.engine.numerics import (cz_scales, cz_warp_coeffs,
                                             cz_warp_fast, cz_warp_k, f32,
                                             kdiv, kdiv_inv, kfma)

F32 = torch.float32
I32 = torch.int32

# the phases SKRED_MEGA_ABLATE may name, in the order of their defines
MEGA_PHASES = ("phase1", "phase2", "lookup", "gain", "phase4", "mix")
MEGA_ABLATE = cuda_call.ablate_env("SKRED_MEGA_ABLATE", MEGA_PHASES)

# per-lane vectors by feature: (key, dtype)
_VEC_BASE = [("base_off", I32), ("clip_i", I32), ("adv", I32), ("act", I32),
             ("lo", F32), ("hi", F32), ("L", F32), ("amp", F32)]
_VEC_FEAT = {
    "fm": [("use_fm", I32), ("mis", F32), ("pinc", F32), ("fm_depth", F32)],
    "direction": [("dirneg", I32)],
    "czm": [("cm_ge0", I32), ("cz_depth", F32)],
    "am": [("am_ge0", I32), ("am_depth_a", F32)],
    "finish": [("osn", I32), ("one_shot", I32)],
    "cz": [("cz_mode", I32), ("cz_dist", F32), ("tsize", F32)],
    "env": [("use_env", I32), ("env_active", I32), ("env_start", I32),
            ("env_rel_at", I32), ("att", F32), ("dec", F32), ("sus", F32),
            ("rel", F32), ("vel", F32)],
    "flt": [("b0", F32), ("b1", F32), ("b2", F32), ("na1", F32),
            ("na2", F32), ("use_flt", I32)],
    "sm": [("use_sm", I32), ("smoothing", F32)],
    "am_self": [("am_self", I32), ("am_depth", F32)],
    "hold": [("hold_on", I32), ("hold_max", I32)],
    "quant": [("quant_on", I32), ("levels", F32), ("inv_levels", F32)],
}
_STATE_FEAT = {
    "finish": [("finished", I32)],
    "flt": [("x1", F32), ("x2", F32), ("y1", F32), ("y2", F32)],
    "sm": [("smoother", F32)],
    "hold": [("hold_count", I32), ("hold_val", F32)],
}
_FEAT_NAMES = ("fm", "cz", "czm", "env", "flt", "sm", "hold", "quant", "am",
               "am_self", "finish", "direction")


# a folded stream's extra per-lane vectors: (source voice, delay flag)
_FOLD_VECS = {"fm": ("fm_src", "fm_del"), "cz": ("cz_src", "cz_del"),
              "am": ("am_src", "am_del")}


class Fold(NamedTuple):
    """The modulator bank of a folded tier pass.

    bank: [N, >= w*b] f32, unit stride along lanes (a column slice of a
    wider block buffer will do): the earlier tiers' output, voice-major;
    prev: [>= w*b] f32, their samples just before the block; w: the
    voices the bank holds; streams: which of "fm", "cz", "am" the kernel
    reads from it."""
    bank: torch.Tensor
    prev: torch.Tensor
    w: int
    streams: tuple = ("fm", "cz", "am")


def fold_read_plain(bank, prev, src, delayed, w, b, n):
    """A modulator-read stream over a block in voice-major lanes, with
    the reference's serial-order rule (synth.c:526): a lane whose delay
    flag is set sees its source one sample late, the previous block's
    last sample at t = 0.

    bank: [N, >= w*b] (or None when w == 0); prev: [>= w*b]; src,
    delayed: [M] i32 per-lane source voice and delay flag.  A source
    outside [0, w) reads 0.0, never another voice, and every read adds
    +0.0, as the JAX package's one-hot product does (which also turns
    -0.0 into +0.0).  Returns [N, M]."""
    m = src.shape[0]
    if w == 0 or bank is None:
        return torch.zeros((n, m), dtype=F32, device=src.device)
    valid = (src >= 0) & (src < w)
    lane_b = torch.arange(m, device=src.device) % b
    col = src.clamp(0, w - 1).long() * b + lane_b
    cur = torch.where(valid, bank[:, col], 0.0) + 0.0
    last = torch.where(valid, prev[col], 0.0) + 0.0
    shifted = torch.cat([last[None], cur[:-1]], dim=0)
    return torch.where(delayed[None] != 0, shifted, cur)


def bank_read(bank, src, delayed, n, b):
    """``fold_read_plain`` from a ``Fold`` (its ``streams`` unused); a
    bank of None, a tier with no earlier tier, reads +0.0 everywhere."""
    if bank is None:
        return torch.zeros((n, src.shape[0]), dtype=F32, device=src.device)
    return fold_read_plain(bank.bank, bank.prev, src, delayed, bank.w, b, n)


def bank_args(a, kernel, bank, dev, n, b, m):
    """Check the bank of a kernel that reads one (csrc/bank.cuh) and fill
    its fields ``b``, ``bank_w``, ``bank_stride``, ``bank``, ``prev``:
    None (or no voices) reads +0.0 everywhere."""
    if b < 1 or m % b:
        raise ValueError(f"{kernel}: b={b} rows do not divide {m} lanes")
    a.b = b
    if bank is None or bank.w == 0:
        return
    w = int(bank.w)
    x, prev = bank.bank, bank.prev
    if x.device != dev or prev.device != dev or x.dtype != F32 \
            or prev.dtype != F32:
        raise ValueError(f"{kernel}: the bank must be f32 on {dev}")
    if x.dim() != 2 or x.shape[0] != n or x.shape[1] < w * b \
            or x.stride(1) != 1 or prev.dim() != 1 \
            or prev.shape[0] < w * b or not prev.is_contiguous():
        raise ValueError(f"{kernel}: the bank must be [{n}, >= {w * b}] "
                         f"with unit stride along lanes, prev [>= {w * b}]")
    a.bank_w, a.bank_stride = w, x.stride(0)
    a.bank, a.prev = x.data_ptr(), prev.data_ptr()


def mix_plain(out, wl, wr, b, acc=None):
    """Phase 5 in torch ops: per channel the sum over voices of
    out[:, v*b:(v+1)*b] * w[v*b:(v+1)*b], product and sum each rounded
    once, in ascending voice order from +0.0, then added onto ``acc``
    (the earlier tiers' pair) when given.  Returns (acc_l, acc_r)."""
    n, m = out.shape
    res = []
    for w, prior in zip((wl, wr), acc if acc is not None else (None, None)):
        s = torch.zeros((n, b), dtype=F32, device=out.device)
        for v in range(m // b):
            s = s + out[:, v * b:(v + 1) * b] * w[v * b:(v + 1) * b]
        res.append(s if prior is None else prior + s)
    return tuple(res)


def _flags(feat):
    fl = dict(zip(_FEAT_NAMES, (bool(x) for x in feat[:12])))
    fl["czm"] = fl["czm"] and fl["cz"]
    fl["cz_modes"] = tuple(int(k) for k in feat[12])
    fl["ts_pow2"] = bool(feat[13])
    return fl


def _vec_keys(fl, folded=()):
    keys = list(_VEC_BASE)
    for name in folded:
        keys += [(k, I32) for k in _FOLD_VECS[name]]
    for name in ("fm", "czm", "am", "finish", "cz", "env", "flt", "sm",
                 "am_self", "hold", "quant"):
        if fl[name]:
            keys += _VEC_FEAT[name]
    if fl["fm"] and fl["direction"]:
        keys += _VEC_FEAT["direction"]
    return keys


def _state_keys(fl):
    keys = [("phase", F32)]
    for name in ("finish", "flt", "sm", "hold"):
        if fl[name]:
            keys += _STATE_FEAT[name]
    return keys


def _folded(fl, fold):
    """The streams of ``fold`` that the feature set has, in fm/cz/am
    order."""
    if fold is None:
        return ()
    has = {"fm": fl["fm"], "cz": fl["czm"], "am": fl["am"]}
    bad = [k for k in fold.streams if k not in has]
    if bad:
        raise ValueError(f"tier: unknown folded stream {bad}")
    return tuple(k for k in ("fm", "cz", "am")
                 if k in fold.streams and has[k])


def tier_plain(table, cbase, inc, dm, amod, vecs, states, *, feat,
               exact=True, n, b=None, mixw=None, acc=None, fold=None,
               out=None):
    """The tier kernel's arithmetic in torch ops on any device: the
    vector phases run over the whole ``[N, M]`` block, the two serial
    recurrences (phases 1 and 4) as a loop over samples; the folded
    reads and the mix as ``fold_read_plain`` and ``mix_plain``.  Takes
    and returns what ``tier`` does."""
    fl = _flags(feat)
    folded = _folded(fl, fold)
    if folded or mixw is not None:
        if b is None:
            raise ValueError("tier: the fold and the mix need b")
    reads = {k: bank_read(fold, vecs[_FOLD_VECS[k][0]],
                          vecs[_FOLD_VECS[k][1]], n, b) for k in folded}
    inc = reads.get("fm", inc)
    dm = reads.get("cz", dm)
    amod = reads.get("am", amod)
    fm, cz, czm = fl["fm"], fl["cz"], fl["czm"]
    env_a, flt, sm, hold, quant = (fl[k] for k in ("env", "flt", "sm",
                                                    "hold", "quant"))
    am_a, am_self_f, finish, dirn = (fl[k] for k in ("am", "am_self",
                                                      "finish", "direction"))
    modes = fl["cz_modes"]
    v = vecs
    dev = v["amp"].device
    m = v["amp"].shape[0]

    # ---- phase 0: FM increment (vector over the block) ----
    if fm:
        g3 = inc * v["fm_depth"]
        inc3 = torch.where(v["use_fm"] != 0, kfma(v["mis"], g3, v["pinc"]),
                           v["pinc"])
        if dirn:
            inc3 = torch.where(v["dirneg"] != 0, -inc3, inc3)

    # ---- phase 1: serial phase walk + alive count ----
    lo, hi, L = v["lo"], v["hi"], v["L"]
    adv = v["adv"] != 0
    act = v["act"] != 0
    if finish:
        osn = v["osn"] != 0
        one_shot = v["one_shot"] != 0
        fin_c = states["finished"]
    ph_c = states["phase"]
    cnt = torch.zeros(m, dtype=I32, device=dev)
    ph_s = torch.empty((n, m), dtype=F32, device=dev)
    hi_os = hi - f32(1e-6)
    for t in range(n):
        ph = ph_c + (inc3[t] if fm else inc)
        bad = ~torch.isfinite(ph)
        over = ph >= hi
        under = ph < lo
        r = torch.fmod(ph - lo, L)
        wrap_over = lo + r
        wrap_under = hi + r
        if finish:
            ph2 = torch.where(
                over, torch.where(osn, hi_os, wrap_over),
                torch.where(under, torch.where(osn, lo, wrap_under), ph))
        else:
            ph2 = torch.where(over, wrap_over,
                              torch.where(under, wrap_under, ph))
        ph2 = torch.where(bad, 0.0, ph2)
        ph_s[t] = ph2
        if finish:
            fin_new = (bad & one_shot) | ((over | under) & osn)
            fin_b = fin_c != 0
            step_on = adv & ~fin_b
            alive_t = act & ~fin_b
            ph_c = torch.where(step_on, ph2, ph_c)
            fin_c = torch.where(step_on & fin_new, 1, fin_c).to(I32)
            cnt = cnt + alive_t.to(I32)
        else:
            ph_c = torch.where(adv, ph2, ph_c)
    if not finish:
        cnt = torch.where(act, n, 0).to(I32)
    tpos = torch.arange(n, dtype=I32, device=dev)[:, None]
    alive = tpos < cnt[None]

    # ---- phase 2: CZ warp + index clip + dead masking ----
    if cz:
        mode, dist, tsz = v["cz_mode"], v["cz_dist"], v["tsize"]
        if exact:
            inv_ts = kdiv(1.0, tsz)
        if exact and fl["ts_pow2"]:
            phase3 = ph_s * inv_ts
        elif exact:
            phase3 = kdiv_inv(ph_s, inv_ts, tsz)
        else:
            phase3 = ph_s / tsz
        if czm:
            dm3 = torch.where(v["cm_ge0"] != 0, dm * v["cz_depth"], 1.0)
            warped = cz_warp_k(mode, ph_s, dist + dm3, tsz, exact, None,
                               phase3, modes)
        else:
            scales = cz_scales(dist + dm, exact, modes)
            coeffs = cz_warp_coeffs(mode, scales, modes)
            warped = cz_warp_fast(coeffs, mode, phase3, tsz, modes)
        idx_f = torch.where(mode != 0, warped, ph_s)
    else:
        idx_f = ph_s
    idx = torch.minimum(torch.clamp(idx_f.to(I32), min=0), v["clip_i"])
    idx = torch.where(alive, idx, 0)

    # ---- phase 3: table lookup at global flat indices ----
    f_s = table[(v["base_off"] + idx).long()]

    # ---- phase 3.5: gain amp·env(·amod) ----
    amp = v["amp"]
    hoist_am = am_a and not am_self_f
    hoist_gain = env_a or hoist_am
    if hoist_gain:
        if env_a:
            tf = (cbase + tpos - v["env_start"]).to(F32)
            trf = (cbase + tpos - v["env_rel_at"]).to(F32)
            att, dec, sus, rel = v["att"], v["dec"], v["sus"], v["rel"]
            env = torch.where(
                tf < att, tf / att,
                torch.where(
                    tf < att + dec,
                    kfma(-((tf - att) / dec), 1.0 - sus, 1.0),
                    torch.where(v["env_rel_at"] == 0, sus,
                                torch.where(trf < rel,
                                            sus * (1.0 - trf / rel), 0.0))))
            env = torch.where(v["env_active"] != 0, env, 0.0)
            env_t = torch.where(v["use_env"] != 0, env * v["vel"], 1.0)
            gain = amp * env_t
        else:
            gain = amp.expand(n, m)
        if hoist_am:
            gain = gain * torch.where(v["am_ge0"] != 0,
                                      amod * v["am_depth_a"], 1.0)

    # ---- phase 4: serial S&H + quant + biquad + smoother ----
    if flt:
        b0, b1, b2, na1, na2 = (v[k] for k in ("b0", "b1", "b2", "na1",
                                               "na2"))
        use_flt = v["use_flt"] != 0
        x1, x2, y1, y2 = (states[k] for k in ("x1", "x2", "y1", "y2"))
    if sm:
        use_sm = v["use_sm"] != 0
        smoothing = v["smoothing"]
        sg = states["smoother"]
    if am_self_f:
        am_self = v["am_self"] != 0
        am_depth = v["am_depth"]
    if hold:
        hold_on = v["hold_on"] != 0
        hmax = v["hold_max"]
        hc, hv = states["hold_count"], states["hold_val"]
    if quant:
        quant_on = v["quant_on"] != 0
        levels, inv_lev = v["levels"], v["inv_levels"]
    if out is None:
        out = torch.empty((n, m), dtype=F32, device=dev)
    for t in range(n):
        alive_t = alive[t]
        f_t = torch.where(alive_t, f_s[t], 0.0)
        if hold:
            hv2 = torch.where(hold_on & (hc == 0), f_t, hv)
            s1 = torch.where(hold_on, hv2, f_t)
            hcn = hc + 1
            hcn = torch.where(hcn >= hmax, 0, hcn)
            hv = torch.where(alive_t, hv2, hv)
            hc = torch.where(alive_t & hold_on, hcn, hc).to(I32)
        else:
            s1 = f_t
        if quant:
            iv = kfma(s1, levels, 0.5).to(I32).to(F32)
            x_t = torch.where(quant_on, iv * inv_lev, s1)
        else:
            x_t = s1
        if flt:
            fv = b1 * x1
            fv = kfma(b0, x_t, fv)
            fv = kfma(b2, x2, fv)
            fv = kfma(na1, y1, fv)
            fv = kfma(na2, y2, fv)
            s3 = torch.where(use_flt, fv, x_t)
            upd = alive_t & use_flt
            x1, x2, y1, y2 = (torch.where(upd, x_t, x1),
                              torch.where(upd, x1, x2),
                              torch.where(upd, fv, y1),
                              torch.where(upd, y1, y2))
        else:
            s3 = x_t
        base_gain = gain[t] if hoist_gain else amp
        if am_self_f:
            if am_a:
                amod_t = torch.where(v["am_ge0"] != 0,
                                     amod[t] * v["am_depth_a"], 1.0)
            else:
                amod_t = 1.0
            amod_t = torch.where(am_self, s3 * am_depth, amod_t)
            final_t = base_gain * amod_t
        else:
            final_t = base_gain
        if sm:
            sg2 = kfma(smoothing, final_t - sg, sg)
            final2 = torch.where(use_sm, sg2, final_t)
            sg = torch.where(alive_t & use_sm, sg2, sg)
        else:
            final2 = final_t
        out[t] = torch.where(alive_t, s3 * final2, 0.0)

    res = {"phase": ph_c, "cnt": cnt}
    if finish:
        res["finished"] = fin_c
    if flt:
        res.update(x1=x1, x2=x2, y1=y1, y2=y2)
    if sm:
        res["smoother"] = sg
    if hold:
        res.update(hold_count=hc, hold_val=hv)
    if mixw is not None:
        res["out_last"] = out[n - 1].clone()
        mixed = mix_plain(out, mixw[0], mixw[1], b, acc)
        if acc is not None:         # in place, as the kernel
            acc[0].copy_(mixed[0])
            acc[1].copy_(mixed[1])
            mixed = acc
        res["acc_l"], res["acc_r"] = mixed
    return out, res


# ---- the CUDA launch: one C struct mirrors csrc/tier.cu's TierArgs ----

_INT_FIELDS = (("n", "m", "cbase", "exact")
               + tuple("has_" + k for k in _FEAT_NAMES)
               + ("cz_mask", "ts_pow2", "b", "out_stride", "has_mix",
                  "acc_add", "fold_fm", "fold_cz", "fold_am", "bank_w",
                  "bank_stride"))
_PTR_FIELDS = (
    "table", "inc", "dm", "amod",
    "bank", "prev", "fm_src", "fm_del", "cz_src", "cz_del", "am_src",
    "am_del", "wl", "wr",
    "use_fm", "mis", "pinc", "fm_depth", "dirneg",
    "cm_ge0", "cz_depth", "am_ge0", "am_depth_a",
    "base_off", "clip_i", "adv", "act", "lo", "hi", "L", "amp",
    "osn", "one_shot", "cz_mode", "cz_dist", "tsize",
    "use_env", "env_active", "env_start", "env_rel_at",
    "att", "dec", "sus", "rel", "vel",
    "b0", "b1", "b2", "na1", "na2", "use_flt", "use_sm", "smoothing",
    "am_self", "am_depth", "hold_on", "hold_max",
    "quant_on", "levels", "inv_levels",
    "phase_0", "finished_0", "x1_0", "x2_0", "y1_0", "y2_0", "smoother_0",
    "hold_count_0", "hold_val_0",
    "out", "cnt_e", "phase_e", "finished_e", "x1_e", "x2_e", "y1_e",
    "y2_e", "smoother_e", "hold_count_e", "hold_val_e",
    "acc_l", "acc_r", "out_last")


class TierArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_int) for k in _INT_FIELDS]
                + [(k, ctypes.c_void_p) for k in _PTR_FIELDS])


def _pack_args(table, cbase, inc, dm, amod, vecs, states, feat, exact, n,
               b, mixw, acc, fold, out):
    """Check the CUDA tensors and fill the kernel's argument struct.
    Returns (TierArgs, out [N, M], end-state dict incl. cnt)."""
    fl = _flags(feat)
    folded = _folded(fl, fold)
    dev = table.device
    m = vecs["amp"].shape[0]
    if folded or mixw is not None:
        if b is None or b < 1 or m % b:
            raise ValueError(f"tier: the fold and the mix need b rows "
                             f"dividing the {m} lanes, got {b}")
    a = TierArgs()
    a.n, a.m, a.cbase, a.exact = n, m, int(cbase), int(bool(exact))
    a.b = m if b is None else int(b)
    for k in _FEAT_NAMES:
        setattr(a, "has_" + k, int(fl[k]))
    a.cz_mask = sum(1 << k for k in fl["cz_modes"] if 1 <= k <= 7)
    a.ts_pow2 = int(fl["ts_pow2"])
    if table.dim() != 1:
        raise ValueError("tier: table must be the flat [R] buffer")
    _check = lambda *x: cuda_call.check("tier", *x)
    a.table = _check("table", table, dev, F32, tuple(table.shape))
    if "fm" not in folded:
        a.inc = _check("inc", inc, dev, F32, (n, m) if fl["fm"] else (m,))
    if fl["cz"] and "cz" not in folded:
        a.dm = _check("dm", dm, dev, F32, (n, m) if fl["czm"] else (m,))
    if fl["am"] and "am" not in folded:
        a.amod = _check("amod", amod, dev, F32, (n, m))
    for k in folded:
        setattr(a, "fold_" + k, 1)
    if folded:
        w = int(fold.w)
        a.bank_w = w
        if w:
            _check("prev", fold.prev, dev, F32, tuple(fold.prev.shape))
            _strided("bank", fold.bank, dev, n)
            if fold.prev.dim() != 1 or fold.prev.shape[0] < w * a.b \
                    or fold.bank.shape[1] < w * a.b:
                raise ValueError(f"tier: the bank holds fewer than "
                                 f"{w} voices of {a.b} rows")
            a.bank, a.prev = fold.bank.data_ptr(), fold.prev.data_ptr()
            a.bank_stride = fold.bank.stride(0)
    for k, dt in _vec_keys(fl, folded):
        if k not in vecs:
            raise KeyError(f"tier: feat needs vecs[{k!r}]")
        setattr(a, k, _check(k, vecs[k], dev, dt, (m,)))
    outs = {}
    for k, dt in _state_keys(fl):
        if k not in states:
            raise KeyError(f"tier: feat needs states[{k!r}]")
        setattr(a, k + "_0", _check(k, states[k], dev, dt, (m,)))
        outs[k] = torch.empty(m, dtype=dt, device=dev)
        setattr(a, k + "_e", outs[k].data_ptr())
    if out is None:
        out = torch.empty((n, m), dtype=F32, device=dev)
    else:
        _strided("out", out, dev, n)
        if out.shape[1] != m:
            raise ValueError(f"tier: out has {out.shape[1]} lanes, needs {m}")
    a.out_stride = out.stride(0)
    outs["cnt"] = torch.empty(m, dtype=I32, device=dev)
    a.out, a.cnt_e = out.data_ptr(), outs["cnt"].data_ptr()
    if mixw is not None:
        a.has_mix = 1
        a.wl = _check("wl", mixw[0], dev, F32, (m,))
        a.wr = _check("wr", mixw[1], dev, F32, (m,))
        if acc is None:
            acc = (torch.empty((n, a.b), dtype=F32, device=dev),
                   torch.empty((n, a.b), dtype=F32, device=dev))
        else:
            a.acc_add = 1
        a.acc_l = _check("acc_l", acc[0], dev, F32, (n, a.b))
        a.acc_r = _check("acc_r", acc[1], dev, F32, (n, a.b))
        outs["acc_l"], outs["acc_r"] = acc
        outs["out_last"] = torch.empty(m, dtype=F32, device=dev)
        a.out_last = outs["out_last"].data_ptr()
    elif acc is not None:
        raise ValueError("tier: acc without mixw")
    return a, out, outs


def _strided(name, x, dev, n):
    """``x`` is an [n, *] f32 tensor on ``dev`` with unit stride along
    its lanes (its rows may be a wider buffer's): raise otherwise."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"tier: {name} must be a tensor")
    if x.device != dev:
        raise ValueError(f"tier: {name} on {x.device}, needs {dev}")
    if x.dtype != F32:
        raise TypeError(f"tier: {name} is {x.dtype}, needs {F32}")
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"tier: {name} has shape {tuple(x.shape)}, "
                         f"needs [{n}, lanes]")
    if x.shape[1] > 1 and x.stride(1) != 1 \
            or n > 1 and x.stride(0) < x.shape[1]:
        raise ValueError(f"tier: {name} needs unit stride along lanes")


def tier_phases(feat, mix=False) -> tuple:
    """The ``MEGA_PHASES`` a keyed build of ``feat`` compiles in, those a
    stub can take out: the walk, the warp and clip, the lookup and phase
    4 always; the gain precompute with an envelope or an am stream that
    no lane self-reads; the mix with ``mix``."""
    fl = _flags(feat)
    gain = fl["env"] or (fl["am"] and not fl["am_self"])
    return tuple(p for p in MEGA_PHASES
                 if (p != "gain" or gain) and (p != "mix" or mix))


@functools.lru_cache(maxsize=None)
def tier_key(feat, exact=True, mix=False, folded=(), ablate=MEGA_ABLATE):
    """The build key (``-D`` defines) of ``csrc/tier.cu``: one library
    per (feature tuple, arithmetic mode, mix, folded streams), as the JAX
    package compiles one kernel per feature tuple.  Deterministic; the CZ
    mode mask counts only where CZ is on, and a folded stream only where
    the feature set has it.  ``ablate`` (default ``MEGA_ABLATE``; a comma
    string or a frozenset): the phases to stub, one
    ``TIER_ABLATE_<PHASE>=1`` define each, in ``MEGA_PHASES`` order, for
    those the build compiles in (``tier_phases``); none for the empty
    set."""
    fl = _flags(feat)
    folded = _folded(fl, Fold(None, None, 0, tuple(folded)))
    mask = sum(1 << k for k in fl["cz_modes"] if 1 <= k <= 7) \
        if fl["cz"] else 0
    key = ((f"TIER_EXACT={int(bool(exact))}", f"TIER_CZ_MASK={mask}",
            f"TIER_TS_POW2={int(fl['ts_pow2'])}", f"TIER_MIX={int(bool(mix))}")
           + tuple(f"TIER_FOLD_{k.upper()}={int(k in folded)}"
                   for k in ("fm", "cz", "am"))
           + tuple(f"TIER_HAS_{k.upper()}={int(fl[k])}"
                   for k in _FEAT_NAMES))
    if not ablate:
        return key
    ablate = cuda_call.ablate_set(ablate, MEGA_PHASES, "tier")
    return key + tuple(f"TIER_ABLATE_{p.upper()}=1"
                       for p in tier_phases(feat, mix) if p in ablate)


def tier_keyed(args, key, dev):
    """Launch the kernel built under ``key`` (built at first use if it
    was not built before; a failed build raises)."""
    cuda_call.launch("tier", args, dev, key, "tier_keyed_launch")
    tier_keyed.launches += 1


def tier(table, cbase, inc, dm, amod, vecs, states, *, feat, exact=True,
         n, b=None, mixw=None, acc=None, fold=None, out=None):
    """One tier pass over one block (see the module docstring).

    table: [R] f32 packed table buffer; cbase: int, the 1-based global
    sample count of the block's first sample (envelope); inc: [N, M] raw
    fm-read stream when feat.fm else [M] constant increment; dm: [N, M]
    raw cz-read stream (czm), [M] constant offset (cz only) or None;
    amod: [N, M] raw am-read stream or None; vecs/states: dicts of [M]
    per-lane vectors.  The kernel reads base_off + [0, clip_i] of the
    table unchecked: the caller keeps those inside it (the fused
    renderer checks every lane once per render, on the host).

    b: batch rows (lane = voice*b + row), needed by the mix and the fold.
    mixw: (wl, wr) [M] f32 stereo weights: the result gains ``acc_l``,
    ``acc_r`` [N, b] and ``out_last`` [M].  acc: the earlier tiers'
    (acc_l, acc_r), which this tier's sums are added onto in place.
    fold: a ``Fold``; a stream it names (and feat has) is read from the
    bank, its argument here ignored (pass None), and vecs carries its
    ``*_src`` / ``*_del`` vectors.  out: an [N, M] view to write the
    samples into, e.g. the tier's columns of a block buffer that is the
    bank of later tiers; it must not overlap the bank's read columns.
    A nonempty ``MEGA_ABLATE`` stubs the kernel's phases (timing only);
    the plain version refuses it.

    Returns (out [N, M], end-state dict incl. cnt)."""
    with spans.span("kernel.tier"):
        kw = dict(feat=feat, exact=exact, n=n, b=b, mixw=mixw, acc=acc,
                  fold=fold, out=out)
        if MEGA_ABLATE and table.device.type == "cpu":
            raise ValueError(
                f"tier: ablation {sorted(MEGA_ABLATE)} stubs phases of the "
                f"kernel only; the plain version (a CPU tensor) has no stubs")
        if table.device.type == "cpu":
            return tier_plain(table, cbase, inc, dm, amod, vecs, states, **kw)
        if table.device.type != "cuda":
            raise ValueError(f"tier: no kernel for device {table.device}")
        args, out, outs = _pack_args(table, cbase, inc, dm, amod, vecs, states,
                                     **kw)
        folded = _folded(_flags(feat), fold)
        tier_keyed(args, tier_key(feat, exact, mixw is not None, folded,
                                  MEGA_ABLATE), table.device)
        tier.launches += 1
        return out, outs


tier.launches = 0
tier_keyed.launches = 0
