"""The phase-walk kernel: a noise-voice tier's serial oscillator phases.

``phase_walk_plain`` is the port of ``skred_tpu.engine.kernels.
phase_walk_pallas`` in torch ops: per lane, N steps of the reference's
osc_next (synth.c:217-258) with the single-fmod wrap of both directions,
one-shot voices pinned at their ends and, when ``finish`` is set, the
per-sample dead mask and the end finished flag.  Layout: time-major
``[N, M]`` streams, ``[M]`` per-lane vectors.

``phase_walk_warp`` is the noise pass's first stage with its glue: the
modulator reads from the bank of earlier tiers, the FM increment, the
walk, the CZ warp and the index clip, giving the int32 table index the
lookup takes and each lane's alive count.  A CPU tensor runs
``phase_walk_warp_plain``, the composition of the glue's torch ops and
``phase_walk_plain`` in the noise pass's order; a CUDA tensor launches
``csrc/phase_walk.cu``, built once per ``phase_walk_key`` with the
stages compiled in.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from skred_tpu_torch import spans
from skred_tpu_torch.engine.kernels import cuda_call
from skred_tpu_torch.engine.kernels.tier import bank_args, bank_read
from skred_tpu_torch.engine.numerics import cz_phasor, f32, fma32

F32 = torch.float32
I32 = torch.int32


def phase_walk_plain(inc, phase0, fin0, lo, hi, L, osn, one_shot, adv, act,
                     *, fm=True, finish=True, n):
    """``phase_walk_pallas``'s walk in torch ops, a loop over samples.
    Returns ``(ph [N, M] f32, dead [N, M] i32 or None, phase_end [M],
    fin_end [M] or None)``."""
    m = phase0.shape[0]
    dev = phase0.device
    adv = adv != 0
    if finish:
        osn, one_shot, act = osn != 0, one_shot != 0, act != 0
        fin_c = fin0
        dead = torch.empty((n, m), dtype=I32, device=dev)
    ph_c = phase0
    ph_s = torch.empty((n, m), dtype=F32, device=dev)
    hi_os = hi - f32(1e-6)
    for t in range(n):
        ph = ph_c + (inc[t] if fm else inc)
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
            dead[t] = (fin_b | ~act).to(I32)
            ph_c = torch.where(step_on, ph2, ph_c)
            fin_c = torch.where(step_on & fin_new, 1, fin_c).to(I32)
        else:
            ph_c = torch.where(adv, ph2, ph_c)
    if finish:
        return ph_s, dead, ph_c, fin_c
    return ph_s, None, ph_c, None


# PwFeat: (fm, finish, direction, cz, czm, cz_modes, ts_pow2), a noise
# tier's flags as ``fused.Feat`` names them

def fm_increment(read, v, direction=False):
    """[N, M] increments from the raw fm read stream: mis·(read·depth) +
    pinc where the lane is FM-modulated (``fma32``, in the engine's exact
    and fast mode alike: csrc/tier.cu), pinc elsewhere, negated on
    reversed lanes."""
    g = read * v["fm_depth"]
    inc = torch.where(v["use_fm"] != 0, fma32(v["mis"], g, v["pinc"]),
                      v["pinc"])
    if direction:
        inc = torch.where(v["dirneg"] != 0, -inc, inc)
    return inc


def cz_offset(read, v):
    """[N, M] the CZ distortion's modulator term from the raw cz read:
    read·depth where the lane has a cz-mod edge, else 1.0."""
    return torch.where(v["cm_ge0"] != 0, read * v["cz_depth"], 1.0)


def cz_clip(ph, dm, v, cz=True, modes=(1, 2, 3, 4, 5, 6, 7)):
    """The clipped int32 table index of each phase: the CZ warp
    (``numerics.cz_phasor``) on lanes with a CZ mode, then [0, clip_i]."""
    if cz:
        cz_idx = cz_phasor(v["cz_mode"], ph, v["cz_dist"] + dm, v["tsize"],
                           modes=modes)
        idx_f = torch.where(v["cz_mode"] != 0, cz_idx, ph)
    else:
        idx_f = ph
    return torch.minimum(torch.clamp(idx_f.to(I32), min=0), v["clip_i"])


def alive_count(dead, act, n):
    """[M] i32 samples each lane is alive for: a lane's dead mask is
    monotone within a block (its finished flag only sets), so its live
    samples are a prefix.  Without finish (``dead`` None) a lane lives
    the whole block when it is active."""
    if dead is None:
        return torch.where(act != 0, n, 0).to(I32)
    return (dead == 0).sum(dim=0, dtype=I32)


def phase_walk_warp_plain(bank, vecs, phase0, fin0, *, feat, n, b):
    """The kernel's function in torch ops: the fm read, the FM
    increment, the walk (``phase_walk_plain``), the cz read, the CZ warp
    and the clip, the alive count, in the noise pass's order.  Takes and
    returns what ``phase_walk_warp`` does."""
    fm, finish, direction, cz, czm, modes, _ = feat
    v = vecs
    read = lambda s: bank_read(bank, v[s + "_src"], v[s + "_del"], n, b)
    if fm:
        inc = fm_increment(read("fm"), v, direction)
    else:
        inc = v["inc"]
    ph, dead, ph_end, fin_end = phase_walk_plain(
        inc, phase0, fin0 if finish else None, v["lo"], v["hi"], v["L"],
        v.get("osn"), v.get("one_shot"), v["adv"], v["act"], fm=fm,
        finish=finish, n=n)
    dm = None
    if cz:
        dm = cz_offset(read("cz"), v) if czm else v["dm"]
    idx = cz_clip(ph, dm, v, cz, modes)
    return idx, alive_count(dead, v["act"], n), ph_end, fin_end


def _pw_flags(feat):
    """The flags a build depends on: direction only with fm (a constant
    increment comes negated), czm, the mode mask and ts_pow2 only with
    cz.  The engine's arithmetic mode is not one: the kernel rounds the
    same in both."""
    fm, finish, direction, cz, czm, modes, ts_pow2 = feat
    cz = bool(cz)
    return dict(fm=bool(fm), finish=bool(finish),
                direction=bool(fm and direction), cz=cz, czm=cz and bool(czm),
                cz_mask=sum(1 << k for k in modes if 1 <= k <= 7) if cz
                else 0, ts_pow2=cz and bool(ts_pow2))


@functools.lru_cache(maxsize=None)
def phase_walk_key(feat):
    """The kernel's build key (``-D`` defines): one library per tier
    feature set."""
    return tuple(f"PW_{k.upper()}={int(v)}"
                 for k, v in _pw_flags(feat).items())


_PW_INTS = ("n", "m", "b", "bank_w", "bank_stride", "has_fm", "has_finish",
            "has_direction", "has_cz", "has_czm", "cz_mask", "ts_pow2")
_PW_PTRS = ("bank", "prev", "fm_src", "fm_del", "cz_src", "cz_del", "inc",
            "dm", "use_fm", "mis", "pinc", "fm_depth", "dirneg", "cm_ge0",
            "cz_depth", "cz_mode", "cz_dist", "tsize", "lo", "hi", "L",
            "clip_i", "osn", "one_shot", "adv", "act", "phase_0",
            "finished_0", "idx", "cnt", "phase_e", "finished_e")


class PhaseWarpArgs(ctypes.Structure):
    """Mirrors csrc/phase_walk.cu's PhaseWarpArgs."""
    _fields_ = ([(k, ctypes.c_int) for k in _PW_INTS]
                + [(k, ctypes.c_void_p) for k in _PW_PTRS])


def _pw_vec_keys(fl):
    keys = [("lo", F32), ("hi", F32), ("L", F32), ("clip_i", I32),
            ("adv", I32), ("act", I32)]
    if fl["finish"]:
        keys += [("osn", I32), ("one_shot", I32)]
    if fl["fm"]:
        keys += [("use_fm", I32), ("mis", F32), ("pinc", F32),
                 ("fm_depth", F32), ("fm_src", I32), ("fm_del", I32)]
        if fl["direction"]:
            keys.append(("dirneg", I32))
    else:
        keys.append(("inc", F32))
    if fl["cz"]:
        keys += [("cz_mode", I32), ("cz_dist", F32), ("tsize", F32)]
        if fl["czm"]:
            keys += [("cm_ge0", I32), ("cz_depth", F32), ("cz_src", I32),
                     ("cz_del", I32)]
        else:
            keys.append(("dm", F32))
    return keys


def _pw_pack(bank, vecs, phase0, fin0, feat, n, b):
    """Check the CUDA tensors and fill the argument struct.  Returns
    (PhaseWarpArgs, (idx, cnt, phase_end, fin_end))."""
    fl = _pw_flags(feat)
    dev = phase0.device
    m = phase0.shape[0]
    chk = lambda name, x, dt, shape: cuda_call.check("phase_walk_warp",
                                                     name, x, dev, dt, shape)
    a = PhaseWarpArgs(n=n, m=m, cz_mask=fl["cz_mask"],
                      ts_pow2=int(fl["ts_pow2"]))
    for k in ("fm", "finish", "direction", "cz", "czm"):
        setattr(a, "has_" + k, int(fl[k]))
    bank_args(a, "phase_walk_warp", bank, dev, n, b, m)
    for k, dt in _pw_vec_keys(fl):
        if k not in vecs:
            raise KeyError(f"phase_walk_warp: feat needs vecs[{k!r}]")
        setattr(a, k, chk(k, vecs[k], dt, (m,)))
    a.phase_0 = chk("phase0", phase0, F32, (m,))
    idx = torch.empty((n, m), dtype=I32, device=dev)
    cnt = torch.empty(m, dtype=I32, device=dev)
    ph_e = torch.empty(m, dtype=F32, device=dev)
    a.idx, a.cnt, a.phase_e = idx.data_ptr(), cnt.data_ptr(), ph_e.data_ptr()
    fin_e = None
    if fl["finish"]:
        a.finished_0 = chk("fin0", fin0, I32, (m,))
        fin_e = torch.empty(m, dtype=I32, device=dev)
        a.finished_e = fin_e.data_ptr()
    return a, (idx, cnt, ph_e, fin_e)


def phase_walk_warp(bank, vecs, phase0, fin0, *, feat, n, b):
    """One block of a noise tier's walk with its glue, over M lanes
    (lane ``v*b + row``).

    bank: a ``tier.Fold`` (its ``streams`` unused) holding the earlier
    tiers' samples, or None; the fm and cz reads take it per lane
    (``fm_src``/``fm_del``, ``cz_src``/``cz_del`` in ``vecs``) as
    ``tier.fold_read_plain`` does.  vecs: [M] per-lane vectors
    (``_pw_vec_keys``; ``inc`` is the constant increment without fm,
    ``dm`` the constant CZ offset without czm); phase0 [M] f32, fin0 [M]
    i32 (with finish).  feat: (fm, finish, direction, cz, czm, cz_modes,
    ts_pow2).  Returns (idx [N, M] i32, cnt [M] i32, phase_end [M],
    fin_end [M] or None)."""
    with spans.span("kernel.phase_walk"):
        dev = phase0.device
        if dev.type == "cpu":
            return phase_walk_warp_plain(bank, vecs, phase0, fin0, feat=feat,
                                         n=n, b=b)
        if dev.type != "cuda":
            raise ValueError(f"phase_walk_warp: no kernel for device {dev}")
        args, outs = _pw_pack(bank, vecs, phase0, fin0, feat, n, b)
        cuda_call.launch("phase_walk", args, dev, phase_walk_key(feat),
                         "phase_walk_keyed_launch")
        phase_walk_warp.launches += 1
        return outs


phase_walk_warp.launches = 0
