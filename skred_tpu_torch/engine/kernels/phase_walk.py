"""The phase-walk kernel: a noise-voice tier's serial oscillator phases.

``phase_walk`` is the port of ``skred_tpu.engine.kernels.
phase_walk_pallas``: per lane, N steps of the reference's osc_next
(synth.c:217-258) with the single-fmod wrap of both directions, one-shot
voices pinned at their ends and, when ``finish`` is set, the per-sample
dead mask and the end finished flag.  Layout: time-major ``[N, M]``
streams, ``[M]`` per-lane vectors.  A CPU tensor runs
``phase_walk_plain``, the same arithmetic in torch ops; a CUDA tensor
launches ``csrc/phase_walk.cu`` or raises.
"""

from __future__ import annotations

import ctypes

import torch

from skred_tpu_torch.engine.kernels import cuda_call
from skred_tpu_torch.engine.numerics import f32

F32 = torch.float32
I32 = torch.int32


def phase_walk_plain(inc, phase0, fin0, lo, hi, L, osn, one_shot, adv, act,
                     *, fm=True, finish=True, n):
    """The kernel's arithmetic in torch ops, a loop over samples.
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


class PhaseWalkArgs(ctypes.Structure):
    """Mirrors csrc/phase_walk.cu's PhaseWalkArgs."""
    _fields_ = ([(k, ctypes.c_int) for k in ("n", "m", "has_fm",
                                             "has_finish")]
                + [(k, ctypes.c_void_p) for k in (
                    "inc", "phase_0", "finished_0", "lo", "hi", "L", "osn",
                    "one_shot", "adv", "act", "ph", "dead", "phase_e",
                    "finished_e")])


def _pack_args(inc, phase0, fin0, lo, hi, L, osn, one_shot, adv, act, fm,
               finish, n):
    """Check the CUDA tensors and fill the argument struct.  Returns
    (PhaseWalkArgs, (ph, dead, phase_end, fin_end))."""
    dev = phase0.device
    m = phase0.shape[0]
    chk = lambda name, x, dt, shape: cuda_call.check("phase_walk", name, x,
                                                     dev, dt, shape)
    a = PhaseWalkArgs(n=n, m=m, has_fm=int(bool(fm)),
                      has_finish=int(bool(finish)))
    a.inc = chk("inc", inc, F32, (n, m) if fm else (m,))
    a.phase_0 = chk("phase0", phase0, F32, (m,))
    a.lo, a.hi, a.L = (chk(k, x, F32, (m,))
                       for k, x in (("lo", lo), ("hi", hi), ("L", L)))
    a.adv = chk("adv", adv, I32, (m,))
    ph = torch.empty((n, m), dtype=F32, device=dev)
    ph_e = torch.empty(m, dtype=F32, device=dev)
    a.ph, a.phase_e = ph.data_ptr(), ph_e.data_ptr()
    dead = fin_e = None
    if finish:
        a.finished_0 = chk("fin0", fin0, I32, (m,))
        a.osn, a.one_shot, a.act = (
            chk(k, x, I32, (m,))
            for k, x in (("osn", osn), ("one_shot", one_shot), ("act", act)))
        dead = torch.empty((n, m), dtype=I32, device=dev)
        fin_e = torch.empty(m, dtype=I32, device=dev)
        a.dead, a.finished_e = dead.data_ptr(), fin_e.data_ptr()
    return a, (ph, dead, ph_e, fin_e)


def phase_walk(inc, phase0, fin0, lo, hi, L, osn, one_shot, adv, act, *,
               fm=True, finish=True, n):
    """One block's phase walk over M lanes.

    inc: [N, M] per-sample increments when ``fm``, else [M] (constant in
    the block); phase0, lo, hi, L: [M] f32; fin0, osn, one_shot, act: [M]
    i32 (read only with ``finish``); adv: [M] i32, the lanes whose phase
    steps.  Returns ``(ph [N, M], dead [N, M] i32 or None, phase_end [M],
    fin_end [M] or None)``, as ``phase_walk_pallas``."""
    dev = phase0.device
    if dev.type == "cpu":
        return phase_walk_plain(inc, phase0, fin0, lo, hi, L, osn, one_shot,
                                adv, act, fm=fm, finish=finish, n=n)
    if dev.type != "cuda":
        raise ValueError(f"phase_walk: no kernel for device {dev}")
    args, outs = _pack_args(inc, phase0, fin0, lo, hi, L, osn, one_shot,
                            adv, act, fm, finish, n)
    cuda_call.launch("phase_walk", args, dev)
    phase_walk.launches += 1
    return outs


phase_walk.launches = 0
