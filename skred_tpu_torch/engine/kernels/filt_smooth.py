"""The filter/smoother kernel: a noise-voice tier's serial output stages.

``filt_smooth`` is the port of ``skred_tpu.engine.kernels.
filt_smooth_pallas``: per lane, over one block, the sample & hold, the
bit quantizer, the biquad, the gain amp·env·amod (am-self lanes take
their own filtered sample), the amp smoother and the dead mask
(synth.c:560-592), with the end states.  Layout: time-major ``[N, M]``
streams, ``[M]`` per-lane vectors, the JAX function's argument order.

``feat`` is the JAX kernel's FsFeat tuple (flt, sm, hold, quant,
am_self, env, am, alive_arr): stages that are off are skipped and their
end states pass through unchanged.  A CPU tensor runs
``filt_smooth_plain``; a CUDA tensor launches ``csrc/filt_smooth.cu`` or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from skred_tpu_torch.engine.kernels import cuda_call
from skred_tpu_torch.engine.numerics import kfma

F32 = torch.float32
I32 = torch.int32

_FS_NAMES = ("flt", "sm", "hold", "quant", "am_self", "env", "am",
             "alive_arr")


def filt_smooth_plain(x, env, amod, alive, b0, b1, b2, na1, na2, use_flt,
                      use_sm, amp, smoothing, am_self, am_depth, hold_on,
                      hold_max, quant_on, levels, inv_levels, x1, x2, y1, y2,
                      sg, hc, hv, *, exact=True, feat):
    """The kernel's arithmetic in torch ops, a loop over samples.
    Returns (samples [N, M], x1, x2, y1, y2, sg, hold_count, hold_val)."""
    flt, sm, hold, quant, am_self_f, env_a, am_a, alive_a = feat
    fma = kfma if exact else (lambda a, b, c: a * b + c)
    n, m = x.shape
    out = torch.empty((n, m), dtype=F32, device=x.device)
    if flt:
        use_flt = use_flt != 0
    if sm:
        use_sm = use_sm != 0
    if am_self_f:
        am_self = am_self != 0
    if hold:
        hold_on = hold_on != 0
    if quant:
        quant_on = quant_on != 0
    alive_row = None if alive_a else alive != 0
    for t in range(n):
        f_t = x[t]
        alive_t = alive[t] != 0 if alive_a else alive_row
        if hold:
            hv2 = torch.where(hold_on & (hc == 0), f_t, hv)
            s1 = torch.where(hold_on, hv2, f_t)
            hcn = hc + 1
            hcn = torch.where(hcn >= hold_max, 0, hcn)
            hv = torch.where(alive_t, hv2, hv)
            hc = torch.where(alive_t & hold_on, hcn, hc).to(I32)
        else:
            s1 = f_t
        if quant:
            iv = kfma(s1, levels, 0.5).to(I32).to(F32)
            x_t = torch.where(quant_on, iv * inv_levels, s1)
        else:
            x_t = s1
        if flt:
            fv = b1 * x1
            fv = fma(b0, x_t, fv)
            fv = fma(b2, x2, fv)
            fv = fma(na1, y1, fv)
            fv = fma(na2, y2, fv)
            s3 = torch.where(use_flt, fv, x_t)
            upd = alive_t & use_flt
            x1, x2, y1, y2 = (torch.where(upd, x_t, x1),
                              torch.where(upd, x1, x2),
                              torch.where(upd, fv, y1),
                              torch.where(upd, y1, y2))
        else:
            s3 = x_t
        amod_t = amod[t] if am_a else 1.0
        if am_self_f:
            amod_t = torch.where(am_self, s3 * am_depth, amod_t)
        final_t = amp * env[t] if env_a else amp
        final_t = final_t * amod_t
        if sm:
            sg2 = fma(smoothing, final_t - sg, sg)
            final2 = torch.where(use_sm, sg2, final_t)
            sg = torch.where(alive_t & use_sm, sg2, sg)
        else:
            final2 = final_t
        out[t] = torch.where(alive_t, s3 * final2, 0.0)
    return out, x1, x2, y1, y2, sg, hc, hv


class FiltSmoothArgs(ctypes.Structure):
    """Mirrors csrc/filt_smooth.cu's FiltSmoothArgs."""
    _fields_ = ([(k, ctypes.c_int) for k in
                 ("n", "m", "exact")
                 + tuple("has_" + k for k in _FS_NAMES[:-1])
                 + ("alive_arr",)]
                + [(k, ctypes.c_void_p) for k in (
                    "x", "alive", "env", "amod", "amp",
                    "b0", "b1", "b2", "na1", "na2", "use_flt",
                    "use_sm", "smoothing", "am_self", "am_depth",
                    "hold_on", "hold_max", "quant_on", "levels",
                    "inv_levels",
                    "x1_0", "x2_0", "y1_0", "y2_0", "sg_0", "hc_0", "hv_0",
                    "out", "x1_e", "x2_e", "y1_e", "y2_e", "sg_e", "hc_e",
                    "hv_e")])


# per-lane inputs by stage: (struct field, dtype)
_VECS = {"flt": (("b0", F32), ("b1", F32), ("b2", F32), ("na1", F32),
                 ("na2", F32), ("use_flt", I32)),
         "sm": (("use_sm", I32), ("smoothing", F32)),
         "am_self": (("am_self", I32), ("am_depth", F32)),
         "hold": (("hold_on", I32), ("hold_max", I32)),
         "quant": (("quant_on", I32), ("levels", F32), ("inv_levels", F32))}
# end states by stage: (struct field stem, dtype, position in the result)
_STATES = {"flt": (("x1", F32, 1), ("x2", F32, 2), ("y1", F32, 3),
                   ("y2", F32, 4)),
           "sm": (("sg", F32, 5),),
           "hold": (("hc", I32, 6), ("hv", F32, 7))}


_ARG_NAMES = ("x", "env", "amod", "alive", "b0", "b1", "b2", "na1", "na2",
              "use_flt", "use_sm", "amp", "smoothing", "am_self", "am_depth",
              "hold_on", "hold_max", "quant_on", "levels", "inv_levels",
              "x1_0", "x2_0", "y1_0", "y2_0", "sg_0", "hc_0", "hv_0")


def _pack_args(args, exact, feat):
    """Check the CUDA tensors (``args`` in ``filt_smooth``'s order) and
    fill the argument struct.  Returns (FiltSmoothArgs, result tuple)."""
    fl = dict(zip(_FS_NAMES, (bool(f) for f in feat)))
    named = dict(zip(_ARG_NAMES, args))
    x = named["x"]
    dev = x.device
    n, m = x.shape
    chk = lambda k, dt, shape: cuda_call.check("filt_smooth", k, named[k],
                                               dev, dt, shape)
    a = FiltSmoothArgs(n=n, m=m, exact=int(bool(exact)),
                       alive_arr=int(fl["alive_arr"]))
    for k in _FS_NAMES[:-1]:
        setattr(a, "has_" + k, int(fl[k]))
    a.x = chk("x", F32, (n, m))
    a.alive = chk("alive", I32, (n, m) if fl["alive_arr"] else (m,))
    if fl["env"]:
        a.env = chk("env", F32, (n, m))
    if fl["am"]:
        a.amod = chk("amod", F32, (n, m))
    a.amp = chk("amp", F32, (m,))
    res = [torch.empty((n, m), dtype=F32, device=dev)] + list(args[20:])
    a.out = res[0].data_ptr()
    for stage, keys in _VECS.items():
        if fl[stage]:
            for k, dt in keys:
                setattr(a, k, chk(k, dt, (m,)))
    for stage, keys in _STATES.items():
        if fl[stage]:
            for k, dt, pos in keys:
                setattr(a, k + "_0", chk(k + "_0", dt, (m,)))
                res[pos] = torch.empty(m, dtype=dt, device=dev)
                setattr(a, k + "_e", res[pos].data_ptr())
    return a, tuple(res)


def filt_smooth(x, env, amod, alive, b0, b1, b2, na1, na2, use_flt, use_sm,
                amp, smoothing, am_self, am_depth, hold_on, hold_max,
                quant_on, levels, inv_levels, x1, x2, y1, y2, sg, hc, hv, *,
                exact=True, feat):
    """One block of the serial output stages over M lanes.

    x: [N, M] f32 oscillator samples; env, amod: [N, M] f32 or None
    (constant 1); alive: [N, M] i32 when feat's alive_arr, else [M];
    the rest [M] (i32 flags and counts, f32 values).  Returns (samples
    [N, M], x1, x2, y1, y2, sg, hold_count, hold_val), as
    ``filt_smooth_pallas``."""
    args = (x, env, amod, alive, b0, b1, b2, na1, na2, use_flt, use_sm,
            amp, smoothing, am_self, am_depth, hold_on, hold_max, quant_on,
            levels, inv_levels, x1, x2, y1, y2, sg, hc, hv)
    dev = x.device
    if dev.type == "cpu":
        return filt_smooth_plain(*args, exact=exact, feat=feat)
    if dev.type != "cuda":
        raise ValueError(f"filt_smooth: no kernel for device {dev}")
    a, res = _pack_args(args, exact, feat)
    cuda_call.launch("filt_smooth", a, dev)
    filt_smooth.launches += 1
    return res


filt_smooth.launches = 0
