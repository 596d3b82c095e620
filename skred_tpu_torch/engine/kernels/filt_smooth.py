"""The filter/smoother kernel: a noise-voice tier's serial output stages.

``filt_smooth_plain`` is the port of ``skred_tpu.engine.kernels.
filt_smooth_pallas`` in torch ops: per lane, over one block, the sample &
hold, the bit quantizer, the biquad, the gain amp·env·amod (am-self
lanes take their own filtered sample), the amp smoother and the dead
mask (synth.c:560-592), with the end states.  Layout: time-major ``[N,
M]`` streams, ``[M]`` per-lane vectors, the JAX function's argument
order.  ``feat`` is the JAX kernel's FsFeat tuple (flt, sm, hold, quant,
am_self, env, am, alive_arr): stages that are off are skipped and their
end states pass through unchanged.

``filt_smooth_noise`` is the noise pass's last stage with its glue: the
noise stream selected in for the noise voices, the alive mask from each
lane's alive count, the envelope × velocity, the am stream read from the
bank of earlier tiers, then the serial stages above.  A CPU tensor runs
``filt_smooth_noise_plain``, the composition of the glue's torch ops and
``filt_smooth_plain`` in the noise pass's order; a CUDA tensor launches
``csrc/filt_smooth.cu``, built once per ``filt_smooth_key`` with the
stages compiled in.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from skred_tpu_torch import spans
from skred_tpu_torch.engine.kernels import cuda_call
from skred_tpu_torch.engine.kernels.tier import bank_args, bank_read
from skred_tpu_torch.engine.numerics import div32, fma32, kfma

F32 = torch.float32
I32 = torch.int32

def filt_smooth_plain(x, env, amod, alive, b0, b1, b2, na1, na2, use_flt,
                      use_sm, amp, smoothing, am_self, am_depth, hold_on,
                      hold_max, quant_on, levels, inv_levels, x1, x2, y1, y2,
                      sg, hc, hv, *, feat):
    """``filt_smooth_pallas``'s arithmetic in torch ops, a loop over
    samples.  Returns (samples [N, M], x1, x2, y1, y2, sg, hold_count,
    hold_val)."""
    flt, sm, hold, quant, am_self_f, env_a, am_a, alive_a = feat
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
        amod_t = amod[t] if am_a else 1.0
        if am_self_f:
            amod_t = torch.where(am_self, s3 * am_depth, amod_t)
        final_t = amp * env[t] if env_a else amp
        final_t = final_t * amod_t
        if sm:
            sg2 = kfma(smoothing, final_t - sg, sg)
            final2 = torch.where(use_sm, sg2, final_t)
            sg = torch.where(alive_t & use_sm, sg2, sg)
        else:
            final2 = final_t
        out[t] = torch.where(alive_t, s3 * final2, 0.0)
    return out, x1, x2, y1, y2, sg, hc, hv


# the per-lane vectors and end states of the serial stages, by stage
_NOISE_VECS = {"env": (("use_env", I32), ("env_active", I32),
                       ("env_start", I32), ("env_rel_at", I32), ("att", F32),
                       ("dec", F32), ("sus", F32), ("rel", F32),
                       ("vel", F32)),
               "am": (("am_ge0", I32), ("am_depth_a", F32), ("am_src", I32),
                      ("am_del", I32)),
               "flt": (("b0", F32), ("b1", F32), ("b2", F32), ("na1", F32),
                       ("na2", F32), ("use_flt", I32)),
               "sm": (("use_sm", I32), ("smoothing", F32)),
               "am_self": (("am_self", I32), ("am_depth", F32)),
               "hold": (("hold_on", I32), ("hold_max", I32)),
               "quant": (("quant_on", I32), ("levels", F32),
                         ("inv_levels", F32))}
_NOISE_STATES = {"flt": (("x1", F32), ("x2", F32), ("y1", F32),
                         ("y2", F32)),
                 "sm": (("smoother", F32),),
                 "hold": (("hold_count", I32), ("hold_val", F32))}
_END_NAMES = ("x1", "x2", "y1", "y2", "smoother", "hold_count", "hold_val")
_FS_ARG_VECS = ("b0", "b1", "b2", "na1", "na2", "use_flt", "use_sm", "amp",
                "smoothing", "am_self", "am_depth", "hold_on", "hold_max",
                "quant_on", "levels", "inv_levels")


def noise_select(f, noise_blk, is_noise, cnt, n, finish=True):
    """The lookup's samples with the block's noise stream on the noise
    lanes and 0.0 where a lane is dead (sample t of a lane lives while t
    < its alive count).  Returns (samples [N, M], alive: [N, M] i32 with
    finish, else [M] i32, as ``filt_smooth`` takes it)."""
    f = torch.where(is_noise != 0, noise_blk[:, None], f)
    if finish:
        alive = torch.arange(n, dtype=I32, device=f.device)[:, None] \
            < cnt[None]
    else:
        alive = cnt != 0
    return torch.where(alive, f, 0.0), alive.to(I32)


def envelope_block(counts, v):
    """Closed-form ADSR over a block (synth.c:398-431), the JAX package's
    ``_envelope_block``: counts [N, 1] i32 global 1-based sample counts,
    ``v`` the [M] lane vectors → [N, M]."""
    t = (counts - v["env_start"]).to(F32)
    tr = (counts - v["env_rel_at"]).to(F32)
    att, dec, sus, rel = v["att"], v["dec"], v["sus"], v["rel"]
    e = torch.where(
        t < att, div32(t, att),
        torch.where(t < att + dec,
                    fma32(-div32(t - att, dec), 1.0 - sus, 1.0),
                    torch.where(v["env_rel_at"] == 0, sus,
                                torch.where(tr < rel,
                                            sus * (1.0 - div32(tr, rel)),
                                            0.0))))
    return torch.where(v["env_active"] != 0, e, 0.0)


def env_stream(cbase, v, n):
    """[N, M] the envelope × velocity of lanes that use one, else 1.0;
    ``cbase`` is the block's first 1-based global sample count."""
    counts = cbase + torch.arange(n, dtype=I32,
                                  device=v["vel"].device)[:, None]
    return torch.where(v["use_env"] != 0, envelope_block(counts, v)
                       * v["vel"], 1.0)


def am_stream(read, v):
    """[N, M] the amp-mod factor from the raw am read: read·depth where
    the lane has an am edge, else 1.0."""
    return torch.where(v["am_ge0"] != 0, read * v["am_depth_a"], 1.0)


def end_states(res, feat):
    """The end-state dict of the stages ``feat`` runs, by the tier
    kernel's names, from ``filt_smooth``'s result tuple."""
    flt, sm, hold = feat[:3]
    used = (flt,) * 4 + (sm,) + (hold,) * 2
    return {k: x for k, x, on in zip(_END_NAMES, res[1:], used) if on}


def filt_smooth_noise_plain(f, noise_blk, cnt, cbase, bank, vecs, states, *,
                            feat, b, out=None):
    """The kernel's function in torch ops: the noise select and the
    dead mask, the envelope, the am read and stream, then
    ``filt_smooth_plain``, in the noise pass's order.  Takes and returns
    what ``filt_smooth_noise`` does."""
    flt, sm, hold, quant, am_self, env_a, am_a, finish = feat
    v = vecs
    n = f.shape[0]
    f, alive = noise_select(f, noise_blk, v["is_noise"], cnt, n, finish)
    env = env_stream(cbase, v, n) if env_a else None
    amod = am_stream(bank_read(bank, v["am_src"], v["am_del"], n, b), v) \
        if am_a else None
    st = lambda k, used: states[k] if used else None
    res = filt_smooth_plain(
        f, env, amod, alive, *(v.get(k) for k in _FS_ARG_VECS),
        st("x1", flt), st("x2", flt), st("y1", flt), st("y2", flt),
        st("smoother", sm), st("hold_count", hold), st("hold_val", hold),
        feat=feat)
    if out is None:
        out = res[0]
    else:
        out.copy_(res[0])
    return out, end_states(res, feat)


def _fs_flags(feat):
    """The flags a build depends on (``finish`` changes nothing in the
    kernel: a lane's alive count covers both)."""
    flt, sm, hold, quant, am_self, env_a, am_a, _ = (bool(x) for x in feat)
    return dict(flt=flt, sm=sm, hold=hold, quant=quant, am_self=am_self,
                env=env_a, am=am_a)


@functools.lru_cache(maxsize=None)
def filt_smooth_key(feat):
    """The kernel's build key (``-D`` defines): one library per stage
    set."""
    return tuple(f"FS_{k.upper()}={int(v)}"
                 for k, v in _fs_flags(feat).items())


_FN_INTS = ("n", "m", "b", "bank_w", "bank_stride", "out_stride", "cbase",
            "has_flt", "has_sm", "has_hold", "has_quant", "has_am_self",
            "has_env", "has_am")
_FN_PTRS = ("f", "noise", "is_noise", "cnt", "bank", "prev", "amp",
            "use_env", "env_active", "env_start", "env_rel_at", "att", "dec",
            "sus", "rel", "vel", "am_ge0", "am_depth_a", "am_src", "am_del",
            "b0", "b1", "b2", "na1", "na2", "use_flt", "use_sm", "smoothing",
            "am_self", "am_depth", "hold_on", "hold_max", "quant_on",
            "levels", "inv_levels", "x1_0", "x2_0", "y1_0", "y2_0",
            "smoother_0", "hold_count_0", "hold_val_0", "out", "x1_e",
            "x2_e", "y1_e", "y2_e", "smoother_e", "hold_count_e",
            "hold_val_e")


class FiltNoiseArgs(ctypes.Structure):
    """Mirrors csrc/filt_smooth.cu's FiltNoiseArgs."""
    _fields_ = ([(k, ctypes.c_int) for k in _FN_INTS]
                + [(k, ctypes.c_void_p) for k in _FN_PTRS])


def fn_vec_keys(fl):
    """The [M] per-lane vectors the kernel reads under build flags
    ``fl`` (``_fs_flags``): (key, dtype)."""
    keys = [("is_noise", I32), ("amp", F32)]
    for stage in ("env", "am", "flt", "sm", "am_self", "hold", "quant"):
        if fl[stage]:
            keys += _NOISE_VECS[stage]
    return keys


def _fn_pack(f, noise_blk, cnt, cbase, bank, vecs, states, feat, b, out):
    """Check the CUDA tensors and fill the argument struct.  Returns
    (FiltNoiseArgs, out, end-state dict)."""
    fl = _fs_flags(feat)
    dev = f.device
    n, m = f.shape
    chk = lambda name, x, dt, shape: cuda_call.check(
        "filt_smooth_noise", name, x, dev, dt, shape)
    a = FiltNoiseArgs(n=n, m=m, cbase=int(cbase))
    for k in ("flt", "sm", "hold", "quant", "am_self", "env", "am"):
        setattr(a, "has_" + k, int(fl[k]))
    bank_args(a, "filt_smooth_noise", bank if fl["am"] else None, dev, n,
               b, m)
    a.f = chk("f", f, F32, (n, m))
    a.noise = chk("noise_blk", noise_blk, F32, (n,))
    a.cnt = chk("cnt", cnt, I32, (m,))
    for k, dt in fn_vec_keys(fl):
        if k not in vecs:
            raise KeyError(f"filt_smooth_noise: feat needs vecs[{k!r}]")
        setattr(a, k, chk(k, vecs[k], dt, (m,)))
    ends = {}
    for stage, skeys in _NOISE_STATES.items():
        if fl[stage]:
            for k, dt in skeys:
                if k not in states:
                    raise KeyError(f"filt_smooth_noise: feat needs "
                                   f"states[{k!r}]")
                setattr(a, k + "_0", chk(k, states[k], dt, (m,)))
                ends[k] = torch.empty(m, dtype=dt, device=dev)
                setattr(a, k + "_e", ends[k].data_ptr())
    if out is None:
        out = torch.empty((n, m), dtype=F32, device=dev)
    elif out.device != dev or out.dtype != F32 or out.dim() != 2 \
            or tuple(out.shape) != (n, m) or out.stride(1) != 1:
        raise ValueError(f"filt_smooth_noise: out must be an [{n}, {m}] f32 "
                         f"view on {dev} with unit stride along lanes")
    a.out, a.out_stride = out.data_ptr(), out.stride(0)
    return a, out, ends


def filt_smooth_noise(f, noise_blk, cnt, cbase, bank, vecs, states, *, feat,
                      b, out=None):
    """One block of a noise tier's serial stages with their glue, over M
    lanes (lane ``v*b + row``).

    f: [N, M] f32 the lookup's samples; noise_blk: [N] f32 the block's
    noise stream; cnt: [M] i32 each lane's alive count
    (``phase_walk_warp``); cbase: the block's first 1-based global sample
    count (envelope); bank: a ``tier.Fold`` or None, from which the am
    stream is read per lane (``am_src``/``am_del``); vecs: [M] per-lane
    vectors (``is_noise`` i32, ``amp`` and the stages'); states: [M] start
    states by the tier kernel's names (x1, x2, y1, y2, smoother,
    hold_count, hold_val).  feat: (flt, sm, hold, quant, am_self, env,
    am, finish).  out: an [N, M] view to write into (e.g. the tier's
    columns of the block buffer).  Returns (out, end-state dict)."""
    with spans.span("kernel.filt_smooth"):
        dev = f.device
        if dev.type == "cpu":
            return filt_smooth_noise_plain(f, noise_blk, cnt, cbase, bank,
                                           vecs, states, feat=feat, b=b,
                                           out=out)
        if dev.type != "cuda":
            raise ValueError(f"filt_smooth_noise: no kernel for device {dev}")
        args, out, ends = _fn_pack(f, noise_blk, cnt, cbase, bank, vecs,
                                   states, feat, b, out)
        cuda_call.launch("filt_smooth", args, dev, filt_smooth_key(feat),
                         "filt_smooth_keyed_launch")
        filt_smooth_noise.launches += 1
        return out, ends


filt_smooth_noise.launches = 0
