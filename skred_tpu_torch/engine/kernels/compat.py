"""The compat engine's kernel: blocks of the per-sample scan over 64 voices.

``compat_block`` is the port of the body of ``skred_tpu.engine.render.
_render_core`` (:375): for each block, the segment's parameters and, at a
segment's first block, its state writes (``_apply_ops`` :354); then for
each sample ``mod_passes`` fixed-point passes over all 64 voices
(``_voice_pass`` :203), the last of which commits the voices' state, the
master-volume smoother and the stereo sum (``_sample_step`` :331).  The
JAX package runs it as two nested ``lax.scan``s; it is not a Pallas
kernel.  In eager torch a sample costs hundreds of small operations, so
on the card the engine is one kernel (``csrc/compat.cu``) that keeps a
row's 64 voices on chip and walks the samples.

Layout (``CompatInputs``): per-voice parameters ``[B, S, fields, V]``
(f32 and i32), built once per render by ``pack_inputs`` from the
timeline's per-segment parameters, with every per-segment constant of
``_voice_pass`` computed there (loop bounds, the FM modulator's scaled
increment, the quantizer's levels, the flags); ``volume_final`` ``[B,
S]``; the segment ops ``[B, S, fields, V]``; the segment map and start
flags ``[B, NB]``; the flat table buffer; the noise stream ``[n*block]``
of the blocks rendered, one value per sample shared by every row.  The
carry is ``(cf [B, 10, V] f32, ci [B, 2, V] i32, vol_gain [B])``
(``CF``, ``CI``).

A CPU tensor runs ``compat_block_plain``, the same arithmetic in torch
ops; a CUDA tensor launches the kernel or raises.  Both return ``(carry,
out [B, n*block, 2], cap [B, n*block, V, 2] or None)``, and both sum the
64 voices in the same fixed tree (``voice_sum``), so the card's render
equals the CPU's bit for bit.  The JAX package's ``jnp.sum`` takes
another order, which tests hold to a stated tolerance.

The kernel is built once per key (``compat_key``: the pass count,
capture, and what the batch takes over every row and segment: the union
of the flag bits, the CZ curves, the modulator reads, power-of-two CZ
tables), at the key's first use, into ``build/kernels/``; the library
refuses arguments that need what its key lacks (``compat_key_ok``), and
the launch raises.  ``pack_inputs`` marks per segment the voices whose
estimate a higher voice reads (the ``read`` flag): only they run the
non-committing passes.

The measurement build (``_launch(..., stamps=)`` only; no render path
takes it) adds clock reads per stage of the sample step (``STAMPS``;
``tools/compat_stamps.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from skred_tpu_torch import config as C
from skred_tpu_torch import spans
from skred_tpu_torch.engine.kernels import cuda_call
from skred_tpu_torch.engine.numerics import div32, f2i, f32, fma32

F32 = torch.float32
I32 = torch.int32
V = C.VOICE_MAX

# per-voice f32 and i32 parameters, per segment (csrc/compat.cu's P_*)
PF = ("pinc", "mis", "fm_dep", "lo", "hi", "L", "hi_os", "tsize",
      "cz_dist", "cz_dep", "levels", "inv_lev", "b0", "b1", "b2", "na1",
      "na2", "att", "dec", "att_dec", "sus", "rel", "vel", "am_dep", "amp",
      "smoothing", "pm_dep")
PI = ("flags", "fm_osc", "cz_mode", "cm_osc", "clip_hi", "table_off",
      "hold_max", "env_start", "env_rel_at", "am_osc", "pm_osc")
# bits of PI "flags", in order (csrc/compat.cu's F_*)
FLAGS = ("use_fm", "dirneg", "osn", "one_shot", "is_noise", "hold_on",
         "quant", "use_flt", "use_env", "env_act", "no_rel", "use_sm",
         "disc", "read")
# "read": a higher voice reads this voice's estimate in this segment, so
# its non-committing passes run (the kernel's F_READ; no feature of the
# key).  The modulator reads a key compiles (csrc/compat.cu's M_*):
# "cz" a CZ voice reads a modulator, "czd" its d varies (a nonzero depth)
MODS = ("fm", "cz", "czd", "am", "pan")
READ = 1 << FLAGS.index("read")
KEY_FLAGS = READ - 1
# segment ops: f32 values, i32 flags / finished / copy source
OF = ("phase", "sample", "smoother", "pan_left", "pan_right")
OI = ("flags", "finished", "copy_hold_from")
SET_PHASE, SET_FINISHED, SET_SAMPLE, CLEAR_FILTER, SET_SMOOTHER, \
    SET_PAN = (1 << i for i in range(6))
_OP_BITS = (("set_phase", SET_PHASE), ("set_finished", SET_FINISHED),
            ("set_sample", SET_SAMPLE), ("clear_filter", CLEAR_FILTER),
            ("set_smoother", SET_SMOOTHER), ("set_pan", SET_PAN))
# the carry: f32 and i32 per-voice states
CF = ("phase", "sample", "hold_val", "x1", "x2", "y1", "y2", "smoother",
      "pan_l", "pan_r")
CI = ("finished", "hold_count")


@dataclasses.dataclass
class CompatInputs:
    """A batch's packed parameters on one device (see the module
    docstring); ``block`` samples a block."""
    pf: torch.Tensor        # [B, S, len(PF), V] f32
    pi: torch.Tensor        # [B, S, len(PI), V] i32
    vf: torch.Tensor        # [B, S] f32 volume_final
    of: torch.Tensor        # [B, S, len(OF), V] f32
    oi: torch.Tensor        # [B, S, len(OI), V] i32
    seg: torch.Tensor       # [B, NB] i32
    start: torch.Tensor     # [B, NB] i32
    table: torch.Tensor     # [R] f32
    block: int
    need: tuple             # (flags, cz curves, mods, ts_pow2): _needs

    @property
    def rows(self) -> int:
        return self.pf.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.seg.shape[1]


def _levels(q: np.ndarray) -> np.ndarray:
    """``(1 << q) - 1`` as f32, as XLA's int32 shift gives it: a shift by
    a negative amount or by 32 or more gives 0 (so -1 levels), and
    ``1 << 31`` wraps."""
    q = np.asarray(q, np.int64)
    ok = (q >= 0) & (q < 32)
    lv = np.where(ok, (np.int64(1) << np.clip(q, 0, 31)) - 1, -1)
    return lv.astype(np.int32).astype(np.float32)


def pack_inputs(params: dict, ops: dict, seg_of_block, seg_is_start,
                table_buffer, block: int, device="cuda") -> CompatInputs:
    """The kernel's inputs from a batch's per-segment ``params`` and
    ``ops`` (numpy ``[B, S, V]``, ``volume_final`` ``[B, S]``; the
    biquad's coefficients already renamed ``b0..b2, na1, na2`` with the
    feedback terms negated, and ``table_off`` resolved), as
    ``render._render_core`` takes them.  Every value computed here is a
    per-segment constant of ``_voice_pass``, in the same f32 operations."""
    f = lambda k: np.asarray(params[k], np.float32)
    i = lambda k: np.asarray(params[k], np.int32)
    B, S, nv = f("amp").shape
    if nv != V:
        raise ValueError(f"compat: {nv} voices, the engine takes {V}")
    pinc = f("phase_inc")
    fm = i("freq_mod_osc")
    n_idx = np.arange(V, dtype=np.int32)
    # mod_inc: the FM source's own increment (render.py:221); an index
    # out of range reads the nearest voice, as XLA's gather clamps it
    mod_inc = np.take_along_axis(pinc, np.clip(fm, 0, V - 1), axis=-1)
    tsize_i = i("table_size")
    tsize = tsize_i.astype(np.float32)
    use_loop = (i("loop_enabled") != 0) & (i("loop_valid") != 0)
    lo = np.where(use_loop, f("loop_start_f"), np.float32(0.0))
    hi = np.where(use_loop, f("loop_end_f"), tsize)
    q = i("quantize")
    levels = _levels(q)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_lev = np.float32(1.0) / levels
    att, dec = f("env_attack"), f("env_decay")
    on = dict(
        use_fm=(fm >= 0) & (fm != n_idx), dirneg=i("direction") != 0,
        osn=(i("one_shot") != 0) & (i("loop_enabled") == 0),
        one_shot=i("one_shot") != 0,
        is_noise=i("table_index") == C.WAVE_TABLE_NOISE_ALT,
        hold_on=i("hold_max") != 0, quant=q != 0,
        use_flt=i("filter_mode") != 0, use_env=i("use_amp_envelope") != 0,
        env_act=i("env_active") != 0, no_rel=i("env_rel_at") == 0,
        use_sm=i("smoother_enable") != 0, disc=i("disconnect") != 0)
    mode, cm = i("cz_mode"), i("cz_mod_osc")
    am, pm = i("amp_mod_osc"), i("pan_mod_osc")
    cz_on = mode != 0
    pan_on = (pm >= 0) & ~on["disc"]
    # the reads a pass makes (read(osc) in csrc/compat.cu): a voice
    # whose estimate a higher voice reads is marked "read"
    edges = [(fm, on["use_fm"]), (cm, cz_on & (cm >= 0)),
             (am, (am >= 0) & (am != n_idx)), (pm, pan_on & (pm != n_idx))]
    read = np.zeros((B, S, V), bool)
    for osc, takes in edges:
        src = takes & (osc >= 0) & (osc < n_idx)
        bs, ss, _ = np.nonzero(src)
        read[bs, ss, osc[src]] = True
    on["read"] = read
    flags = np.zeros((B, S, V), np.int32)
    for bit, name in enumerate(FLAGS):
        flags |= np.where(on[name], 1 << bit, 0).astype(np.int32)
    pf = dict(pinc=pinc, mis=mod_inc * f("freq_scale"),
              fm_dep=f("freq_mod_depth"), lo=lo, hi=hi, L=hi - lo,
              hi_os=hi - np.float32(1e-6), tsize=tsize,
              cz_dist=f("cz_distortion"), cz_dep=f("cz_mod_depth"),
              levels=levels, inv_lev=inv_lev,
              b0=f("b0"), b1=f("b1"), b2=f("b2"), na1=f("na1"),
              na2=f("na2"), att=att, dec=dec, att_dec=att + dec,
              sus=f("env_sustain"), rel=f("env_release"),
              vel=f("env_velocity"), am_dep=f("amp_mod_depth"),
              amp=f("amp"), smoothing=f("smoother_smoothing"),
              pm_dep=f("pan_mod_depth"))
    pi = dict(flags=flags, fm_osc=fm, cz_mode=i("cz_mode"),
              cm_osc=i("cz_mod_osc"),
              clip_hi=np.maximum(tsize_i - 1, 0).astype(np.int32),
              table_off=i("table_off"), hold_max=i("hold_max"),
              env_start=i("env_start"), env_rel_at=i("env_rel_at"),
              am_osc=i("amp_mod_osc"), pm_osc=i("pan_mod_osc"))
    table = np.asarray(table_buffer, np.float32).reshape(-1)
    # the kernel reads table_off + [0, clip_hi] unchecked: hold every
    # voice's table inside the buffer here, on the host
    off = pi["table_off"].astype(np.int64)
    if off.size and (int(off.min()) < 0 or int(
            (off + pi["clip_hi"]).max()) >= table.size):
        raise ValueError("compat: a voice's table runs past the buffer")
    oflags = np.zeros(np.shape(ops["set_phase"]), np.int32)
    for name, bit in _OP_BITS:
        oflags |= np.where(np.asarray(ops[name]) != 0, bit, 0).astype(
            np.int32)
    of = {k: np.asarray(ops[k], np.float32) for k in OF}
    oi = dict(flags=oflags, finished=np.asarray(ops["finished"], np.int32),
              copy_hold_from=np.asarray(ops["copy_hold_from"], np.int32))
    st = lambda d, keys, dt: torch.as_tensor(
        np.ascontiguousarray(np.stack([d[k] for k in keys], axis=2), dt),
        device=device)
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt),
                                      device=device)
    need = _needs(flags, mode, cm, f("cz_distortion"), f("cz_mod_depth"),
                  am, pan_on, on["use_fm"], tsize_i)
    return CompatInputs(
        need=need,
        pf=st(pf, PF, np.float32), pi=st(pi, PI, np.int32),
        vf=t(np.asarray(params["volume_final"]).reshape(B, S), np.float32),
        of=st(of, OF, np.float32), oi=st(oi, OI, np.int32),
        seg=t(seg_of_block, np.int32), start=t(seg_is_start, np.int32),
        table=t(table, np.float32), block=int(block))


def _needs(flags, mode, cm, dist, dep, am, pan_on, use_fm, tsize):
    """What a batch takes of the kernel, over every row, segment and
    voice: (the union of the flag bits but "read", the CZ curves as a
    mask (bit m for curve m in 1..7, bit 0 any other nonzero mode), the
    MODS bits, whether every CZ voice's table size is a power of two).
    A CZ voice's d is constant over its segment unless it reads a
    modulator at a nonzero depth (or its distortion is -0, which a zero
    product would turn +0): then "czd"."""
    fl = int(np.bitwise_or.reduce(flags.ravel(), initial=0)) & KEY_FLAGS
    cz_on = mode != 0
    curves = 0
    for m in np.unique(mode[cz_on]).tolist():
        curves |= 1 << (m if 1 <= m <= 7 else 0)
    neg0 = (dist == 0) & np.signbit(dist)
    varies = cz_on & (cm >= 0) & ((dep != 0) | neg0)
    mods = 0
    for name, any_ in (("fm", use_fm.any()), ("cz", (cz_on & (cm >= 0)).any()),
                       ("czd", varies.any()), ("am", (am >= 0).any()),
                       ("pan", pan_on.any())):
        mods |= (1 << MODS.index(name)) if any_ else 0
    ts = tsize[cz_on]
    pow2 = bool(((ts > 0) & ((ts & (ts - 1)) == 0)).all())
    return (fl, curves, mods, int(pow2))


def compat_key(inp: CompatInputs, mod_passes: int, capture: bool,
               stamp: bool = False) -> tuple:
    """The build key (``-D`` defines) of ``csrc/compat.cu`` for a launch
    on ``inp``: its pass count, capture, the union of its voices' flags,
    CZ curves and modulator reads over every row and segment, and whether
    every CZ table is a power of two; ``stamp``: the measurement build
    (timing only).  One library per key, built at its first use."""
    fl, curves, mods, pow2 = inp.need
    key = (f"COMPAT_PASSES={int(mod_passes)}",
           f"COMPAT_CAPTURE={int(bool(capture))}",
           f"COMPAT_FLAGS={fl:#x}", f"COMPAT_CZ_MASK={curves:#x}",
           f"COMPAT_MODS={mods:#x}", f"COMPAT_TS_POW2={pow2}")
    return key + (("COMPAT_STAMP=1",) if stamp else ())


def zero_carry(B: int, device="cuda"):
    """The engine's carry at the first block: every state 0."""
    return (torch.zeros((B, len(CF), V), dtype=F32, device=device),
            torch.zeros((B, len(CI), V), dtype=I32, device=device),
            torch.zeros((B,), dtype=F32, device=device))


def voice_sum(x: torch.Tensor) -> torch.Tensor:
    """[B, 64] -> [B]: the stereo sum's fixed tree, as the kernel adds
    (a warp a half: lane i adds lane i+16, then i+8, 4, 2, 1; then the
    two halves)."""
    x = x.reshape(x.shape[0], 2, V // 2)
    for h in (16, 8, 4, 2, 1):
        x = x[..., :h] + x[..., h:2 * h]
    return x[:, 0, 0] + x[:, 1, 0]


# ---- the plain version ----

def _fast_pow(a, b):
    """render._fast_pow (synth.c:140-147) with XLA's saturating
    conversion (the card's ``__float2int_rz``): ``numerics.f2i``."""
    i = a.contiguous().view(I32)
    x = fma32(b, (i - 1065353216).to(F32), 1065353216.0)
    r = f2i(x).view(F32)
    return torch.where(a <= 0.0, 0.0, r)


def _cz_phasor(mode, p, d, tsize, modes):
    """render._cz_phasor (synth.c:149-215) over the curves in ``modes``
    (the others select nothing)."""
    phase = div32(p, tsize)
    d = torch.clamp(d, 0.0, f32(0.999))
    half, one = 0.5, 1.0
    mk = {}
    if 1 in modes:
        mk[1] = torch.where(phase < d, phase * div32(half, d),
                            fma32(phase - d, div32(half, one - d), half))
    if modes & {2, 3, 5}:
        sc2 = div32(half, half - d * half)
    if 2 in modes:
        mk[2] = torch.where(phase < half, phase * sc2,
                            fma32(-(one - phase), sc2, one))
    if 3 in modes:
        mk[3] = torch.where(phase < half, phase * sc2,
                            fma32(phase - half, sc2, half))
    if 4 in modes:
        mk[4] = torch.fmod(phase * 2.0, one)
    if 5 in modes:
        sc5b = div32(half, half + d * half)
        mk[5] = torch.where(phase < half, phase * sc2,
                            fma32(phase - half, sc5b, half))
    if 6 in modes:
        mk[6] = _fast_pow(phase, one + 4.0 * d)
    if 7 in modes:
        mk[7] = _fast_pow(phase, one + 8.0 * d)
    out = phase
    for k in sorted(mk, reverse=True):
        out = torch.where(mode == k, mk[k], out)
    return out * tsize


class _Seg:
    """One segment's parameters as [B, V] tensors, the per-segment masks
    and gather indices, and which stages any (row, voice) uses: a stage
    no one uses is skipped, since its selects would keep every old
    value."""

    def __init__(self, inp: CompatInputs, seg: torch.Tensor):
        ar = torch.arange(inp.rows, device=seg.device)
        pf, pi = inp.pf[ar, seg], inp.pi[ar, seg]
        for j, k in enumerate(PF):
            setattr(self, k, pf[:, j])
        for j, k in enumerate(PI):
            setattr(self, k, pi[:, j])
        self.vf = inp.vf[ar, seg]
        for bit, name in enumerate(FLAGS):
            setattr(self, name, (self.flags & (1 << bit)) != 0)
        n_idx = torch.arange(V, device=seg.device, dtype=I32)
        for name in ("fm", "cm", "am", "pm"):
            osc = getattr(self, f"{name}_osc")
            # read(osc): est[osc] if osc < n else prev[osc], at
            # max(osc, 0); XLA's gather clamps an index past the voices
            setattr(self, f"{name}_at", torch.clamp(osc, 0, V - 1).long())
            setattr(self, f"{name}_cur", osc < n_idx)
        self.am_self = self.am_osc == n_idx
        self.pm_self = self.pm_osc == n_idx
        self.amp_nz = self.amp != 0.0
        self.cz_on = self.cz_mode != 0
        self.modes = {int(m) for m in torch.unique(
            self.cz_mode[self.cz_on]).tolist()} & set(range(1, 8))
        self.pan_on = (self.pm_osc >= 0) & ~self.disc
        self.has = dict(
            fm=bool(self.use_fm.any()), dir=bool(self.dirneg.any()),
            cz=bool(self.cz_on.any()), noise=bool(self.is_noise.any()),
            hold=bool(self.hold_on.any()), quant=bool(self.quant.any()),
            flt=bool(self.use_flt.any()), env=bool(self.use_env.any()),
            am=bool((self.am_osc >= 0).any()), sm=bool(self.use_sm.any()),
            pan=bool(self.pan_on.any()))


def _voice_pass(est, prev, c, p: _Seg, whiteish, count, table):
    """render._voice_pass on [B, V] tensors: one fixed-point pass.
    Returns (sample_out, left, right, new state)."""
    active = (c["finished"] == 0) & p.amp_nz

    def read(name):
        at = getattr(p, f"{name}_at")
        return torch.where(getattr(p, f"{name}_cur"), est.gather(1, at),
                           prev.gather(1, at))

    # ---- oscillator (synth.c:543-558, osc_next :217-275) ----
    inc = p.pinc
    if p.has["fm"]:
        g = read("fm") * p.fm_dep
        inc = torch.where(p.use_fm, fma32(p.mis, g, p.pinc), p.pinc)
    if p.has["dir"]:
        inc = torch.where(p.dirneg, -inc, inc)
    ph = c["phase"] + inc
    bad = ~torch.isfinite(ph)
    over = ph >= p.hi
    under = ph < p.lo
    wrap_over = p.lo + torch.fmod(ph - p.lo, p.L)
    wrap_under = p.hi - torch.fmod(p.lo - ph, p.L)
    ph2 = torch.where(over, torch.where(p.osn, p.hi_os, wrap_over),
                      torch.where(under, torch.where(p.osn, p.lo,
                                                     wrap_under), ph))
    ph2 = torch.where(bad, 0.0, ph2)
    fin_osc = (bad & p.one_shot) | ((over | under) & p.osn)
    idx_f = ph2
    if p.has["cz"]:
        dm = torch.where(p.cm_osc >= 0, read("cm") * p.cz_dep, 1.0)
        cz_idx = _cz_phasor(p.cz_mode, ph2, p.cz_dist + dm, p.tsize,
                            p.modes)
        idx_f = torch.where(p.cz_on, cz_idx, ph2)
    # the f32 -> i32 conversion before the clip (render.py:247): NaN and
    # operands out of range convert as XLA and the card do (numerics.f2i)
    idx = torch.minimum(torch.clamp(f2i(idx_f), min=0), p.clip_hi)
    f = table[(p.table_off + idx).long()]
    f = torch.where(bad, 0.0, f)
    adv = active
    if p.has["noise"]:
        f = torch.where(p.is_noise, whiteish, f)
        adv = active & ~p.is_noise
    new = dict(c)
    new["phase"] = torch.where(adv, ph2, c["phase"])
    new["finished"] = torch.where(adv & fin_osc, 1, c["finished"]).to(I32)

    # ---- sample & hold (synth.c:560-571) ----
    s1 = f
    if p.has["hold"]:
        hv = torch.where(p.hold_on & (c["hold_count"] == 0), f,
                         c["hold_val"])
        s1 = torch.where(p.hold_on, hv, f)
        hc = c["hold_count"] + 1
        new["hold_count"] = torch.where(
            active & p.hold_on, torch.where(hc >= p.hold_max, 0, hc),
            c["hold_count"]).to(I32)
        new["hold_val"] = torch.where(active, hv, c["hold_val"])

    # ---- bit quantizer (synth.c:341-345, :574); levels from the host ----
    s2 = s1
    if p.has["quant"]:
        iv = f2i(fma32(s1, p.levels, 0.5)).to(F32)
        s2 = torch.where(p.quant, iv * p.inv_lev, s1)

    # ---- biquad, direct form I (mmf_process, synth.c:349-364) ----
    s3 = s2
    if p.has["flt"]:
        flt = p.b1 * c["x1"]
        flt = fma32(p.b0, s2, flt)
        flt = fma32(p.b2, c["x2"], flt)
        flt = fma32(p.na1, c["y1"], flt)
        flt = fma32(p.na2, c["y2"], flt)
        s3 = torch.where(p.use_flt, flt, s2)
        upd = active & p.use_flt
        new["x2"] = torch.where(upd, c["x1"], c["x2"])
        new["x1"] = torch.where(upd, s2, c["x1"])
        new["y2"] = torch.where(upd, c["y1"], c["y2"])
        new["y1"] = torch.where(upd, flt, c["y1"])

    # ---- amp / envelope / amp-mod / smoother (synth.c:580-593) ----
    env = 1.0
    if p.has["env"]:
        t = (count - p.env_start).to(F32)
        attack_val = div32(t, p.att)
        decay_val = fma32(-div32(t - p.att, p.dec), 1.0 - p.sus, 1.0)
        tr = (count - p.env_rel_at).to(F32)
        release_val = p.sus * (1.0 - div32(tr, p.rel))
        v = torch.where(
            t < p.att, attack_val,
            torch.where(t < p.att_dec, decay_val,
                        torch.where(p.no_rel, p.sus,
                                    torch.where(tr < p.rel, release_val,
                                                0.0))))
        v = torch.where(p.env_act, v, 0.0)
        env = torch.where(p.use_env, v * p.vel, 1.0)
    ampmod = 1.0
    if p.has["am"]:
        am_read = torch.where(p.am_self, s3, read("am"))
        ampmod = torch.where(p.am_osc >= 0, am_read * p.am_dep, 1.0)
    final = p.amp * env * ampmod
    final2 = final
    if p.has["sm"]:
        sg = fma32(p.smoothing, final - c["smoother"], c["smoother"])
        final2 = torch.where(p.use_sm, sg, final)
        new["smoother"] = torch.where(active & p.use_sm, sg, c["smoother"])
    sample_out = torch.where(active, s3 * final2, 0.0)

    # ---- pan (+pan-mod) (synth.c:595-612) ----
    pl, pr = c["pan_l"], c["pan_r"]
    if p.has["pan"]:
        pm_read = torch.where(p.pm_self, sample_out, read("pm"))
        one_m_q = fma32(-pm_read, p.pm_dep, 1.0)
        one_p_q = fma32(pm_read, p.pm_dep, 1.0)
        pl = torch.where(p.pan_on, one_m_q / 2.0, c["pan_l"])
        pr = torch.where(p.pan_on, one_p_q / 2.0, c["pan_r"])
        new["pan_l"] = torch.where(active & p.pan_on, pl, c["pan_l"])
        new["pan_r"] = torch.where(active & p.pan_on, pr, c["pan_r"])
    contrib = active & ~p.disc
    left = torch.where(contrib, sample_out * pl, 0.0)
    right = torch.where(contrib, sample_out * pr, 0.0)
    return sample_out, left, right, new


def _apply_ops(c, inp: CompatInputs, seg, flag):
    """render._apply_ops on the rows whose segment starts here: the
    copied hold state is the source voice's before this block's ops."""
    ar = torch.arange(inp.rows, device=seg.device)
    of, oi = inp.of[ar, seg], inp.oi[ar, seg]
    fl, on = oi[:, 0], flag[:, None]
    w = lambda bit, new, old: torch.where(on & ((fl & bit) != 0), new, old)
    n = dict(c)
    n["phase"] = w(SET_PHASE, of[:, 0], c["phase"])
    n["finished"] = w(SET_FINISHED, oi[:, 1], c["finished"])
    n["sample"] = w(SET_SAMPLE, of[:, 1], c["sample"])
    for k in ("x1", "x2", "y1", "y2"):
        n[k] = w(CLEAR_FILTER, 0.0, c[k])
    n["smoother"] = w(SET_SMOOTHER, of[:, 2], c["smoother"])
    n["pan_l"] = w(SET_PAN, of[:, 3], c["pan_l"])
    n["pan_r"] = w(SET_PAN, of[:, 4], c["pan_r"])
    src = oi[:, 2]
    do = on & (src >= 0)
    at = torch.clamp(src, 0, V - 1).long()
    n["hold_count"] = torch.where(do, c["hold_count"].gather(1, at),
                                  n["hold_count"])
    n["hold_val"] = torch.where(do, c["hold_val"].gather(1, at),
                                n["hold_val"])
    return n


def compat_block_plain(inp: CompatInputs, carry, noise, block0: int,
                       nb: int, mod_passes: int, exact: bool = True,
                       capture: bool = False):
    """The kernel's arithmetic in torch ops on any device: blocks
    ``block0 .. block0+nb`` of the scan, sample by sample.  Returns what
    ``compat_block`` returns; ``exact`` selects nothing (see
    ``compat_block``)."""
    cf, ci, vg = carry
    c = {k: cf[:, j] for j, k in enumerate(CF)}
    c.update({k: ci[:, j] for j, k in enumerate(CI)})
    B, n, dev = inp.rows, inp.block, cf.device
    out = torch.empty((B, nb * n, 2), dtype=F32, device=dev)
    cap = torch.empty((B, nb * n, V, 2), dtype=F32, device=dev) \
        if capture else None
    p, seg_key = None, None
    for k in range(nb):
        kg = block0 + k
        seg = inp.seg[:, kg].long()
        if p is None or not torch.equal(seg, seg_key):
            p, seg_key = _Seg(inp, seg), seg
        c = _apply_ops(c, inp, seg, inp.start[:, kg] != 0)
        for t in range(n):
            i = k * n + t
            count = kg * n + 1 + t               # 1-based global sample
            prev = c["sample"]
            est = prev
            for _ in range(mod_passes):
                sample_out, left, right, new = _voice_pass(
                    est, prev, c, p, noise[i], count, inp.table)
                est = sample_out
            c = new
            c["sample"] = sample_out
            # ---- master volume smoother + stereo mix (synth.c:616-624) --
            vg = fma32(0.002, p.vf - vg, vg)
            out[:, i, 0] = voice_sum(left) * vg
            out[:, i, 1] = voice_sum(right) * vg
            if capture:
                cap[:, i, :, 0] = left
                cap[:, i, :, 1] = right
    new_carry = (torch.stack([c[k] for k in CF], dim=1),
                 torch.stack([c[k] for k in CI], dim=1).to(I32), vg)
    return new_carry, out, cap


# ---- the CUDA launch: one C struct mirrors csrc/compat.cu's CompatArgs ----

_INT_FIELDS = ("rows", "segs", "nb_total", "block", "block0", "nblocks",
               "passes", "capture", "need_flags", "need_cz", "need_mods",
               "ts_pow2")
_PTR_FIELDS = ("pf", "pi", "vf", "of", "oi", "seg", "start", "table",
               "noise", "cf0", "ci0", "vg0", "cf1", "ci1", "vg1", "out",
               "cap", "stamp")


class CompatArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_int) for k in _INT_FIELDS]
                + [(k, ctypes.c_void_p) for k in _PTR_FIELDS])


# the largest fixed-point pass count the kernel takes: timeline's
# _mod_passes counts the chain depth of the 64 voices, at most 64
MAX_PASSES = V


def _layout_checked(lib) -> None:
    """Raise unless the library's field counts are this module's."""
    fn = lib.compat_layout
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    want = (len(PF), len(PI), len(OF), len(OI), len(CF), len(CI), V,
            len(STAMPS))
    got = tuple(fn(j) for j in range(len(want)))
    if got != want:
        raise RuntimeError(f"compat.cu's layout {got} is not the "
                           f"wrapper's {want}")


def _pack_args(inp: CompatInputs, carry, noise, block0, nb, mod_passes,
               capture):
    """Check the CUDA tensors and fill the kernel's argument struct.
    Returns (CompatArgs, new carry, out, cap)."""
    dev = inp.pf.device
    B, S = inp.rows, inp.pf.shape[1]
    NB, n = inp.num_blocks, inp.block
    chk = lambda *x: cuda_call.check("compat", *x)
    if block0 < 0 or nb < 1 or block0 + nb > NB:
        raise ValueError(f"compat: blocks {block0}..{block0 + nb} outside "
                         f"0..{NB}")
    if not 1 <= mod_passes <= MAX_PASSES:
        raise ValueError(f"compat: {mod_passes} passes")
    a = CompatArgs()
    a.rows, a.segs, a.nb_total, a.block = B, S, NB, n
    a.block0, a.nblocks, a.passes = int(block0), int(nb), int(mod_passes)
    a.capture = int(bool(capture))
    a.need_flags, a.need_cz, a.need_mods, a.ts_pow2 = inp.need
    a.pf = chk("pf", inp.pf, dev, F32, (B, S, len(PF), V))
    a.pi = chk("pi", inp.pi, dev, I32, (B, S, len(PI), V))
    a.vf = chk("vf", inp.vf, dev, F32, (B, S))
    a.of = chk("of", inp.of, dev, F32, (B, S, len(OF), V))
    a.oi = chk("oi", inp.oi, dev, I32, (B, S, len(OI), V))
    a.seg = chk("seg", inp.seg, dev, I32, (B, NB))
    a.start = chk("start", inp.start, dev, I32, (B, NB))
    if inp.table.dim() != 1:
        raise ValueError("compat: table must be the flat [R] buffer")
    a.table = chk("table", inp.table, dev, F32, tuple(inp.table.shape))
    a.noise = chk("noise", noise, dev, F32, (nb * n,))
    cf, ci, vg = carry
    a.cf0 = chk("carry f32", cf, dev, F32, (B, len(CF), V))
    a.ci0 = chk("carry i32", ci, dev, I32, (B, len(CI), V))
    a.vg0 = chk("vol_gain", vg, dev, F32, (B,))
    new = (torch.empty_like(cf), torch.empty_like(ci), torch.empty_like(vg))
    a.cf1, a.ci1, a.vg1 = (x.data_ptr() for x in new)
    out = torch.empty((B, nb * n, 2), dtype=F32, device=dev)
    a.out = out.data_ptr()
    cap = None
    if capture:
        cap = torch.empty((B, nb * n, V, 2), dtype=F32, device=dev)
        a.cap = cap.data_ptr()
    return a, new, out, cap


# the measurement build's stages (csrc/compat.cu's S_*): clock cycles a
# sample step, per warp; "r_" the non-committing passes, "c_" the last
STAMPS = ("noise", "bar_prev", "r_reads", "r_wrap", "r_cz", "r_table",
          "r_hqb", "r_env", "r_pan", "bar_est", "c_reads", "c_wrap", "c_cz",
          "c_table", "c_hqb", "c_env", "c_pan", "reduce", "store")


def stamp_buffer(inp: CompatInputs) -> torch.Tensor:
    """The measurement build's output for a launch on ``inp``: uint32
    cycles (as int32) ``[rows, 2 warps, len(STAMPS)]``, zero."""
    return torch.zeros((inp.rows, V // 32, len(STAMPS)), dtype=I32,
                       device=inp.pf.device)


def _launch(inp: CompatInputs, carry, noise, block0, nb, mod_passes, exact,
            capture, stamps=None):
    """Pack the arguments, launch ``csrc/compat.cu`` under ``compat_key``
    of the batch on the inputs' device (built at first use; its field
    counts held to this module's once) and count the launch.  The library
    refuses arguments its key does not take (``cuda_call.launch``
    raises).  ``stamps`` (``stamp_buffer``): launch the measurement
    build, which writes each warp's cycles a stage there."""
    from skred_tpu_torch.engine.kernels import build

    args, new, out, cap = _pack_args(inp, carry, noise, block0, nb,
                                     mod_passes, capture)
    key = compat_key(inp, mod_passes, capture, stamps is not None)
    if stamps is not None:
        args.stamp = cuda_call.check("compat", "stamps", stamps,
                                     inp.pf.device, I32,
                                     (inp.rows, V // 32, len(STAMPS)))
    lib = build.load("compat", key)
    if not getattr(lib, "layout_checked", False):
        _layout_checked(lib)
        lib.layout_checked = True
    cuda_call.launch("compat", args, inp.pf.device, key)
    compat_block.launches += 1
    return new, out, cap


def compat_block(inp: CompatInputs, carry, noise, block0: int, nb: int,
                 mod_passes: int, exact: bool = True,
                 capture: bool = False):
    """Blocks ``block0 .. block0+nb`` of the compat engine over every
    row: one CUDA block a row, built under ``compat_key`` of the batch.

    inp: ``pack_inputs``' tensors; carry: ``(cf, ci, vol_gain)`` (see
    the module docstring); noise: [nb*block] f32, the stream's values of
    these blocks; mod_passes: fixed-point passes a sample; exact: the
    engine's mode, which selects nothing: both modes take one fma at
    each of ``render._fma``'s sites (the reference's in exact mode, and
    in fast mode the card's plain multiply-add, which is what the JAX
    package's fast mode gives on the CPU); capture: also return each
    voice's post-pan stereo pair.
    Returns ``(carry, out [B, nb*block, 2], cap [B, nb*block, V, 2] or
    None)``; the carry is new tensors, the input's is left as it was."""
    with spans.span("kernel.compat"):
        dev = inp.pf.device
        if dev.type == "cpu":
            return compat_block_plain(inp, carry, noise, block0, nb,
                                      mod_passes, exact, capture)
        if dev.type != "cuda":
            raise ValueError(f"compat: no kernel for device {dev}")
        return _launch(inp, carry, noise, block0, nb, mod_passes, exact,
                       capture)


compat_block.launches = 0
