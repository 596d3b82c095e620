"""The fused block renderer in torch, on the port's CUDA kernels.

A packed batch (``parallel/batch.py``) renders block by block, 512
samples at a time.  Voices are laid out in tiers of the modulation DAG:
tier k reads only tiers < k, so each block runs one pass per tier, in
order, and every voice renders once per block.  A tier without noise
voices runs one tier-kernel call (``engine/kernels/tier.py``); a tier
that holds a noise voice (``w6``) runs the noise pass, three kernels: the
keyed phase walk (modulator reads, FM increment, walk, CZ warp and index
clip), the table lookup, and the keyed filter/smoother (the noise stream
selected in for the noise voices, dead mask, envelope, am stream, serial
stages).  After the tiers the stereo mix sums the voices and the
master-volume smoother runs as an associative scan.

Every pass writes its samples into its columns of one block buffer
``[N, Vp*B]``, which is the modulator bank of the later tiers.  With
``fold`` (the default) a tier-kernel tier past the first reads its fm /
cz / am modulator streams from that bank inside the kernel (a noise
tier's kernels always do); with ``mix``
(the default) the kernel also sums its static-pan voices into the
block's stereo accumulators, so torch is left with the pan-modulated
lanes, the noise tiers' voices and the volume smoother.  ``mix=False,
fold=False`` reads the streams (``_read_vm``) and mixes in torch.

A batch whose segments' graphs are acyclic while their union is not has
no tiers (``st.tiers is None``, the repeat-passes layout): every block
runs ``fused_passes - 1`` estimate passes over the modulator-source
prefix, starting from the previous block's last samples, then the final
pass over all voices.

Layout: per-lane streams are time-major ``[N, M]`` over voice-major lanes
(lane ``v*B + b``, as the kernels take them), so the modulator reads,
the kernels and the mix never transpose a block.  Per-voice parameters
and the carry stay ``[B, V]`` as the JAX package keeps them.

``render_fused(capture=True)`` also returns each voice's post-pan
stereo pair, before the voice sum: the mix and the fold are off, every
tier writes its samples into the block buffer, and ``_mix_parts`` keeps
each lane's panned samples beside the sum it takes.

``render_fused(mesh=...)`` splits the batch's rows over several
devices (see its docstring).

Port of ``skred_tpu.engine.fused`` (render_fused, render_fused_device,
render_fused_stream, render_fused_stream_device) on its Pallas paths.  A
cyclic batch is a ValueError here, as in the JAX package:
``engine/cyclic.py`` renders it (``render_cyclic``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from skred_tpu_torch import config as C
from skred_tpu_torch import spans
from skred_tpu_torch.engine import download
from skred_tpu_torch.engine.kernels.filt_smooth import (filt_smooth_key,
                                                        filt_smooth_noise)
from skred_tpu_torch.engine.kernels.lookup import lookup
from skred_tpu_torch.engine.kernels.phase_walk import (phase_walk_key,
                                                       phase_walk_warp)
from skred_tpu_torch.engine.kernels.tier import (Fold, bank_read,
                                                 tier, tier_key)
from skred_tpu_torch.engine.numerics import div32, f32
from skred_tpu_torch.host.timeline import noise_stream

F32 = torch.float32
I32 = torch.int32

_CK = ("phase", "finished", "sample", "hold_count", "hold_val",
       "x1", "x2", "y1", "y2", "smoother", "pan_l", "pan_r")


class Feat(NamedTuple):
    """Static per-batch DSP feature flags: which stages exist ANYWHERE in
    the stacked timelines (the same fields as the JAX package's Feat).
    Stages off for a whole tier are skipped by its kernel call."""

    fm: bool = True          # any freq_mod_osc >= 0
    cz: bool = True          # any cz_mode != 0 (phase-distortion warp)
    czm: bool = True         # any EFFECTIVE cz-mod edge (warped voice,
                             # cz_mod_osc >= 0, nonzero depth)
    am: bool = True          # any amp_mod_osc >= 0
    pm: bool = True          # any pan_mod_osc >= 0
    am_self: bool = True     # any packed am_self flag
    pm_self: bool = True
    env: bool = True         # any use_amp_envelope
    flt: bool = True         # any filter_mode != 0
    sm: bool = True          # any smoother_enable
    hold: bool = True        # any hold_max != 0
    quant: bool = True       # any quantize != 0
    noise: bool = True       # any noise-alt voice
    finish: bool = True      # any one-shot voice (finished can flip)
    direction: bool = True   # any reversed oscillator
    disc: bool = True        # any disconnected voice
    hold_copy: bool = True   # any copy_hold_from op
    cz_modes: tuple = (1, 2, 3, 4, 5, 6, 7)   # cz_mode values present
    pm_lanes: tuple = ()     # packed lanes with pan_mod_osc >= 0
    pm_srcs: tuple = ()      # packed lanes any pan-mod edge READS
    ts_pow2: bool = False    # every table_size a power of two


def compute_feat(st, lanes=None) -> Feat:
    """Derive the static feature flags from a (packed) StackedTimelines;
    ``lanes=(lo, hi)`` restricts to a voice-lane slice (per-tier flags)."""
    p, o = st.params, st.ops
    sl = slice(*lanes) if lanes is not None else slice(None)
    arr = lambda k: np.asarray(p[k])[..., sl]
    oarr = lambda k: np.asarray(o[k])[..., sl]
    return Feat(
        fm=bool((arr("freq_mod_osc") >= 0).any()),
        cz=bool((arr("cz_mode") != 0).any()),
        czm=bool(((arr("cz_mod_osc") >= 0)
                  & (arr("cz_mode") != 0)
                  & (arr("cz_mod_depth") != 0)).any()),
        am=bool((arr("amp_mod_osc") >= 0).any()),
        pm=bool((arr("pan_mod_osc") >= 0).any()),
        am_self=bool("am_self" in p and (arr("am_self") != 0).any()),
        pm_self=bool("pm_self" in p and (arr("pm_self") != 0).any()),
        env=bool((arr("use_amp_envelope") != 0).any()),
        flt=bool((arr("filter_mode") != 0).any()),
        sm=bool((arr("smoother_enable") != 0).any()),
        hold=bool((arr("hold_max") != 0).any()),
        quant=bool((arr("quantize") != 0).any()),
        noise=bool((arr("table_index") == C.WAVE_TABLE_NOISE_ALT).any()),
        finish=bool((arr("one_shot") != 0).any()
                    or (oarr("set_finished")
                        & (oarr("finished") != 0)).any()),
        direction=bool((arr("direction") != 0).any()),
        disc=bool((arr("disconnect") != 0).any()),
        hold_copy=bool((oarr("copy_hold_from") >= 0).any()),
        cz_modes=tuple(int(v) for v in np.unique(arr("cz_mode"))
                       if 1 <= v <= 7),
        # lane indices stay GLOBAL packed coordinates
        pm_lanes=tuple(int(v) + (lanes[0] if lanes is not None else 0)
                       for v in np.nonzero(
                           (arr("pan_mod_osc") >= 0).any(axis=(0, 1)))[0]),
        pm_srcs=tuple(int(v) for v in np.unique(arr("pan_mod_osc"))
                      if v >= 0),
        ts_pow2=bool((np.bitwise_and(arr("table_size"),
                                     arr("table_size") - 1) == 0).all()),
    )


def _feat_tiers(st):
    """Per-tier static feature flags (None when not tiered / single
    tier): tier k's pass runs only the stages its lanes use."""
    if not st.tiers or len(st.tiers) <= 1:
        return None
    bounds = np.cumsum((0,) + tuple(st.tiers))
    return tuple(compute_feat(st, (int(bounds[i]), int(bounds[i + 1])))
                 for i in range(len(st.tiers)))


def _fold_tiers(st, fts):
    """Per-tier modulator-bank fold decisions (None: no tier folds), the
    port of the JAX package's ``_fold_tiers``: a tier past the first
    reads its modulator streams inside the tier kernel when it has a
    cross-tier stream (fm, effective cz-mod, or am) and holds no noise
    voice (the noise pass runs other kernels).

    The JAX package's further conditions are the TPU kernel's layout and
    do not apply here.  Its read topology must be uniform across batch
    rows, the rows a multiple of 1024 and the bank within 48 MiB of
    VMEM, because that kernel picks (8,128) row windows of a VMEM copy
    of the bank through per-voice row maps; this kernel takes the source
    voice per lane and reads the bank from global memory, so rows may
    differ, any row count will do and the bank is not copied.  A tier
    whose am stream holds a self-read folds too: the kernel takes the
    bank read first and lets the self-read lanes' select override it
    per sample, as it does with a stream passed in (a self-read lane's
    source lies past the bank and reads 0.0)."""
    if not st.tiers or len(st.tiers) <= 1 or fts is None:
        return None
    out = [False]
    for ft in fts[1:]:
        streams = ft.fm or (ft.cz and ft.czm) or ft.am
        out.append(bool(streams and not ft.noise))
    return tuple(out) if any(out) else None


# ---- voice-major lane layout (lane = v*B + b) ----

def to_vm_vec(a: torch.Tensor) -> torch.Tensor:
    """[B, V] → [V*B] voice-major."""
    return a.T.reshape(-1).contiguous()


def from_vm_vec(a: torch.Tensor, b: int, v: int) -> torch.Tensor:
    """[V*B] voice-major → [B, V]."""
    return a.reshape(v, b).T


# ---- scans ----

def _associative_scan(combine, elems):
    """Inclusive scan along dim 0 with jax.lax.associative_scan's combine
    tree (pairwise reduce, recurse on the odd elements, fill the even
    ones), so every element rounds as it does in the JAX package."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine([e[0:n - 1:2] for e in elems],
                      [e[1::2] for e in elems])
    odd = _associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = combine(odd, [e[2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[0] = e[0]
        r[2::2] = ev
        r[1::2] = od
        out.append(r)
    return out


def _affine_scan(a, b, x0):
    """x_t = a_t * x_{t-1} + b_t along dim 0 with initial value x0."""
    a = a.expand_as(b)
    b = torch.cat([(b[0] + a[0] * x0)[None], b[1:]], dim=0)

    def combine(l, r):
        return [l[0] * r[0], l[1] * r[0] + r[1]]

    return _associative_scan(combine, [a, b])[1]


# ---- per-block pieces ----

def _read_vm(est_vm, prev_vm, osc, delayed, n, b):
    """Modulator read over a block in voice-major lanes (the port of the
    JAX package's ``_read_block`` / ``_read_blocks_multi``), with the
    reference's serial-order rule (synth.c:526): a read of a modulator
    with original index >= the reader's sees a one-sample delay.

    est_vm: [N, W*B] the earlier tiers' samples (or None); prev_vm:
    [W*B] their last samples of the previous block; osc/delayed: [B, V]
    packed source index / delay flag.  A source outside [0, W) reads
    0.0, as the JAX package's one-hot product does (its +0.0 sum also
    turns -0.0 into +0.0).  Returns [N, V*B]."""
    bank = None if est_vm is None \
        else Fold(est_vm, prev_vm, est_vm.shape[1] // b)
    return bank_read(bank, to_vm_vec(osc.to(I32)), to_vm_vec(delayed), n, b)


def _tier_params(p, full_inc, feat, fold=False):
    """The tier kernel's per-lane parameter vectors that depend only on
    the block's parameters (not on the carry): built once per render
    for a single-segment batch, else once per block.  ``fold`` adds the
    per-lane source voice and delay flag of each modulator stream, which
    may change from segment to segment like any other parameter."""
    i32v = lambda a: to_vm_vec(a.to(I32))
    f32v = lambda a: to_vm_vec(a.to(F32))
    active0 = p["amp"] != 0.0
    tsize_f = p["table_size"].to(F32)
    use_loop = (p["loop_enabled"] != 0) & (p["loop_valid"] != 0)
    lo = torch.where(use_loop, p["loop_start_f"], 0.0)
    hi = torch.where(use_loop, p["loop_end_f"], tsize_f)
    vecs = {
        "base_off": i32v(p["table_off"]),
        "clip_i": i32v(torch.clamp(p["table_size"] - 1, min=0)),
        "act": i32v(active0),
        "lo": f32v(lo), "hi": f32v(hi), "L": f32v(hi - lo),
        "amp": f32v(p["amp"]),
    }
    if feat.finish:
        vecs["osn"] = i32v((p["one_shot"] != 0) & (p["loop_enabled"] == 0))
        vecs["one_shot"] = i32v(p["one_shot"])
    if feat.cz:
        vecs.update(cz_mode=i32v(p["cz_mode"]),
                    cz_dist=f32v(p["cz_distortion"]), tsize=f32v(tsize_f))
    if feat.env:
        vecs.update(use_env=i32v(p["use_amp_envelope"]),
                    env_active=i32v(p["env_active"]),
                    env_start=i32v(p["env_start"]),
                    env_rel_at=i32v(p["env_rel_at"]),
                    att=f32v(p["env_attack"]), dec=f32v(p["env_decay"]),
                    sus=f32v(p["env_sustain"]), rel=f32v(p["env_release"]),
                    vel=f32v(p["env_velocity"]))
    if feat.flt:
        vecs.update(b0=f32v(p["b0"]), b1=f32v(p["b1"]), b2=f32v(p["b2"]),
                    na1=f32v(p["na1"]), na2=f32v(p["na2"]),
                    use_flt=i32v(p["filter_mode"] != 0))
    if feat.sm:
        vecs.update(use_sm=i32v(p["smoother_enable"]),
                    smoothing=f32v(p["smoother_smoothing"]))
    if feat.am_self:
        vecs.update(am_self=i32v(p["am_self"]),
                    am_depth=f32v(p["amp_mod_depth"]))
    if feat.hold:
        vecs.update(hold_on=i32v(p["hold_max"] != 0),
                    hold_max=i32v(torch.clamp(p["hold_max"], min=1)))
    if feat.quant:
        q = p["quantize"].to(I32)
        levels = (torch.bitwise_left_shift(torch.ones_like(q), q) - 1) \
            .to(F32)
        inv_levels = div32(1.0, torch.clamp(levels, min=1.0))
        vecs.update(quant_on=i32v(q != 0), levels=f32v(levels),
                    inv_levels=f32v(inv_levels))
    if feat.fm:
        fm = p["freq_mod_osc"]
        mod_inc = torch.gather(full_inc, 1, fm.clamp(min=0).long())
        vecs.update(use_fm=i32v((fm >= 0) & (p["fm_self"] == 0)),
                    mis=f32v(mod_inc * p["freq_scale"]),
                    pinc=f32v(p["phase_inc"]),
                    fm_depth=f32v(p["freq_mod_depth"]))
        if feat.direction:
            vecs["dirneg"] = i32v(p["direction"] != 0)
        inc_row = None
    else:
        # no FM in the tier: the increment is constant within the block
        inc_row = p["phase_inc"]
        if feat.direction:
            inc_row = torch.where(p["direction"] != 0, -inc_row, inc_row)
        inc_row = f32v(inc_row)
    if feat.cz and feat.czm:
        vecs.update(cm_ge0=i32v(p["cz_mod_osc"] >= 0),
                    cz_depth=f32v(p["cz_mod_depth"]))
        dm_row = None
    elif feat.cz:
        # no effective cz-mod edge: the taken read multiplies to +0.0
        dm_row = f32v(torch.where(p["cz_mod_osc"] >= 0, 0.0, 1.0))
    else:
        dm_row = None
    if feat.am:
        vecs.update(am_ge0=i32v(p["amp_mod_osc"] >= 0),
                    am_depth_a=f32v(p["amp_mod_depth"]))
    if fold:
        if feat.fm:
            vecs.update(fm_src=i32v(p["freq_mod_osc"]),
                        fm_del=i32v(p["fm_delayed"]))
        if feat.cz and feat.czm:
            vecs.update(cz_src=i32v(p["cz_mod_osc"]),
                        cz_del=i32v(p["cm_delayed"]))
        if feat.am:
            vecs.update(am_src=i32v(p["amp_mod_osc"]),
                        am_del=i32v(p["am_delayed"]))
    if feat.disc:
        contrib = (p["disconnect"] == 0) & active0
    else:
        contrib = active0
    return dict(vecs=vecs, active0=active0, inc_row=inc_row, dm_row=dm_row,
                contrib=contrib)


def _kernel_feat(feat):
    """The tier kernel's 14-tuple of a ``Feat``."""
    return (feat.fm, feat.cz, feat.czm, feat.env, feat.flt, feat.sm,
            feat.hold, feat.quant, feat.am, feat.am_self, feat.finish,
            feat.direction, tuple(feat.cz_modes), feat.ts_pow2)


def _tier_keys(r):
    """The keyed tier kernel's build key of every tier-kernel call the
    render makes: each tier without noise voices (with the render's mix,
    and the fold where it folds), and in the repeat-passes layout its
    estimate passes (no mix, no fold).  Per-tier features are static
    over a render, so these are all its calls' keys."""
    keys = []
    for ti in range(len(r.tiers)):
        ft = r.tier_feat(ti)
        if ft.noise:
            continue
        kf = _kernel_feat(ft)
        keys.append(tier_key(kf, r.exact, r.mix,
                             ("fm", "cz", "am") if r.folds(ti) else ()))
        if r.estimate()[0]:
            keys.append(tier_key(kf, r.exact))
    return tuple(dict.fromkeys(keys))


def _noise_keys(r):
    """The keyed noise kernels' builds of every noise tier the render
    has: (source, key) pairs."""
    keys = []
    for ti in range(len(r.tiers)):
        ft = r.tier_feat(ti)
        if ft.noise:
            keys += [("phase_walk", phase_walk_key(_pw_feat(ft))),
                     ("filt_smooth", filt_smooth_key(_fs_feat(ft)))]
    return list(dict.fromkeys(keys))


def _builds_kernels(device):
    """Whether a render on ``device`` launches the CUDA kernels."""
    return torch.device(device).type == "cuda"


def _voice_block_pass(est_vm, prev_vm, carry, p, tp, cbase, table, exact,
                      feat, n, b, out=None, mixw=None, acc=None,
                      fold=False):
    """One tier over one block through the tier kernel.

    ``out``: the tier's columns of the block buffer; ``mixw``: the
    tier's (wl, wr) lane weights, for the in-kernel mix onto ``acc``
    (the earlier tiers' accumulators, or None); ``fold``: the kernel
    reads its modulator streams from ``est_vm`` itself (``tp`` then
    holds the source vectors).  Returns (out_vm [N, V*B], contrib
    [B, V], (any_alive, il) [B, V], carry, (acc_l, acc_r) or None)."""
    v_ = p["amp"].shape[1]
    reads = {}
    bank = None
    if fold:
        bank = Fold(est_vm, prev_vm, est_vm.shape[1] // b)
    else:
        if feat.fm:
            reads["fm"] = _read_vm(est_vm, prev_vm, p["freq_mod_osc"],
                                   p["fm_delayed"], n, b)
        if feat.cz and feat.czm:
            reads["cz"] = _read_vm(est_vm, prev_vm, p["cz_mod_osc"],
                                   p["cm_delayed"], n, b)
        if feat.am:
            reads["am"] = _read_vm(est_vm, prev_vm, p["amp_mod_osc"],
                                   p["am_delayed"], n, b)
    fin_prev = carry["finished"] != 0
    vecs = dict(tp["vecs"])
    vecs["adv"] = to_vm_vec((tp["active0"] & ~fin_prev).to(I32))
    f32v = lambda a: to_vm_vec(a.to(F32))
    i32v = lambda a: to_vm_vec(a.to(I32))
    states = {"phase": f32v(carry["phase"])}
    if feat.finish:
        states["finished"] = i32v(carry["finished"])
    if feat.flt:
        states.update({k: f32v(carry[k]) for k in ("x1", "x2", "y1", "y2")})
    if feat.sm:
        states["smoother"] = f32v(carry["smoother"])
    if feat.hold:
        states["hold_count"] = i32v(carry["hold_count"])
        states["hold_val"] = f32v(carry["hold_val"])
    out, res = tier(table, cbase,
                    reads.get("fm") if feat.fm else tp["inc_row"],
                    reads.get("cz", tp["dm_row"]), reads.get("am"),
                    vecs, states, feat=_kernel_feat(feat), exact=exact,
                    n=n, b=b, mixw=mixw, acc=acc, fold=bank, out=out)
    back = lambda a: from_vm_vec(a, b, v_)
    cnt = back(res["cnt"])
    new_carry = dict(
        phase=back(res["phase"]),
        finished=back(res["finished"]) if feat.finish
        else carry["finished"],
        sample=back(res["out_last"] if mixw is not None else out[n - 1]),
        hold_count=back(res["hold_count"]) if feat.hold
        else carry["hold_count"],
        hold_val=back(res["hold_val"]) if feat.hold else carry["hold_val"],
        x1=back(res["x1"]) if feat.flt else carry["x1"],
        x2=back(res["x2"]) if feat.flt else carry["x2"],
        y1=back(res["y1"]) if feat.flt else carry["y1"],
        y2=back(res["y2"]) if feat.flt else carry["y2"],
        smoother=back(res["smoother"]) if feat.sm else carry["smoother"],
        pan_l=carry["pan_l"], pan_r=carry["pan_r"],
    )
    il = torch.clamp(cnt - 1, 0, n - 1)
    macc = (res["acc_l"], res["acc_r"]) if mixw is not None else None
    return out, tp["contrib"], (cnt >= 1, il), new_carry, macc


# ---- noise-voice tiers: phase walk -> lookup -> filter/smoother ----

def _pw_feat(feat):
    """The keyed phase walk's feature tuple of a ``Feat``."""
    return (feat.fm, feat.finish, feat.direction, feat.cz, feat.czm,
            tuple(feat.cz_modes), feat.ts_pow2)


def _fs_feat(feat):
    """The keyed filter/smoother's feature tuple of a ``Feat``."""
    return (feat.flt, feat.sm, feat.hold, feat.quant, feat.am_self,
            feat.env, feat.am, feat.finish)


def _noise_inputs(est_vm, prev_vm, carry, tp, feat, b):
    """A noise pass's kernel inputs in lane order: (bank, vecs, phase0,
    fin0, start states)."""
    f32v = lambda a: to_vm_vec(a.to(F32))
    i32v = lambda a: to_vm_vec(a.to(I32))
    v = dict(tp["vecs"])
    # noise voices hold their phase
    v["adv"] = to_vm_vec((tp["adv0"] & ~(carry["finished"] != 0)).to(I32))
    bank = None if est_vm is None \
        else Fold(est_vm, prev_vm, est_vm.shape[1] // b)
    states = {}
    if feat.flt:
        states.update({k: f32v(carry[k]) for k in ("x1", "x2", "y1", "y2")})
    if feat.sm:
        states["smoother"] = f32v(carry["smoother"])
    if feat.hold:
        states.update(hold_count=i32v(carry["hold_count"]),
                      hold_val=f32v(carry["hold_val"]))
    return (bank, v, f32v(carry["phase"]),
            i32v(carry["finished"]) if feat.finish else None, states)


def _noise_pass(est_vm, prev_vm, carry, p, tp, cbase, table, exact, feat,
                n, b, noise_blk, out=None):
    """One noise-voice tier over one block: the port of the JAX package's
    ``_voice_block_pass`` on its Pallas non-mega branch
    (``skred_tpu/engine/fused.py:379-781``), in three kernels: the walk
    with the modulator reads, the FM increment, the CZ warp and the clip
    (``phase_walk_warp``); the table lookup; the noise select, dead mask,
    envelope, am stream and serial stages (``filt_smooth_noise``).  ``tp``
    is the tier's ``_pass_params``; ``out`` the tier's columns of the
    block buffer.  Returns what ``_voice_block_pass`` returns, with no
    accumulators: a noise tier's voices mix in torch."""
    v_ = p["amp"].shape[1]
    bank, v, phase0, fin0, states = _noise_inputs(est_vm, prev_vm, carry, tp,
                                                  feat, b)
    idx, cnt, ph_end, fin_end = phase_walk_warp(
        bank, v, phase0, fin0, feat=_pw_feat(feat), n=n, b=b)
    f = lookup(table, v["base_off"], v["limit"], idx)
    out, ends = filt_smooth_noise(f, noise_blk, cnt, cbase, bank, v, states,
                                  feat=_fs_feat(feat), b=b, out=out)

    back = lambda a: from_vm_vec(a, b, v_)
    cnt = back(cnt)
    kept = lambda k: back(ends[k]) if k in ends else carry[k]
    new_carry = dict(
        phase=back(ph_end),
        finished=back(fin_end) if feat.finish else carry["finished"],
        sample=back(out[n - 1]),
        **{k: kept(k) for k in ("hold_count", "hold_val", "x1", "x2", "y1",
                                "y2", "smoother")},
        pan_l=carry["pan_l"], pan_r=carry["pan_r"],
    )
    il = torch.clamp(cnt - 1, 0, n - 1)
    return out, tp["contrib"], (cnt >= 1, il), new_carry, None


def _mix_mask(p, feat):
    """[B, Vp] the lanes whose static pan the tier kernel mixes: active,
    connected, not pan-modulated (those ride ``_mix_parts``' slab)."""
    mask = p["amp"] != 0.0
    if feat.disc:
        mask = mask & (p["disconnect"] == 0)
    if feat.pm and feat.pm_lanes:
        mask = mask.clone()
        mask[:, list(feat.pm_lanes)] = False
    return mask


def _voice_sum(x):
    """[N, V, B] -> [N, B]: the sum over voices in a fixed pairwise tree
    (V zero-padded to a power of two, then halved: voice v adds voice
    v + h).  Every step is an elementwise add, so a row's sum does not
    depend on the batch's row count or layout, as ``torch.sum``'s order
    does: a shard of a batch mixes as the whole batch does, and the card
    as the CPU."""
    v = x.shape[1]
    w = 1 << max(v - 1, 0).bit_length()
    if w != v:
        x = torch.nn.functional.pad(x, (0, 0, 0, w - v))
    while w > 1:
        w //= 2
        x = x[:, :w] + x[:, w:2 * w]
    return x[:, 0]


def _mix_parts(carry, p, parts, feat, n, b, acc=None, caps=None):
    """Stereo mix of the tiers' kernel outputs ([N, B] each channel).

    parts: list of (out_vm, contrib [B, V_t], any_alive, il, (ts, te),
    mixed); ``acc``: the accumulator pair the tier kernel summed the
    static-pan lanes of the ``mixed`` parts into.  The other parts'
    static-pan lanes sum out·pan over voices here; pan-modulated lanes
    (feat.pm_lanes) take a per-sample pan from their modulator (or
    their own sample), and their pan carry freezes at the last alive
    sample.  With ``caps`` (a list; no part mixed, the capture path of
    ``skred_tpu/engine/fused.py:1441-1482``) every lane's post-pan
    stereo pair, zero where the lane does not sound, is appended to it
    as ``[B, Vp, N, 2]``.  Returns (mix_l, mix_r, pan update or None)."""
    pms_lanes = tuple(feat.pm_lanes) if feat.pm else ()
    srcs = tuple(feat.pm_srcs)
    mix_l = mix_r = None
    pm_s, pm_c, pm_aa, pm_il, src_s = [], [], [], [], []
    cap_l, cap_r = [], []
    for out_vm, contrib_t, aa_t, il_t, (ts, te), mixed in parts:
        o3 = out_vm.view(n, te - ts, b)
        loc = [v - ts for v in pms_lanes if ts <= v < te]
        if not mixed:
            wl = torch.where(contrib_t, carry["pan_l"][:, ts:te], 0.0)
            wr = torch.where(contrib_t, carry["pan_r"][:, ts:te], 0.0)
        if loc:
            pm_s.append(o3[:, loc])
            pm_c.append(contrib_t[:, loc])
            pm_aa.append(aa_t[:, loc])
            pm_il.append(il_t[:, loc])
            if not mixed:
                stat = torch.ones(te - ts, dtype=torch.bool,
                                  device=wl.device)
                stat[loc] = False
                wl = torch.where(stat, wl, 0.0)
                wr = torch.where(stat, wr, 0.0)
        sloc = [v - ts for v in srcs if ts <= v < te]
        if sloc:
            src_s.append(o3[:, sloc])
        if mixed:
            continue
        lw, rw = o3 * wl.T[None], o3 * wr.T[None]
        if caps is not None:
            sounds = contrib_t.T[None]
            cap_l.append(torch.where(sounds, lw, 0.0))
            cap_r.append(torch.where(sounds, rw, 0.0))
        l_t, r_t = _voice_sum(lw), _voice_sum(rw)
        mix_l = l_t if mix_l is None else mix_l + l_t
        mix_r = r_t if mix_r is None else mix_r + r_t
    if acc is not None:
        mix_l = acc[0] if mix_l is None else mix_l + acc[0]
        mix_r = acc[1] if mix_r is None else mix_r + acc[1]
    pan_upd = None
    if pms_lanes:
        lanes, lpm, rpm, new_pl, new_pr = _pan_mod_mix(
            carry, p, feat, b, pm_s, pm_c, pm_aa, pm_il, src_s)
        mix_l = mix_l + _voice_sum(lpm)
        mix_r = mix_r + _voice_sum(rpm)
        pan_upd = (lanes, new_pl, new_pr)
    if caps is not None:
        left, right = torch.cat(cap_l, dim=1), torch.cat(cap_r, dim=1)
        if pan_upd is not None:
            left[:, lanes], right[:, lanes] = lpm, rpm
        caps.append(torch.stack([left, right], dim=-1).permute(2, 1, 0, 3))
    return mix_l, mix_r, pan_upd


def _pan_mod_mix(carry, p, feat, b, pm_s, pm_c, pm_aa, pm_il, src_s):
    """The pan-modulated lanes of ``_mix_parts``: their post-pan samples
    ``[N, P, B]`` (zero where a lane does not sound) and their pan
    carry, frozen at the last alive sample.  Returns (lanes, left,
    right, new pan_l, new pan_r)."""
    srcs = tuple(feat.pm_srcs)
    pms = torch.cat(pm_s, dim=1)                     # [N, P, B]
    cpm = torch.cat(pm_c, dim=1).T                   # [P, B]
    aa = torch.cat(pm_aa, dim=1)                     # [B, P]
    il = torch.cat(pm_il, dim=1)
    lanes = list(feat.pm_lanes)
    pm_osc = p["pan_mod_osc"][:, lanes]              # [B, P]
    if srcs:
        est = torch.cat(src_s, dim=1)                # [N, S, B]
        sidx = torch.tensor(srcs, dtype=pm_osc.dtype, device=pm_osc.device)
        hit = pm_osc[..., None] == sidx              # [B, P, S]
        valid = hit.any(-1)
        j = hit.to(I32).argmax(-1).long()            # [B, P]
        bb = torch.arange(b, device=j.device)[:, None]
        src = est[:, j, bb]                          # [N, B, P]
        src = torch.where(valid, src, 0.0).permute(0, 2, 1) + 0.0
        last = carry["sample"][:, list(srcs)][bb, j]  # [B, P]
        last = torch.where(valid, last, 0.0).T + 0.0
        shifted = torch.cat([last[None], src[:-1]], dim=0)
        pm_read = torch.where(p["pm_delayed"][:, lanes].T[None] != 0,
                              shifted, src)
    else:
        pm_read = torch.zeros_like(pms)
    if feat.pm_self:
        pm_read = torch.where(p["pm_self"][:, lanes].T[None] != 0, pms,
                              pm_read)
    qv = pm_read * p["pan_mod_depth"][:, lanes].T[None]
    pan_on = (pm_osc >= 0) & (p["disconnect"][:, lanes] == 0)   # [B, P]
    pl = torch.where(pan_on.T[None], (1.0 - qv) * 0.5,
                     carry["pan_l"][:, lanes].T[None])
    pr = torch.where(pan_on.T[None], (1.0 + qv) * 0.5,
                     carry["pan_r"][:, lanes].T[None])
    # pan carry freezes at the last alive sample
    il_t = il.T.long()[None]                          # [1, P, B]
    act_pan = pan_on & aa
    new_pl = torch.where(act_pan, pl.gather(0, il_t)[0].T + 0.0,
                         carry["pan_l"][:, lanes])
    new_pr = torch.where(act_pan, pr.gather(0, il_t)[0].T + 0.0,
                         carry["pan_r"][:, lanes])
    return (lanes, torch.where(cpm[None], pms * pl, 0.0),
            torch.where(cpm[None], pms * pr, 0.0), new_pl, new_pr)


def _apply_ops_b(carry, ops, flag, feat=Feat()):
    """Segment-start ops (set phase/finished/sample/smoother/pan, clear
    filter, copy hold) on the rows where ``flag`` [B, 1] is set."""
    c = dict(carry)
    on = lambda k: flag & (ops[k] != 0)
    c["phase"] = torch.where(on("set_phase"), ops["phase"], carry["phase"])
    c["finished"] = torch.where(on("set_finished"), ops["finished"],
                                carry["finished"])
    c["sample"] = torch.where(on("set_sample"), ops["sample"],
                              carry["sample"])
    for k in ("x1", "x2", "y1", "y2"):
        c[k] = torch.where(on("clear_filter"), 0.0, carry[k])
    c["smoother"] = torch.where(on("set_smoother"), ops["smoother"],
                                carry["smoother"])
    c["pan_l"] = torch.where(on("set_pan"), ops["pan_left"], carry["pan_l"])
    c["pan_r"] = torch.where(on("set_pan"), ops["pan_right"],
                             carry["pan_r"])
    if not feat.hold_copy:
        return c
    src = ops["copy_hold_from"].clamp(min=0).long()
    do = flag & (ops["copy_hold_from"] >= 0)
    c["hold_count"] = torch.where(do, torch.gather(carry["hold_count"], 1,
                                                   src), c["hold_count"])
    c["hold_val"] = torch.where(do, torch.gather(carry["hold_val"], 1, src),
                                c["hold_val"])
    return c


def make_carry0(B, Vp, device="cuda"):
    z = lambda dt: torch.zeros((B, Vp), dtype=dt, device=device)
    return dict(
        phase=z(F32), finished=z(I32), sample=z(F32), hold_count=z(I32),
        hold_val=z(F32), x1=z(F32), x2=z(F32), y1=z(F32), y2=z(F32),
        smoother=z(F32), pan_l=z(F32), pan_r=z(F32),
        vol_gain=torch.zeros((B,), dtype=F32, device=device))


def _pack_by_dtype(arrs: dict, Vp: int):
    """Group [B, S, Vp] tensors by dtype and stack each group into one
    [B, S, P, Vp] tensor, so the per-block segment gather is a few big
    gathers instead of one per parameter."""
    groups = {}
    rest = []
    for k in sorted(arrs):
        v = arrs[k]
        if v.ndim == 3 and v.shape[2] == Vp:
            groups.setdefault(v.dtype, []).append(k)
        else:
            rest.append(k)
    stacked = {dt: torch.stack([arrs[k] for k in keys], dim=2)
               for dt, keys in groups.items()}
    return groups, stacked, rest


# ---- the block loop ----

@dataclasses.dataclass
class Plan:
    """The static routing of a packed batch's blocks: which kernels each
    tier runs, on which lanes, and where its modulator streams come
    from.  The block loop, its kernel builds and the roofline model
    (``parallel/roofline.py``) all read it, so the routing is decided
    here once."""
    Vp: int
    tiers: tuple                  # voices per tier; (Vp,) without tiers
    feat: Feat
    feat_tiers: Optional[tuple]   # per-tier features (None: one tier)
    mix: bool                     # tier-kernel tiers mix in the kernel
    fold_tiers: Optional[tuple]   # per-tier bank fold (None: none folds)
    mod_passes: int
    n_src: int                    # modulator-source prefix (no tiers)

    @property
    def any_mod(self) -> bool:
        f = self.feat
        return bool(f.fm or (f.cz and f.czm) or f.am)

    def tier_feat(self, ti) -> Feat:
        return self.feat_tiers[ti] if self.feat_tiers is not None \
            else self.feat

    def folds(self, ti) -> bool:
        """Tier ``ti`` reads its streams from the bank in the kernel."""
        return bool(self.fold_tiers and self.fold_tiers[ti])

    def streams_in(self, ti) -> bool:
        """Tier ``ti`` reads modulator streams: the earlier tiers'
        columns of the block buffer, or in a batch of one tier its
        estimate passes' output."""
        return self.any_mod and (ti > 0 or len(self.tiers) == 1)

    def estimate(self) -> tuple:
        """(passes, voices) of the estimate passes each block of a
        one-tier batch runs before its last pass: ``mod_passes - 1``
        passes over the modulator-source prefix where the pack made one,
        else over all voices; (0, 0) where there are none."""
        if len(self.tiers) != 1 or not self.any_mod or self.mod_passes < 2:
            return 0, 0
        ns = self.n_src
        return self.mod_passes - 1, ns if 0 < ns < self.Vp else self.Vp


def plan(st, mix: bool = True, fold: bool = True) -> Plan:
    """The ``Plan`` of a packed batch as the renderer takes it with these
    ``mix`` and ``fold`` options (see the module docstring)."""
    feat = compute_feat(st)
    vp = int(np.asarray(st.params["amp"]).shape[-1])
    fts = _feat_tiers(st)
    return Plan(Vp=vp, tiers=tuple(st.tiers) if st.tiers else (vp,),
                feat=feat, feat_tiers=fts,
                # only a tier that takes the tier kernel mixes in it
                mix=bool(mix) and not all(ft.noise for ft in fts or (feat,)),
                fold_tiers=_fold_tiers(st, fts) if fold else None,
                mod_passes=st.fused_passes, n_src=int(st.n_src or 0))


@dataclasses.dataclass
class _Render(Plan):
    """A packed batch on the device, ready for the block loop."""
    params: dict
    ops: dict
    seg_of_block: torch.Tensor
    seg_is_start: torch.Tensor
    table: torch.Tensor
    B: int
    block: int
    exact: bool
    single_seg: bool
    buf: Optional[torch.Tensor] = None       # [N, Vp*B] block buffer
    p_const: Optional[dict] = None
    o_const: Optional[dict] = None
    groups: Optional[tuple] = None
    tier_params: Optional[list] = None
    src_params: Optional[dict] = None        # the source prefix's params
    mix_mask: Optional[torch.Tensor] = None  # [B, Vp] _mix_mask
    noise: Optional[torch.Tensor] = None     # the render's noise stream


def _tier_slice(p, ts, te, Vp):
    """The [B, Vp] per-voice entries of ``p`` cut to lanes [ts, te)."""
    return {k: (v[:, ts:te] if v.ndim == 2 and v.shape[1] == Vp else v)
            for k, v in p.items()}


def _gather_seg(groups, arrs, seg, B):
    p_groups, p_stacked, p_rest = groups
    ar = torch.arange(B, device=seg.device)
    out = {}
    for dt, keys in p_groups.items():
        blk = p_stacked[dt][ar, seg]               # [B, P, Vp]
        for i, k in enumerate(keys):
            out[k] = blk[:, i]
    for k in p_rest:
        out[k] = arrs[k][ar, seg]
    return out


def _pass_params(p_t, full_inc, ft, fold=False):
    """A tier's per-lane vectors (``_tier_params``).  A noise tier's pass
    reads its modulator streams from the bank in its kernels (the source
    vectors of a fold), and takes the lookup's per-lane limit, the
    noise-voice mask and the constant increment or CZ offset of a tier
    without fm or cz-mod in ``vecs``."""
    tp = _tier_params(p_t, full_inc, ft, fold or ft.noise)
    if ft.noise:
        is_noise = p_t["table_index"] == C.WAVE_TABLE_NOISE_ALT
        v = tp["vecs"]
        # limit = max(size, 1): an empty table reads its first entry, as
        # the XLA branch's table_buffer[table_off + idx] does
        v["limit"] = to_vm_vec(torch.clamp(p_t["table_size"], min=1).to(I32))
        v["is_noise"] = to_vm_vec(is_noise.to(I32))
        if tp["inc_row"] is not None:
            v["inc"] = tp["inc_row"]
        if tp["dm_row"] is not None:
            v["dm"] = tp["dm_row"]
        tp["adv0"] = tp["active0"] & ~is_noise
    return tp


def _estimate(r, run, carry, p, tp, prev_vm, cbase):
    """The last pass's modulator estimate where the batch has one tier
    or none (the repeat-passes layout): it starts as the previous
    block's last samples, and each of the ``mod_passes - 1`` earlier
    passes renders into a tensor of its own, over the ``n_src``
    modulator-source prefix only where the pack made one (no other
    voice is read).  Returns [N, Vp*B]."""
    B, n = r.B, r.block
    est = prev_vm[None].expand(n, -1)
    args = (cbase, r.table, r.exact, r.feat, n, B)
    passes, ns = r.estimate()
    if passes and ns < r.Vp:
        p_s = _tier_slice(p, 0, ns, r.Vp)
        c_s = _tier_slice(carry, 0, ns, r.Vp)
        tp_s = r.src_params if r.single_seg \
            else _pass_params(p_s, p["phase_inc"], r.feat)
        for _ in range(passes):
            s_src = run(est[:, :ns * B], prev_vm[:ns * B], c_s, p_s, tp_s,
                        *args)[0]
            est = torch.cat([s_src, est[:, ns * B:]], dim=1)
    else:
        for _ in range(passes):
            est = run(est, prev_vm, carry, p, tp, *args)[0]
    return est


def _block_step(r: _Render, carry, k_glob, caps=None):
    """One 512-sample block: every tier through its pass (the tier
    kernel, or the noise pass for a tier with noise voices), then the mix
    and the volume smoother.  With ``caps`` (a list; the render's mix and
    fold off) the block's per-voice stereo pairs are appended to it.
    Returns (carry, out [N, B, 2])."""
    with spans.span("fused.block"):
        B, n = r.B, r.block
        with spans.span("fused.ops"):
            if r.single_seg:
                p, o = r.p_const, r.o_const
            else:
                seg = r.seg_of_block[:, k_glob]
                p = _gather_seg(r.groups[0], r.params, seg, B)
                o = _gather_seg(r.groups[1], r.ops, seg, B)
            carry = _apply_ops_b(carry, o,
                                 r.seg_is_start[:, k_glob][:, None], r.feat)
        cbase = k_glob * n + 1           # 1-based global sample count
        feat = r.feat
        bounds = np.cumsum((0,) + tuple(r.tiers))
        layered = len(r.tiers) > 1
        # taken after the segment-start ops: a delayed read at t = 0 sees a
        # sample the segment has just set
        prev_vm = to_vm_vec(carry["sample"])
        full_inc = p["phase_inc"]
        nblk = None if r.noise is None \
            else r.noise[k_glob * n:(k_glob + 1) * n]
        if r.mix:
            mask = r.mix_mask if r.single_seg else _mix_mask(p, feat)
            wl_vm = to_vm_vec(torch.where(mask, carry["pan_l"], 0.0))
            wr_vm = to_vm_vec(torch.where(mask, carry["pan_r"], 0.0))
        parts, nc_parts = [], []
        acc = None                       # the kernel-mixed tiers' sums
        for ti in range(len(r.tiers)):
            with spans.span("fused.tier"):
                ts, te = int(bounds[ti]), int(bounds[ti + 1])
                p_t = _tier_slice(p, ts, te, r.Vp)
                c_t = _tier_slice(carry, ts, te, r.Vp)
                ft = r.tier_feat(ti)
                fold = r.folds(ti)
                if ft.noise:
                    run = functools.partial(_noise_pass, noise_blk=nblk)
                else:
                    run = _voice_block_pass
                if r.single_seg:
                    tp = r.tier_params[ti]
                else:
                    tp = _pass_params(p_t, full_inc, ft, fold)
                if not r.streams_in(ti):
                    est = None
                elif layered:
                    # earlier tiers' columns of the block buffer are the bank
                    est = r.buf[:, :ts * B]
                else:
                    # fixed-point passes read columns that have not converged
                    est = _estimate(r, run, c_t, p_t, tp, prev_vm, cbase)
                out_cols = r.buf[:, ts * B:te * B]
                kw = dict(out=out_cols)
                if not ft.noise:
                    kw["fold"] = fold
                    if r.mix:
                        kw.update(mixw=(wl_vm[ts * B:te * B],
                                        wr_vm[ts * B:te * B]), acc=acc)
                out_t, contrib_t, (aa_t, il_t), nc_t, macc = run(
                    est, prev_vm[:ts * B] if layered else prev_vm, c_t, p_t,
                    tp, cbase, r.table, r.exact, ft, n, B, **kw)
                if macc is not None:
                    acc = macc
                nc_parts.append(nc_t)
                parts.append((out_t, contrib_t, aa_t, il_t, (ts, te),
                              macc is not None))
        with spans.span("fused.mix"):
            new_carry = {kk: torch.cat([nc[kk] for nc in nc_parts], dim=1)
                         for kk in _CK}
            mix_l, mix_r, pan_upd = _mix_parts(carry, p, parts, feat, n, B,
                                               acc, caps)
            if pan_upd is not None:
                lanes, new_pl, new_pr = pan_upd
                new_carry["pan_l"][:, lanes] = new_pl
                new_carry["pan_r"][:, lanes] = new_pr
        with spans.span("fused.volume"):
            vf = p["volume_final"]                  # [B]
            a = f32(np.float32(1.0) - np.float32(0.002))
            vg = _affine_scan(torch.full_like(vf, a)[None],
                              (f32(0.002) * vf)[None].expand(n, B),
                              carry["vol_gain"])    # [N, B]
            new_carry["vol_gain"] = vg[-1]
            return new_carry, torch.stack([mix_l * vg, mix_r * vg], dim=-1)


def from_stacked(st, device="cuda") -> dict:
    """A packed StackedTimelines (this package's or the JAX package's:
    the fields are the same numpy arrays) as the port's tensors:
    params and ops [B, S, V] on ``device``, seg_of_block / seg_is_start
    as numpy [B, NB], the flat table buffer, and the zero carry."""
    from skred_tpu_torch.parallel.batch import _prep_params

    params = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
              for k, v in _prep_params(st).items()}
    ops = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
           for k, v in st.ops.items()}
    return dict(params=params, ops=ops,
                seg_of_block=np.asarray(st.seg_of_block),
                seg_is_start=np.asarray(st.seg_is_start),
                table_buffer=torch.as_tensor(
                    np.asarray(st.table_buffer, np.float32), device=device),
                carry=make_carry0(st.batch, params["amp"].shape[-1],
                                  device))


def _packed(st, capture=False, mix=True, fold=True, pack=True):
    """(packed batch, its ``Plan``): ``pack_stacked(st, pack=pack)``
    unless ``st`` is packed.  ``mix`` and ``fold`` choose the tier
    kernel's in-kernel stereo mix and modulator-bank fold (see the module
    docstring); ``capture`` turns both off, as the JAX package does
    (``skred_tpu/engine/fused.py:1410``)."""
    from skred_tpu_torch.parallel.batch import pack_stacked

    if st.fused_passes is None:
        raise ValueError(
            "cyclic modulation graph (1-sample feedback): the fused "
            "engine cannot render it; use engine.cyclic.render_cyclic")
    if capture:
        mix = fold = False
    with spans.span("fused.pack"):
        if "fm_delayed" not in st.params:
            st = pack_stacked(st, pack=pack)
        return st, plan(st, mix, fold)


def _prepare(st, exact, device, capture=False, noise_blocks=None,
             noise=None, mix=True, fold=True, pl=None):
    """The batch on ``device`` for the block loop; the noise stream
    (``noise``, or the engine's own), when a tier has noise voices,
    covers ``noise_blocks`` (default: all) blocks.  ``pl``: the plan to
    render ``st`` (packed) by, a larger batch's when ``st`` is a shard of
    it; else ``_packed``'s."""
    with spans.span("fused.prepare"):
        if pl is None:
            st, pl = _packed(st, capture, mix, fold)
        feat = pl.feat
        if exact is None:
            exact = True
        # the kernel reads table_off + [0, table_size) unchecked: hold every
        # lane's table inside the buffer here, on the host
        end = (np.asarray(st.params["table_off"], np.int64)
               + np.maximum(np.asarray(st.params["table_size"], np.int64), 1))
        if end.size and int(end.max()) > np.asarray(st.table_buffer).size:
            raise ValueError("a lane's table runs past the table buffer")
        d = from_stacked(st, device)
        params, ops = d["params"], d["ops"]
        Vp = pl.Vp
        single_seg = all(v.shape[1] == 1 for v in params.values()) \
            and all(v.shape[1] == 1 for v in ops.values())
        r = _Render(**{f.name: getattr(pl, f.name)
                       for f in dataclasses.fields(Plan)},
                    params=params, ops=ops,
                    seg_of_block=torch.as_tensor(d["seg_of_block"],
                                                 device=device).long(),
                    seg_is_start=torch.as_tensor(d["seg_is_start"],
                                                 device=device),
                    table=d["table_buffer"], B=st.batch, block=st.block,
                    exact=bool(exact), single_seg=single_seg,
                    buf=torch.empty((st.block, Vp * st.batch), dtype=F32,
                                    device=device))
        if feat.noise:
            nb = st.num_blocks if noise_blocks is None else noise_blocks
            stream = noise_stream(nb * st.block) if noise is None \
                else np.asarray(noise, np.float32)[:nb * st.block]
            r.noise = torch.as_tensor(stream, device=device)
        if single_seg:
            r.p_const = {k: v[:, 0] for k, v in params.items()}
            r.o_const = {k: v[:, 0] for k, v in ops.items()}
            bounds = np.cumsum((0,) + r.tiers)
            r.tier_params = []
            for ti in range(len(r.tiers)):
                ts, te = int(bounds[ti]), int(bounds[ti + 1])
                p_t = _tier_slice(r.p_const, ts, te, Vp)
                r.tier_params.append(_pass_params(
                    p_t, r.p_const["phase_inc"], r.tier_feat(ti), r.folds(ti)))
            passes, ns = r.estimate()
            if passes and ns < Vp:
                r.src_params = _pass_params(
                    _tier_slice(r.p_const, 0, r.n_src, Vp),
                    r.p_const["phase_inc"], feat)
            r.mix_mask = _mix_mask(r.p_const, feat)
        else:
            r.groups = (_pack_by_dtype(params, Vp), _pack_by_dtype(ops, Vp))
        if _builds_kernels(device):
            from skred_tpu_torch.engine.kernels import build

            # every tier and noise key at once, in parallel, before the first
            # block (a failed build raises)
            build.build_all([("tier", key) for key in _tier_keys(r)]
                            + _noise_keys(r))
        return st, r, d["carry"]


def _render_chunk(r: _Render, carry, block0, nb, caps=None):
    outs = []
    for k in range(nb):
        carry, o = _block_step(r, carry, block0 + k, caps=caps)
        outs.append(o)
    return carry, torch.stack(outs)               # [nb, N, B, 2]


def _shard_blocks(r: _Render, carry, nb, caps=None):
    """Generator over the blocks of one shard's render: each block's
    ``[N, B, 2]`` on the shard's device."""
    for k in range(nb):
        carry, o = _block_step(r, carry, k, caps=caps)
        yield o


def render_fused(st, noise: Optional[np.ndarray] = None, mesh=None,
                 capture: bool = False, exact: Optional[bool] = None,
                 pack: bool = True, *, device="cuda", mix: bool = True,
                 fold: bool = True):
    """Render a StackedTimelines batch with the fused engine → numpy
    [B, T, 2]; with ``capture`` also each voice's post-pan stereo pair
    as the JAX package returns it, ``[num_blocks, B, Vp, block, 2]``
    (packed voice order).  The JAX package's arguments, in its order
    (its ``use_pallas`` has no counterpart: the kernel route is the
    plan's): ``noise``, the noise stream (default the engine's own);
    ``mesh``, a list of devices (``parallel.batch.make_mesh``) that the
    batch's rows are split over, data-parallel; ``pack=False`` packs
    every voice (``pack_stacked(st, pack=False)``) where ``st`` is not
    packed yet.  Runs on the card unless ``device="cpu"`` (without a
    mesh).  ``mix`` and ``fold``: see the module docstring.

    Under a mesh the batch is packed and planned once, whole, and then
    split into runs of rows, one a mesh entry: every shard renders by
    the whole batch's plan (its tier keys and lanes), with the same
    noise stream and table buffer, so the audio is the unsplit render's
    bit for bit.  The shards' blocks are stepped in turn, so the cards
    of a mesh work at once while the host queues the next shard's
    block.

    The audio leaves each card in chunks while the loop runs
    (``engine/download.py``); the result is a numpy array of the
    caller's own, written once."""
    from skred_tpu_torch.parallel.batch import shard_rows, take_rows

    with spans.span("fused.render"):
        st, pl = _packed(st, capture, mix, fold, pack)
        split = shard_rows(st.batch, [device] if mesh is None else mesh)
        shards = []

        def start():
            for dev, rows in split:
                _, r, carry = _prepare(take_rows(st, rows), exact, dev,
                                       capture, noise=noise, pl=pl)
                shards.append((r, carry, [] if capture else None))
            return zip(*(_shard_blocks(r, carry, st.num_blocks, caps)
                         for r, carry, caps in shards))

        out = download.run("fused", split, st.num_blocks, st.block, start)
        if capture:
            caps = torch.cat([torch.stack(c).cpu() for _, _, c in shards],
                             dim=1).numpy()
    return (out, caps) if capture else out


def render_fused_device(st, noise=None, exact: Optional[bool] = None,
                        device="cuda", mix: bool = True,
                        fold: bool = True) -> torch.Tensor:
    """Like render_fused but keeps the result on ``device``, as a tensor
    ``[num_blocks, B, block, 2]`` (for benchmarks and pipelines where the
    download would dominate).  A cyclic batch is a ValueError.  Runs on
    the card unless ``device="cpu"``."""
    st, r, carry = _prepare(st, exact, device, noise=noise, mix=mix,
                            fold=fold)
    with torch.no_grad():
        _, outs = _render_chunk(r, carry, 0, st.num_blocks)
    return outs.transpose(1, 2).contiguous()


def render_fused_stream(st, chunk_blocks: int = 256, noise=None,
                        exact: Optional[bool] = None,
                        keep_rows: Optional[int] = None, device="cuda",
                        mix: bool = True, fold: bool = True):
    """Generator yielding rendered chunks as numpy ``[rows, chunk*block,
    2]`` (the last chunk may be shorter): device memory is bounded by the
    chunk, whatever the render's length, and the carry goes from chunk
    to chunk.  ``keep_rows`` downloads only the first rows of each chunk
    (a replicated batch skips the transfer of redundant rows).  Runs on
    the card unless ``device="cpu"``."""
    st, r, carry = _prepare(st, exact, device, noise=noise, mix=mix,
                            fold=fold)
    rows = st.batch if keep_rows is None else min(keep_rows, st.batch)
    for b0 in range(0, st.num_blocks, chunk_blocks):
        nb = min(chunk_blocks, st.num_blocks - b0)
        with torch.no_grad():
            carry, outs = _render_chunk(r, carry, b0, nb)
        yield outs[:, :, :rows].permute(2, 0, 1, 3).reshape(
            rows, nb * st.block, 2).cpu().numpy()


def render_fused_stream_device(st, chunk_blocks: int = 173,
                               exact: Optional[bool] = None,
                               warmup_only: bool = False,
                               device="cuda", mix: bool = True,
                               fold: bool = True) -> float:
    """Streamed render that keeps the carry and the audio on the device,
    chunk by chunk (only whole chunks render, as in the JAX package);
    returns a checksum, the |out| sum of the final chunk in f64."""
    whole = (st.num_blocks // chunk_blocks) * chunk_blocks
    st, r, carry = _prepare(st, exact, device, noise_blocks=whole, mix=mix,
                            fold=fold)
    outs = None
    with torch.no_grad():
        for b0 in range(0, whole, chunk_blocks):
            carry, outs = _render_chunk(r, carry, b0, chunk_blocks)
            if warmup_only:
                break
    if outs is None:
        return 0.0
    return float(outs.abs().sum(dtype=torch.float64))
