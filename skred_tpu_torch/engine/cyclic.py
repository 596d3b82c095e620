"""Cyclic-graph engine: scripts with 1-sample feedback loops.

The fused block renderer cannot render a cyclic modulation graph (a
mutual-FM pair, a ring of mixed edges, CZ self-modulation): a block pass
per tier has no order to run a cycle in.  Such a batch renders here, block
by block, through one kernel (``engine/kernels/cyclic.py``) that runs the
reference's per-frame voice loop (synth.c:526-612) serially, one lane per
batch row:

  * voices evaluate in packed order, ascending ORIGINAL index
    (``pack_stacked(cyclic=True)``); a modulator read takes this frame's
    sample of a lower-index voice and the previous frame's otherwise, by
    the packed ``*_delayed`` flags.  A CZ self edge is delayed by
    construction (synth.c:263-264 reads voice_sample[dv] before the frame
    writes it), so self-feedback needs no special case;
  * each voice reads its table from the flat buffer at its ``table_off``;
    the table's size is no limit.  The JAX package's per-voice table
    windows (``win_rows_for``, its window budget) are a TPU memory plan
    and are not ported;
  * arithmetic mirrors the JAX kernel site for site in exact mode.

Eligibility (``cyclic_gate``): per-voice table bindings uniform across
the batch, because the kernel takes one table base per voice.  Buckets
are built per script identity, so every batch ``render_batch`` makes
passes.

``render_cyclic`` renders one batch through the block-loop engines'
download (``engine/download.py``): the audio leaves the card in chunks
while the block loop runs and lands in one array of the caller's own.
With a mesh it splits the batch's rows over its devices as
``render_fused`` does, every shard rendered by the whole batch's
features, noise stream and schedule.  ``render_batch`` renders each
group of its cyclic scripts (those that share a
``parallel.batch.cyclic_group_key``) as one batch through it.

Spans (``spans.py``): ``cyclic.render`` around ``render_cyclic``;
``cyclic.prepare`` (every entry point's set-up, once a call), inside it
``cyclic.schedule`` (``n`` = the general kernel's waves a frame);
``cyclic.block_loop``
(``n`` = blocks) and each ``cyclic.block``, inside which the kernel's
wrapper records ``kernel.cyclic`` (``n`` = packed voices);
``cyclic.download`` and inside it ``cyclic.download_tail`` (``n`` = blocks
not yet in the result when the loop closed).

Port of ``skred_tpu.engine.cyclic`` (cyclic_gate, the block scan,
render_cyclic, render_cyclic_stream, render_cyclic_stream_device).
Reference: synth.c:526-612 (frame loop), :217-275 (osc_next).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from skred_tpu_torch import config as C
from skred_tpu_torch import spans
from skred_tpu_torch.engine import download
from skred_tpu_torch.engine.fused import (Feat, _apply_ops_b, _gather_seg,
                                          _pack_by_dtype, compute_feat,
                                          from_stacked)
from skred_tpu_torch.engine.kernels.cyclic import cyclic_block, schedule_of
from skred_tpu_torch.engine.numerics import div32
from skred_tpu_torch.host.timeline import noise_stream

F32 = torch.float32
I32 = torch.int32


def cyclic_gate(st) -> Optional[str]:
    """None if the packed cyclic batch can take the kernel, else the
    reason it cannot: the kernel reads one table base per voice, so every
    row must bind the same tables."""
    p = st.params
    for name in ("table_off", "table_size"):
        a = np.asarray(p[name])
        if not bool((a == a[:1]).all()):
            return "per-voice table bindings differ across rows"
    return None


def _read_vecs(p, feat: Feat) -> dict:
    """The vectors of ``_vecs`` that say which voice reads which voice's
    sample, and where a read's value is used; the general kernel's
    schedule takes these alone (``_schedule``)."""
    i32 = lambda a: a.to(I32).T.contiguous()
    v = {}
    if feat.fm:
        fmo = p["freq_mod_osc"]
        v.update(fm_osc=i32(fmo), fm_del=i32(p["fm_delayed"]),
                 use_fm=i32((fmo >= 0) & (p["fm_self"] == 0)))
    if feat.cz:
        v["cz_mode"] = i32(p["cz_mode"])
        if feat.czm:
            v.update(cm_osc=i32(p["cz_mod_osc"]),
                     cm_del=i32(p["cm_delayed"]))
    if feat.am:
        v.update(am_osc=i32(p["amp_mod_osc"]), am_del=i32(p["am_delayed"]))
    if feat.pm:
        v.update(pm_osc=i32(p["pan_mod_osc"]), pm_del=i32(p["pm_delayed"]))
    if feat.disc:
        v["disconn"] = i32(p["disconnect"])
    return v


def _vecs(p, feat: Feat):
    """The kernel's per-voice vectors of one block, contiguous ``[k, B]``
    (rows along the fast axis, so a warp's parameter loads coalesce),
    from the ``[B, k]`` parameters.  Returns (vecs, table_off [k] i32)."""
    T = lambda a: a.T.contiguous()
    i32 = lambda a: T(a.to(I32))
    tsize_f = p["table_size"].to(F32)
    use_loop = (p["loop_enabled"] != 0) & (p["loop_valid"] != 0)
    lo = torch.where(use_loop, p["loop_start_f"], 0.0)
    hi = torch.where(use_loop, p["loop_end_f"], tsize_f)
    v = {
        "amp": T(p["amp"]), "pinc": T(p["phase_inc"]),
        "lo": T(lo), "hi": T(hi), "L": T(hi - lo),
        "clip_i": i32(torch.clamp(p["table_size"] - 1, min=0)),
        **_read_vecs(p, feat),
    }
    if feat.fm:
        fmo = p["freq_mod_osc"]
        mod_inc = torch.gather(p["phase_inc"], 1, fmo.clamp(min=0).long())
        v.update(mis=T(mod_inc * p["freq_scale"]),
                 fm_dep=T(p["freq_mod_depth"]))
    if feat.direction:
        v["dirneg"] = i32(p["direction"])
    if feat.cz:
        v.update(cz_dist=T(p["cz_distortion"]), tsize=T(tsize_f),
                 inv_ts=T(div32(1.0, tsize_f)))
        if feat.czm:
            cm = p["cz_mod_osc"]
            v.update(cm_ge=i32(cm >= 0), cm_dep=T(p["cz_mod_depth"]))
        else:
            # no effective cz-mod edge: the taken read multiplies to +0.0
            v["dm_row"] = T(torch.where(p["cz_mod_osc"] >= 0, 0.0, 1.0)
                            .to(F32))
    if feat.noise:
        v["is_noise"] = i32(p["table_index"] == C.WAVE_TABLE_NOISE_ALT)
    if feat.finish:
        v.update(one_shot=i32(p["one_shot"]),
                 osn=i32((p["one_shot"] != 0) & (p["loop_enabled"] == 0)))
    if feat.hold:
        v.update(hold_on=i32(p["hold_max"] != 0), hmax=i32(p["hold_max"]))
    if feat.quant:
        q = p["quantize"].to(I32)
        levels = (torch.bitwise_left_shift(torch.ones_like(q), q) - 1) \
            .to(F32)
        v.update(quant_on=i32(q != 0), levels=T(levels),
                 inv_lev=T(div32(1.0, torch.clamp(levels, min=1.0))))
    if feat.flt:
        v.update({kk: T(p[kk]) for kk in ("b0", "b1", "b2", "na1", "na2")})
        v["use_flt"] = i32(p["filter_mode"] != 0)
    if feat.env:
        v.update(use_env=i32(p["use_amp_envelope"]),
                 env_act=i32(p["env_active"]), env_start=i32(p["env_start"]),
                 env_relat=i32(p["env_rel_at"]), att=T(p["env_attack"]),
                 dec=T(p["env_decay"]), sus=T(p["env_sustain"]),
                 rel=T(p["env_release"]), vel=T(p["env_velocity"]))
    if feat.am:
        v["am_dep"] = T(p["amp_mod_depth"])
    if feat.pm:
        v["pm_dep"] = T(p["pan_mod_depth"])
    if feat.pm_self:
        v["pm_self"] = i32(p["pm_self"])
    if feat.sm:
        v.update(use_sm=i32(p["smoother_enable"]),
                 smoothing=T(p["smoother_smoothing"]))
    # bindings are row-uniform (cyclic_gate): row 0's bases serve all rows
    return v, p["table_off"][0].to(I32).contiguous()


def _schedule(st, feat: Feat, k: int, device):
    """The general kernel's waves over every row's and segment's reads,
    once per batch, on the host, from the packed parameters (``[B, S,
    k]`` numpy): ``kernels.cyclic.schedule_of`` of their ``_read_vecs``."""
    flat = {kk: torch.from_numpy(np.asarray(v).reshape(-1, k))
            for kk, v in st.params.items()
            if np.ndim(v) == 3 and np.shape(v)[-1] == k}
    return schedule_of(_read_vecs(flat, feat), feat, k, device)


@dataclasses.dataclass
class _Cyclic:
    """A packed cyclic batch on the device, ready for the block loop."""
    params: dict
    ops: dict
    seg_of_block: np.ndarray          # on the host: blocks that share
    seg_is_start: np.ndarray          # their rows' segments share vectors
    table: torch.Tensor
    B: int
    k: int
    block: int
    feat: Feat
    exact: bool
    single_seg: bool
    # the general kernel's waves: (wave [k] i32 on the device, count)
    schedule: Optional[tuple] = None
    groups: Optional[tuple] = None
    noise: Optional[torch.Tensor] = None
    # the last block's segments (bytes of seg_of_block's column) and what
    # was built from them: (key, params, ops, vecs, table_off)
    built: Optional[tuple] = None


_STATE_NAMES = ("phase", "sample", "finished", "hold_count", "hold_val",
                "x1", "x2", "y1", "y2", "smoother", "pan_l", "pan_r")


def _prep_shards(st, exact, split, noise=None, noise_blocks=None):
    """The batch for the block loop, split by rows over ``split``
    (``parallel.batch.shard_rows``'s ``(device, rows)`` pairs): packed
    for the cyclic engine if it is not yet, held to the gate and to its
    table buffer.  The features, the noise stream and the general
    kernel's schedule are the whole batch's, so every shard renders as
    its rows do in the unsplit batch.  Returns (st, [(_Cyclic, zero
    carry)] one a shard)."""
    from skred_tpu_torch.parallel.batch import pack_stacked, take_rows

    with spans.span("cyclic.prepare"):
        if "fm_delayed" not in st.params:
            st = pack_stacked(st, cyclic=True)
        reason = cyclic_gate(st)
        if reason is not None:
            raise ValueError(f"cyclic kernel ineligible: {reason}")
        # the kernel reads table_off + [0, table_size) unchecked: hold
        # every voice's table inside the buffer here, on the host
        end = (np.asarray(st.params["table_off"], np.int64)
               + np.maximum(np.asarray(st.params["table_size"], np.int64),
                            1))
        if end.size and int(end.max()) > np.asarray(st.table_buffer).size:
            raise ValueError("a voice's table runs past the table buffer")
        feat = compute_feat(st)
        k = np.shape(st.params["amp"])[-1]
        with spans.span("cyclic.schedule") as sched:
            wave, waves = _schedule(st, feat, k, "cpu")
            sched.n = waves
        stream = None
        if feat.noise:
            nb = st.num_blocks if noise_blocks is None else noise_blocks
            stream = noise_stream(nb * st.block) if noise is None \
                else np.asarray(noise, np.float32)[:nb * st.block]
        shards = []
        for device, rows in split:
            shard = take_rows(st, rows)
            d = from_stacked(shard, device)
            params, ops = d["params"], d["ops"]
            single_seg = all(v.shape[1] == 1 for v in params.values()) \
                and all(v.shape[1] == 1 for v in ops.values())
            r = _Cyclic(params=params, ops=ops,
                        seg_of_block=d["seg_of_block"],
                        seg_is_start=d["seg_is_start"] != 0,
                        table=d["table_buffer"], B=shard.batch, k=k,
                        block=st.block, feat=feat, exact=bool(exact),
                        single_seg=single_seg,
                        schedule=(wave.to(device), waves))
            if stream is not None:
                r.noise = torch.as_tensor(stream, device=device)
            if single_seg:
                p = {kk: v[:, 0] for kk, v in params.items()}
                o = {kk: v[:, 0] for kk, v in ops.items()}
                r.built = (None, p, o, *_vecs(p, feat))
            else:
                r.groups = (_pack_by_dtype(params, k),
                            _pack_by_dtype(ops, k))
            shards.append((r, d["carry"]))
        return st, shards


def _prep(st, exact, device, noise=None, noise_blocks=None):
    """``_prep_shards`` of all the batch's rows on one ``device``.
    Returns (st, _Cyclic, zero carry)."""
    st, [(r, carry)] = _prep_shards(
        st, exact, [(torch.device(device), np.arange(st.batch))], noise,
        noise_blocks)
    return st, r, carry


def _block_step(r: _Cyclic, carry, kb):
    """One block: the segment's parameters, the segment-start ops, one
    kernel call.  The carry stays ``[B, k]`` as the fused renderer keeps
    it; the kernel takes its transposed views and returns the same
    layout, so no state is copied.  Returns (carry, out [2, N, B])."""
    B, n = r.B, r.block
    with spans.span("cyclic.block"):
        if not r.single_seg:
            # segments last many blocks: gather and derive only when a
            # row's segment changes
            seg = np.ascontiguousarray(r.seg_of_block[:, kb])
            if r.built is None or r.built[0] != seg.tobytes():
                seg_t = torch.as_tensor(seg, device=r.table.device).long()
                p = _gather_seg(r.groups[0], r.params, seg_t, B)
                o = _gather_seg(r.groups[1], r.ops, seg_t, B)
                r.built = (seg.tobytes(), p, o, *_vecs(p, r.feat))
        _, p, o, vecs, table_off = r.built
        start = r.seg_is_start[:, kb]
        if start.any():
            # rows that start no segment keep their carry: without one the
            # ops change nothing
            flag = torch.as_tensor(start, device=r.table.device)[:, None]
            carry = _apply_ops_b(carry, o, flag, r.feat)
        states = {kk: carry[kk].T for kk in _STATE_NAMES}
        states["vol_gain"] = carry["vol_gain"]
        nblk = r.noise[kb * n:(kb + 1) * n] if r.noise is not None else None
        out_l, out_r, ns = cyclic_block(
            r.table, table_off, kb * n + 1, nblk, vecs, states,
            p["volume_final"], r.feat, r.k, n, r.exact,
            schedule=r.schedule)
        new_carry = dict(carry)
        for kk, vv in ns.items():
            new_carry[kk] = vv.T if vv.dim() == 2 else vv
        return new_carry, torch.stack([out_l.T, out_r.T])


def _render_chunk(r: _Cyclic, carry, block0, nb):
    outs = []
    for kb in range(block0, block0 + nb):
        carry, o = _block_step(r, carry, kb)
        outs.append(o)
    return carry, torch.stack(outs)               # [nb, 2, N, B]


def _rows_audio(outs, rows):
    """[nb, 2, N, B] → [rows, nb*N, 2] for the first ``rows`` rows."""
    nb, _, n, _ = outs.shape
    return outs[..., :rows].permute(3, 0, 2, 1).reshape(rows, nb * n, 2)


def render_cyclic_stream(st, chunk_blocks: int = 172, noise=None,
                         exact: bool = True,
                         keep_rows: Optional[int] = None, device="cuda"):
    """Generator yielding rendered chunks as numpy ``[rows, chunk*block,
    2]`` (the last chunk may be shorter); ``keep_rows`` downloads only
    the first rows of each chunk.  Runs on the card unless
    ``device="cpu"``."""
    st, r, carry = _prep(st, exact, device, noise)
    rows = st.batch if keep_rows is None else min(keep_rows, st.batch)
    for b0 in range(0, st.num_blocks, chunk_blocks):
        nb = min(chunk_blocks, st.num_blocks - b0)
        with torch.no_grad():
            carry, outs = _render_chunk(r, carry, b0, nb)
        yield _rows_audio(outs, rows).cpu().numpy()


def _shard_blocks(r: _Cyclic, carry, nb):
    """Generator over the blocks of one shard's render: each block's
    ``[N, B, 2]`` on the shard's device."""
    for kb in range(nb):
        carry, o = _block_step(r, carry, kb)
        yield o.permute(1, 2, 0)


def render_cyclic(st, noise=None, exact: bool = True, device="cuda",
                  mesh=None) -> np.ndarray:
    """Full render → numpy ``[B, T, 2]``, an array of the caller's own.
    Each block goes to the download (``engine/download.py``) as the loop
    makes it, so the audio leaves the card in chunks while the loop
    runs, and at most a chunk of blocks and its staging stay on the
    card.  ``mesh``: a list of devices (``parallel.batch.make_mesh``)
    that the batch's rows are split over, as ``render_fused`` splits
    them: the batch is packed, gated and scheduled once, whole, each
    shard renders by the whole batch's features, noise stream and
    schedule, so the audio is the unsplit render's bit for bit, and the
    shards' blocks are stepped in turn.  Runs on the card unless
    ``device="cpu"`` (without a mesh)."""
    from skred_tpu_torch.parallel.batch import shard_rows

    with spans.span("cyclic.render"):
        split = shard_rows(st.batch, [device] if mesh is None else mesh)

        def start():
            _, shards = _prep_shards(st, exact, split, noise)
            return zip(*(_shard_blocks(r, carry, st.num_blocks)
                         for r, carry in shards))

        return download.run("cyclic", split, st.num_blocks, st.block,
                            start)


def render_cyclic_stream_device(st, chunk_blocks: int = 172,
                                exact: bool = True,
                                warmup_only: bool = False,
                                device="cuda") -> float:
    """Streamed render that keeps the carry and the audio on the device,
    chunk by chunk (only whole chunks render); returns a checksum, the
    |out| sum of the final chunk in f64, as
    ``fused.render_fused_stream_device`` does."""
    whole = (st.num_blocks // chunk_blocks) * chunk_blocks
    st, r, carry = _prep(st, exact, device, noise_blocks=whole)
    outs = None
    with torch.no_grad():
        for b0 in range(0, whole, chunk_blocks):
            carry, outs = _render_chunk(r, carry, b0, chunk_blocks)
            if warmup_only:
                break
    if outs is None:
        return 0.0
    return float(outs.abs().sum(dtype=torch.float64))
