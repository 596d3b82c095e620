"""Roofline model of the port on an NVIDIA card: the card's peaks, each
kernel's least time, and the per-block cost of a bench bucket.

Three parts, one source for the counts:

  * ``PEAKS``: the published device-memory rate and f32 rate (outside the
    tensor cores) of each card the model knows, keyed by
    ``torch.cuda.get_device_name``.  A card not in the table gets no
    peaks, and then no percentages and no bound label: the model names
    the card rather than guess its rates.
  * per-kernel counts and bounds (``tier_counts`` / ``tier_bound``,
    ``phase_walk_warp_*``, ``lookup_*``, ``filt_smooth_noise_*``,
    ``cyclic_*`` and ``compat_*``), each taking one call's arguments as
    the renderer passes them: the bytes the call must move
    (each input read once, each output written once; where the work
    depends on the data, what these inputs need) against its f32
    operations.  chip_smoke.py holds each kernel's time against them.
  * ``estimate_bucket(st).roofline(wall_s, blocks)``: the DRAM bytes and
    f32 operations a block of a packed bucket needs (``block_calls``:
    call by call), counted from the pack (rows, block length, tiers and
    their lanes, each tier's feature set, the bank columns its
    modulator fields name; the cyclic kernel's voices) along the
    routing the renderer itself takes (``engine.fused.plan``: the tier
    kernel or the noise pass's walk, lookup and filter, the fold, the
    estimate passes), never from the tensors a kernel happens to be
    passed, so a later kernel that does the same work reads the same
    bound.  Divided by the
    measured wall it gives the achieved rates; when neither reaches 30%
    of its peak the bucket is labelled ``"latency/overhead"``: the time
    goes where the model does not look (the host's Python, launches,
    small kernels).

Operations count an fma as 2; the per-sample counts per stage are the
ones chip_smoke.py has used since the kernels were ported.  Port of
``skred_tpu.parallel.roofline`` (a TPU v5e model); the Pallas grid-step
cost it also modelled has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


class Peaks(NamedTuple):
    part: str
    hbm_bytes_s: float        # device memory, bytes/s
    f32_flops: float          # f32 outside the tensor cores, op/s


# NVIDIA's data sheet (SXM part, dense rates), at the full 700 W power
# limit; a card set below it runs slower under load
PEAKS = {"NVIDIA H100 80GB HBM3": Peaks("H100 SXM", 3.35e12, 67e12)}
LATENCY_SHARE = 0.30          # below this share of both peaks: overhead


def peaks_for(card: str) -> Optional[Peaks]:
    """The peaks of ``card`` (a ``torch.cuda.get_device_name``), or None
    for a card the table does not hold."""
    return PEAKS.get(card)


def bound(read, write, ops, peaks: Peaks):
    """Least time on a card of ``peaks``: the bytes read once and written
    once over the memory rate, against the f32 operations over the f32
    rate.  Returns (ms, "bytes" | "operations")."""
    t_bytes = (read + write) / peaks.hbm_bytes_s * 1e3
    t_ops = ops / peaks.f32_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


# ---- f32 operations per lane-sample (per row-frame for the cyclic
# kernel), by kernel and feature flags ----

def tier_ops(fl, mix=False):
    return 6 + (3 if fl["fm"] else 0) + (5 if fl["cz"] else 0) \
        + (3 if fl["quant"] else 0) + (9 if fl["flt"] else 0) \
        + (3 if fl["sm"] else 0) + (12 if fl["env"] else 0) \
        + (2 if fl["am"] else 0) + 1 + (4 if mix else 0)


def walk_ops(fl):
    """The keyed walk: the walk (6), the FM increment (3), the CZ warp
    (the divide and the curve, 8)."""
    return 6 + (3 if fl["fm"] else 0) + (8 if fl["cz"] else 0)


def filter_ops(fl):
    """The keyed filter/smoother: the serial stages, the envelope (12),
    the am stream and the gain."""
    return (3 if fl["quant"] else 0) + (9 if fl["flt"] else 0) \
        + (3 if fl["sm"] else 0) + (12 if fl["env"] else 0) \
        + (2 if fl["am"] else 0) + 3


def cyclic_frame_ops(fl, k):
    """One row-frame of the cyclic kernel: ``k`` voices and the mix."""
    per_voice = 12 + (3 if fl["fm"] else 0) + (8 if fl["cz"] else 0) \
        + (4 if fl["quant"] else 0) + (9 if fl["flt"] else 0) \
        + (12 if fl["env"] else 0) + (2 if fl["am"] else 0) \
        + (3 if fl["sm"] else 0) + (6 if fl["pm"] else 0)
    return k * per_voice + 5


def compat_voice_ops(flags, cz_on, am_on, pm_on):
    """One voice pass of the compat kernel, by the voice's stages: the
    oscillator and the lookup (12), the FM increment (3), the CZ warp
    (8), the quantizer (4), the biquad (9), the envelope (12), the
    amp-mod (2), the smoother (3), the pan-mod (6).  Arrays of the
    packed flags and stage masks in, operations out."""
    from skred_tpu_torch.engine.kernels import compat as K

    on = lambda name: (flags & (1 << K.FLAGS.index(name))) != 0
    return (12 + 3 * on("use_fm") + 8 * cz_on + 4 * on("quant")
            + 9 * on("use_flt") + 12 * on("use_env") + 2 * am_on
            + 3 * on("use_sm") + 6 * pm_on)


def compat_counts(inp, block0, nb, passes, capture=False):
    """The compat kernel over blocks ``block0 .. block0+nb`` of ``inp``
    (``engine.kernels.compat.CompatInputs``) at ``passes`` passes: its
    inputs read once (the parameters, ops and maps, the table buffer,
    the blocks' noise, the carry), its outputs written once (the stereo
    stream, the carry, the capture), and the operations of the voices
    each block's segment sounds (amp != 0), every pass, with the voice
    sum and the volume smoother a row-sample."""
    from skred_tpu_torch.engine.kernels import compat as K

    n, rows = inp.block, inp.rows
    pi = inp.pi.cpu().numpy()
    amp = inp.pf[:, :, K.PF.index("amp")].cpu().numpy()
    col = lambda name: pi[:, :, K.PI.index(name)]
    per = compat_voice_ops(col("flags"), col("cz_mode") != 0,
                           col("am_osc") >= 0, col("pm_osc") >= 0)
    per = np.where(amp != 0.0, per, 0).sum(axis=-1)          # [B, S]
    seg = inp.seg[:, block0:block0 + nb].cpu().numpy().astype(np.int64)
    voice_ops = int(np.take_along_axis(per, seg, axis=1).sum())
    ops = n * (passes * voice_ops + nb * rows * (2 * 63 + 5))
    carry = (rows * (len(K.CF) + len(K.CI)) * 64 + rows) * 4
    read = nbytes(inp.pf, inp.pi, inp.vf, inp.of, inp.oi, inp.seg,
                  inp.start, inp.table) + nb * n * 4 + carry
    write = rows * nb * n * 2 * 4 * (1 + (64 if capture else 0)) + carry
    return read, write, ops


def compat_bound(inp, block0, nb, passes, peaks, capture=False):
    return bound(*compat_counts(inp, block0, nb, passes, capture), peaks)


# ---- per-kernel counts, on one call's arguments ``(a, kw)``: (bytes
# read, bytes written, f32 operations); each ``*_bound`` is ``bound`` of
# its ``*_counts`` ----

def bank_bytes(fold, vecs, pairs, b, n, m):
    """Bytes of the bank columns a call's lanes read, each column once
    whatever its readers, with its sample before the block: ``pairs``
    are (source vector, gate vector) names of the streams read."""
    if fold is None or not fold.w or not pairs:
        return 0
    dev = vecs[pairs[0][0]].device
    lane_b = torch.arange(m, device=dev) % b
    cols = []
    for src_k, gate_k in pairs:
        src = vecs[src_k].long()
        on = (src >= 0) & (src < fold.w) & (vecs[gate_k] != 0)
        cols.append((src * b + lane_b)[on])
    return (n + 1) * 4 * int(torch.unique(torch.cat(cols)).numel())


_FOLD_GATE = {"fm": "use_fm", "cz": "cm_ge0", "am": "am_ge0"}


def tier_counts(a, kw):
    """Bytes: every stream passed in, the bank columns this call's lanes
    read (each once, whatever the number of readers, plus their previous
    samples), the per-lane vectors and states; out, the end states and,
    with the mix, the weights and the accumulators (read too where the
    call adds onto earlier ones)."""
    from skred_tpu_torch.engine.kernels.tier import (_FOLD_VECS, _flags,
                                                     _folded, _state_keys)

    table, cbase, inc, dm, amod, vecs, states = a
    fl, n = _flags(kw["feat"]), kw["n"]
    m = vecs["amp"].shape[0]
    mix = kw.get("mixw") is not None
    read = nbytes(table, inc, dm, amod, *vecs.values(), *states.values())
    write = n * m * 4 + m * 4 * (len(_state_keys(fl)) + 1)
    fold = kw.get("fold")
    read += bank_bytes(fold, vecs, [(_FOLD_VECS[k][0], _FOLD_GATE[k])
                                    for k in _folded(fl, fold)],
                       kw.get("b"), n, m)
    if mix:
        b = kw["b"]
        read += nbytes(*kw["mixw"])
        write += 2 * n * b * 4 + m * 4
        if kw.get("acc") is not None:
            read += 2 * n * b * 4
    return read, write, tier_ops(fl, mix) * n * m


def lookup_counts(a, kw):
    table, base, limit, idx = a
    return nbytes(table, base, limit, idx), nbytes(idx), 0


def phase_walk_warp_counts(a, kw):
    """Bytes: the per-lane vectors and start states, the bank columns the
    lanes' fm and cz reads take; the index, the alive count and the end
    states."""
    from skred_tpu_torch.engine.kernels import phase_walk as pw

    bank, vecs, phase0, fin0 = a
    fl = pw._pw_flags(kw["feat"])
    n, m = kw["n"], phase0.shape[0]
    read = nbytes(phase0, fin0 if fl["finish"] else None,
                  *(vecs[k] for k, _ in pw._pw_vec_keys(fl)))
    pairs = ([("fm_src", "use_fm")] if fl["fm"] else []) \
        + ([("cz_src", "cm_ge0")] if fl["czm"] else [])
    read += bank_bytes(bank, vecs, pairs, kw["b"], n, m)
    write = n * m * 4 + m * 4 * (3 if fl["finish"] else 2)
    return read, write, walk_ops(fl) * n * m


def filt_smooth_noise_counts(a, kw):
    """Bytes: the lookup's samples the lanes need (live samples of lanes
    that are not noise voices), the noise stream, the alive counts, the
    per-lane vectors the key reads (``fn_vec_keys``) and the start
    states of its stages, the bank columns the am reads take; the output
    and the end states."""
    from skred_tpu_torch.engine.kernels import filt_smooth as fs

    f, noise_blk, cnt, cbase, bank, vecs, states = a
    fl = fs._fs_flags(kw["feat"])
    n, m = f.shape
    tpos = torch.arange(n, device=f.device)[:, None]
    need = (tpos < cnt[None]) & (vecs["is_noise"][None] == 0)
    used = [states[k] for stage, keys in fs._NOISE_STATES.items()
            if fl[stage] for k, _ in keys]
    read = 4 * int(need.sum()) + nbytes(
        noise_blk, cnt, *(vecs[k] for k, _ in fs.fn_vec_keys(fl)), *used)
    if fl["am"]:
        read += bank_bytes(bank, vecs, [("am_src", "am_ge0")], kw["b"], n, m)
    write = n * m * 4 + nbytes(*used)
    return read, write, filter_ops(fl) * n * m


def cyclic_counts(a, kw):
    from skred_tpu_torch.engine.kernels import cyclic as ck

    table, table_off, _, noise_blk, vecs, states, vf, feat, k, n = a[:10]
    fl, rows = ck._flags(feat), vf.shape[0]
    read = nbytes(table, table_off, noise_blk, vf, *vecs.values(),
                  *states.values())
    write = 2 * n * rows * 4 + nbytes(*(states[key] for key, _ in
                                        ck._state_keys(fl))) + rows * 4
    return read, write, n * rows * cyclic_frame_ops(fl, k)


def _bounded(counts):
    def bnd(a, kw, peaks):
        return bound(*counts(a, kw), peaks)
    bnd.__doc__ = counts.__doc__
    return bnd


tier_bound = _bounded(tier_counts)
lookup_bound = _bounded(lookup_counts)
phase_walk_warp_bound = _bounded(phase_walk_warp_counts)
filt_smooth_noise_bound = _bounded(filt_smooth_noise_counts)
cyclic_bound = _bounded(cyclic_counts)


# ---- the bucket model ----

@dataclasses.dataclass
class BucketCost:
    bytes_per_block: float       # DRAM bytes (reads + writes) per block
    flops_per_block: float       # f32 operations per block
    card: str
    peaks: Optional[Peaks]

    def roofline(self, wall_s: float, blocks: int) -> dict:
        """The model's rates over the measured wall, against the card's
        peaks, and the resource that bounds the bucket."""
        t = wall_s / max(blocks, 1)
        bw = self.bytes_per_block / t
        fl = self.flops_per_block / t
        out = {"card": self.card,
               "model_bytes_per_block": self.bytes_per_block,
               "model_flops_per_block": self.flops_per_block,
               "gb_s": round(bw / 1e9, 1), "gflop_s": round(fl / 1e9, 1)}
        if self.peaks is None:
            # no published rate for this card: no shares, no label
            return {**out, "pct_hbm_peak": None, "pct_f32_peak": None,
                    "bound_ms_per_block": None, "bound": None}
        fr_bw = bw / self.peaks.hbm_bytes_s
        fr_fl = fl / self.peaks.f32_flops
        res = max(("bytes", fr_bw), ("operations", fr_fl),
                  key=lambda kv: kv[1])
        return {**out, "pct_hbm_peak": round(100 * fr_bw, 1),
                "pct_f32_peak": round(100 * fr_fl, 1),
                "bound_ms_per_block": 1e3 * max(
                    self.bytes_per_block / self.peaks.hbm_bytes_s,
                    self.flops_per_block / self.peaks.f32_flops),
                "bound": res[0] if res[1] >= LATENCY_SHARE
                else "latency/overhead"}


class Call(NamedTuple):
    """One kernel call of a block as the model counts its work."""
    kernel: str               # the wrapper engine.fused calls
    tier: int
    lanes: int
    read: int
    write: int
    ops: int


def _bank_columns(st, names, lo, hi, w):
    """The bank columns a block's voices [lo, hi) read through the
    modulator fields ``names``: in each row, the distinct source voices
    in [0, w) of the block's segment, each column read once whatever its
    readers (a self-fm read, ``fm_self``, takes none).  Summed over the
    rows, the mean over the blocks."""
    if not names:
        return 0
    p = st.params
    src = []
    for name in names:
        v = np.asarray(p[name])[..., lo:hi]             # [B, S, V]
        on = (v >= 0) & (v < w)
        if name == "freq_mod_osc":
            on &= np.asarray(p["fm_self"])[..., lo:hi] == 0
        src.append(np.where(on, v, -1))
    srt = np.sort(np.concatenate(src, axis=-1), axis=-1)
    first = np.ones(srt.shape, bool)
    first[..., 1:] = srt[..., 1:] != srt[..., :-1]
    cols = ((srt >= 0) & first).sum(-1)                  # [B, S]
    per_block = np.take_along_axis(
        cols, np.asarray(st.seg_of_block, np.int64), axis=1).sum(0)
    return float(per_block.mean())


def _tier_call(ti, fl, folded, B, n, L, table, streams, consts, cols, mix,
               acc):
    """A tier-kernel call over ``L`` lanes: ``streams`` modulator streams
    passed in as [N, L] blocks, ``consts`` per-lane rows in their place,
    ``cols`` bank columns read in the kernel (with their previous
    samples), the vectors of the ``folded`` streams' sources."""
    from skred_tpu_torch.engine.kernels import tier as tk

    n_states = len(tk._state_keys(fl))
    read = table + 4 * L * (len(tk._vec_keys(fl, folded)) + n_states
                            + consts) \
        + 4 * n * L * streams + 4 * (n + 1) * cols
    write = 4 * n * L + 4 * L * (n_states + 1)
    if mix:
        read += 2 * 4 * L + (2 * 4 * n * B if acc else 0)
        write += 2 * 4 * n * B + 4 * L
    return Call("tier", ti, L, read, write, tier_ops(fl, mix) * n * L)


def _noise_calls(st, ti, ft, B, n, lo, hi, w, table):
    """A noise pass over voices [lo, hi): the keyed walk, the lookup and
    the keyed filter/smoother, the walk's fm / cz and the filter's am
    read from a bank of ``w`` voices (0: none)."""
    from skred_tpu_torch.engine.fused import _fs_feat, _pw_feat
    from skred_tpu_torch.engine.kernels import filt_smooth as fs
    from skred_tpu_torch.engine.kernels import phase_walk as pw

    L = B * (hi - lo)
    pfl = pw._pw_flags(_pw_feat(ft))
    walk_cols = _bank_columns(st, (["freq_mod_osc"] if pfl["fm"] else [])
                              + (["cz_mod_osc"] if pfl["czm"] else []),
                              lo, hi, w)
    walk = Call("phase_walk_warp", ti, L,
                4 * L * (len(pw._pw_vec_keys(pfl)) + 1 + pfl["finish"])
                + 4 * (n + 1) * walk_cols,
                4 * n * L + 4 * L * (3 if pfl["finish"] else 2),
                walk_ops(pfl) * n * L)
    # the index block, base and limit, the table; the samples
    look = Call("lookup", ti, L, table + 4 * n * L + 2 * 4 * L, 4 * n * L,
                0)
    ffl = fs._fs_flags(_fs_feat(ft))
    n_states = sum(len(keys) for stage, keys in fs._NOISE_STATES.items()
                   if ffl[stage])
    am_cols = _bank_columns(st, ["amp_mod_osc"], lo, hi, w) \
        if ffl["am"] else 0
    filt = Call("filt_smooth_noise", ti, L,
                4 * n * L + 4 * n
                + 4 * L * (1 + len(fs.fn_vec_keys(ffl)) + n_states)
                + 4 * (n + 1) * am_cols,
                4 * n * L + 4 * L * n_states, filter_ops(ffl) * n * L)
    return [walk, look, filt]


def block_calls(st, pl=None) -> list:
    """The kernel calls of a block of a packed fused batch, on average
    over its blocks, in the order the block loop makes them, each with
    the bytes and operations of its work: the routing from ``pl`` (a
    larger batch's plan where ``st`` is a shard of it) or
    ``engine.fused.plan`` (the one the renderer takes by default), the
    sizes from the pack (rows, block length, the tiers' voices and
    features, the bank columns their modulator fields name in each
    block's segment, the table buffer)."""
    from skred_tpu_torch.engine.fused import _kernel_feat, plan
    from skred_tpu_torch.engine.kernels import tier as tk

    pl = plan(st) if pl is None else pl
    B, n = st.batch, st.block
    table = 4 * np.asarray(st.table_buffer).size
    est_passes, est_v = pl.estimate()
    calls, lo, acc = [], 0, False
    for ti, vt in enumerate(pl.tiers):
        ft, hi = pl.tier_feat(ti), lo + vt
        # the bank the streams come from: the earlier tiers, or in a
        # batch of one tier the estimate of the source voices
        w = (lo if ti else est_v) if pl.streams_in(ti) else 0
        if ft.noise:
            for _ in range(est_passes):
                calls += _noise_calls(st, ti, ft, B, n, 0, est_v, est_v,
                                      table)
            calls += _noise_calls(st, ti, ft, B, n, lo, hi, w, table)
        else:
            fl = tk._flags(_kernel_feat(ft))
            names = (["freq_mod_osc"] if fl["fm"] else []) \
                + (["cz_mod_osc"] if fl["czm"] else []) \
                + (["amp_mod_osc"] if fl["am"] else [])
            # a per-lane row where a tier has no such stream
            consts = (0 if fl["fm"] else 1) + (fl["cz"] and not fl["czm"])
            for _ in range(est_passes):
                calls.append(_tier_call(ti, fl, (), B, n, B * est_v, table,
                                        len(names), consts, 0, False,
                                        False))
            if pl.folds(ti):
                folded = tk._folded(fl, tk.Fold(None, None, w))
                calls.append(_tier_call(
                    ti, fl, folded, B, n, B * vt, table, 0, consts,
                    _bank_columns(st, names, lo, hi, w), pl.mix, acc))
            else:
                calls.append(_tier_call(
                    ti, fl, (), B, n, B * vt, table,
                    len(names) if pl.streams_in(ti) else 0, consts, 0,
                    pl.mix, acc))
            acc = acc or pl.mix
        lo = hi
    return calls


def _fused_cost(st):
    """A block's kernel calls, the noise tiers' voices mixed in torch (a
    read of their output, 4 operations a lane-sample), the accumulators
    into the mix, the volume smoother and the block out."""
    from skred_tpu_torch.engine.fused import plan

    calls = block_calls(st)
    B, n = st.batch, st.block
    read = sum(c.read for c in calls)
    write = sum(c.write for c in calls)
    ops = sum(c.ops for c in calls)
    pl = plan(st)
    noise_l = B * sum(vt for ti, vt in enumerate(pl.tiers)
                      if pl.tier_feat(ti).noise)
    read += 4 * n * noise_l + (2 * 4 * n * B if pl.mix else 0)
    write += 2 * 4 * n * B
    ops += 4 * n * noise_l + 6 * n * B
    return read + write, ops


def _cyclic_cost(st):
    from skred_tpu_torch.engine.fused import compute_feat
    from skred_tpu_torch.engine.kernels import cyclic as ck

    rows, n = st.batch, st.block
    k = st.params["amp"].shape[-1]
    fl = ck._flags(compute_feat(st))
    n_states = len(ck._state_keys(fl))
    read = 4 * np.asarray(st.table_buffer).size + 4 * k \
        + (4 * n if fl["noise"] else 0) + 4 * rows \
        + 4 * k * rows * (len(ck._vec_keys(fl)) + n_states) + 4 * rows
    write = 2 * 4 * n * rows + 4 * k * rows * n_states + 4 * rows
    return read + write, n * rows * cyclic_frame_ops(fl, k)


def estimate_bucket(st, card: Optional[str] = None) -> BucketCost:
    """The per-block cost of a packed bucket as the port renders it by
    default (the tier kernel's mix and fold on; the arithmetic mode
    moves no byte), on ``card`` (default: card 0, or "cpu" where there
    is none)."""
    if card is None:
        card = torch.cuda.get_device_name(0) if torch.cuda.is_available() \
            else "cpu"
    b, f = _cyclic_cost(st) if st.fused_passes is None \
        else _fused_cost(st)
    return BucketCost(float(b), float(f), card, peaks_for(card))
