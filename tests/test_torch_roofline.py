"""The port's roofline model (``skred_tpu_torch/parallel/roofline.py``) on
the CPU: the bucket model's counts against a hand count and, call for
call, against the per-kernel counts on the arguments a render passes
(the tiered, noise, fold and repeat-passes routes), each per-kernel
bound against the formula chip_smoke.py computed inline before it moved
into the module (copied below as ``_former_*``, with the H100 SXM peaks
it hard-coded), and a card the peak table does not hold.
"""

import numpy as np
import pytest
import torch

from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.engine.fused import compute_feat
from skred_tpu_torch.engine.kernels import cyclic as ck
from skred_tpu_torch.engine.kernels import cyclic_inputs as ci
from skred_tpu_torch.engine.kernels import filt_smooth as fs
from skred_tpu_torch.engine.kernels import phase_walk as pw
from skred_tpu_torch.engine.kernels.noise_inputs import (
    NOISE64_FSN0, NOISE64_FSN1, NOISE64_WARP0, NOISE64_WARP1,
    random_lookup_inputs, random_noise_fs_inputs, random_warp_inputs)
from skred_tpu_torch.engine.kernels.tier import (_FOLD_VECS, Fold, _flags,
                                                 _folded, _state_keys)
from skred_tpu_torch.engine.kernels.tier_inputs import (
    STRESS64_TIER0, STRESS64_TIER1, random_fold_inputs, random_mix_weights,
    random_tier_inputs)
from skred_tpu_torch.host.timeline import compile_script
from skred_tpu_torch.parallel import roofline as rl
from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

H100 = "NVIDIA H100 80GB HBM3"
PEAKS = rl.peaks_for(H100)
N, B, V, W = 16, 8, 4, 3            # samples, rows, voices, bank voices
M = B * V
t = lambda x: None if x is None else torch.from_numpy(np.asarray(x))


# ---- chip_smoke.py's former inline formulas ----

def _former_bound(read, write, ops):
    t_bytes = (read + write) / 3.35e12 * 1e3
    t_ops = ops / 67e12 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nb(*xs):
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def _former_bank_bytes(fold, vecs, pairs, b, n, m):
    if fold is None or not fold.w or not pairs:
        return 0
    lane_b = torch.arange(m) % b
    cols = []
    for src_k, gate_k in pairs:
        src = vecs[src_k].long()
        on = (src >= 0) & (src < fold.w) & (vecs[gate_k] != 0)
        cols.append((src * b + lane_b)[on])
    return (n + 1) * 4 * int(torch.unique(torch.cat(cols)).numel())


def _former_tier(a, kw):
    table, cbase, inc, dm, amod, vecs, states = a
    fl, n = _flags(kw["feat"]), kw["n"]
    m = vecs["amp"].shape[0]
    ops = 6 + (3 if fl["fm"] else 0) + (5 if fl["cz"] else 0) \
        + (3 if fl["quant"] else 0) + (9 if fl["flt"] else 0) \
        + (3 if fl["sm"] else 0) + (12 if fl["env"] else 0) \
        + (2 if fl["am"] else 0) + 1
    read = _nb(table, inc, dm, amod, *vecs.values(), *states.values())
    write = n * m * 4 + m * 4 * (len(_state_keys(fl)) + 1)
    fold = kw.get("fold")
    folded = _folded(fl, fold)
    if folded and fold.w:
        b = kw["b"]
        lane_b = torch.arange(m) % b
        gate = {"fm": "use_fm", "cz": "cm_ge0", "am": "am_ge0"}
        cols = []
        for k in folded:
            src = vecs[_FOLD_VECS[k][0]].long()
            on = (src >= 0) & (src < fold.w) & (vecs[gate[k]] != 0)
            cols.append((src * b + lane_b)[on])
        read += (n + 1) * 4 * int(torch.unique(torch.cat(cols)).numel())
    if kw.get("mixw") is not None:
        b = kw["b"]
        ops += 4
        read += _nb(*kw["mixw"])
        write += 2 * n * b * 4 + m * 4
        if kw.get("acc") is not None:
            read += 2 * n * b * 4
    return _former_bound(read, write, ops * n * m)


def _former_lookup(a, kw):
    table, base, limit, idx = a
    return _former_bound(_nb(table, base, limit, idx), _nb(idx), 0)


def _former_phase_walk_warp(a, kw):
    bank, vecs, phase0, fin0 = a
    fl = pw._pw_flags(kw["feat"])
    n, m = kw["n"], phase0.shape[0]
    read = _nb(phase0, fin0 if fl["finish"] else None,
               *(vecs[k] for k, _ in pw._pw_vec_keys(fl)))
    pairs = ([("fm_src", "use_fm")] if fl["fm"] else []) \
        + ([("cz_src", "cm_ge0")] if fl["czm"] else [])
    read += _former_bank_bytes(bank, vecs, pairs, kw["b"], n, m)
    write = n * m * 4 + m * 4 * (3 if fl["finish"] else 2)
    ops = 6 + (3 if fl["fm"] else 0) + (8 if fl["cz"] else 0)
    return _former_bound(read, write, ops * n * m)


def _former_filt_smooth_noise(a, kw):
    f, noise_blk, cnt, cbase, bank, vecs, states = a
    fl = fs._fs_flags(kw["feat"])
    n, m = f.shape
    tpos = torch.arange(n)[:, None]
    need = (tpos < cnt[None]) & (vecs["is_noise"][None] == 0)
    used = [states[k] for stage, keys in fs._NOISE_STATES.items()
            if fl[stage] for k, _ in keys]
    read = 4 * int(need.sum()) + _nb(
        noise_blk, cnt, *(vecs[k] for k, _ in fs.fn_vec_keys(fl)), *used)
    if fl["am"]:
        read += _former_bank_bytes(bank, vecs, [("am_src", "am_ge0")],
                                   kw["b"], n, m)
    write = n * m * 4 + _nb(*used)
    ops = (3 if fl["quant"] else 0) + (9 if fl["flt"] else 0) \
        + (3 if fl["sm"] else 0) + (12 if fl["env"] else 0) \
        + (2 if fl["am"] else 0) + 3
    return _former_bound(read, write, ops * n * m)


def _former_cyclic(a, kw):
    table, table_off, _, noise_blk, vecs, states, vf, feat, k, n = a[:10]
    fl, rows = ck._flags(feat), vf.shape[0]
    per_voice = 12 + (3 if fl["fm"] else 0) + (8 if fl["cz"] else 0) \
        + (4 if fl["quant"] else 0) + (9 if fl["flt"] else 0) \
        + (12 if fl["env"] else 0) + (2 if fl["am"] else 0) \
        + (3 if fl["sm"] else 0) + (6 if fl["pm"] else 0)
    read = _nb(table, table_off, noise_blk, vf, *vecs.values(),
               *states.values())
    write = 2 * n * rows * 4 + _nb(*(states[key] for key, _ in
                                     ck._state_keys(fl))) + rows * 4
    return _former_bound(read, write, n * rows * (k * per_voice + 5))


# ---- calls on small tensors ----

def _tier_calls():
    calls = []
    for feat in (STRESS64_TIER0, STRESS64_TIER1):
        table, cbase, inc, dm, amod, vecs, states = random_tier_inputs(
            feat, N, M, seed=3, table_len=16384)
        tv = {k: t(x) for k, x in vecs.items()}
        ts = {k: t(x) for k, x in states.items()}
        calls.append(((t(table), cbase, t(inc), t(dm), t(amod), tv, ts),
                      dict(feat=feat, n=N)))
    feat = STRESS64_TIER1
    table, cbase, inc, dm, amod, vecs, states = random_tier_inputs(
        feat, N, M, seed=4, table_len=16384)
    bank, prev, fv = random_fold_inputs(N, M, B, W, seed=4)
    wl, wr = random_mix_weights(M, seed=4)
    tv = {k: t(x) for k, x in {**vecs, **fv}.items()}
    ts = {k: t(x) for k, x in states.items()}
    acc = (torch.zeros(N, B), torch.zeros(N, B))
    for mix, fold, add in ((True, False, False), (False, True, False),
                           (True, True, True)):
        kw = dict(feat=feat, n=N, b=B)
        if mix:
            kw["mixw"] = (t(wl), t(wr))
        if fold:
            kw["fold"] = Fold(t(bank), t(prev), W)
        if add:
            kw["acc"] = acc
        calls.append(((t(table), cbase, None if fold else t(inc), t(dm),
                       t(amod), tv, ts), kw))
    return calls


def _cases():
    cases = [("tier", a, kw) for a, kw in _tier_calls()]
    for ss in (4096, 32768):
        table, slot, idx = (t(x) for x in random_lookup_inputs(N, M, ss,
                                                               seed=6))
        base = slot * ss
        cases.append(("lookup", (table, base, torch.full_like(base, ss),
                                 idx.T.contiguous()), {}))
    for feat in (NOISE64_WARP0, NOISE64_WARP1):
        bank, prev, vecs, ph0, fin0 = random_warp_inputs(feat, N, M, B, W,
                                                         seed=8)
        cases.append(("phase_walk_warp",
                      (Fold(t(bank), t(prev), W),
                       {k: t(v) for k, v in vecs.items()}, t(ph0), t(fin0)),
                      dict(feat=feat, n=N, b=B)))
    for feat in (NOISE64_FSN0, NOISE64_FSN1):
        f, nz, cnt, cbase, bank, prev, vecs, states = \
            random_noise_fs_inputs(feat, N, M, B, W, seed=9)
        cases.append(("filt_smooth_noise",
                      (t(f), t(nz), t(cnt), cbase, Fold(t(bank), t(prev), W),
                       {k: t(v) for k, v in vecs.items()},
                       {k: t(v) for k, v in states.items()}),
                      dict(feat=feat, b=B)))
    for lines in (ci.ALL_FEATURES, (ci.CORPUS / "fb2.sk").read_text()
                  .splitlines()):
        cases.append(("cyclic", ci.block_inputs(lines, 4, seed=10, n=N), {}))
    return cases


CASES = _cases()
MOVED = {"tier": (rl.tier_bound, _former_tier),
         "lookup": (rl.lookup_bound, _former_lookup),
         "phase_walk_warp": (rl.phase_walk_warp_bound,
                             _former_phase_walk_warp),
         "filt_smooth_noise": (rl.filt_smooth_noise_bound,
                               _former_filt_smooth_noise),
         "cyclic": (rl.cyclic_bound, _former_cyclic)}


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_moved_bound_equals_former_formula(i):
    name, a, kw = CASES[i]
    moved, former = MOVED[name]
    ms, by = moved(a, kw, PEAKS)
    assert (ms, by) == former(a, kw)
    assert ms > 0


def test_peaks_of_the_h100():
    assert PEAKS == rl.Peaks("H100 SXM", 3.35e12, 67e12)
    assert rl.bound(3.35e9, 0, 0, PEAKS) == (1.0, "bytes")
    assert rl.bound(0, 0, 67e9, PEAKS) == (1.0, "operations")


def _one_tier_bucket():
    tl = compile_script(["v0 w0 f440 a5 q5 h3"], 0.05, bank=WaveBank())
    return pack_stacked(stack_timelines([tl] * 4))


def test_bucket_model_equals_a_hand_count():
    """One voice (sm, hold, quant), 4 rows, one tier through the tier
    kernel with its mix: per block of N=512 samples, L=4 lanes."""
    st = _one_tier_bucket()
    assert st.tiers == (1,) and st.batch == 4 and st.block == 512
    n, lanes = 512, 4
    table = 4 * 32768                     # the bound table buffer, once
    vectors = 8 + 2 + 2 + 3               # base, sm, hold, quant vectors
    states = 1 + 1 + 2                    # phase, smoother, hold
    inc_row = 1                           # no fm: a constant increment
    read = table + 4 * lanes * (vectors + states + inc_row) \
        + 2 * 4 * lanes                   # the mix weights
    write = 4 * n * lanes + 4 * lanes * (states + 1) \
        + 2 * 4 * n * 4 + 4 * lanes       # samples, end states, mix sums
    read += 2 * 4 * n * 4                 # accumulators into the mix
    write += 2 * 4 * n * 4                # the block out
    ops = (6 + 3 + 3 + 1 + 4) * n * lanes + 6 * n * 4
    cost = rl.estimate_bucket(st, H100)
    assert cost.bytes_per_block == read + write == 188864
    assert cost.flops_per_block == ops == 47104
    # at 0.1 ms a block on the H100: 1.9 GB/s of 3,350, no resource near
    # its peak
    roof = cost.roofline(wall_s=1e-4 * 10, blocks=10)
    assert roof["card"] == H100 and roof["bound"] == "latency/overhead"
    assert roof["pct_hbm_peak"] == round(
        100 * cost.bytes_per_block / 1e-4 / 3.35e12, 1)
    # a wall at the bytes bound reads 100% and "bytes"
    t_b = cost.bytes_per_block / 3.35e12
    roof = cost.roofline(wall_s=t_b * 10, blocks=10)
    assert roof["bound"] == "bytes" and roof["pct_hbm_peak"] == 100.0
    assert roof["bound_ms_per_block"] == pytest.approx(t_b * 1e3)


def test_cyclic_bucket_model_counts_the_voices():
    tl = compile_script((ci.CORPUS / "fb2.sk").read_text().splitlines(),
                        0.05, bank=WaveBank(), script_dir=ci.CORPUS)
    st2 = pack_stacked(stack_timelines([tl] * 2), cyclic=True)
    st4 = pack_stacked(stack_timelines([tl] * 4), cyclic=True)
    c2, c4 = (rl.estimate_bucket(s, H100) for s in (st2, st4))
    k = st2.params["amp"].shape[-1]
    fl = ck._flags(compute_feat(st2))
    assert c4.flops_per_block == 2 * c2.flops_per_block \
        == 4 * 512 * rl.cyclic_frame_ops(fl, k)
    table = 4 * np.asarray(st2.table_buffer).size
    assert c4.bytes_per_block - c2.bytes_per_block \
        == c2.bytes_per_block - (table + 4 * k + (4 * 512 if fl["noise"]
                                                  else 0))


def test_an_unknown_card_gets_no_percentages():
    cost = rl.estimate_bucket(_one_tier_bucket(), "NVIDIA A100-SXM4-80GB")
    assert cost.peaks is None and rl.peaks_for("cpu") is None
    roof = cost.roofline(wall_s=0.01, blocks=10)
    assert roof["card"] == "NVIDIA A100-SXM4-80GB"
    assert roof["pct_hbm_peak"] is None and roof["pct_f32_peak"] is None
    assert roof["bound"] is None and roof["bound_ms_per_block"] is None
    assert roof["gb_s"] == round(cost.bytes_per_block / 1e-3 / 1e9, 1)


def test_profile_aggregation_by_category():
    """The profiler tool's sums over ``key_averages()``-like rows: kernels
    by category (the volume kernel its own), torch calls per block; no
    device row gives None."""
    from types import SimpleNamespace as Row

    from skred_tpu_torch.tools import profile_roofline as prof

    rows = [Row(key="tier_keyed_kernel(TierArgs)", count=4,
                device_type="DeviceType.CUDA", device_time_total=400.0),
            Row(key="tier_mix_kernel(TierArgs)", count=4,
                device_type="DeviceType.CUDA", device_time_total=100.0),
            Row(key="lookup_time_major_kernel<true>", count=2,
                device_type="DeviceType.CUDA", device_time_total=50.0),
            Row(key="Memcpy HtoD (Pageable -> Device)", count=3,
                device_type="DeviceType.CUDA", device_time_total=30.0),
            Row(key="void at::native::vectorized_elementwise_kernel<4>",
                count=10, device_type="DeviceType.CUDA",
                device_time_total=20.0),
            Row(key="volume_kernel(VolumeArgs)", count=2,
                device_type="DeviceType.CUDA", device_time_total=15.0),
            Row(key="fused.volume", count=2, device_type="DeviceType.CPU",
                device_time_total=12.0),
            Row(key="aten::slice", count=40, device_type="DeviceType.CPU",
                device_time_total=0.0)]
    agg = prof.aggregate(rows, blocks=2)
    assert agg["device_busy_s"] == pytest.approx(615e-6)
    assert agg["device_ops"] == 25 and agg["device_ops_per_block"] == 12.5
    assert agg["categories_ms"] == {"tier kernel": 0.4, "tier mix": 0.1,
                                    "lookup": 0.05,
                                    "copies and slices": 0.03,
                                    "rest": 0.02, "volume kernel": 0.015}
    assert agg["torch_calls_per_block"] == {"slice": 20.0}
    assert prof.aggregate(rows[-2:], blocks=2) is None


# ---- the bucket model against the kernels' own counts ----

ROOT = ci.CORPUS.parent
# each segment's graph acyclic, their union not: the repeat-passes
# layout, estimate passes over a source prefix, then with a noise voice
UNION_CYCLE = ["v0 w0 f330 a3 F1,0.5", "v1 w2 f2 a2", "v2 w0 f220 a2 p0.3 "
               "~.06 v0 F1,0 v1 F0,0.4"]
UNION_CYCLE_NOISE = ["v0 w0 f330 a3 F1,0.5", "v1 w2 f2 a2 A3,0.3",
                     "v3 w6 f5 a1 h30", "v2 w0 f220 a2 P1 Q0.5 "
                     "~.06 v0 F1,0 v1 F0,0.4"]
# a noise tier 0, then a tier-kernel tier that folds
NOISE_MIXED = ["v1 w6 f3 a1 h40", "v0 w0 f220 a3 F1,0.5"]
COUNTS = {"tier": rl.tier_counts,
          "phase_walk_warp": rl.phase_walk_warp_counts,
          "lookup": rl.lookup_counts,
          "filt_smooth_noise": rl.filt_smooth_noise_counts}


def _live_samples(a):
    """The lookup samples the keyed filter reads: live samples of lanes
    that are not noise voices (its count is of what the data needs; the
    model counts every lane-sample)."""
    f, _, cnt, _, _, vecs, _ = a
    tpos = torch.arange(f.shape[0])[:, None]
    return int(((tpos < cnt[None]) & (vecs["is_noise"][None] == 0)).sum())


def _kernel_counts(st, monkeypatch):
    """(kernel, read, write, ops) of the kernel calls of a block of a CPU
    render, from the per-kernel counts on their arguments, on average
    over the render's blocks."""
    from skred_tpu_torch.engine import fused as tf

    calls = []

    def spy(name, real):
        def call(*a, **kw):
            r, w, o = COUNTS[name](a, kw)
            if name == "filt_smooth_noise":
                n, m = a[0].shape
                r += 4 * (n * m - _live_samples(a))
            calls.append((name, r, w, o))
            return real(*a, **kw)
        return call

    for name in COUNTS:
        monkeypatch.setattr(tf, name, spy(name, getattr(tf, name)))
    _, r, carry = tf._prepare(st, True, "cpu")
    with torch.no_grad():
        for k in range(st.num_blocks):
            carry, _ = tf._block_step(r, carry, k)
    per = len(calls) // st.num_blocks
    assert len(calls) == per * st.num_blocks
    mean = []
    for i in range(per):
        same = calls[i::per]
        assert len({c[0] for c in same}) == 1
        mean.append((same[0][0],) + tuple(
            sum(c[j] for c in same) / st.num_blocks for j in (1, 2, 3)))
    return mean


@pytest.mark.parametrize("name,lines,rows", [
    ("stress64", (ci.CORPUS / "stress64.sk").read_text().splitlines(), 4),
    ("noise64", (ROOT / "skred_tpu_torch" / "scripts" / "noise64.sk")
     .read_text().splitlines(), 4),
    ("noise_mixed", NOISE_MIXED, 3),
    ("union_cycle", UNION_CYCLE, 3),
    ("union_cycle_noise", UNION_CYCLE_NOISE, 3),
])
def test_block_calls_equal_the_kernels_counts(name, lines, rows,
                                              monkeypatch):
    """Call for call, the model's bytes and operations of a block (from
    the plan and the pack) equal the per-kernel counts on the arguments
    the renderer passes, on average over the blocks, once the keyed
    filter's read of the lookup's samples is taken at every lane-sample
    as the model takes it.  Seven blocks: UNION_CYCLE* change their
    reads at the segment that starts in block 5."""
    tl = compile_script(lines, 0.08, bank=WaveBank(), script_dir=ci.CORPUS)
    st = pack_stacked(stack_timelines([tl] * rows))
    assert st.num_blocks == 7
    got = _kernel_counts(st, monkeypatch)
    want = [(c.kernel, c.read, c.write, c.ops) for c in rl.block_calls(st)]
    assert [g[0] for g in got] == [w[0] for w in want], name
    for g, w in zip(got, want):
        assert g[1:] == pytest.approx(w[1:], rel=1e-12, abs=0), (name, g, w)
