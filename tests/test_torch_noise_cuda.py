"""The noise pass's CUDA kernels against their plain versions, on the card.

csrc/phase_walk.cu and csrc/filt_smooth.cu as the render path launches
them (``phase_walk_warp``, ``filt_smooth_noise``, one library per key,
all built once in one parallel build by a session fixture), and the
lookup.  Needs an NVIDIA card and nvcc; skips elsewhere.  Imports
nothing of JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_noise_cuda.py
"""

import pathlib

import numpy as np
import pytest
import torch

from skred_tpu_torch.engine.kernels import filt_smooth as fs
from skred_tpu_torch.engine.kernels import lookup as lk
from skred_tpu_torch.engine.kernels import phase_walk as pw
from skred_tpu_torch.engine.kernels.noise_inputs import (
    NOISE64_FSN0, NOISE64_FSN1, NOISE64_WARP0, NOISE64_WARP1,
    random_lookup_inputs, random_noise_fs_inputs, random_warp_inputs)
from skred_tpu_torch.engine.kernels.tier import Fold

ALL_MODES = (1, 2, 3, 4, 5, 6, 7)
# phase_walk_warp's (fm, finish, direction, cz, czm, cz_modes, ts_pow2)
WARP_CASES = {
    "noise64_tier0": NOISE64_WARP0, "noise64_tier1": NOISE64_WARP1,
    "all": (True, True, True, True, True, ALL_MODES, False),
    "czm_pow2": (True, False, False, True, True, (1, 4, 6), True),
    "cz_no_fm": (False, True, False, True, False, (2, 3, 5, 7), False),
    "fm_only": (True, False, True, False, False, (), False),
}
# filt_smooth_noise's (flt, sm, hold, quant, am_self, env, am, finish)
FSN_CASES = {
    "noise64_tier0": NOISE64_FSN0, "noise64_tier1": NOISE64_FSN1,
    "all": (True,) * 8, "none": (False,) * 8,
    "am_self_env_am": (True, False, True, True, True, True, True, False),
    "sm_am_self": (False, True, False, False, True, False, True, True),
}
B, V, W = 1024, 8, 4                # rows, voices of the tier, bank voices
SCRIPTS = pathlib.Path(__file__).resolve().parent.parent \
    / "skred_tpu_torch" / "scripts"


def _keys():
    """Every keyed build this file launches."""
    return ([("phase_walk", pw.phase_walk_key(f))
             for f in WARP_CASES.values()]
            + [("filt_smooth", fs.filt_smooth_key(f))
               for f in FSN_CASES.values()])


@pytest.fixture(scope="session")
def built():
    """The card, with every source and key of the file built in one
    parallel build."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from skred_tpu_torch.engine.kernels import build

    build.build_all(["lookup"] + _keys())
    return torch.device("cuda")


@pytest.fixture
def cuda_device(built):
    return built


def _same(a, b, what):
    """Bit for bit, except that two NaNs agree whatever their payload (the
    card's fma gives another NaN than its other operations); a NaN
    against a number still differs."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, what
    both_nan = np.zeros(a.shape, bool)
    if a.dtype == np.float32:
        both_nan = np.isnan(a) & np.isnan(b)
        a, b = a.view(np.int32), b.view(np.int32)
    bad = (a != b) & ~both_nan
    assert not bad.any(), f"{what}: {bad.sum()} differ"


def _on(dev):
    return lambda a: None if a is None else torch.from_numpy(a).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("slot_size", [4096, 32768])
def test_lookup_cuda_matches_plain_on_card(slot_size, cuda_device):
    on = _on(cuda_device)
    table, slot, idx = random_lookup_inputs(512, 8192, slot_size, seed=8,
                                            out_of_range=True)
    tab3 = on(table).reshape(-1, slot_size // 128, 128)
    base = on(slot) * slot_size
    limit = torch.full_like(base, slot_size)
    want = lk.lookup_plain(on(table), base, limit, on(idx), lane_major=True)
    for fn in (lk.table_lookup_grouped, lk.table_lookup_pallas):
        before = fn.launches
        got = fn(tab3, on(slot), on(idx), slot_size)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _same(got, want, fn.__name__)
    # the pass's form: time-major indices, per-lane base and limit
    idx_t = on(np.ascontiguousarray(idx.T))
    before = lk.lookup.launches
    got = lk.lookup(on(table), base, limit, idx_t)
    torch.cuda.synchronize()
    assert lk.lookup.launches == before + 1
    _same(got, lk.lookup_plain(on(table), base, limit, idx_t), "lookup")


@pytest.mark.cuda
def test_noise_kernels_reject_bad_inputs(cuda_device):
    on = _on(cuda_device)
    feat = NOISE64_WARP1
    bank, prev, vecs, ph0, fin0 = random_warp_inputs(feat, 16, 64, 8, 2,
                                                     seed=1)
    tv = {k: on(x) for k, x in vecs.items()}
    tv["lo"] = tv["lo"].double()
    with pytest.raises(TypeError):
        pw.phase_walk_warp(Fold(on(bank), on(prev), 2), tv, on(ph0),
                           on(fin0), feat=feat, n=16, b=8)
    table, slot, idx = random_lookup_inputs(16, 64, 4096, seed=1)
    with pytest.raises(ValueError):                  # idx on the CPU
        lk.table_lookup_grouped(on(table).reshape(-1, 32, 128), on(slot),
                                torch.from_numpy(idx))
    feat = NOISE64_FSN0
    f, nz, cnt, cbase, bank, prev, vecs, states = random_noise_fs_inputs(
        feat, 16, 64, 8, 2, seed=1)
    with pytest.raises(ValueError):                  # f of the wrong width
        fs.filt_smooth_noise(on(f)[:, :32], on(nz), on(cnt), cbase,
                             Fold(on(bank), on(prev), 2),
                             {k: on(x) for k, x in vecs.items()},
                             {k: on(x) for k, x in states.items()},
                             feat=feat, b=8)


def _warp_call(feat, dev, n, seed, out_of_range=False):
    """phase_walk_warp on the card against its plain version, the bank a
    column slice of a wider block buffer: every output bit for bit."""
    bank, prev, vecs, ph0, fin0 = random_warp_inputs(
        feat, n, B * V, B, W, seed=seed, out_of_range=out_of_range)
    on = _on(dev)
    buf = torch.zeros((n, (W + V) * B), device=dev)
    buf[:, :W * B] = on(bank)
    fold = Fold(buf[:, :W * B], on(prev), W)
    tv = {k: on(x) for k, x in vecs.items()}
    before = pw.phase_walk_warp.launches
    got = pw.phase_walk_warp(fold, tv, on(ph0), on(fin0), feat=feat, n=n,
                             b=B)
    torch.cuda.synchronize()
    assert pw.phase_walk_warp.launches == before + 1
    want = pw.phase_walk_warp_plain(fold, tv, on(ph0), on(fin0), feat=feat,
                                    n=n, b=B)
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
        else:
            _same(g, w, f"output {k}")
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_phase_walk_warp_matches_plain_on_card(case, cuda_device):
    """The keyed walk with its reads, FM increment, CZ warp and clip:
    index, alive count, end phase and finished flag bit for bit."""
    idx, cnt, _, _ = _warp_call(WARP_CASES[case], cuda_device, 512, seed=61)
    assert (idx > 0).float().mean() > 0.5
    assert (cnt.float().mean() > 100)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_phase_walk_warp_out_of_range_matches_plain_on_card(case,
                                                            cuda_device):
    """Operands outside the fast wrap's range (increments of 7.3 loop
    lengths, bank samples of +-1e30, +-inf and NaN, NaN and infinite
    start phases): the lanes that meet one render the block again through
    wrap_fmod's slow path, bit-equal to the plain version."""
    _warp_call(WARP_CASES[case], cuda_device, 512, seed=62,
               out_of_range=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37])
@pytest.mark.parametrize("case", ["noise64_tier1", "all"])
def test_phase_walk_warp_short_blocks_match_plain_on_card(case, n,
                                                          cuda_device):
    """Blocks that end inside a chunk of the keyed walk."""
    _warp_call(WARP_CASES[case], cuda_device, n, seed=n)


def _fsn_call(feat, dev, n, seed):
    """filt_smooth_noise on the card against its plain version, writing
    into a column slice of a wider block buffer: out, the buffer around
    it and every end state bit for bit."""
    f, nz, cnt, cbase, bank, prev, vecs, states = random_noise_fs_inputs(
        feat, n, B * V, B, W, seed=seed)
    on = _on(dev)
    fold = Fold(on(bank), on(prev), W)
    tv = {k: on(x) for k, x in vecs.items()}
    ts = {k: on(x) for k, x in states.items()}
    bufs = [torch.full((n, (W + V) * B), 7.0, device=dev) for _ in (0, 1)]
    cols = lambda buf: buf[:, W * B:]
    before = fs.filt_smooth_noise.launches
    out, ends = fs.filt_smooth_noise(on(f), on(nz), on(cnt), cbase, fold, tv,
                                     ts, feat=feat, b=B, out=cols(bufs[0]))
    torch.cuda.synchronize()
    assert fs.filt_smooth_noise.launches == before + 1
    want, want_ends = fs.filt_smooth_noise_plain(
        on(f), on(nz), on(cnt), cbase, fold, tv, ts, feat=feat, b=B,
        out=cols(bufs[1]))
    _same(out, want, "out")
    _same(bufs[0], bufs[1], "the block buffer")
    assert sorted(ends) == sorted(want_ends)
    for k in want_ends:
        _same(ends[k], want_ends[k], k)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FSN_CASES))
def test_filt_smooth_noise_matches_plain_on_card(case, cuda_device):
    """The keyed serial stages with the noise select, dead mask,
    envelope and am stream: out and every end state bit for bit."""
    out = _fsn_call(FSN_CASES[case], cuda_device, 512, seed=63)
    assert (out != 0).float().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37])
@pytest.mark.parametrize("case", ["noise64_tier1", "all"])
def test_filt_smooth_noise_short_blocks_match_plain_on_card(case, n,
                                                            cuda_device):
    _fsn_call(FSN_CASES[case], cuda_device, n, seed=n)


@pytest.mark.cuda
def test_keyed_noise_builds_spill_free(cuda_device):
    """ptxas reports no spill for any noise key this file builds, read
    from the report kept beside each library (so a cached build
    counts)."""
    from skred_tpu_torch.engine.kernels import build

    for name, key in _keys():
        rep = build.report(name, key)
        lines = [ln.strip() for ln in rep.splitlines() if "spill" in ln]
        assert lines, rep
        assert all(ln.startswith("0 bytes stack frame, 0 bytes spill "
                                 "stores, 0 bytes spill loads")
                   for ln in lines), (build.label(name, key), lines)


@pytest.mark.cuda
def test_keyed_noise_kernels_refuse_another_key(cuda_device):
    """A keyed library refuses the arguments of another key (-1 ->
    RuntimeError)."""
    from skred_tpu_torch.engine.kernels import cuda_call

    on = _on(cuda_device)
    feat = WARP_CASES["noise64_tier1"]
    bank, prev, vecs, ph0, fin0 = random_warp_inputs(feat, 16, 64, 8, 2,
                                                     seed=1)
    args, _ = pw._pw_pack(Fold(on(bank), on(prev), 2),
                          {k: on(x) for k, x in vecs.items()}, on(ph0),
                          on(fin0), feat, 16, 8)
    with pytest.raises(RuntimeError, match="not the build's key"):
        cuda_call.launch("phase_walk", args, cuda_device,
                         pw.phase_walk_key(WARP_CASES["all"]),
                         "phase_walk_keyed_launch")
    feat = FSN_CASES["noise64_tier1"]
    f, nz, cnt, cbase, bank, prev, vecs, states = random_noise_fs_inputs(
        feat, 16, 64, 8, 2, seed=1)
    args, _, _ = fs._fn_pack(on(f), on(nz), on(cnt), cbase,
                             Fold(on(bank), on(prev), 2),
                             {k: on(x) for k, x in vecs.items()},
                             {k: on(x) for k, x in states.items()}, feat,
                             8, None)
    with pytest.raises(RuntimeError, match="not the build's key"):
        cuda_call.launch("filt_smooth", args, cuda_device,
                         fs.filt_smooth_key(FSN_CASES["all"]),
                         "filt_smooth_keyed_launch")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_noise_pass_launches_only_the_keyed_variants(cuda_device):
    """noise64 on the card: each noise tier launches the keyed walk, the
    lookup and the keyed filter/smoother once a block; the render equals
    the one whose wrappers run their plain versions on the card."""
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine import fused
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

    lines = (SCRIPTS / "noise64.sk").read_text().splitlines()
    tl = compile_script(lines, 3 * 512 / 44100.0, bank=WaveBank(),
                        script_dir=SCRIPTS.parent.parent / "corpus")
    st = pack_stacked(stack_timelines([tl] * 8))
    counters = (pw.phase_walk_warp, fs.filt_smooth_noise, lk.lookup)
    before = [c.launches for c in counters]
    got = fused.render_fused(st, device=cuda_device)
    after = [c.launches - b for c, b in zip(counters, before)]
    assert after == [2 * st.num_blocks] * 3, after
    real = (fused.phase_walk_warp, fused.filt_smooth_noise, fused.lookup)
    fused.phase_walk_warp = pw.phase_walk_warp_plain
    fused.filt_smooth_noise = fs.filt_smooth_noise_plain
    fused.lookup = lk.lookup_plain
    try:
        want = fused.render_fused(st, device=cuda_device)
    finally:
        fused.phase_walk_warp, fused.filt_smooth_noise, fused.lookup = real
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
