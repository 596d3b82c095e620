"""The CUDA tier kernel against its plain version, on the card.

csrc/tier.cu is built once per ``tier_key``.  Every key this file
launches is built once, in one parallel build, by a
session fixture.  Needs an NVIDIA card and nvcc; skips elsewhere.
Imports nothing of JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest -m cuda tests/test_torch_tier_cuda.py
"""

import numpy as np
import pytest
import torch

from skred_tpu_torch.engine.kernels import tier as tt
from skred_tpu_torch.engine.kernels.tier_inputs import (STRESS64_TIER0,
                                                        STRESS64_TIER1,
                                                        out_of_range,
                                                        random_fold_inputs,
                                                        random_mix_weights,
                                                        random_tier_inputs)

ENV_AM = (True, True, False, True, True, True, True, True, True, False,
          True, False, (1, 2, 5, 7), True)
ALL = (True,) * 12 + ((1, 2, 3, 4, 5, 6, 7), False)
CASES = {"stress64_tier0": STRESS64_TIER0, "stress64_tier1": STRESS64_TIER1,
         "env_am": ENV_AM, "all": ALL}


VARIANTS = {"mix": ((), True), "fold_fm": (("fm",), False),
            "fold_cz": (("cz",), False), "fold_am": (("am",), False),
            "fold_all": (("fm", "cz", "am"), False),
            "mix_fold_all": (("fm", "cz", "am"), True)}
MIX_FOLD_CASES = ["stress64_tier1", "env_am", "all"]
ROWS = [1, 8, 1000, 1024]
SHORT_BLOCKS = [1, 37, 77]
ALL_STREAMS = ("fm", "cz", "am")


def _file_keys():
    """Every keyed build this file launches."""
    keys = []
    for exact in (True, False):
        for feat in CASES.values():
            keys.append(tt.tier_key(feat, exact))
            keys.append(tt.tier_key(feat, exact, True, ALL_STREAMS))
        for case in MIX_FOLD_CASES:
            for streams, mix in VARIANTS.values():
                keys.append(tt.tier_key(CASES[case], exact, mix, streams))
    return list(dict.fromkeys(keys))


@pytest.fixture(scope="session")
def built():
    """The card, with every key of the file built in one parallel build."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from skred_tpu_torch.engine.kernels import build

    build.build_all([("tier", key) for key in _file_keys()])
    return torch.device("cuda")


@pytest.fixture
def cuda_device(built):
    return built


def _same(a, b, what):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    assert np.array_equal(a, b), f"{what}: {(a != b).sum()} differ"


def _counts():
    return (tt.tier.launches, tt.tier_keyed.launches)


def _launched(before):
    """The counts after one launch from ``before``."""
    t, k = before
    return (t + 1, k + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tier_cuda_matches_plain_on_card(case, exact, cuda_device):
    feat = CASES[case]
    n, m = 512, 8192
    table, cbase, inc, dm, amod, vecs, states = random_tier_inputs(
        feat, n, m, seed=4)
    t = lambda a: None if a is None else torch.from_numpy(a).to(cuda_device)
    args = (t(table), cbase, t(inc), t(dm), t(amod),
            {k: t(v) for k, v in vecs.items()},
            {k: t(v) for k, v in states.items()})
    before = _counts()
    out, res = tt.tier(*args, feat=feat, exact=exact, n=n)
    torch.cuda.synchronize()
    assert _counts() == _launched(before)
    want, want_res = tt.tier_plain(*args, feat=feat, exact=exact, n=n)
    _same(out, want, "out")
    assert sorted(res) == sorted(want_res)
    for k in want_res:
        _same(res[k], want_res[k], k)


def _check_mix_fold(feat, streams, mix, exact, dev, n, b, v, w, seed,
                    inputs=None):
    """One tier call with the given mix and fold, the kernel against the
    plain version: out, the block buffer, every result bit for bit."""
    m = b * v
    if inputs is None:
        inputs = random_tier_inputs(feat, n, m, seed=seed)
    table, cbase, inc, dm, amod, vecs, states = inputs
    bank, prev, fv = random_fold_inputs(n, m, b, w, seed=seed)
    wl, wr = random_mix_weights(m, seed=seed)
    cuda_device = dev
    t = lambda a: None if a is None else torch.from_numpy(a).to(cuda_device)
    given = {"fm": t(inc), "cz": t(dm), "am": t(amod)}
    # a stream the feature set lacks is not folded: its argument stays
    for k in tt._folded(tt._flags(feat), tt.Fold(None, None, w, streams)):
        given[k] = None
    tv = {k: t(x) for k, x in {**vecs, **fv}.items()}
    ts = {k: t(x) for k, x in states.items()}
    bufs = []
    for _ in (0, 1):                      # the kernel's and the plain one's
        buf = torch.zeros((n, (w + v) * b), device=cuda_device)
        buf[:, :w * b] = t(bank)
        bufs.append(buf)

    def kw(buf):
        d = dict(feat=feat, exact=exact, n=n, b=b)
        if streams:
            d.update(fold=tt.Fold(buf[:, :w * b], t(prev), w, streams),
                     out=buf[:, w * b:])
        if mix:
            d["mixw"] = (t(wl), t(wr))
        if mix and streams:
            d["acc"] = (torch.full((n, b), 0.25, device=cuda_device),
                        torch.full((n, b), -0.5, device=cuda_device))
        return d

    a = (t(table), cbase, given["fm"], given["cz"], given["am"], tv, ts)
    before = _counts()
    out, res = tt.tier(*a, **kw(bufs[0]))
    torch.cuda.synchronize()
    assert _counts() == _launched(before)
    want, want_res = tt.tier_plain(*a, **kw(bufs[1]))
    _same(out, want, "out")
    _same(bufs[0], bufs[1], "the block buffer")
    assert sorted(res) == sorted(want_res)
    for k in want_res:
        _same(res[k], want_res[k], k)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("case", MIX_FOLD_CASES)
def test_tier_cuda_mix_fold_matches_plain_on_card(case, variant, exact,
                                                  cuda_device):
    """The in-kernel mix and the modulator-bank fold, each stream alone
    and all together, with per-lane sources (some outside the bank), the
    bank a column slice of the block buffer the call writes its own
    columns of, and (mix with fold) earlier accumulators to add onto:
    out, out_last, acc_l, acc_r and every end state bit for bit."""
    streams, mix = VARIANTS[variant]
    _check_mix_fold(CASES[case], streams, mix, exact, cuda_device, 512,
                    1024, 8, 4, seed=7)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("case", ["stress64_tier1", "all"])
def test_tier_keyed_rows_match_plain_on_card(case, rows, exact, cuda_device):
    """The kernel with mix and every fold at 1, 8, 1000 and 1024
    batch rows over 7 voices: lane counts that are not a multiple of the
    block size (7, 56, 7000), and at 1000 rows warps that straddle two
    voices, so one warp holds different sources, CZ modes and gates."""
    _check_mix_fold(CASES[case], ALL_STREAMS, True, exact, cuda_device,
                    512, rows, 7, 3, seed=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SHORT_BLOCKS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tier_keyed_short_blocks_match_plain_on_card(case, n, cuda_device):
    """Blocks that end inside a chunk of the kernel's walk."""
    _check_mix_fold(CASES[case], ALL_STREAMS, True, True, cuda_device, n,
                    1000, 7, 3, seed=n)


@pytest.mark.cuda
def test_tier_keyed_per_lane_cz_modes_match_plain_on_card(cuda_device):
    """Every CZ mode drawn per lane, so each warp mixes modes (and
    diverges): the bits stay the plain version's."""
    feat = CASES["all"]
    n, b, v = 512, 1000, 7
    inputs = random_tier_inputs(feat, n, b * v, seed=31)
    modes = inputs[5]["cz_mode"]
    per_warp = [len(set(modes[i:i + 32])) for i in range(0, modes.size, 32)]
    assert min(per_warp) >= 4, per_warp
    for exact in (True, False):
        _check_mix_fold(feat, ALL_STREAMS, True, exact, cuda_device, n, b,
                        v, 3, seed=31, inputs=inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tier_keyed_out_of_range_matches_plain_on_card(case, exact,
                                                       cuda_device):
    """Phase-walk operands outside the fast wrap's range (increments of
    7.3 loop lengths, raw FM samples of +-1e30, +-inf and NaN, NaN and
    infinite start phases): the lanes that meet one render the block
    again through wrap_fmod's slow path, bit-equal to the plain version,
    without and with the fold (the folded FM stream then takes the large
    increments only)."""
    feat = CASES[case]
    n, b, v = 512, 1000, 7
    inputs = out_of_range(feat, random_tier_inputs(feat, n, b * v,
                                                   seed=41), seed=41)
    ph = inputs[6]["phase"]
    assert np.isnan(ph).any() and np.isinf(ph).any()
    for streams, mix in (((), False), (ALL_STREAMS, True)):
        _check_mix_fold(feat, streams, mix, exact, cuda_device, n, b, v, 3,
                        seed=41, inputs=inputs)


@pytest.mark.cuda
def test_tier_keyed_builds_spill_free(cuda_device):
    """ptxas reports no spill for any key this file builds, read from
    the report kept beside each library (so a cached build counts)."""
    from skred_tpu_torch.engine.kernels import build

    for key in _file_keys():
        rep = build.report("tier", key)
        lines = [ln.strip() for ln in rep.splitlines() if "spill" in ln]
        assert lines, rep
        assert all(ln.startswith("0 bytes stack frame, 0 bytes spill "
                                 "stores, 0 bytes spill loads")
                   for ln in lines), (build.label("tier", key), lines)


@pytest.mark.cuda
def test_tier_takes_the_keyed_library_and_refuses_another_key(cuda_device):
    """``tier`` launches the keyed library of its arguments' key; a
    library refuses the arguments of another key (-1 ->
    RuntimeError)."""
    from skred_tpu_torch.engine.kernels import cuda_call

    feat = STRESS64_TIER0
    table, cbase, inc, dm, amod, vecs, states = random_tier_inputs(
        feat, 16, 256, seed=1)
    t = lambda a: None if a is None else torch.from_numpy(a).to(cuda_device)
    a = (t(table), cbase, t(inc), t(dm), t(amod),
         {k: t(v) for k, v in vecs.items()},
         {k: t(v) for k, v in states.items()})
    before = _counts()
    tt.tier(*a, feat=feat, n=16)
    assert _counts() == _launched(before)
    args, _, _ = tt._pack_args(*a, feat=feat, exact=True, n=16, b=None,
                               mixw=None, acc=None, fold=None, out=None)
    for other in (tt.tier_key(feat, False), tt.tier_key(STRESS64_TIER1),
                  tt.tier_key(feat, True, True)):
        with pytest.raises(RuntimeError, match="not the build's key"):
            cuda_call.launch("tier", args, cuda_device, other,
                             "tier_keyed_launch")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_tier_cuda_build_log(cuda_device):
    """ptxas' registers and spills for both kernels of tier.cu, under
    stress64's two tier keys (mix on, tier 1 folded)."""
    from skred_tpu_torch.engine.kernels import build

    lines = [ln.strip() for key in (
        tt.tier_key(STRESS64_TIER0, True, True),
        tt.tier_key(STRESS64_TIER1, True, True, ("fm",)))
        for ln in build.report("tier", key).splitlines()
        if "registers" in ln or "spill" in ln]
    print("\n".join(lines))
    assert not any("bytes spill stores" in ln
                   and not ln.lstrip().startswith("0 bytes")
                   for ln in lines), lines


@pytest.mark.cuda
def test_tier_cuda_rejects_bad_inputs(cuda_device):
    feat = STRESS64_TIER0
    table, cbase, inc, dm, amod, vecs, states = random_tier_inputs(
        feat, 16, 256, seed=1)
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    vecs_t = {k: t(v) for k, v in vecs.items()}
    states_t = {k: t(v) for k, v in states.items()}
    vecs_t["amp"] = vecs_t["amp"].double()
    with pytest.raises(TypeError):
        tt.tier(t(table), cbase, t(inc), None, None, vecs_t, states_t,
                feat=feat, n=16)
    vecs_t["amp"] = torch.from_numpy(vecs["amp"])          # on the CPU
    with pytest.raises(ValueError):
        tt.tier(t(table), cbase, t(inc), None, None, vecs_t, states_t,
                feat=feat, n=16)
    vecs_t["amp"] = t(vecs["amp"])
    wl, wr = (t(x) for x in random_mix_weights(256, seed=1))
    with pytest.raises(ValueError, match="need b"):        # mix without b
        tt.tier(t(table), cbase, t(inc), None, None, vecs_t, states_t,
                feat=feat, n=16, mixw=(wl, wr))
    with pytest.raises(ValueError, match="unit stride"):   # a transposed out
        tt.tier(t(table), cbase, t(inc), None, None, vecs_t, states_t,
                feat=feat, n=16,
                out=torch.zeros((256, 16), device=cuda_device).T)
