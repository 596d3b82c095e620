"""The CUDA tier kernel against its plain version, on the card.

Needs an NVIDIA card and nvcc; skips elsewhere.  Imports nothing of JAX,
so it runs on a machine that has only the port's dependencies:

    python -m pytest -m cuda tests/test_torch_tier_cuda.py
"""

import numpy as np
import pytest
import torch

from skred_tpu_torch.engine.kernels import tier as tt
from skred_tpu_torch.engine.kernels.tier_inputs import (STRESS64_TIER0,
                                                        STRESS64_TIER1,
                                                        random_fold_inputs,
                                                        random_mix_weights,
                                                        random_tier_inputs)

ENV_AM = (True, True, False, True, True, True, True, True, True, False,
          True, False, (1, 2, 5, 7), True)
ALL = (True,) * 12 + ((1, 2, 3, 4, 5, 6, 7), False)
CASES = {"stress64_tier0": STRESS64_TIER0, "stress64_tier1": STRESS64_TIER1,
         "env_am": ENV_AM, "all": ALL}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _same(a, b, what):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    assert np.array_equal(a, b), f"{what}: {(a != b).sum()} differ"


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
    before = tt.tier.launches
    out, res = tt.tier(*args, feat=feat, exact=exact, n=n)
    torch.cuda.synchronize()
    assert tt.tier.launches == before + 1
    want, want_res = tt.tier_plain(*args, feat=feat, exact=exact, n=n)
    _same(out, want, "out")
    assert sorted(res) == sorted(want_res)
    for k in want_res:
        _same(res[k], want_res[k], k)


VARIANTS = {"mix": ((), True), "fold_fm": (("fm",), False),
            "fold_cz": (("cz",), False), "fold_am": (("am",), False),
            "fold_all": (("fm", "cz", "am"), False),
            "mix_fold_all": (("fm", "cz", "am"), True)}


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("case", ["stress64_tier1", "env_am", "all"])
def test_tier_cuda_mix_fold_matches_plain_on_card(case, variant, exact,
                                                  cuda_device):
    """The in-kernel mix and the modulator-bank fold, each stream alone
    and all together, with per-lane sources (some outside the bank), the
    bank a column slice of the block buffer the call writes its own
    columns of, and (mix with fold) earlier accumulators to add onto:
    out, out_last, acc_l, acc_r and every end state bit for bit."""
    feat = CASES[case]
    streams, mix = VARIANTS[variant]
    n, b, v, w = 512, 1024, 8, 4
    m = b * v
    table, cbase, inc, dm, amod, vecs, states = random_tier_inputs(
        feat, n, m, seed=7)
    bank, prev, fv = random_fold_inputs(n, m, b, w, seed=7)
    wl, wr = random_mix_weights(m, seed=7)
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
    before = tt.tier.launches
    out, res = tt.tier(*a, **kw(bufs[0]))
    torch.cuda.synchronize()
    assert tt.tier.launches == before + 1
    want, want_res = tt.tier_plain(*a, **kw(bufs[1]))
    _same(out, want, "out")
    _same(bufs[0], bufs[1], "the block buffer")
    assert sorted(res) == sorted(want_res)
    for k in want_res:
        _same(res[k], want_res[k], k)


@pytest.mark.cuda
def test_tier_cuda_build_log(cuda_device):
    """ptxas' registers and spills for both kernels of tier.cu."""
    from skred_tpu_torch.engine.kernels import build

    lines = [ln.strip() for ln in build.report("tier").splitlines()
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
