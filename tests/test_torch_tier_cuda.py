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
