"""The noise pass's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA card and nvcc; skips elsewhere.  Imports nothing of JAX,
so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_noise_cuda.py
"""

import numpy as np
import pytest
import torch

from skred_tpu_torch.engine.kernels import filt_smooth as fs
from skred_tpu_torch.engine.kernels import lookup as lk
from skred_tpu_torch.engine.kernels import phase_walk as pw
from skred_tpu_torch.engine.kernels.noise_inputs import (NOISE64_FS0,
                                                         NOISE64_FS1,
                                                         random_fs_inputs,
                                                         random_lookup_inputs,
                                                         random_phase_inputs)

FS_CASES = {"noise64_tier0": NOISE64_FS0, "noise64_tier1": NOISE64_FS1,
            "all": (True,) * 8,
            "none_const_alive": (False,) * 8}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b, what):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.dtype == b.dtype, what
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    assert np.array_equal(a, b), f"{what}: {(a != b).sum()} differ"


def _on(dev):
    return lambda a: None if a is None else torch.from_numpy(a).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("fm", [False, True])
@pytest.mark.parametrize("finish", [False, True])
def test_phase_walk_cuda_matches_plain_on_card(fm, finish, cuda_device):
    n, m = 512, 8192
    args = list(map(_on(cuda_device),
                    random_phase_inputs(fm, finish, n, m, seed=6)))
    before = pw.phase_walk.launches
    got = pw.phase_walk(*args, fm=fm, finish=finish, n=n)
    torch.cuda.synchronize()
    assert pw.phase_walk.launches == before + 1
    want = pw.phase_walk_plain(*args, fm=fm, finish=finish, n=n)
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
        else:
            _same(g, w, f"output {k}")


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
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("case", sorted(FS_CASES))
def test_filt_smooth_cuda_matches_plain_on_card(case, exact, cuda_device):
    feat = FS_CASES[case]
    n, m = 512, 8192
    args = list(map(_on(cuda_device), random_fs_inputs(feat, n, m, seed=9)))
    before = fs.filt_smooth.launches
    got = fs.filt_smooth(*args, exact=exact, feat=feat)
    torch.cuda.synchronize()
    assert fs.filt_smooth.launches == before + 1
    want = fs.filt_smooth_plain(*args, exact=exact, feat=feat)
    for k, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"output {k}")


@pytest.mark.cuda
def test_noise_kernels_reject_bad_inputs(cuda_device):
    on = _on(cuda_device)
    args = list(map(on, random_phase_inputs(True, True, 16, 256, seed=1)))
    args[3] = args[3].double()                       # lo
    with pytest.raises(TypeError):
        pw.phase_walk(*args, fm=True, finish=True, n=16)
    table, slot, idx = random_lookup_inputs(16, 64, 4096, seed=1)
    with pytest.raises(ValueError):                  # idx on the CPU
        lk.table_lookup_grouped(on(table).reshape(-1, 32, 128), on(slot),
                                torch.from_numpy(idx))
    args = list(map(on, random_fs_inputs(NOISE64_FS0, 16, 256, seed=1)))
    args[0] = args[0][:, :128]                       # x of the wrong width
    with pytest.raises(ValueError):
        fs.filt_smooth(*args, feat=NOISE64_FS0)
