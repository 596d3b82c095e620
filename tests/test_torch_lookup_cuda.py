"""The CUDA table-lookup kernel against its plain version, on the card.

Both layouts of csrc/lookup.cu, bit for bit against ``lookup_plain``: the
noise pass's time-major form (``lookup``) and the lane-major form of the
JAX package's ``table_lookup_grouped`` and ``table_lookup_pallas``; lane
counts and row counts that are no multiple of the kernel's vectors,
indices below 0 and at or past the limit, lanes of limit 1, runs of lanes
with mixed slots, and views whose pointer is not 16-byte aligned.  Every
call launches the kernel once.  Needs an NVIDIA card and nvcc; skips
elsewhere.  Imports nothing of JAX, so it runs on a machine that has only
the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_lookup_cuda.py
"""

import numpy as np
import pytest
import torch

from skred_tpu_torch.engine.kernels import lookup as lk
from skred_tpu_torch.engine.kernels.noise_inputs import random_lookup_inputs

MS = [1, 3, 97, 8192, 57344]
NS = [1, 7, 512]


@pytest.fixture(scope="session")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from skred_tpu_torch.engine.kernels import build

    build.build_all(["lookup"])
    return torch.device("cuda")


def _same(a, b, what):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, what
    bad = a.view(np.int32) != b.view(np.int32)
    assert not bad.any(), f"{what}: {bad.sum()} of {bad.size} differ"


def _inputs(m, n, lane_major, seed, slot_size=4096):
    """Table, per-lane base and limit, and indices: slots mixed within
    runs of lanes (a run of 8 shares one unless it is broken up), a tenth
    of the lanes of limit 1, indices below 0 and at or past the limit."""
    table, slot, idx = random_lookup_inputs(
        n, m, slot_size, seed=seed, lane_major=lane_major,
        out_of_range=True, negative=True)
    rng = np.random.default_rng(seed)
    mixed = rng.uniform(0, 1, m) < 0.3
    slot = np.where(mixed, rng.integers(0, 4, m), slot).astype(np.int32)
    limit = rng.integers(1, slot_size + 1, m).astype(np.int32)
    limit[rng.uniform(0, 1, m) < 0.1] = 1
    return table, slot * slot_size, limit, idx


def _misaligned(x):
    """A contiguous copy of ``x`` whose data pointer is 4 bytes past a
    16-byte boundary."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    y = y.view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 4
    return y


def _on(dev):
    return lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("m", MS)
def test_lookup_pass_form_matches_plain_on_card(m, n, cuda_device):
    table, base, limit, idx = map(_on(cuda_device),
                                  _inputs(m, n, False, seed=m + n))
    assert idx.shape == (n, m)
    before = lk.lookup.launches
    got = lk.lookup(table, base, limit, idx)
    torch.cuda.synchronize()
    assert lk.lookup.launches == before + 1
    _same(got, lk.lookup_plain(table, base, limit, idx), "lookup")


@pytest.mark.cuda
@pytest.mark.parametrize("slot_size", [4096, 32768])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("m", MS)
def test_lookup_lane_major_matches_plain_on_card(m, n, slot_size,
                                                 cuda_device):
    on = _on(cuda_device)
    table, slot, idx = random_lookup_inputs(n, m, slot_size, seed=m + 2 * n,
                                            out_of_range=True, negative=True)
    tab3 = on(table).reshape(-1, slot_size // 128, 128)
    base = on(slot) * slot_size
    want = lk.lookup_plain(on(table), base, torch.full_like(base, slot_size),
                           on(idx), lane_major=True)
    for fn in (lk.table_lookup_grouped, lk.table_lookup_pallas):
        before = fn.launches
        got = fn(tab3, on(slot), on(idx), slot_size)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _same(got, want, fn.__name__)


@pytest.mark.cuda
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("m", [3, 97, 8192])
def test_lookup_lane_major_limits_on_card(m, n, cuda_device):
    """The lane-major kernel with per-lane limits (lanes of limit 1) and
    mixed slots, as the shared launch runs it."""
    table, base, limit, idx = map(_on(cuda_device),
                                  _inputs(m, n, True, seed=3 * m + n))
    got, launched = lk._run(table, base, limit, idx, True)
    torch.cuda.synchronize()
    assert launched
    _same(got, lk.lookup_plain(table, base, limit, idx, lane_major=True),
          "lane-major lookup")


@pytest.mark.cuda
@pytest.mark.parametrize("lane_major", [False, True])
@pytest.mark.parametrize("which", ["idx", "base", "table", "all"])
def test_lookup_misaligned_views_on_card(which, lane_major, cuda_device):
    """Offset views (data pointers 4 bytes past a 16-byte boundary) are
    taken, and read through the kernel's scalar path."""
    m, n = 8192, 512
    args = list(map(_on(cuda_device),
                    _inputs(m, n, lane_major, seed=5 + lane_major)))
    pos = {"table": [0], "base": [1, 2], "idx": [3], "all": [0, 1, 2, 3]}
    for k in pos[which]:
        args[k] = _misaligned(args[k])
    got, launched = lk._run(*args, lane_major)
    torch.cuda.synchronize()
    assert launched
    _same(got, lk.lookup_plain(*args, lane_major=lane_major), which)


@pytest.mark.cuda
def test_lookup_refuses_what_the_kernel_does_not_take(cuda_device):
    table, base, limit, idx = map(_on(cuda_device),
                                  _inputs(97, 7, False, seed=1))
    with pytest.raises(TypeError):                   # i64 indices
        lk.lookup(table, base, limit, idx.long())
    with pytest.raises(ValueError):                  # a strided view
        lk.lookup(table, base, limit, idx.T.contiguous().T)
    with pytest.raises(ValueError):                  # limit of another width
        lk.lookup(table, base, limit[:-1], idx)
    with pytest.raises(ValueError):                  # base on the CPU
        lk.lookup(table, base.cpu(), limit, idx)
