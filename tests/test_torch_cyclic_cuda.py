"""The CUDA cyclic kernel against its plain version, on the card.

Needs an NVIDIA card and nvcc; skips elsewhere.  Imports nothing of JAX,
so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cyclic_cuda.py
"""

import numpy as np
import pytest
import torch

from skred_tpu_torch.engine import cyclic as tc
from skred_tpu_torch.engine.kernels import cyclic as ck
from skred_tpu_torch.engine.kernels import cyclic_inputs as ci

SCRIPTS = ("fb1", "fb2", "fb3", "fb5", "all_features")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _lines(name):
    if name == "all_features":
        return ci.ALL_FEATURES
    return (ci.CORPUS / f"{name}.sk").read_text().splitlines()


def _same(a, b, what):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    assert np.array_equal(a, b), f"{what}: {(a != b).sum()} differ"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kb", "bk"])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name", SCRIPTS)
def test_cyclic_cuda_matches_plain_on_card(name, exact, layout, cuda_device):
    """One block at 1000 rows (a ragged last warp) and 128 frames; ``bk``
    hands the states over as transposed ``[B, k]`` tensors, as the
    renderer does."""
    args = list(ci.on_device(ci.block_inputs(_lines(name), 1000, seed=7,
                                             n=128), cuda_device))
    if layout == "bk":
        args[5] = {kk: (v.T.contiguous().T if v.dim() == 2 else v)
                   for kk, v in args[5].items()}
    before = ck.cyclic_block.launches
    got = ck.cyclic_block(*args, exact=exact)
    torch.cuda.synchronize()
    assert ck.cyclic_block.launches == before + 1
    want = ck.cyclic_block_plain(*args, exact=exact)
    assert sorted(got[2]) == sorted(want[2])
    for kk in want[2]:
        _same(got[2][kk], want[2][kk], f"{name} state {kk}")
        assert got[2][kk].stride() == args[5][kk].stride()
    _same(got[0], want[0], f"{name} out_l")
    _same(got[1], want[1], f"{name} out_r")


@pytest.mark.cuda
def test_cyclic_cuda_at_the_voice_limit(cuda_device):
    """64 voices in a ring: above 48 KB of shared memory a block, which
    the launch has to ask for."""
    lines = [f"v{v} w{v % 3} f{50 + 7 * v} a5 F{(v + 1) % 64},0.3 "
             f"J1 K3000 Q2 h3 c1,0.4" for v in range(64)]
    args = ci.on_device(ci.block_inputs(lines, 64, seed=8, n=32),
                        cuda_device)
    assert args[8] == 64
    got = ck.cyclic_block(*args)
    torch.cuda.synchronize()
    want = ck.cyclic_block_plain(*args)
    _same(got[0], want[0], "out_l")
    for kk in want[2]:
        _same(got[2][kk], want[2][kk], kk)


@pytest.mark.cuda
def test_render_cyclic_on_card_matches_the_cpu_render(cuda_device):
    st = ci.packed(_lines("fb4"), 0.05, 4)
    a = tc.render_cyclic(st, device=cuda_device)
    b = tc.render_cyclic(st, device="cpu")
    peak = float(np.abs(b).max())
    db = 20 * np.log10(max(float(np.abs(a - b).max()), 1e-30) / peak)
    assert db <= -100.0, f"{db:.1f} dB"


@pytest.mark.cuda
def test_cyclic_kernel_rejects_bad_inputs(cuda_device):
    args = list(ci.on_device(ci.block_inputs(_lines("fb1"), 8, seed=1, n=8),
                             cuda_device))
    bad = list(args)
    bad[4] = dict(args[4], amp=args[4]["amp"].double())
    with pytest.raises(TypeError):
        ck.cyclic_block(*bad)
    bad = list(args)
    bad[5] = dict(args[5], phase=args[5]["phase"][:, :4])
    with pytest.raises(ValueError):
        ck.cyclic_block(*bad)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError):
        ck.cyclic_block(*bad)
    bad = list(args)
    bad[4] = {kk: v for kk, v in args[4].items() if kk != "mis"}
    with pytest.raises(KeyError):
        ck.cyclic_block(*bad)
