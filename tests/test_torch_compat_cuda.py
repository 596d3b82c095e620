"""The CUDA compat kernel against its plain version, on the card.

``csrc/compat.cu`` on five scripts stacked as one batch (stress64,
noise64, fb2, fb4 with its waits cut, a voice copy), in both arithmetic
modes, with capture on and off, at 1 and 2 passes, against
``compat_block_plain`` on the same inputs (on the CPU, where it is
cheap); the card's ``render_timeline`` against the CPU's; the render
path never runs the plain version.  Needs an NVIDIA card and nvcc; skips
elsewhere.  Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_compat_cuda.py
"""

import pathlib

import numpy as np
import pytest
import torch

from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.engine import render as tr
from skred_tpu_torch.engine.kernels import compat as K
from skred_tpu_torch.host.timeline import compile_script, noise_stream
from skred_tpu_torch.parallel.batch import stack_timelines

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "corpus"
FB4_CUT = [ln.replace("~.5", "~.012")
           for ln in (CORPUS / "fb4.sk").read_text().splitlines()]
VOICE_COPY = ["v0 w0 f220 a3 h5 J900 K5000 Q25", "v1 w1 f110 a2 F0,0.5",
              "~.012 v0 >2 v2 f330 a2"]
SCRIPTS = [(CORPUS / "stress64.sk").read_text().splitlines(),
           (ROOT / "skred_tpu_torch" / "scripts"
            / "noise64.sk").read_text().splitlines(),
           (CORPUS / "fb2.sk").read_text().splitlines(), FB4_CUT,
           VOICE_COPY]
TWO_BLOCKS = 0.0232


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _batch(rows=8):
    bank = WaveBank()
    tls = [compile_script(lines, TWO_BLOCKS, bank=bank, script_dir=CORPUS)
           for lines in SCRIPTS]
    return stack_timelines([tls[i % len(tls)] for i in range(rows)])


def _same(a, b, what):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == np.float32:
        nan = np.isnan(a) & np.isnan(b)
        a, b = a.view(np.int32), b.view(np.int32)
        assert ((a == b) | nan).all(), f"{what}: {(a != b).sum()} differ"
    else:
        assert np.array_equal(a, b), what


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("exact", [True, False])
def test_compat_cuda_matches_plain(exact, passes, cuda_device):
    st = _batch()
    inp, cpu = tr.stacked_inputs(st, cuda_device), tr.stacked_inputs(st,
                                                                      "cpu")
    noise = torch.as_tensor(noise_stream(2 * 512))
    want = K.compat_block_plain(cpu, K.zero_carry(8, "cpu"), noise, 0, 2,
                                passes, exact, True)
    for capture in (False, True):
        before = K.compat_block.launches
        got = K.compat_block(inp, K.zero_carry(8, cuda_device),
                             noise.to(cuda_device), 0, 2, passes, exact,
                             capture)
        torch.cuda.synchronize()
        assert K.compat_block.launches == before + 1
        for g, w, nm in zip(got[0], want[0], ("cf", "ci", "vol_gain")):
            _same(g, w, nm)
        _same(got[1], want[1], "out")
        if capture:
            _same(got[2], want[2], "cap")
        else:
            assert got[2] is None


@pytest.mark.cuda
def test_card_render_equals_cpu_render_and_never_runs_plain(cuda_device,
                                                             monkeypatch):
    tl = compile_script(SCRIPTS[0], 4 * TWO_BLOCKS, bank=WaveBank(),
                        script_dir=CORPUS)
    want_out, want_cap = tr.render_timeline(tl, capture=True, device="cpu")

    def plain(*a, **kw):
        raise AssertionError("the card's render ran the plain version")

    monkeypatch.setattr(K, "compat_block_plain", plain)
    before = K.compat_block.launches
    out, cap = tr.render_timeline(tl, capture=True, device=cuda_device)
    assert K.compat_block.launches == before + 1
    _same(torch.from_numpy(out), torch.from_numpy(want_out), "out")
    _same(torch.from_numpy(cap), torch.from_numpy(want_cap), "cap")
    cs = tr.render_stream_device(tl, chunk_blocks=2, device=cuda_device)
    assert K.compat_block.launches == before + 1 + tl.num_blocks // 2
    last = want_out[(tl.num_blocks // 2 * 2 - 2) * 512:
                    tl.num_blocks // 2 * 2 * 512]
    assert cs == pytest.approx(np.abs(last.astype(np.float64)).sum(),
                               rel=1e-12)
