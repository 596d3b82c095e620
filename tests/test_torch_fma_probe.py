"""``skred_tpu_torch/tools/fma_probe.py``: its oracle and its verdict.

The port's fma (``numerics.fma32``, and ``fma32_emulated`` built from f32
operations alone) is bit-equal to the JAX package's in-kernel
``kernels._kfma`` on the probe's adversarial operands (the original
tool's generator, seed 7) at ``1 << 16`` values.  On the CPU the probe
compares torch's separate multiply and add with ``fma32``:
NOT-CONTRACTED.  The card case builds ``csrc/fma_probe.cu`` under the
port's flags and under ``-fmad=true`` and skips without a card.
"""

import jax
import numpy as np
import pytest
import torch

from skred_tpu.engine.kernels import _kfma
from skred_tpu_torch.engine.kernels import build
from skred_tpu_torch.engine.numerics import fma32, fma32_emulated
from skred_tpu_torch.tools import fma_probe as fp

N = 1 << 16


def test_port_fma_is_the_jax_kernels_fma():
    a, b, c = fp.inputs(N)
    want = np.asarray(jax.jit(_kfma)(a, b, c))
    t = [torch.from_numpy(x) for x in (a, b, c)]
    for fn in (fma32, fma32_emulated):
        got = fn(*t).numpy()
        assert fp.same_bits(got, want).all(), fn.__name__
    # the operands are adversarial: two roundings differ from the fma
    two = np.float32(a * b) + c
    assert (~fp.same_bits(two, want)).sum() > N // 4


def test_cpu_probe_is_not_contracted(capsys):
    rec = fp.probe("cpu", N)
    (r,) = rec["builds"].values()
    assert r["verdict"] == "NOT-CONTRACTED"
    assert r["mismatches"] == r["two_rounding_mismatches"] > 0
    assert r["fused_equals_fma32"]
    assert "NOT-CONTRACTED" in capsys.readouterr().out


def test_verdicts():
    a, b, c = fp.inputs(1024)
    fused = fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    two = np.float32(a * b) + c
    assert fp.verdict(fused, fused, a, b, c)["verdict"] == "CONTRACTED"
    assert fp.verdict(two, fused, a, b, c)["verdict"] == "NOT-CONTRACTED"
    mixed = np.where(np.arange(1024) % 4 == 0, two, fused)
    assert fp.verdict(mixed, fused, a, b, c)["verdict"] == "MIXED"
    # the -fmad=true build is a key of its own, with its own flags
    fmad = fp.KEYS["-fmad=true"]
    assert build.nvcc_args(fmad) \
        == ["-fmad=true" if f == "-fmad=false" else f
            for f in build.NVCC_FLAGS]
    assert build.nvcc_args(()) == build.NVCC_FLAGS
    assert build.nvcc_args(("A=1",)) == build.NVCC_FLAGS + ["-DA=1"]
    assert build._target("fma_probe", fmad) != build._target("fma_probe")
    with pytest.raises(ValueError, match="no flag"):
        build.nvcc_args(("-G",))


@pytest.mark.cuda
def test_probe_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    rec = fp.probe("cuda")
    assert rec["builds"]["port flags"]["verdict"] == "NOT-CONTRACTED"
    assert rec["builds"]["-fmad=true"]["verdict"] == "CONTRACTED"
    assert rec["builds"]["port flags"]["fused_equals_fma32"]
