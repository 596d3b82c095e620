"""The keyed compat kernel on the CPU at 1 and 3 passes.

``tests/test_torch_compat_keyed.py``'s stacked batch (stress64, noise64,
fb1-fb5 with fb4's waits cut, a voice copy; 4 blocks, segments starting
past block 1) under its union key at 1 and at 3 fixed-point passes,
capture on and off, through the launch wrapper with the g++ build of
``csrc/compat.cu`` (``CpuCompat``), held bit for bit to
``compat_block_plain`` at the same pass count (1 pass is not the
scripts' own render: both sides take the same wrong count).
"""

import pytest
import torch

from skred_tpu_torch.engine import render as tr
from skred_tpu_torch.engine.kernels import compat as K
from skred_tpu_torch.parallel.batch import stack_timelines
from tests.test_torch_compat_keyed import (SCRIPTS, CpuCompat, held,
                                           kernel_render, plain_render,
                                           timelines)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch():
    return stack_timelines(timelines(list(SCRIPTS)))


@pytest.mark.parametrize("passes", [1, 3])
def test_union_key_at_other_pass_counts(batch, tmp_path, monkeypatch,
                                        passes):
    inp = tr.stacked_inputs(batch, "cpu")
    want = plain_render(batch, passes)
    keys = [K.compat_key(inp, passes, cap) for cap in (True, False)]
    cpu = CpuCompat(tmp_path)
    cpu.build(keys)
    cpu.patch(monkeypatch)
    rows = list(range(batch.batch))
    for cap in (True, False):
        held(kernel_render(inp, passes, cap), want, rows, cap,
             f"{passes} passes, capture={cap}")
