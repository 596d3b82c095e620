"""The port's entry points (entry_torch.py) on the CPU: the
batched compat render step of ``entry()`` and ``dryrun_multichip`` over
an eight-entry CPU mesh (``["cpu"] * 8`` stands for the JAX package's
eight virtual devices)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import entry_torch
from skred_tpu_torch.parallel import batch as tb
from tests.test_torch_fused import ROOT

torch.set_num_threads(1)


def test_entry_step_is_the_compat_render():
    fn, args = entry_torch.entry(device="cpu", seconds=0.0116)
    inp, carry, noise = args
    assert inp.pf.device.type == carry[0].device.type == "cpu"
    new_carry, out, cap = fn(*args)
    st = entry_torch._tiny_stacked(batch=2, seconds=0.0116)
    assert cap is None and out.shape == (2, st.num_blocks * st.block, 2)
    assert torch.isfinite(out).all() and float(out.abs().max()) > 0.01
    want = tb.render_stacked(st, exact=True, device="cpu")
    assert np.array_equal(out.numpy(), want)
    assert torch.equal(carry[0], torch.zeros_like(carry[0])), \
        "the step wrote its input carry"


def test_dryrun_multichip_on_a_cpu_mesh(capsys):
    entry_torch.dryrun_multichip(8, device="cpu", seconds=0.006)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("# dryrun_multichip: 8 devices (cpu, cpu,")
    assert "shard-invariance 0.0e+00" in line
    assert "[1dev=1.000, 2dev=1.000, 4dev=1.000, 8dev=1.000]" in line
    assert line.endswith("5 scripts over 8 devices max|d| 0.0")


def test_main_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert entry_torch.main([]) == 1
    assert "no CUDA card" in capsys.readouterr().err


@pytest.mark.parametrize("module", ["entry_torch", "skred_tpu_torch.cli",
                                    "skred_tpu_torch.frontends.cz_view",
                                    "skred_tpu_torch.frontends.repl",
                                    "skred_tpu_torch.frontends.scope_px"])
def test_imports_without_jax(module):
    """With JAX and the JAX package unimportable, entry_torch.py, the CLI and
    the frontends still import."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['skred_tpu'] = None; "
            f"import {module}")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
