"""The variant generator: what it scales and keeps, and that no seed
moves a variant off the script's kernels (``bucket_key`` and the fused
``Plan`` for the sweeps, the compat key for the preview)."""

from __future__ import annotations

import pathlib

import numpy as np
import pytest

from benchmark import harness
from benchmark.traffic import variants

SEEDS = [0, 7, 2**31 + 5, 2**32 + 123]
CONFIGS = ["stress64", "noise64"]


def _lines(config):
    return variants.wire_lines(
        (harness.HERE / "configs" / f"{config}.sk").read_text())


@pytest.mark.parametrize("config", CONFIGS)
def test_scales_only_values(config):
    lines = _lines(config)
    fac = variants.factors(variants.rng_for(3, 0), 16, lines, 0.2, 0.3)
    kinds = [k for _, _, k in variants.slots(lines)]
    spread = fac[:, [k == "spread" for k in kinds]]
    cut = fac[:, [k == "cut" for k in kinds]]
    assert spread.min() >= 0.8 and spread.max() <= 1.2
    assert cut.min() >= 0.7 and cut.max() <= 1.0
    for row in fac:
        v = variants.variant(lines, row)
        for a, b in zip(lines, v):
            ta, tb = a.split(), b.split()
            assert len(ta) == len(tb)
            for x, y in zip(ta, tb):
                assert x[0] == y[0]
                if x[0] in "wvmqhJrtl>":
                    assert x == y
                elif x[0] in variants.SCALED:
                    xa, ya = x[1:].split(","), y[1:].split(",")
                    arg = variants.SCALED[x[0]][0]
                    assert xa[:arg] == ya[:arg]
                    assert np.sign(float(xa[arg])) == np.sign(float(ya[arg]))


def test_same_seed_same_variants():
    lines = _lines("stress64")
    a = variants.factors(variants.rng_for(2**31 + 9, 0), 4, lines, .2, .3)
    b = variants.factors(variants.rng_for(2**31 + 9, 0), 4, lines, .2, .3)
    c = variants.factors(variants.rng_for(2**31 + 10, 0), 4, lines, .2, .3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config", CONFIGS)
def test_variants_keep_the_fused_keys(config, seed):
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine.fused import plan
    from skred_tpu_torch.host.native import compile_script_native
    from skred_tpu_torch.parallel.batch import (bucket_key, pack_stacked,
                                                stack_timelines)

    lines = _lines(config)
    bank = WaveBank()
    comp = lambda t: compile_script_native(t, 0.05, bank=bank,
                                           script_dir=pathlib.Path("."))
    base = comp(lines)
    fac = variants.factors(variants.rng_for(seed, 0), 16, lines, 0.2, 0.3)
    tls = [comp(variants.variant(lines, f)) for f in fac]
    assert all(bucket_key(tl) == bucket_key(base) for tl in tls)
    single = plan(pack_stacked(stack_timelines([base])))
    assert plan(pack_stacked(stack_timelines(tls))) == single
    for tl in tls[:4]:
        assert plan(pack_stacked(stack_timelines([tl]))) == single


@pytest.mark.parametrize("seed", SEEDS)
def test_variants_keep_the_compat_key(seed):
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine.kernels.compat import compat_key
    from skred_tpu_torch.engine.render import stacked_inputs
    from skred_tpu_torch.host.native import compile_script_native
    from skred_tpu_torch.parallel.batch import stack_timelines

    lines = _lines("stress64")
    bank = WaveBank()

    def key(t):
        tl = compile_script_native(t, 0.05, bank=bank,
                                   script_dir=pathlib.Path("."))
        return compat_key(stacked_inputs(stack_timelines([tl]), "cpu"),
                          tl.mod_passes, False)

    fac = variants.factors(variants.rng_for(seed, 0), 16, lines, 0.2, 0.3)
    k0 = key(lines)
    assert all(key(variants.variant(lines, f)) == k0 for f in fac)
