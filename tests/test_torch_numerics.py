"""The port's exact-arithmetic helpers against the JAX package's, bit for
bit, on random and cancellation operands (skred_tpu_torch.engine.numerics
vs skred_tpu.engine.render / fused / kernels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skred_tpu.engine import fused as jf
from skred_tpu.engine import kernels as jk
from skred_tpu.engine import render as jr
from skred_tpu_torch.engine import numerics as tn

torch.set_num_threads(1)


def _same_bits(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bad = got.view(np.int32) != want.view(np.int32)
    assert not bad.any(), (f"{bad.sum()} of {bad.size} differ, first "
                           f"{got[bad][:3]} != {want[bad][:3]}")


def _t(a):
    return torch.from_numpy(np.array(a))


def _fma_operands(rng, n=120_000):
    """Random magnitudes plus cancellation cases (c ~ -a*b)."""
    a = rng.uniform(-4, 4, n).astype(np.float32)
    b = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)) \
        .astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    k = n // 3
    c[:k] = -(a[:k].astype(np.float64) * b[:k]).astype(np.float32)
    c[k:2 * k] = (-(a[k:2 * k].astype(np.float64) * b[k:2 * k])
                  * (1 + rng.uniform(-1e-6, 1e-6, k))).astype(np.float32)
    return a, b, c


@pytest.mark.parametrize("which", ["render", "kernels"])
def test_fma32_bitwise(which):
    rng = np.random.default_rng(1)
    a, b, c = _fma_operands(rng)
    fn = jr._fma32 if which == "render" else jk._kfma
    want = np.asarray(jax.jit(fn)(a, b, c))
    _same_bits(tn.fma32(_t(a), _t(b), _t(c)).numpy(), want)
    # and the f64 oracle: a*b is exact in f64, the add rounds once more
    # only when it is inexact, which the odd-rounding check covers
    exact = (a.astype(np.float64) * b + c).astype(np.float32)
    ok = np.abs(a.astype(np.float64) * b) < 1e30
    _same_bits(want[ok], exact[ok])


def test_fma32_equals_its_f32_emulation():
    """``fma32`` (exact f64 product, sum rounded to odd) against the f32
    emulation the JAX package writes, tensor and scalar operands."""
    rng = np.random.default_rng(11)
    a, b, c = map(_t, _fma_operands(rng))
    _same_bits(tn.fma32(a, b, c).numpy(), tn.fma32_emulated(a, b, c).numpy())
    for k in (0.002, 0.5, 1.0):
        _same_bits(tn.fma32(k, b, c).numpy(),
                   tn.fma32_emulated(k, b, c).numpy())
        _same_bits(tn.fma32(a, b, k).numpy(),
                   tn.fma32_emulated(a, b, k).numpy())
        _same_bits(tn.fma32(-a, k, k).numpy(),
                   tn.fma32_emulated(-a, k, k).numpy())
    edge = tn.fma32(_t(np.array([np.inf, np.nan, 1e38, 0.0, -0.0],
                                np.float32)),
                    _t(np.array([1.0, 1.0, 1e10, 0.0, 0.0], np.float32)),
                    _t(np.array([1.0, 1.0, 1.0, -0.0, -0.0], np.float32)))
    want = np.array([np.inf, np.nan, np.inf, 0.0, -0.0], np.float32)
    _same_bits(np.nan_to_num(edge.numpy(), nan=7.0),
               np.nan_to_num(want, nan=7.0))


def test_div32_bitwise():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(150_000).astype(np.float32) * 1e3
    y = rng.uniform(1e-3, 1e6, 150_000).astype(np.float32)
    _same_bits(tn.div32(_t(x), _t(y)).numpy(),
               np.asarray(jax.jit(jr._div32)(x, y)))


def test_kdiv_from_perturbed_seed_bitwise():
    rng = np.random.default_rng(7)
    a = np.concatenate([rng.uniform(0, 1.2e6, 60_000),
                        np.full(20_000, 0.5),
                        rng.uniform(0, 1.0, 60_000)]).astype(np.float32)
    b = np.concatenate([rng.uniform(1.0, 1.2e6, 60_000),
                        rng.uniform(1e-3, 1.0, 20_000),
                        rng.uniform(1e-3, 2.0, 60_000)]).astype(np.float32)
    y0 = (1.0 / b).astype(np.float32)
    for shift in (0, 1, -1):
        y = (y0.view(np.int32) + np.int32(shift)).view(np.float32)
        want = np.asarray(jax.jit(jk._kdiv_from)(y, a, b))
        _same_bits(tn.kdiv_from(_t(y), _t(a), _t(b)).numpy(), want)
    _same_bits(tn.kdiv(_t(a), _t(b)).numpy(),
               np.asarray(jax.jit(jk._kdiv)(a, b)))


def test_kdiv_inv_nonpow2_sizes_bitwise():
    rng = np.random.default_rng(11)
    sizes = np.array([707, 2048, 2766, 4096, 8186, 27618, 28440, 28932,
                      30826, 47518, 52320], np.float32)
    b = np.concatenate([np.repeat(sizes, 8_000),
                        rng.uniform(1e-3, 1.2e6, 40_000)]).astype(np.float32)
    a = (rng.uniform(0, 1, b.size).astype(np.float32) * b).astype(np.float32)
    y1 = np.asarray(jax.jit(jk._kdiv)(jnp.float32(1.0), b))
    _same_bits(tn.kdiv(1.0, _t(b)).numpy(), y1)
    want = np.asarray(jax.jit(jk._kdiv_inv)(a, y1, b))
    _same_bits(tn.kdiv_inv(_t(a), _t(y1), _t(b)).numpy(), want)


def _cz_operands(n=100_000, seed=13):
    rng = np.random.default_rng(seed)
    mode = rng.integers(0, 8, n).astype(np.int32)
    d = rng.uniform(0.0, 1.1, n).astype(np.float32)
    tsize = rng.choice(np.array([707, 2048, 4096, 28932, 52320],
                                np.float32), n)
    frac = np.concatenate([
        rng.uniform(0, 1, n - 4 * (n // 8)).astype(np.float32),
        np.full(n // 8, 0.0, np.float32),
        np.full(n // 8, 0.5, np.float32),
        np.full(n // 8, 1.0 - 2 ** -24, np.float32),
        d[:n // 8]])[:n]
    ph = (frac * tsize).astype(np.float32)
    return mode, ph, d, tsize


def test_fast_pow_and_cz_phasor_bitwise():
    mode, ph, d, tsize = _cz_operands()
    p = (ph / tsize).astype(np.float32)
    e = (1 + 8 * d).astype(np.float32)
    _same_bits(tn.fast_pow(_t(p), _t(e)).numpy(),
               np.asarray(jax.jit(jf._fast_pow)(p, e)))
    _same_bits(tn.k_fast_pow(_t(p), _t(e)).numpy(),
               np.asarray(jax.jit(jk._k_fast_pow)(p, e)))
    want = np.asarray(jax.jit(jf._cz_phasor)(mode, ph, d, tsize))
    _same_bits(tn.cz_phasor(_t(mode), _t(ph), _t(d), _t(tsize)).numpy(),
               want)


@pytest.mark.parametrize("modes", [jk.CZ_ALL, (1,), (2, 3, 5), (4, 6, 7)])
@pytest.mark.parametrize("exact", [True, False])
def test_cz_warp_bitwise(modes, exact):
    """_cz_scales, _cz_warp_k, _cz_warp_coeffs and _cz_warp_fast, in
    both modes: in fast mode (exact=False) the port takes an fma at the
    warps' ``a*b + c`` sites, which XLA's CPU compiler contracts into
    fmas there too; the two warps are also held to each other (as
    tests/test_mega.py holds the JAX pair)."""
    mode, ph, d, tsize = _cz_operands(seed=17)

    def jax_both(mode, ph, d, tsize):
        scales = jk._cz_scales(d, exact, modes)
        phase = jk._kdiv(ph, tsize) if exact else ph / tsize
        old = jk._cz_warp_k(mode, ph, None, tsize, exact, scales, phase,
                            modes)
        coeffs = jk._cz_warp_coeffs(mode, scales, modes)
        new = jk._cz_warp_fast(coeffs, mode, phase, tsize, exact, modes)
        return ([s for s in scales if s is not None], old, new)

    js, jold, jnew = jax.jit(jax_both)(mode, ph, d, tsize)
    tm, tp, td, tt = _t(mode), _t(ph), _t(d), _t(tsize)
    scales = tn.cz_scales(td, exact, modes)
    phase = tn.kdiv(tp, tt) if exact else tp / tt
    for got, want in zip([s for s in scales if s is not None], js):
        _same_bits(got.numpy(), np.asarray(want))
    old = tn.cz_warp_k(tm, tp, None, tt, exact, scales, phase, modes)
    coeffs = tn.cz_warp_coeffs(tm, scales, modes)
    new = tn.cz_warp_fast(coeffs, tm, phase, tt, modes)
    _same_bits(new.numpy(), old.numpy())
    _same_bits(old.numpy(), np.asarray(jold))
    _same_bits(new.numpy(), np.asarray(jnew))
