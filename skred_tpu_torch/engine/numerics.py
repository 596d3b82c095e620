"""Exact f32 arithmetic helpers, as torch functions.

The reference binary is built by gcc, which contracts some multiply-adds
into single-rounding fmas and divides with a correctly rounded ``/``.
These helpers reproduce that rounding (the fma through an exact f64
product and a sum rounded to odd, the divides op for op as the JAX
package writes them), so the same inputs give the same bits on every
device.  Torch runs each elementwise op as its own kernel, so nothing
here is contracted behind the caller's back.

Constants are passed as Python floats holding exact f32 values: an f32
op on such a scalar rounds once whether the backend computes it in f32
or in f64 first.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32


def f32(x: float) -> float:
    """The f32 value nearest ``x``, as an exact Python float."""
    return float(np.float32(x))


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(I32)


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(F32)


def _f32_tensors(*vals):
    """The operands as broadcast f32 tensors on the device of the first
    tensor among them (Python scalars join that device)."""
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
               None)
    return torch.broadcast_tensors(*(torch.as_tensor(v, dtype=F32,
                                                     device=dev)
                                     for v in vals))


def fma32(a, b, c):
    """Correctly rounded f32 ``a*b + c`` (the JAX package's
    ``render._fma32`` and ``kernels._kfma``, and the card's
    ``__fmaf_rn``).  The product of two f32 values is exact in f64; the
    f64 sum is rounded to odd with its TwoSum error, so the final
    rounding to f32 is the only one that counts (53 >= 24 + 2 bits)."""
    tensors = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
    if len(tensors) < 2 or any(t.dtype != F32 for t in tensors):
        a, b, c = _f32_tensors(a, b, c)
    # a Python scalar joins as the f64 value of its f32 rounding
    a, b, cd = (x.to(F64) if isinstance(x, torch.Tensor)
                else float(np.float32(x)) for x in (a, b, c))
    p = a * b                                # exact
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)         # p + cd = s + err, exactly
    si = s.view(torch.int64)
    # inexact (a NaN or infinite s has a NaN err) and even: step to the
    # odd neighbour on err's side
    need = (err.abs() > 0.0) & ((si & 1) == 0)
    step = torch.where((err > 0.0) != (s < 0.0), 1, -1)
    return torch.where(need, (si + step).view(F64), s).to(F32)


def fma32_emulated(a, b, c):
    """``fma32`` from f32 ops alone (Veltkamp split, Dekker product,
    TwoSum, round-to-odd), op for op as the JAX package writes it.  Equal
    to ``fma32`` wherever no intermediate leaves the normal f32 range;
    kept as the tests' cross-check."""
    a, b, c = _f32_tensors(a, b, c)
    C = 4097.0                           # 2^12 + 1
    g = a * C
    ah = g - (g - a)
    al = a - ah
    g = b * C
    bh = g - (g - b)
    bl = b - bh
    p = a * b
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl   # a*b = p + e
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)                      # p + c = s + err
    t = err + e
    bv2 = t - err
    r = (err - (t - bv2)) + (e - bv2)                    # err + e = t + r
    ti = _as_i32(t)
    need = (r != 0.0) & ((ti & 1) == 0) & torch.isfinite(t)
    up = (r > 0.0) != (t < 0.0)
    adj = torch.where(up, ti + 1, ti - 1)
    t = torch.where(need, _as_f32(adj), t)
    return s + t


def div32(x, y):
    """Correctly rounded f32 division via f64 (``render._div32``)."""
    x, y = _f32_tensors(x, y)
    return (x.to(torch.float64) / y.to(torch.float64)).to(F32)


def wrap_fmod(x, L):
    """``fmod(x, L)`` as the cyclic kernel computes it (``wrap_fmod`` in
    csrc/numerics.cuh): ``x - L`` for ``L <= x < 2L`` (exact, Sterbenz),
    ``x`` for ``|x| < L``, ``torch.fmod`` otherwise; bit for bit
    ``torch.fmod(x, L)`` everywhere."""
    x, L = _f32_tensors(x, L)
    return torch.where((x >= L) & (x < 2.0 * L), x - L,
                       torch.where(x.abs() < L, x, torch.fmod(x, L)))


def f2i(x):
    """f32 -> i32 as XLA's ``convert`` and the card's ``__float2int_rz``
    give it: toward zero, saturated to the int32 range, NaN to 0.  (The
    CPU's ``.to(int32)`` gives INT_MIN for NaN and for every operand out
    of range.)"""
    big = x >= 2147483648.0
    small = x < -2147483648.0
    i = torch.where(big | small | torch.isnan(x), 0.0, x).to(I32)
    i = torch.where(big, 2147483647, i)
    return torch.where(small, -2147483648, i).to(I32)


def fast_pow(a, b):
    """``fused._fast_pow``: the reference's bit-trick pow (synth.c:140)."""
    i = _as_i32(a)
    x = fma32(b, (i - 1065353216).to(F32), 1065353216.0)
    r = _as_f32(x.to(I32))
    return torch.where(a <= 0.0, 0.0, r)


def cz_phasor(mode, ph, d, tsize, modes=(1, 2, 3, 4, 5, 6, 7)):
    """``fused._cz_phasor``: the CZ phase-distortion warp
    (synth.c:149-215) over the curve set ``modes``."""
    phase = div32(ph, tsize)
    d = torch.clamp(d, 0.0, f32(0.999))
    half, one = 0.5, 1.0
    mk = {}
    if 1 in modes:
        mk[1] = torch.where(phase < d, phase * div32(half, d),
                            fma32(phase - d, div32(half, one - d), half))
    if 2 in modes or 3 in modes or 5 in modes:
        sc2 = div32(half, half - d * half)
    if 2 in modes:
        mk[2] = torch.where(phase < half, phase * sc2,
                            fma32(-(one - phase), sc2, one))
    if 3 in modes:
        mk[3] = torch.where(phase < half, phase * sc2,
                            fma32(phase - half, sc2, half))
    if 4 in modes:
        mk[4] = torch.fmod(phase * 2.0, one)
    if 5 in modes:
        sc5b = div32(half, half + d * half)
        mk[5] = torch.where(phase < half, phase * sc2,
                            fma32(phase - half, sc5b, half))
    if 6 in modes:
        mk[6] = fast_pow(phase, one + 4.0 * d)
    if 7 in modes:
        mk[7] = fast_pow(phase, one + 8.0 * d)
    out = phase
    for k in sorted(mk, reverse=True):
        out = torch.where(mode == k, mk[k], out)
    return out * tsize


# ---- the tier kernel's in-kernel helpers (kernels.py:851-1047) ----

kfma = fma32


def kdiv_from(y0, a, b):
    """Finish a correctly rounded ``a/b`` from the reciprocal seed ``y0``:
    one Newton step, then two Markstein residual corrections."""
    r = kfma(-b, y0, 1.0)
    y = kfma(y0, r, y0)
    q = a * y
    e = kfma(-b, q, a)
    q = kfma(e, y, q)
    e = kfma(-b, q, a)
    q = kfma(e, y, q)
    return q


def kdiv(a, b):
    """Correctly rounded f32 ``a/b`` (``kernels._kdiv``)."""
    a, b = _f32_tensors(a, b)
    q = kdiv_from(1.0 / b, a, b)
    return torch.where(torch.isfinite(q), q, a / b)


def kdiv_inv(a, y1, b):
    """``a/b`` from the correctly rounded reciprocal ``y1 = kdiv(1, b)``
    and one Markstein correction (``kernels._kdiv_inv``)."""
    q0 = a * y1
    r = kfma(-b, q0, a)
    q = kfma(r, y1, q0)
    return torch.where(torch.isfinite(q), q, a / b)


def k_fast_pow(a, b):
    """``kernels._k_fast_pow``: an fma at gcc's one contracted site, in
    both modes (see ``cz_warp_k``)."""
    g = (_as_i32(a) - 1065353216).to(F32)
    x = kfma(b, g, 1065353216.0)
    r = _as_f32(x.to(I32))
    return torch.where(a <= 0.0, 0.0, r)


CZ_ALL = (1, 2, 3, 4, 5, 6, 7)


def cz_scales(d, exact=True, modes=CZ_ALL):
    """The CZ warp's d-dependent scale factors (``kernels._cz_scales``):
    (d, s1a, s1b, sc2, sc5b, p6, p7), None where ``modes`` needs none."""
    div = kdiv if exact else (lambda a, b: a / b)
    d = torch.clamp(d, 0.0, f32(0.999))
    half, one = 0.5, 1.0
    return (d,
            div(half, d) if 1 in modes else None,
            div(half, one - d) if 1 in modes else None,
            div(half, half - d * half)
            if any(k in modes for k in (2, 3, 5)) else None,
            div(half, half + d * half) if 5 in modes else None,
            one + 4.0 * d if 6 in modes else None,
            one + 8.0 * d if 7 in modes else None)


def cz_warp_k(mode, ph, d, tsize, exact=True, scales=None, phase=None,
              modes=CZ_ALL):
    """The per-mode CZ phasor (``kernels._cz_warp_k``).  Fast mode
    divides by IEEE division and keeps the fmas where the JAX kernel
    writes ``a*b + c``: the card's own multiply-add, which XLA contracts
    it into on the CPU, where the JAX package's fast mode holds its
    parity (rounded apart, a PCM table's index flips on ~0.5% of
    samples)."""
    if phase is None:
        phase = kdiv(ph, tsize) if exact else ph / tsize
    if scales is None:
        scales = cz_scales(d, exact, modes)
    d, s1a, s1b, sc2, sc5b, p6, p7 = scales
    half, one = 0.5, 1.0
    mk = {}
    if 1 in modes:
        mk[1] = torch.where(phase < d, phase * s1a,
                            kfma(phase - d, s1b, half))
    if 2 in modes:
        mk[2] = torch.where(phase < half, phase * sc2,
                            kfma(-(one - phase), sc2, one))
    if 3 in modes:
        mk[3] = torch.where(phase < half, phase * sc2,
                            kfma(phase - half, sc2, half))
    if 4 in modes:
        mk[4] = torch.fmod(phase * 2.0, one)
    if 5 in modes:
        mk[5] = torch.where(phase < half, phase * sc2,
                            kfma(phase - half, sc5b, half))
    if 6 in modes:
        mk[6] = k_fast_pow(phase, p6)
    if 7 in modes:
        mk[7] = k_fast_pow(phase, p7)
    out = phase
    for k in sorted(mk, reverse=True):
        out = torch.where(mode == k, mk[k], out)
    return out * tsize


def cz_warp_coeffs(mode, scales, modes=CZ_ALL):
    """Per-lane curve coefficients (``kernels._cz_warp_coeffs``): modes
    1/2/3/5 collapse to one knee curve ``phase < knee ? phase*sA :
    kfma(phase-c, sB, off)``, modes 6/7 to one fast_pow exponent.
    Returns (is_pl, knee, sa, c, sb, off, is_pw, pexp)."""
    d, s1a, s1b, sc2, sc5b, p6, p7 = scales
    half, one = 0.5, 1.0
    shape = mode.shape

    def full(x):
        if isinstance(x, float):
            return torch.full(shape, x, dtype=F32, device=mode.device)
        return x.expand(shape)

    plm = [k for k in (1, 2, 3, 5) if k in modes]
    is_pl = knee = sa = c = sb = off = None
    if plm:
        table = {1: (d, s1a, d, s1b, half),
                 2: (half, sc2, one, sc2, one),
                 3: (half, sc2, half, sc2, half),
                 5: (half, sc2, half, sc5b, half)}
        is_pl = mode == plm[0]
        knee, sa, c, sb, off = (full(x) for x in table[plm[0]])
        for k in plm[1:]:
            mk = mode == k
            is_pl = is_pl | mk
            kn, a2, c2, b2, o2 = table[k]
            knee = torch.where(mk, kn, knee)
            sa = torch.where(mk, a2, sa)
            c = torch.where(mk, c2, c)
            sb = torch.where(mk, b2, sb)
            off = torch.where(mk, o2, off)
    is_pw = pexp = None
    pwm = [k for k in (6, 7) if k in modes]
    if pwm == [6]:
        is_pw, pexp = mode == 6, full(p6)
    elif pwm == [7]:
        is_pw, pexp = mode == 7, full(p7)
    elif pwm:
        is_pw = (mode == 6) | (mode == 7)
        pexp = torch.where(mode == 7, p7, p6)
    return (is_pl, knee, sa, c, sb, off, is_pw, pexp)


def cz_warp_fast(coeffs, mode, phase, tsize, modes=CZ_ALL):
    """The hoisted-coefficient CZ phasor (``kernels._cz_warp_fast``),
    its fma in the engine's exact and fast mode alike, as
    ``cz_warp_k``'s."""
    is_pl, knee, sa, c, sb, off, is_pw, pexp = coeffs
    out = phase
    if is_pl is not None:
        pl_v = torch.where(phase < knee, phase * sa,
                           kfma(phase - c, sb, off))
        out = torch.where(is_pl, pl_v, out)
    if 4 in modes:
        out = torch.where(mode == 4, torch.fmod(phase * 2.0, 1.0), out)
    if is_pw is not None:
        out = torch.where(is_pw, k_fast_pow(phase, pexp), out)
    return out * tsize
