// Exact-f32 device helpers shared by the port's kernels (tier.cu,
// cyclic.cu, phase_walk.cu, filt_smooth.cu): the JAX package's in-kernel
// arithmetic (kernels.py _kfma, _kdiv_from, _kdiv, _kdiv_inv,
// _k_fast_pow, _cz_scales, _cz_warp_k, _cz_warp_coeffs, _cz_warp_fast),
// bit for bit.  A source that includes this header builds with
// -fmad=false: nothing here may be contracted beyond the __fmaf_rn calls
// it spells out.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// _kfma sites, and in fast mode the JAX kernels' a*b + c sites too: a
// single correctly rounded fma, the card's own multiply-add (XLA
// contracts a*b + c into it on the CPU, where the JAX package's fast
// mode holds its parity; rounded apart, the FM increment's error
// integrates into the phase and misses -60 dB within a second)
__device__ __forceinline__ float kfma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
}

// kernels._kdiv_from: Newton step on the seed, two Markstein corrections
__device__ __forceinline__ float kdiv_from(float y0, float a, float b) {
    float r = kfma(-b, y0, 1.0f);
    float y = kfma(y0, r, y0);
    float q = __fmul_rn(a, y);
    float e = kfma(-b, q, a);
    q = kfma(e, y, q);
    e = kfma(-b, q, a);
    q = kfma(e, y, q);
    return q;
}

__device__ __forceinline__ float kdiv(float a, float b) {
    float q = kdiv_from(__fdiv_rn(1.0f, b), a, b);
    return isfinite(q) ? q : __fdiv_rn(a, b);
}

__device__ __forceinline__ float kdiv_inv(float a, float y1, float b) {
    float q0 = __fmul_rn(a, y1);
    float r = kfma(-b, q0, a);
    float q = kfma(r, y1, q0);
    return isfinite(q) ? q : __fdiv_rn(a, b);
}

__device__ __forceinline__ float xdiv(float a, float b, int exact) {
    return exact ? kdiv(a, b) : __fdiv_rn(a, b);
}

// kernels._k_fast_pow (synth.c:140-147)
__device__ __forceinline__ float k_fast_pow(float a, float b) {
    float g = (float)(__float_as_int(a) - 1065353216);
    float x = kfma(b, g, 1065353216.0f);
    float r = __int_as_float((int)x);
    return a <= 0.0f ? 0.0f : r;
}

// fmodf(x, L) bit for bit, without its loop where the result is one
// subtraction or x itself: for L <= x < 2L, x - L is exact (Sterbenz)
// and is the remainder; for |x| < L the remainder is x (-0.0 kept).
// Any other operands, non-finite ones included, take fmodf.
static __device__ __noinline__ float fmod_slow(float x, float L) {
    return fmodf(x, L);
}

__device__ __forceinline__ float wrap_fmod(float x, float L) {
    if (x >= L && x < 2.0f * L) return x - L;
    if (fabsf(x) < L) return x;
    return fmod_slow(x, L);
}

// wrap_fmod without its slow path (FAST): exact for operands in its two
// in-range cases; any other sets `slow`, and the keyed kernels render
// such a lane again with FAST false, writing every output again.  A
// branch to fmodf would end the basic block in which the compiler
// overlaps the samples (or voices) of a chunk.
template <bool FAST>
__device__ __forceinline__ float wrap(float x, float L, bool& slow) {
    if (!FAST) return wrap_fmod(x, L);
    const bool once = x >= L && x < 2.0f * L;   // wrap_fmod's two ranges
    slow = slow || !(once || fabsf(x) < L);
    return once ? x - L : x;
}

__device__ __forceinline__ bool has_mode(int mask, int k) {
    return (mask >> k) & 1;
}

// kernels._cz_scales: the warp's d-dependent factors
struct CzScales { float d, s1a, s1b, sc2, sc5b, p6, p7; };

__device__ __forceinline__ CzScales cz_scales(float d, int exact, int mask) {
    CzScales s;
    d = d < 0.0f ? 0.0f : d;            // jnp.clip: max then min, NaN kept
    d = d > 0.999f ? 0.999f : d;
    s.d = d;
    s.s1a = s.s1b = s.sc2 = s.sc5b = s.p6 = s.p7 = 0.0f;
    if (has_mode(mask, 1)) {
        s.s1a = xdiv(0.5f, d, exact);
        s.s1b = xdiv(0.5f, 1.0f - d, exact);
    }
    if (has_mode(mask, 2) || has_mode(mask, 3) || has_mode(mask, 5))
        s.sc2 = xdiv(0.5f, 0.5f - d * 0.5f, exact);
    if (has_mode(mask, 5)) s.sc5b = xdiv(0.5f, 0.5f + d * 0.5f, exact);
    if (has_mode(mask, 6)) s.p6 = 1.0f + 4.0f * d;
    if (has_mode(mask, 7)) s.p7 = 1.0f + 8.0f * d;
    return s;
}

// mode 4's fmodf(x, L), as the JAX kernel writes it; a caller may pass
// another callable that gives the same bits (wrap_fmod)
struct FmodWrap {
    __device__ __forceinline__ float operator()(float x, float L) const {
        return fmodf(x, L);
    }
};

// kernels._cz_warp_k on the lane's own mode (modes are exclusive, so the
// JAX select chain picks exactly this curve, or the raw phase)
template <class Wrap = FmodWrap>
__device__ __forceinline__ float cz_warp_k(int mode, float phase,
                                           const CzScales& s, float tsz,
                                           int mask, Wrap wrap = Wrap()) {
    float out = phase;
    if (mode >= 1 && mode <= 7 && has_mode(mask, mode)) {
        switch (mode) {
        case 1:
            out = phase < s.d ? phase * s.s1a
                              : kfma(phase - s.d, s.s1b, 0.5f);
            break;
        case 2:
            out = phase < 0.5f ? phase * s.sc2
                               : kfma(-(1.0f - phase), s.sc2, 1.0f);
            break;
        case 3:
            out = phase < 0.5f ? phase * s.sc2
                               : kfma(phase - 0.5f, s.sc2, 0.5f);
            break;
        case 4:
            out = wrap(phase * 2.0f, 1.0f);
            break;
        case 5:
            out = phase < 0.5f ? phase * s.sc2
                               : kfma(phase - 0.5f, s.sc5b, 0.5f);
            break;
        case 6:
            out = k_fast_pow(phase, s.p6);
            break;
        default:
            out = k_fast_pow(phase, s.p7);
            break;
        }
    }
    return out * tsz;
}

// kernels._cz_warp_coeffs: modes 1/2/3/5 as one knee curve, 6/7 as one
// fast_pow exponent, selected once per block
struct CzCoeffs { int is_pl, is_4, is_pw; float knee, sa, c, sb, off, pexp; };

__device__ __forceinline__ CzCoeffs cz_coeffs(int mode, const CzScales& s,
                                              int mask) {
    CzCoeffs k;
    k.is_pl = k.is_4 = k.is_pw = 0;
    k.knee = k.sa = k.c = k.sb = k.off = k.pexp = 0.0f;
    if (mode >= 1 && mode <= 7 && has_mode(mask, mode)) {
        switch (mode) {
        case 1: k.is_pl = 1; k.knee = s.d; k.sa = s.s1a; k.c = s.d;
                k.sb = s.s1b; k.off = 0.5f; break;
        case 2: k.is_pl = 1; k.knee = 0.5f; k.sa = s.sc2; k.c = 1.0f;
                k.sb = s.sc2; k.off = 1.0f; break;
        case 3: k.is_pl = 1; k.knee = 0.5f; k.sa = s.sc2; k.c = 0.5f;
                k.sb = s.sc2; k.off = 0.5f; break;
        case 5: k.is_pl = 1; k.knee = 0.5f; k.sa = s.sc2; k.c = 0.5f;
                k.sb = s.sc5b; k.off = 0.5f; break;
        case 4: k.is_4 = 1; break;
        case 6: k.is_pw = 1; k.pexp = s.p6; break;
        default: k.is_pw = 1; k.pexp = s.p7; break;
        }
    }
    return k;
}

// kernels._cz_warp_fast
template <class Wrap = FmodWrap>
__device__ __forceinline__ float cz_warp_fast(const CzCoeffs& k, float phase,
                                              float tsz, Wrap wrap = Wrap()) {
    float out = phase;
    if (k.is_pl)
        out = phase < k.knee ? phase * k.sa
                             : kfma(phase - k.c, k.sb, k.off);
    else if (k.is_4)
        out = wrap(phase * 2.0f, 1.0f);
    else if (k.is_pw)
        out = k_fast_pow(phase, k.pexp);
    return out * tsz;
}
