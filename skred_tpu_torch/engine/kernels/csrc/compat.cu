// The compat engine for Hopper (sm_90a): blocks of the reference's
// per-sample render over all 64 voices, one batch row a CUDA block.
//
// Replaces skred_tpu/engine/render.py:_render_core (:375), the JAX
// package's bit-exact engine: a lax.scan over blocks around a lax.scan
// over samples (_voice_pass :203, _sample_step :331, _apply_ops :354).
// It is not a Pallas kernel; in eager torch each sample would cost
// hundreds of small launches, so the whole recurrence is one kernel.
//
// Bound on this card: latency at one row, issue at many.  Each row is a
// serial recurrence of block * nblocks samples; a sample is mod_passes
// passes of each voice's dependent chain (modulator read -> phase wrap
// -> CZ warp -> table load -> hold -> quantizer -> biquad -> gain ->
// smoother -> pan), the passes joined by a barrier (a voice reads the
// others' estimates), then a 64-voice sum.  The bytes (the parameters
// once, two f32 a sample out, 512 bytes a sample with capture) are
// negligible beside it.  Divergence is what lengthens the chain: the
// voices of stress64 take all seven CZ curves, and with the curves as
// run-time branches a warp ran every curve's IEEE divides one after
// another, half its sample step (clock stamps, tools/compat_stamps.py).
//
// The design: one library per build key (kernels/compat.py compat_key),
// as the cyclic kernel's keyed variant has:
//   * COMPAT_PASSES, COMPAT_CAPTURE, COMPAT_FLAGS (the union of the
//     voices' F_* bits), COMPAT_CZ_MASK (the curves taken; bit 0 a
//     nonzero mode past 7), COMPAT_MODS (M_*: the modulator reads taken)
//     and COMPAT_TS_POW2 (every CZ voice's table size a power of two) are
//     compile-time constants: a feature no voice takes is not compiled,
//     nor its divides;
//   * the CZ curve is branch-free: at segment load each voice's curve is
//     reduced to phase < thr ? phase * sa : fma(phase - b, sb, c)
//     (curves 1, 2, 3, 5), an exponent (6, 7) or fmod(phase * 2, 1) (4),
//     its IEEE quotients computed there once.  d is constant over a
//     segment unless the voice reads a CZ modulator at a nonzero depth
//     (M_CZD: the divides every sample, branch-free); at depth 0 the read
//     only decides whether d is NaN, which the curve takes as NaN scales;
//   * p / tsize is a multiply by 1 / tsize where tsize is a power of two
//     (both are the correctly rounded value of one real number);
//   * the envelope takes one IEEE divide: its arm picks the operands;
//   * a non-committing pass runs only where a higher voice reads the
//     estimate (F_READ, marked per segment by the host): a warp skips it
//     when none of its voices is read;
//   * the stereo sum is off the chain: no voice reads it, so each voice
//     leaves its pair in shared memory and every 32 samples each thread
//     sums one sample's 64 pairs (the fixed tree, one thread a sum); the
//     previous samples sit in two buffers by the sample's parity, so a
//     sample takes one barrier and one more a non-committing pass;
//   * the noise sample is loaded a step ahead.
// One voice a thread, two warps a row: one warp a row with two voices a
// lane, tried, took 1.6-1.7x as long at 1 and at 1024 rows (PERF.md).
// A launch whose arguments need a feature outside the key returns -1
// (the wrapper raises); there is no general variant.
//
// Numerics are render.py's, site by site, bit for bit with
// kernels/compat.py:compat_block_plain:
//   * _fma(.., exact) (FM increment, the four biquad fmas, the smoother,
//     the pan fmas, the volume smoother): __fmaf_rn in both modes.  Exact
//     mode is the reference's fma; fast mode is "plain hardware
//     arithmetic" (render.py:54), which is one fma on this card and on
//     the CPU, where XLA contracts the JAX package's a * b + c.  A
//     separately rounded product would differ in the last bit, and the
//     feedback of fb1 and fb4 grows that to the scale of the signal, so
//     the engine has one arithmetic and no mode;
//   * _fma32 (always an fma: fast_pow, the CZ curves, the envelope decay,
//     the quantizer): __fmaf_rn;
//   * _div32: IEEE division (-prec-div=true); one_m_q / 2 is the
//     multiply by 0.5 (exact either way);
//   * jnp.fmod: fmodf, exact, through wrap_fmod's exact short cuts;
//   * the f32 -> i32 conversions (the table index before its clip,
//     fast_pow's bit trick, the quantizer) saturate and send NaN to 0,
//     as XLA's convert does: f2i below;
//   * the stereo sum: voice_sum's fixed tree in compat.py.
// Build with -fmad=false and without --use_fast_math; denormals are kept.

#include <cuda_runtime.h>
#include <math.h>

#ifndef COMPAT_SHIM
#define COMPAT_DEV __device__ __forceinline__
#endif

#ifndef COMPAT_PASSES
#error "compat.cu builds under a key: kernels/compat.py compat_key"
#endif

constexpr int V = 64;
// the per-voice parameter fields (compat.py PF, PI), the segment ops'
// (OF, OI) and the carry's (CF, CI), in the same order
enum { P_PINC, P_MIS, P_FM_DEP, P_LO, P_HI, P_L, P_HI_OS, P_TSIZE,
       P_CZ_DIST, P_CZ_DEP, P_LEVELS, P_INV_LEV, P_B0, P_B1, P_B2, P_NA1,
       P_NA2, P_ATT, P_DEC, P_ATT_DEC, P_SUS, P_REL, P_VEL, P_AM_DEP,
       P_AMP, P_SMOOTHING, P_PM_DEP, NPF };
enum { Q_FLAGS, Q_FM_OSC, Q_CZ_MODE, Q_CM_OSC, Q_CLIP_HI, Q_TABLE_OFF,
       Q_HOLD_MAX, Q_ENV_START, Q_ENV_REL_AT, Q_AM_OSC, Q_PM_OSC, NPI };
enum { F_USE_FM = 1 << 0, F_DIRNEG = 1 << 1, F_OSN = 1 << 2,
       F_ONE_SHOT = 1 << 3, F_IS_NOISE = 1 << 4, F_HOLD_ON = 1 << 5,
       F_QUANT = 1 << 6, F_USE_FLT = 1 << 7, F_USE_ENV = 1 << 8,
       F_ENV_ACT = 1 << 9, F_NO_REL = 1 << 10, F_USE_SM = 1 << 11,
       F_DISC = 1 << 12, F_READ = 1 << 13 };
// the modulator reads a key compiles (compat.py MODS)
enum { M_FM = 1, M_CZ = 2, M_CZD = 4, M_AM = 8, M_PAN = 16 };
enum { O_PHASE, O_SAMPLE, O_SMOOTHER, O_PAN_L, O_PAN_R, NOF };
enum { OI_FLAGS, OI_FINISHED, OI_COPY_HOLD, NOI };
enum { SET_PHASE = 1, SET_FINISHED = 2, SET_SAMPLE = 4, CLEAR_FILTER = 8,
       SET_SMOOTHER = 16, SET_PAN = 32 };
enum { C_PHASE, C_SAMPLE, C_HOLD_VAL, C_X1, C_X2, C_Y1, C_Y2, C_SMOOTHER,
       C_PAN_L, C_PAN_R, NCF };
enum { CI_FINISHED, CI_HOLD_COUNT, NCI };

// ---- the key ----
constexpr int PASSES = COMPAT_PASSES;
constexpr bool CAPTURE = COMPAT_CAPTURE != 0;
constexpr int KF = COMPAT_FLAGS;
constexpr int KCZ = COMPAT_CZ_MASK;
constexpr int KM = COMPAT_MODS;
constexpr bool TS_POW2 = COMPAT_TS_POW2 != 0;
constexpr bool HAS_CZ = KCZ != 0;
constexpr bool CZ_PIECE = (KCZ & 0x2e) != 0;          // curves 1, 2, 3, 5
constexpr bool CZ_POW = (KCZ & 0xc0) != 0;            // curves 6, 7
static_assert(PASSES >= 1 && PASSES <= V, "COMPAT_PASSES in 1..64");

struct CompatArgs {
    int rows, segs, nb_total, block, block0, nblocks, passes, capture;
    int need_flags, need_cz, need_mods, ts_pow2;   // what the batch takes
    const float* pf;      // [rows, segs, NPF, V]
    const int* pi;        // [rows, segs, NPI, V]
    const float* vf;      // [rows, segs]
    const float* of;      // [rows, segs, NOF, V]
    const int* oi;        // [rows, segs, NOI, V]
    const int* seg;       // [rows, nb_total]
    const int* start;     // [rows, nb_total]
    const float* table;   // [R]
    const float* noise;   // [nblocks * block]: this call's samples
    const float* cf0; const int* ci0; const float* vg0;   // carry in
    float* cf1; int* ci1; float* vg1;                     // carry out
    float* out;           // [rows, nblocks * block, 2]
    float* cap;           // [rows, nblocks * block, V, 2] or null
    unsigned* stamp;      // [rows, V / 32, NSTAMP] (COMPAT_STAMP) or null
};

// the measurement build (COMPAT_STAMP): clock cycles per stage of a
// sample step, summed over the launch, per warp (tools/compat_stamps.py).
// A stamp waits for the stage's last result.
enum { S_NOISE, S_BAR_PREV, S_R_READS, S_R_WRAP, S_R_CZ, S_R_TABLE,
       S_R_HQB, S_R_ENV, S_R_PAN, S_BAR_EST, S_C_READS, S_C_WRAP, S_C_CZ,
       S_C_TABLE, S_C_HQB, S_C_ENV, S_C_PAN, S_REDUCE, S_STORE, NSTAMP };
#ifdef COMPAT_STAMP
struct Stamps {
    unsigned t, acc[NSTAMP];
    float* sink;
};
COMPAT_DEV void stamp(Stamps& st, int k, float x) {
    *(volatile float*)st.sink = x;
    unsigned t;
    asm volatile("mov.u32 %0, %%clock;" : "=r"(t) :: "memory");
    st.acc[k] += t - st.t;
    st.t = t;
}
#define STAMP(k, x) stamp(st, (k), (x))
#define STAMP_PARAM , Stamps& st
#define STAMP_ARG , st
#else
#define STAMP(k, x) ((void)0)
#define STAMP_PARAM
#define STAMP_ARG
#endif

// f32 -> i32 as XLA's convert gives it (render.py:144, :247, :268):
// toward zero, saturated, NaN to 0.  A plain (int) cast of NaN or of an
// operand out of range is undefined in C++ and differs between the
// card, XLA and the CPU; the checks make it the same on all three.
COMPAT_DEV int f2i(float x) {
    const int r = __float2int_rz(x);
    return x != x ? 0
                  : (x >= 2147483648.0f ? 2147483647
                                        : (x < -2147483648.0f
                                               ? (int)0x80000000u : r));
}

// fmodf(x, L) bit for bit: for L <= x < 2L the remainder is x - L, exact
// (Sterbenz); for |x| < L it is x.  Any other operands, non-finite ones
// included, take fmodf, on a branch no lane takes in a steady render.
COMPAT_DEV float wrap_fmod(float x, float L) {
    const bool one = x >= L && x < 2.0f * L;
    float r = one ? x - L : x;
    if (!one && !(fabsf(x) < L)) r = fmodf(x, L);
    return r;
}

// render._fast_pow (synth.c:140-147): the reference's bit trick, its
// multiply-add one fma; the int subtraction wraps as XLA's does
COMPAT_DEV float fast_pow(float a, float b) {
    const int i = (int)((unsigned)__float_as_int(a) - 1065353216u);
    const float x = __fmaf_rn(b, (float)i, 1065353216.0f);
    const float r = __int_as_float(f2i(x));
    return a <= 0.0f ? 0.0f : r;
}

// render._cz_phasor (synth.c:149-215) as one form: curves 1, 2, 3 and 5
// are phase < thr ? phase * sa : fma(phase - b, sb, c) (curve 2's
// -(1 - phase) is phase - 1, the same rounding of the same number, and
// an fma of a zero of either sign with c = 1 is 1), 6 and 7 fast_pow
// to the exponent e.  The quotients are _div32's of the same operands;
// computed once a segment where d is constant, they keep their bits.
struct Curve {
    float thr, sa, b, sb, c, e;
};

COMPAT_DEV Curve cz_curve(int mode, float d) {
    d = d < 0.0f ? 0.0f : d;               // jnp.clip: NaN stays NaN
    d = d > 0.999f ? 0.999f : d;
    const bool one = mode == 1;
    const float hd = d * 0.5f;
    Curve k;
    k.sa = 0.5f / (one ? d : 0.5f - hd);
    const float q2 = 0.5f / (one ? 1.0f - d : 0.5f + hd);
    k.sb = (mode == 2 || mode == 3) ? k.sa : q2;
    k.thr = one ? d : 0.5f;
    k.b = one ? d : (mode == 2 ? 1.0f : 0.5f);
    k.c = mode == 2 ? 1.0f : 0.5f;
    k.e = 1.0f + (mode == 6 ? 4.0f : 8.0f) * d;
    return k;
}

// one segment's parameters of one voice, and what is constant over it
struct Voice {
    float f[NPF];
    int i[NPI];
    int fm_at, cm_at, am_at, pm_at;       // read indices (read_at)
    Curve cz;
    bool cz_fixed, cz_read;               // d constant; d read (NaN check)
    bool cz_piece, cz_four, cz_pow;       // the curve's form
    float inv_ts;
};

// the voice's state: the carry's fields
struct State {
    float phase, sample, hold_val, x1, x2, y1, y2, smoother, pan_l, pan_r;
    int finished, hold_count;
};

struct PassOut {
    float sample, left, right;
};

// read(osc) as an index: the serial-order rule, est[osc] if osc < n else
// prev[osc], at max(osc, 0) (an index past the voices clamps, as XLA's
// gather does); V is added for est
COMPAT_DEV int read_at(int osc, int v) {
    const int at = osc < 0 ? 0 : (osc > V - 1 ? V - 1 : osc);
    return osc < v ? at + V : at;
}

// one read: prev[at] or est[at]
COMPAT_DEV float read(const float* prev, const float* est, int at) {
    return at >= V ? est[at - V] : prev[at];
}

COMPAT_DEV void load_voice(Voice& p, const CompatArgs& a, int b, int seg,
                           int v) {
    const float* pf = a.pf + ((size_t)b * a.segs + seg) * NPF * V + v;
    const int* pi = a.pi + ((size_t)b * a.segs + seg) * NPI * V + v;
#pragma unroll
    for (int j = 0; j < NPF; ++j) p.f[j] = __ldg(pf + j * V);
#pragma unroll
    for (int j = 0; j < NPI; ++j) p.i[j] = __ldg(pi + j * V);
    p.fm_at = read_at(p.i[Q_FM_OSC], v);
    p.cm_at = read_at(p.i[Q_CM_OSC], v);
    p.am_at = read_at(p.i[Q_AM_OSC], v);
    p.pm_at = read_at(p.i[Q_PM_OSC], v);
    if (HAS_CZ) {
        // d = cz_dist + dm: dm is 1 without a modulator; from one at
        // depth 0 it is a zero (d = cz_dist, but for a -0 there) or NaN
        // (a non-finite read)
        const int cm = p.i[Q_CM_OSC];
        const float dist = p.f[P_CZ_DIST];
        const bool neg0 = dist == 0.0f && __float_as_int(dist) < 0;
        p.cz_fixed = cm < 0 || (p.f[P_CZ_DEP] == 0.0f && !neg0);
        p.cz_read = cm >= 0;
        const int mode = p.i[Q_CZ_MODE];
        p.cz = cz_curve(mode, cm < 0 ? dist + 1.0f : dist);
        p.cz_piece = mode == 1 || mode == 2 || mode == 3 || mode == 5;
        p.cz_four = mode == 4;
        p.cz_pow = mode == 6 || mode == 7;
        p.inv_ts = 1.0f / p.f[P_TSIZE];
    }
}

// render._voice_pass for voice v: prev and est are the 64 voices'
// previous samples and current estimates (shared memory).  With
// COMMIT, the voice's new state goes into s (the last pass), and the
// pan and the stereo pair are computed; a non-committing pass gives the
// sample alone.
template <bool COMMIT>
COMPAT_DEV PassOut voice_pass(const float* prev, const float* est,
                              State& s, const Voice& p,
                              float white, int count,
                              const float* __restrict__ table, int v
                              STAMP_PARAM) {
    const int base = COMMIT ? S_C_READS : S_R_READS;
    const int fl = p.i[Q_FLAGS];
    const bool active = s.finished == 0 && p.f[P_AMP] != 0.0f;
    const float r_fm = (KF & F_USE_FM) ? read(prev, est, p.fm_at) : 0.0f;
    const float r_cm = (KM & M_CZ) ? read(prev, est, p.cm_at) : 0.0f;
    const float r_am = (KM & M_AM) ? read(prev, est, p.am_at) : 0.0f;
    const float r_pm = (COMMIT && (KM & M_PAN)) ? read(prev, est, p.pm_at)
                                                : 0.0f;
    STAMP(base, r_fm + r_cm + r_am + r_pm);

    // ---- oscillator (synth.c:543-558, osc_next :217-275) ----
    const float pinc = p.f[P_PINC];
    float inc = pinc;
    if (KF & F_USE_FM) {
        const float g = __fmul_rn(r_fm, p.f[P_FM_DEP]);
        inc = (fl & F_USE_FM) ? __fmaf_rn(p.f[P_MIS], g, pinc) : pinc;
    }
    if (KF & F_DIRNEG) inc = (fl & F_DIRNEG) ? -inc : inc;
    const float ph = s.phase + inc;
    const bool bad = !isfinite(ph);
    const float lo = p.f[P_LO], hi = p.f[P_HI];
    const bool over = ph >= hi, under = ph < lo;
    // one wrap: lo + fmod(ph - lo, L) over, hi - fmod(lo - ph, L) under
    const float w = wrap_fmod(bad ? 0.0f : (over ? ph - lo : lo - ph),
                              p.f[P_L]);
    float ph2 = over ? lo + w : (under ? hi - w : ph);
    bool fin_osc = false;
    if (KF & F_OSN) {
        const bool osn = (fl & F_OSN) != 0;
        ph2 = osn && over ? p.f[P_HI_OS] : (osn && under ? lo : ph2);
        fin_osc = (over || under) && osn;
    }
    ph2 = bad ? 0.0f : ph2;
    if (KF & F_ONE_SHOT) fin_osc = fin_osc || (bad && (fl & F_ONE_SHOT));
    STAMP(base + 1, ph2);

    // ---- CZ warp (render._cz_phasor) ----
    float idx_f = ph2;
    if (HAS_CZ) {
        const int mode = p.i[Q_CZ_MODE];
        Curve k = p.cz;
        if ((KM & M_CZD) && !p.cz_fixed) {
            // a CZ modulator at a nonzero depth: d every sample
            k = cz_curve(mode, p.f[P_CZ_DIST]
                                   + __fmul_rn(r_cm, p.f[P_CZ_DEP]));
        } else if ((KM & M_CZ) && p.cz_read && !isfinite(r_cm)) {
            // read * 0 is NaN: so are d and every scale (the curves give
            // NaN, fast_pow 0)
            k.sa = k.sb = k.e = __int_as_float(0x7fc00000);
        }
        const float phase = TS_POW2 ? __fmul_rn(ph2, p.inv_ts)
                                    : ph2 / p.f[P_TSIZE];
        float out = phase;
        if (CZ_PIECE) {
            const float pc = phase < k.thr
                                 ? __fmul_rn(phase, k.sa)
                                 : __fmaf_rn(phase - k.b, k.sb, k.c);
            out = p.cz_piece ? pc : out;
        }
        if (KCZ & (1 << 4))
            out = p.cz_four ? wrap_fmod(phase * 2.0f, 1.0f) : out;
        if (CZ_POW) out = p.cz_pow ? fast_pow(phase, k.e) : out;
        idx_f = mode != 0 ? out * p.f[P_TSIZE] : ph2;
    }
    STAMP(base + 2, idx_f);

    // ---- table (the conversion before the clip, render.py:247) ----
    int idx = f2i(idx_f);
    idx = idx < 0 ? 0 : idx;
    idx = idx > p.i[Q_CLIP_HI] ? p.i[Q_CLIP_HI] : idx;
    float f = __ldg(table + p.i[Q_TABLE_OFF] + idx);
    f = bad ? 0.0f : f;
    const bool noise = (KF & F_IS_NOISE) && (fl & F_IS_NOISE);
    if (KF & F_IS_NOISE) f = noise ? white : f;
    STAMP(base + 3, f);

    // ---- sample & hold (synth.c:560-571) ----
    const bool hold_on = (KF & F_HOLD_ON) && (fl & F_HOLD_ON);
    const float hv = (hold_on && s.hold_count == 0) ? f : s.hold_val;
    const float s1 = hold_on ? hv : f;

    // ---- bit quantizer (synth.c:341-345, :574): levels from the host ----
    float s2 = s1;
    if (KF & F_QUANT) {
        const float iv = (float)f2i(__fmaf_rn(s1, p.f[P_LEVELS], 0.5f));
        s2 = (fl & F_QUANT) ? __fmul_rn(iv, p.f[P_INV_LEV]) : s1;
    }

    // ---- biquad, direct form I (mmf_process, synth.c:349-364) ----
    const bool use_flt = (KF & F_USE_FLT) && (fl & F_USE_FLT);
    float s3 = s2, flt = 0.0f;
    if (KF & F_USE_FLT) {
        flt = __fmul_rn(p.f[P_B1], s.x1);
        flt = __fmaf_rn(p.f[P_B0], s2, flt);
        flt = __fmaf_rn(p.f[P_B2], s.x2, flt);
        flt = __fmaf_rn(p.f[P_NA1], s.y1, flt);
        flt = __fmaf_rn(p.f[P_NA2], s.y2, flt);
        s3 = use_flt ? flt : s2;
    }
    STAMP(base + 4, s3);

    // ---- envelope (synth.c:580-593): one divide, its operands by arm ----
    float env = 1.0f;
    if (KF & F_USE_ENV) {
        float e = 0.0f;
        if (KF & F_ENV_ACT) {
            const float t = (float)(int)((unsigned)count
                                         - (unsigned)p.i[Q_ENV_START]);
            const float tr = (float)(int)((unsigned)count
                                          - (unsigned)p.i[Q_ENV_REL_AT]);
            const float att = p.f[P_ATT], sus = p.f[P_SUS];
            const float rel = p.f[P_REL];
            const bool a0 = t < att, a1 = !a0 && t < p.f[P_ATT_DEC];
            const float q = (a0 ? t : (a1 ? t - att : tr))
                            / (a0 ? att : (a1 ? p.f[P_DEC] : rel));
            const float rv = tr < rel ? __fmul_rn(sus, 1.0f - q) : 0.0f;
            e = a0 ? q : (a1 ? __fmaf_rn(-q, 1.0f - sus, 1.0f)
                             : ((fl & F_NO_REL) ? sus : rv));
            e = (fl & F_ENV_ACT) ? e : 0.0f;
        }
        env = (fl & F_USE_ENV) ? __fmul_rn(e, p.f[P_VEL]) : 1.0f;
    }
    STAMP(base + 5, env);

    // ---- amp / amp-mod / smoother ----
    float ampmod = 1.0f;
    if (KM & M_AM) {
        const int am = p.i[Q_AM_OSC];
        const float m = __fmul_rn(am == v ? s3 : r_am, p.f[P_AM_DEP]);
        ampmod = am >= 0 ? m : 1.0f;
    }
    const float fin = __fmul_rn(__fmul_rn(p.f[P_AMP], env), ampmod);
    const bool use_sm = (KF & F_USE_SM) && (fl & F_USE_SM);
    float final2 = fin, sg = 0.0f;
    if (KF & F_USE_SM) {
        sg = __fmaf_rn(p.f[P_SMOOTHING], fin - s.smoother, s.smoother);
        final2 = use_sm ? sg : fin;
    }
    const float out = active ? __fmul_rn(s3, final2) : 0.0f;
    PassOut o;
    o.sample = out;
    o.left = o.right = 0.0f;
    if (!COMMIT) {
        STAMP(base + 6, out);
        return o;
    }

    // ---- pan (+pan-mod) (synth.c:595-612) ----
    const bool disc = (KF & F_DISC) && (fl & F_DISC);
    float pl = s.pan_l, pr = s.pan_r;
    bool pan_on = false;
    if (KM & M_PAN) {
        const int pm = p.i[Q_PM_OSC];
        pan_on = pm >= 0 && !disc;
        const float q = pm == v ? out : r_pm;
        // gcc fuses the q product into both (1-q) and (1+q)
        pl = pan_on ? __fmul_rn(__fmaf_rn(-q, p.f[P_PM_DEP], 1.0f), 0.5f)
                    : pl;
        pr = pan_on ? __fmul_rn(__fmaf_rn(q, p.f[P_PM_DEP], 1.0f), 0.5f)
                    : pr;
    }
    const bool contrib = active && !disc;
    o.left = contrib ? __fmul_rn(out, pl) : 0.0f;
    o.right = contrib ? __fmul_rn(out, pr) : 0.0f;

    if (active && !noise) s.phase = ph2;
    if (active && !noise && fin_osc) s.finished = 1;
    if (KF & F_HOLD_ON) {
        const int hc = s.hold_count + 1;
        if (active && hold_on) s.hold_count = hc >= p.i[Q_HOLD_MAX] ? 0 : hc;
        if (active) s.hold_val = hv;
    }
    if (active && use_flt) {
        s.x2 = s.x1; s.x1 = s2; s.y2 = s.y1; s.y1 = flt;
    }
    if (active && use_sm) s.smoother = sg;
    if (active && pan_on) { s.pan_l = pl; s.pan_r = pr; }
    s.sample = out;
    STAMP(base + 6, o.left + o.right);
    return o;
}

// the fixed tree of compat.py's voice_sum over one half of a sample's
// values h: value k of the level of width N is value k plus value k + N
// of the level of width 2N (k + 16, then k + 8, 4, 2, 1), unrolled at
// compile time into straight-line adds of registers
template <int K, int N>
struct Tree {
    static __device__ __forceinline__ float sum(const float* h) {
        return __fadd_rn(Tree<K, 2 * N>::sum(h), Tree<K + N, 2 * N>::sum(h));
    }
};
template <int K>
struct Tree<K, 32> {
    static __device__ __forceinline__ float sum(const float* h) {
        return h[K];
    }
};

// voice_sum: the two halves' trees, then their sum
COMPAT_DEV float voice_sum(const float* h) {
    return __fadd_rn(Tree<0, 1>::sum(h), Tree<0, 1>::sum(h + 32));
}

constexpr int HIST = 32;                  // samples a voice sum round

// the per-row body; blockIdx.x is the row, threadIdx.x the voice
__global__ void __launch_bounds__(V) compat_kernel(const CompatArgs a) {
    __shared__ float s_prev[2][V];         // by the sample's parity
    __shared__ float s_est[2][V];          // by the pass's parity
    __shared__ float s_hist[2][HIST][V + 1];   // left, right; padded
    __shared__ float s_vg[HIST];
    __shared__ float s_hv[V];
    __shared__ int s_hc[V];
    const int b = blockIdx.x, v = threadIdx.x;
    const int lane = v & 31, warp = v >> 5;
    const int T = a.nblocks * a.block;

    State s;
    {
        const float* c = a.cf0 + (size_t)b * NCF * V + v;
        const int* ci = a.ci0 + (size_t)b * NCI * V + v;
        s.phase = c[C_PHASE * V]; s.sample = c[C_SAMPLE * V];
        s.hold_val = c[C_HOLD_VAL * V];
        s.x1 = c[C_X1 * V]; s.x2 = c[C_X2 * V];
        s.y1 = c[C_Y1 * V]; s.y2 = c[C_Y2 * V];
        s.smoother = c[C_SMOOTHER * V];
        s.pan_l = c[C_PAN_L * V]; s.pan_r = c[C_PAN_R * V];
        s.finished = ci[CI_FINISHED * V];
        s.hold_count = ci[CI_HOLD_COUNT * V];
    }
    float vg = a.vg0[b];
    Voice p;
    bool run = false;              // the warp's non-committing passes
    float vf = 0.0f;
    int cur = -1;
    float* out = a.out + (size_t)b * T * 2;
    float white_next = __ldg(a.noise);
#ifdef COMPAT_STAMP
    __shared__ float s_sink[V];
    Stamps st;
    st.sink = s_sink + v;
#pragma unroll
    for (int k = 0; k < NSTAMP; ++k) st.acc[k] = 0;
    asm volatile("mov.u32 %0, %%clock;" : "=r"(st.t) :: "memory");
#endif

    for (int k = 0; k < a.nblocks; ++k) {
        const int kg = a.block0 + k;
        const int seg = __ldg(a.seg + (size_t)b * a.nb_total + kg);
        if (seg != cur) {
            load_voice(p, a, b, seg, v);
            run = __any_sync(0xffffffffu, (p.i[Q_FLAGS] & F_READ) != 0);
            vf = __ldg(a.vf + (size_t)b * a.segs + seg);
            cur = seg;
        }
        if (__ldg(a.start + (size_t)b * a.nb_total + kg)) {
            // ---- the segment's state writes (render._apply_ops) ----
            const size_t so = ((size_t)b * a.segs + seg);
            const float* of = a.of + so * NOF * V + v;
            const int* oi = a.oi + so * NOI * V + v;
            // a copied hold state is the source voice's from before this
            // block's writes (render.py:368-371): it crosses threads
            s_hc[v] = s.hold_count;
            s_hv[v] = s.hold_val;
            __syncthreads();
            const int fl = __ldg(oi + OI_FLAGS * V);
            if (fl & SET_PHASE) s.phase = __ldg(of + O_PHASE * V);
            if (fl & SET_FINISHED) s.finished = __ldg(oi + OI_FINISHED * V);
            if (fl & SET_SAMPLE) s.sample = __ldg(of + O_SAMPLE * V);
            if (fl & CLEAR_FILTER) s.x1 = s.x2 = s.y1 = s.y2 = 0.0f;
            if (fl & SET_SMOOTHER) s.smoother = __ldg(of + O_SMOOTHER * V);
            if (fl & SET_PAN) {
                s.pan_l = __ldg(of + O_PAN_L * V);
                s.pan_r = __ldg(of + O_PAN_R * V);
            }
            const int src = __ldg(oi + OI_COPY_HOLD * V);
            if (src >= 0) {
                const int at = src > V - 1 ? V - 1 : src;
                s.hold_count = s_hc[at];
                s.hold_val = s_hv[at];
            }
        }
        for (int t = 0; t < a.block; ++t) {
            const int i = k * a.block + t;
            const int count = kg * a.block + 1 + t;      // 1-based, global
            const float white = white_next;
            if (i + 1 < T) white_next = __ldg(a.noise + i + 1);
            STAMP(S_NOISE, white);
            // every pass reads the previous samples; the first pass's
            // estimates are those too.  The buffer of the sample before
            // is still being read: this one writes the other.
            float* prev = s_prev[i & 1];
            prev[v] = s.sample;
            __syncthreads();
            STAMP(S_BAR_PREV, 0.0f);
            const float* est = prev;
            // the non-committing passes, each into the estimate buffer
            // the last pass did not read (a voice no one reads may leave
            // its slot as it was: no one reads it)
#pragma unroll 1
            for (int ps = 0; ps + 1 < PASSES; ++ps) {
                float* w = s_est[ps & 1];
                if (run)
                    w[v] = voice_pass<false>(prev, est, s, p, white, count,
                                             a.table, v STAMP_ARG).sample;
                __syncthreads();
                STAMP(S_BAR_EST, 0.0f);
                est = w;
            }
            const PassOut o = voice_pass<true>(prev, est, s, p, white, count,
                                               a.table, v STAMP_ARG);
            // ---- master volume smoother + stereo mix (synth.c:616-624) ----
            vg = __fmaf_rn(0.002f, vf - vg, vg);
            const int h = i & (HIST - 1);
            s_hist[0][h][v] = o.left;
            s_hist[1][h][v] = o.right;
            if (v == 0) s_vg[h] = vg;
            if (CAPTURE)
                reinterpret_cast<float2*>(a.cap)[((size_t)b * T + i) * V + v]
                    = make_float2(o.left, o.right);
            STAMP(S_STORE, o.left + o.right);
            // every HIST samples (and at the end) the sums: thread u sums
            // the left (warp 0) or right (warp 1) of sample lane u
            if (h == HIST - 1 || i == T - 1) {
                __syncthreads();
                if (lane <= h) {
                    const float sum = voice_sum(s_hist[warp][lane]);
                    out[(size_t)(i - h + lane) * 2 + warp] =
                        __fmul_rn(sum, s_vg[lane]);
                }
            }
            STAMP(S_REDUCE, 0.0f);
        }
    }
#ifdef COMPAT_STAMP
    if (lane == 0 && a.stamp)
#pragma unroll
        for (int k = 0; k < NSTAMP; ++k)
            a.stamp[((size_t)b * (V / 32) + warp) * NSTAMP + k] = st.acc[k];
#endif

    {
        float* c = a.cf1 + (size_t)b * NCF * V + v;
        int* ci = a.ci1 + (size_t)b * NCI * V + v;
        c[C_PHASE * V] = s.phase; c[C_SAMPLE * V] = s.sample;
        c[C_HOLD_VAL * V] = s.hold_val;
        c[C_X1 * V] = s.x1; c[C_X2 * V] = s.x2;
        c[C_Y1 * V] = s.y1; c[C_Y2 * V] = s.y2;
        c[C_SMOOTHER * V] = s.smoother;
        c[C_PAN_L * V] = s.pan_l; c[C_PAN_R * V] = s.pan_r;
        ci[CI_FINISHED * V] = s.finished;
        ci[CI_HOLD_COUNT * V] = s.hold_count;
        if (v == 0) a.vg1[b] = vg;
    }
}

// the field counts the wrapper checks against its own (compat.py)
extern "C" int compat_layout(int which) {
    const int n[] = {NPF, NPI, NOF, NOI, NCF, NCI, V, NSTAMP};
    return which >= 0 && which < 8 ? n[which] : -1;
}

// 1 when the arguments are the build's key: the same passes, capture
// and measurement setting, and no feature the build lacks
extern "C" int compat_key_ok(const CompatArgs* a) {
#ifdef COMPAT_STAMP
    const bool stamped = true;
#else
    const bool stamped = false;
#endif
    return a->passes == PASSES && (a->capture != 0) == CAPTURE
           && (a->need_flags & ~KF) == 0 && (a->need_cz & ~KCZ) == 0
           && (a->need_mods & ~KM) == 0 && (a->ts_pow2 != 0 || !TS_POW2)
           && (a->stamp != nullptr) == stamped;
}

#ifndef COMPAT_SHIM

extern "C" int compat_launch(const CompatArgs* a, void* stream) {
    if (!compat_key_ok(a)) return -1;
    if (a->rows <= 0) return (int)cudaGetLastError();
    compat_kernel<<<a->rows, V, 0, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

#endif  // COMPAT_SHIM
