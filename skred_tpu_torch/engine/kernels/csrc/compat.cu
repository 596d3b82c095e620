// The compat engine for Hopper (sm_90a): blocks of the reference's
// per-sample render over all 64 voices, one CUDA block a batch row, one
// thread a voice.
//
// Replaces skred_tpu/engine/render.py:_render_core (:375), the JAX
// package's bit-exact engine: a lax.scan over blocks around a lax.scan
// over samples (_voice_pass :203, _sample_step :331, _apply_ops :354).
// It is not a Pallas kernel; in eager torch each sample would cost
// hundreds of small launches, so the whole recurrence is one kernel.
//
// Bound on this card: latency.  Each row is a serial recurrence of
// block * nblocks samples; a sample is mod_passes passes of each voice's
// dependent chain (modulator read -> phase wrap -> CZ warp -> table load
// -> hold -> quantizer -> biquad -> envelope -> smoother -> pan), the
// passes joined by barriers (a voice reads the others' estimates), then a
// 64-voice sum.  The bytes (the parameters once, two f32 a sample out,
// 512 bytes a sample with capture) are negligible beside it.  The design
// keeps the whole row on chip: every voice's state and its segment's
// parameters in registers, the estimates in shared memory, one barrier a
// pass plus two a sample; rows are independent blocks, so many rows fill
// the SMs while one row runs at the chain's latency.
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
//   * _div32 and one_m_q / 2: IEEE division (-prec-div=true);
//   * jnp.fmod: fmodf, exact, through wrap_fmod's exact short cuts;
//   * the f32 -> i32 conversions (the table index before its clip,
//     fast_pow's bit trick, the quantizer) saturate and send NaN to 0,
//     as XLA's convert does: f2i below;
//   * the stereo sum: a fixed tree, voice_sum in compat.py.
// Build with -fmad=false and without --use_fast_math; denormals are kept.

#include <cuda_runtime.h>
#include <math.h>

#ifndef COMPAT_SHIM
#define COMPAT_DEV __device__ __forceinline__
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
       F_DISC = 1 << 12 };
enum { O_PHASE, O_SAMPLE, O_SMOOTHER, O_PAN_L, O_PAN_R, NOF };
enum { OI_FLAGS, OI_FINISHED, OI_COPY_HOLD, NOI };
enum { SET_PHASE = 1, SET_FINISHED = 2, SET_SAMPLE = 4, CLEAR_FILTER = 8,
       SET_SMOOTHER = 16, SET_PAN = 32 };
enum { C_PHASE, C_SAMPLE, C_HOLD_VAL, C_X1, C_X2, C_Y1, C_Y2, C_SMOOTHER,
       C_PAN_L, C_PAN_R, NCF };
enum { CI_FINISHED, CI_HOLD_COUNT, NCI };

struct CompatArgs {
    int rows, segs, nb_total, block, block0, nblocks, passes, capture;
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
};

// f32 -> i32 as XLA's convert gives it (render.py:144, :247, :268):
// toward zero, saturated, NaN to 0.  A plain (int) cast of NaN or of an
// operand out of range is undefined in C++ and differs between the
// card, XLA and the CPU; the checks make it the same on all three.
COMPAT_DEV int f2i(float x) {
    if (x != x) return 0;
    if (x >= 2147483648.0f) return 2147483647;
    if (x < -2147483648.0f) return (int)0x80000000u;
    return __float2int_rz(x);
}

// fmodf(x, L) bit for bit (numerics.cuh's wrap_fmod, inlined): for
// L <= x < 2L the remainder is x - L, exact (Sterbenz); for |x| < L it is
// x.  Any other operands, non-finite ones included, take fmodf.  Trap:
// libdevice's fmodf inlined bare at the three wrap sites makes ptxas
// spill to an 8-byte stack frame, which chip_smoke.py's build phase
// refuses; behind these short cuts it does not.
COMPAT_DEV float wrap_fmod(float x, float L) {
    if (x >= L && x < 2.0f * L) return x - L;
    if (fabsf(x) < L) return x;
    return fmodf(x, L);
}

// render._fast_pow (synth.c:140-147): the reference's bit trick, its
// multiply-add one fma; the int subtraction wraps as XLA's does
COMPAT_DEV float fast_pow(float a, float b) {
    const int i = (int)((unsigned)__float_as_int(a) - 1065353216u);
    const float x = __fmaf_rn(b, (float)i, 1065353216.0f);
    const float r = __int_as_float(f2i(x));
    return a <= 0.0f ? 0.0f : r;
}

// render._cz_phasor (synth.c:149-215) on the voice's own mode: the modes
// exclude each other, so JAX's select chain picks exactly this curve
COMPAT_DEV float cz_phasor(int mode, float p, float d, float tsize) {
    const float phase = p / tsize;
    d = d < 0.0f ? 0.0f : d;               // jnp.clip: NaN stays NaN
    d = d > 0.999f ? 0.999f : d;
    float out = phase;
    switch (mode) {
    case 1:
        out = phase < d ? __fmul_rn(phase, 0.5f / d)
                        : __fmaf_rn(phase - d, 0.5f / (1.0f - d), 0.5f);
        break;
    case 2: {
        const float sc2 = 0.5f / (0.5f - d * 0.5f);
        out = phase < 0.5f ? __fmul_rn(phase, sc2)
                           : __fmaf_rn(-(1.0f - phase), sc2, 1.0f);
        break;
    }
    case 3: {
        const float sc2 = 0.5f / (0.5f - d * 0.5f);
        out = phase < 0.5f ? __fmul_rn(phase, sc2)
                           : __fmaf_rn(phase - 0.5f, sc2, 0.5f);
        break;
    }
    case 4:
        out = wrap_fmod(phase * 2.0f, 1.0f);
        break;
    case 5:
        if (phase < 0.5f)
            out = __fmul_rn(phase, 0.5f / (0.5f - d * 0.5f));
        else
            out = __fmaf_rn(phase - 0.5f, 0.5f / (0.5f + d * 0.5f), 0.5f);
        break;
    case 6:
        out = fast_pow(phase, 1.0f + 4.0f * d);
        break;
    case 7:
        out = fast_pow(phase, 1.0f + 8.0f * d);
        break;
    default:
        break;
    }
    return out * tsize;
}

// one segment's parameters of this thread's voice
struct Params {
    float f[NPF];
    int i[NPI];
};

// the voice's state: the carry's fields
struct State {
    float phase, sample, hold_val, x1, x2, y1, y2, smoother, pan_l, pan_r;
    int finished, hold_count;
};

struct PassOut {
    float sample, left, right;
};

// render._voice_pass for voice v: est / prev are the 64 voices'
// current-sample estimates and previous samples (shared memory).  With
// COMMIT, the voice's new state goes into s (the last pass).
template <bool COMMIT>
COMPAT_DEV PassOut voice_pass(const float* est, const float* prev, State& s,
                              const Params& p, float white, int count,
                              const float* __restrict__ table, int v) {
    const int fl = p.i[Q_FLAGS];
    const bool active = s.finished == 0 && p.f[P_AMP] != 0.0f;
    // read(osc): the serial-order rule, est[osc] if osc < n else
    // prev[osc], at max(osc, 0) (an index past the voices clamps, as
    // XLA's gather does)
    auto read = [&](int osc) {
        const int at = osc < 0 ? 0 : (osc > V - 1 ? V - 1 : osc);
        return osc < v ? est[at] : prev[at];
    };

    // ---- oscillator (synth.c:543-558, osc_next :217-275) ----
    const float pinc = p.f[P_PINC];
    float inc = pinc;
    if (fl & F_USE_FM) {
        const float g = __fmul_rn(read(p.i[Q_FM_OSC]), p.f[P_FM_DEP]);
        inc = __fmaf_rn(p.f[P_MIS], g, pinc);
    }
    if (fl & F_DIRNEG) inc = -inc;
    const float ph = s.phase + inc;
    const bool bad = !isfinite(ph);
    const float lo = p.f[P_LO], hi = p.f[P_HI];
    const bool osn = (fl & F_OSN) != 0;
    const bool over = ph >= hi, under = ph < lo;
    float ph2 = ph;
    if (over)
        ph2 = osn ? p.f[P_HI_OS] : lo + wrap_fmod(ph - lo, p.f[P_L]);
    else if (under)
        ph2 = osn ? lo : hi - wrap_fmod(lo - ph, p.f[P_L]);
    if (bad) ph2 = 0.0f;
    const bool fin_osc = (bad && (fl & F_ONE_SHOT)) || ((over || under) && osn);
    float idx_f = ph2;
    const int mode = p.i[Q_CZ_MODE];
    if (mode != 0) {
        const int cm = p.i[Q_CM_OSC];
        const float dm = cm >= 0 ? __fmul_rn(read(cm), p.f[P_CZ_DEP]) : 1.0f;
        idx_f = cz_phasor(mode, ph2, p.f[P_CZ_DIST] + dm, p.f[P_TSIZE]);
    }
    // the conversion before the clip (render.py:247): f2i, then the clip
    int idx = f2i(idx_f);
    idx = idx < 0 ? 0 : idx;
    idx = idx > p.i[Q_CLIP_HI] ? p.i[Q_CLIP_HI] : idx;
    float f = bad ? 0.0f : __ldg(table + p.i[Q_TABLE_OFF] + idx);
    const bool noise = (fl & F_IS_NOISE) != 0;
    if (noise) f = white;

    // ---- sample & hold (synth.c:560-571) ----
    const bool hold_on = (fl & F_HOLD_ON) != 0;
    const float hv = (hold_on && s.hold_count == 0) ? f : s.hold_val;
    const float s1 = hold_on ? hv : f;

    // ---- bit quantizer (synth.c:341-345, :574): levels from the host ----
    float s2 = s1;
    if (fl & F_QUANT) {
        const float iv = (float)f2i(__fmaf_rn(s1, p.f[P_LEVELS], 0.5f));
        s2 = __fmul_rn(iv, p.f[P_INV_LEV]);
    }

    // ---- biquad, direct form I (mmf_process, synth.c:349-364) ----
    const bool use_flt = (fl & F_USE_FLT) != 0;
    float s3 = s2, flt = 0.0f;
    if (use_flt) {
        flt = __fmul_rn(p.f[P_B1], s.x1);
        flt = __fmaf_rn(p.f[P_B0], s2, flt);
        flt = __fmaf_rn(p.f[P_B2], s.x2, flt);
        flt = __fmaf_rn(p.f[P_NA1], s.y1, flt);
        flt = __fmaf_rn(p.f[P_NA2], s.y2, flt);
        s3 = flt;
    }

    // ---- amp / envelope / amp-mod / smoother (synth.c:580-593) ----
    float env = 1.0f;
    if (fl & F_USE_ENV) {
        float e = 0.0f;
        if (fl & F_ENV_ACT) {
            const float t = (float)(int)((unsigned)count
                                         - (unsigned)p.i[Q_ENV_START]);
            const float att = p.f[P_ATT], sus = p.f[P_SUS];
            if (t < att) {
                e = t / att;
            } else if (t < p.f[P_ATT_DEC]) {
                e = __fmaf_rn(-((t - att) / p.f[P_DEC]), 1.0f - sus, 1.0f);
            } else if (fl & F_NO_REL) {
                e = sus;
            } else {
                const float tr = (float)(int)((unsigned)count
                                              - (unsigned)p.i[Q_ENV_REL_AT]);
                e = tr < p.f[P_REL]
                        ? __fmul_rn(sus, 1.0f - tr / p.f[P_REL]) : 0.0f;
            }
        }
        env = __fmul_rn(e, p.f[P_VEL]);
    }
    float ampmod = 1.0f;
    const int am = p.i[Q_AM_OSC];
    if (am >= 0)
        ampmod = __fmul_rn(am == v ? s3 : read(am), p.f[P_AM_DEP]);
    const float fin = __fmul_rn(__fmul_rn(p.f[P_AMP], env), ampmod);
    const bool use_sm = (fl & F_USE_SM) != 0;
    float final2 = fin, sg = 0.0f;
    if (use_sm) {
        sg = __fmaf_rn(p.f[P_SMOOTHING], fin - s.smoother, s.smoother);
        final2 = sg;
    }
    const float out = active ? __fmul_rn(s3, final2) : 0.0f;

    // ---- pan (+pan-mod) (synth.c:595-612) ----
    const int pm = p.i[Q_PM_OSC];
    const bool disc = (fl & F_DISC) != 0;
    const bool pan_on = pm >= 0 && !disc;
    float pl = s.pan_l, pr = s.pan_r;
    if (pan_on) {
        const float q = pm == v ? out : read(pm);
        // gcc fuses the q product into both (1-q) and (1+q)
        pl = __fmaf_rn(-q, p.f[P_PM_DEP], 1.0f) / 2.0f;
        pr = __fmaf_rn(q, p.f[P_PM_DEP], 1.0f) / 2.0f;
    }
    const bool contrib = active && !disc;
    PassOut o;
    o.sample = out;
    o.left = contrib ? __fmul_rn(out, pl) : 0.0f;
    o.right = contrib ? __fmul_rn(out, pr) : 0.0f;

    if (COMMIT) {
        if (active && !noise) s.phase = ph2;
        if (active && !noise && fin_osc) s.finished = 1;
        if (active && hold_on) {
            const int hc = s.hold_count + 1;
            s.hold_count = hc >= p.i[Q_HOLD_MAX] ? 0 : hc;
        }
        if (active) s.hold_val = hv;
        if (active && use_flt) {
            s.x2 = s.x1; s.x1 = s2; s.y2 = s.y1; s.y1 = flt;
        }
        if (active && use_sm) s.smoother = sg;
        if (active && pan_on) { s.pan_l = pl; s.pan_r = pr; }
        s.sample = out;
    }
    return o;
}

COMPAT_DEV void load_params(Params& p, const CompatArgs& a, int b, int seg,
                            int v) {
    const float* pf = a.pf + ((size_t)b * a.segs + seg) * NPF * V + v;
    const int* pi = a.pi + ((size_t)b * a.segs + seg) * NPI * V + v;
#pragma unroll
    for (int j = 0; j < NPF; ++j) p.f[j] = __ldg(pf + j * V);
#pragma unroll
    for (int j = 0; j < NPI; ++j) p.i[j] = __ldg(pi + j * V);
}

// the per-row body; blockIdx.x is the row, threadIdx.x the voice
template <bool CAPTURE>
__global__ void __launch_bounds__(V) compat_kernel(const CompatArgs a) {
    __shared__ float s_prev[V];
    __shared__ float s_est[2][V];
    __shared__ float s_hv[V];
    __shared__ int s_hc[V];
    __shared__ float s_red[2][2];
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
    Params p;
    float vf = 0.0f;
    int cur = -1;
    float* out = a.out + (size_t)b * T * 2;

    for (int k = 0; k < a.nblocks; ++k) {
        const int kg = a.block0 + k;
        const int seg = __ldg(a.seg + (size_t)b * a.nb_total + kg);
        if (seg != cur) {
            load_params(p, a, b, seg, v);
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
            const float white = __ldg(a.noise + i);
            // every pass reads the previous samples; the first pass's
            // estimates are those too
            s_prev[v] = s.sample;
            __syncthreads();
            const float* est = s_prev;
            PassOut o;
            for (int ps = 0; ps + 1 < a.passes; ++ps) {
                o = voice_pass<false>(est, s_prev, s, p, white, count,
                                      a.table, v);
                float* w = s_est[ps & 1];
                w[v] = o.sample;
                __syncthreads();
                est = w;
            }
            o = voice_pass<true>(est, s_prev, s, p, white, count,
                                 a.table, v);
            // ---- master volume smoother + stereo mix (synth.c:616-624) ----
            vg = __fmaf_rn(0.002f, vf - vg, vg);
            if (CAPTURE) {
                float2* c2 = reinterpret_cast<float2*>(a.cap)
                             + ((size_t)b * T + i) * V + v;
                *c2 = make_float2(o.left, o.right);
            }
            // the fixed tree of compat.py's voice_sum: lane i adds lane
            // i+16, i+8, i+4, i+2, i+1, then the two warps' sums
            float l = o.left, r = o.right;
#pragma unroll
            for (int h = 16; h >= 1; h >>= 1) {
                l = __fadd_rn(l, __shfl_down_sync(0xffffffffu, l, h));
                r = __fadd_rn(r, __shfl_down_sync(0xffffffffu, r, h));
            }
            if (lane == 0) { s_red[warp][0] = l; s_red[warp][1] = r; }
            __syncthreads();
            if (v == 0) {
                out[2 * i] = __fmul_rn(__fadd_rn(s_red[0][0], s_red[1][0]),
                                       vg);
                out[2 * i + 1] = __fmul_rn(__fadd_rn(s_red[0][1],
                                                     s_red[1][1]), vg);
            }
        }
    }

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

#ifndef COMPAT_SHIM

// the field counts the wrapper checks against its own (compat.py)
extern "C" int compat_layout(int which) {
    const int n[] = {NPF, NPI, NOF, NOI, NCF, NCI, V};
    return which >= 0 && which < 7 ? n[which] : -1;
}

extern "C" int compat_launch(const CompatArgs* a, void* stream) {
    if (a->rows <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (a->capture)
        compat_kernel<true><<<a->rows, V, 0, st>>>(*a);
    else
        compat_kernel<false><<<a->rows, V, 0, st>>>(*a);
    return (int)cudaGetLastError();
}

#endif  // COMPAT_SHIM
