// The filter/smoother kernel for Hopper (sm_90a): a noise-voice tier's
// serial output stages over one block, with the glue that feeds them, one
// thread per lane (filt_smooth.py: filt_smooth_noise).
//
// Replaces skred_tpu/engine/kernels.py:filt_smooth_pallas (body
// _make_fs_kernel) and the noise pass's glue around it.  Per lane and per
// sample: the lookup's sample, or the block's noise stream on a noise
// lane; the dead mask from the lane's alive count (its live samples are a
// prefix of the block); the envelope × velocity (synth.c:398-431, IEEE
// divides, fma32 as the noise pass has it); the am stream read from the
// bank of earlier tiers; then (synth.c:560-592) the S&H refresh on its
// counter wrap, the bit quantizer, the biquad, the gain amp·env·amod
// (amod from the voice's own filtered sample for am-self lanes) and the
// one-pole amp smoother; the end states of the stages that are on.  The
// arithmetic is tier.cu's phase 4, with the gain formed per sample as the
// JAX kernel forms it.
//
// Built once per stage set (filt_smooth.py: filt_smooth_key), with
// -DFS_<FLAG>=<0|1> for FLT, SM, HOLD, QUANT, AM_SELF, ENV and AM.  It
// has no arithmetic mode: the biquad and the smoother take the fma in the
// engine's exact and fast mode alike.
//
// Bound on this card: bytes.  Per lane-sample it reads the lookup's
// sample and, with am, the lane's bank column (4 B each), and writes the
// sample (4 B).  Its real limit is the serial chain (hold -> quantize ->
// four fmas -> smoother fma) of each lane, so each thread keeps its
// lane's state in registers and walks the N samples once; neighbouring
// threads own neighbouring lanes, so every [N, M] read and write
// coalesces.  Around the chain:
//   - the features are compiled in: no flag is tested per sample;
//   - loads off the chain: the next chunk's samples and bank reads are
//     issued before this chunk's serial chain runs;
//   - the per-sample factors that do not feed back (noise select, dead
//     mask, envelope, am stream, the gain without am-self) are formed for
//     a whole chunk ahead of the chain;
//   - one warp a block, so a narrow tier spreads over every SM.
// The envelope keeps its IEEE divides behind branches (one a sample):
// all three segments' quotients as reciprocal products and selects took
// 0.197 ms a tier-1 call against 0.144 (noise64, H100 80GB HBM3, 700 W;
// PERF.md).
//
// Numerics are the JAX kernel's, bit for bit: __fmaf_rn where it calls
// _kfma (the quantizer; the biquad and the smoother, in fast mode too,
// where the JAX kernel's a*b + c is the fma XLA contracts it into on the
// CPU), separately rounded multiply and add elsewhere.  Build with
// -fmad=false and without --use_fast_math; denormals are kept.

#include <cuda_runtime.h>

#include "bank.cuh"
#include "numerics.cuh"

#include <type_traits>

struct FiltNoiseArgs {
    int n, m, b, bank_w, bank_stride, out_stride, cbase, has_flt,
        has_sm, has_hold, has_quant, has_am_self, has_env, has_am;
    const float* f;         // [n, m] the lookup's samples
    const float* noise;     // [n] the block's noise stream
    const int* is_noise;
    const int* cnt;         // alive samples of each lane
    const float* bank;      // [n, >= bank_w*b], row stride bank_stride
    const float* prev;
    const float* amp;
    const int* use_env; const int* env_active; const int* env_start;
    const int* env_rel_at;
    const float* att; const float* dec; const float* sus; const float* rel;
    const float* vel;
    const int* am_ge0; const float* am_depth_a;
    const int* am_src; const int* am_del;
    const float* b0; const float* b1; const float* b2; const float* na1;
    const float* na2; const int* use_flt;
    const int* use_sm; const float* smoothing;
    const int* am_self; const float* am_depth;
    const int* hold_on; const int* hold_max;
    const int* quant_on; const float* levels; const float* inv_levels;
    const float* x1_0; const float* x2_0; const float* y1_0;
    const float* y2_0; const float* smoother_0;
    const int* hold_count_0; const float* hold_val_0;
    float* out;             // [n, m], row stride out_stride
    float* x1_e; float* x2_e; float* y1_e; float* y2_e; float* smoother_e;
    int* hold_count_e; float* hold_val_e;
};

constexpr bool FLT = FS_FLT, SM = FS_SM, HOLD = FS_HOLD, QUANT = FS_QUANT,
    AM_SELF = FS_AM_SELF, ENV = FS_ENV, AM = FS_AM;
// samples per chunk
constexpr int T = 8;

extern "C" int filt_smooth_chunk_samples() { return T; }

__global__ void __launch_bounds__(32) filt_smooth_keyed_kernel(
        const FiltNoiseArgs a) {
    const int m = blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= a.m) return;
    const int M = a.m;
    const int n = a.n;
    const bool noise_lane = a.is_noise[m] != 0;
    const int live = a.cnt[m];
    const float amp = a.amp[m];

    bool use_env = false, env_act = false;
    int env_start = 0, env_relat = 0;
    float att = 0.0f, dec = 0.0f, sus = 0.0f, rel = 0.0f, vel = 0.0f,
          att_dec = 0.0f, one_sus = 0.0f;
    if (ENV) {
        use_env = a.use_env[m] != 0; env_act = a.env_active[m] != 0;
        env_start = a.env_start[m]; env_relat = a.env_rel_at[m];
        att = a.att[m]; dec = a.dec[m]; sus = a.sus[m]; rel = a.rel[m];
        vel = a.vel[m];
        att_dec = att + dec;
        one_sus = 1.0f - sus;
    }
    bool am_ge = false;
    float amdep_a = 0.0f;
    Stream<T, true> s_am;
    if (AM) {
        am_ge = a.am_ge0[m] != 0;
        amdep_a = a.am_depth_a[m];
        s_am.fold(a.bank, a.prev, a.bank_w, a.bank_stride, a.b, am_ge,
                  a.am_src, a.am_del, m);
    }
    float b0 = 0, b1 = 0, b2 = 0, na1 = 0, na2 = 0;
    bool use_flt = false;
    float x1 = 0, x2 = 0, y1 = 0, y2 = 0;
    if (FLT) {
        b0 = a.b0[m]; b1 = a.b1[m]; b2 = a.b2[m];
        na1 = a.na1[m]; na2 = a.na2[m]; use_flt = a.use_flt[m] != 0;
        x1 = a.x1_0[m]; x2 = a.x2_0[m]; y1 = a.y1_0[m]; y2 = a.y2_0[m];
    }
    bool use_sm = false;
    float smoothing = 0, sg = 0;
    if (SM) {
        use_sm = a.use_sm[m] != 0; smoothing = a.smoothing[m];
        sg = a.smoother_0[m];
    }
    bool am_self = false;
    float am_depth = 0;
    if (AM_SELF) { am_self = a.am_self[m] != 0; am_depth = a.am_depth[m]; }
    bool hold_on = false;
    int hmax = 1, hc = 0;
    float hv = 0;
    if (HOLD) {
        hold_on = a.hold_on[m] != 0; hmax = a.hold_max[m];
        hc = a.hold_count_0[m]; hv = a.hold_val_0[m];
    }
    bool quant_on = false;
    float levels = 0, inv_lev = 0;
    if (QUANT) {
        quant_on = a.quant_on[m] != 0; levels = a.levels[m];
        inv_lev = a.inv_levels[m];
    }

    const float* const fp = a.f + m;
    float* const op = a.out + m;
    const size_t ostride = (size_t)a.out_stride;

    // the chunk's raw loads: the lookup's samples (none on a noise lane
    // or past the lane's live prefix) and the noise stream
    float fb[T], nz[T];
    const auto load = [&](int t0) {
        if (t0 >= n) return;
#pragma unroll
        for (int j = 0; j < T; ++j) {
            const int t = t0 + j;
            if (t < n) {
                fb[j] = (t < live && !noise_lane)
                            ? __ldg(fp + (size_t)t * M) : 0.0f;
                nz[j] = noise_lane ? __ldg(a.noise + t) : 0.0f;
            }
        }
        if (AM) s_am.fetch(t0, n);
    };

    // One chunk: its per-sample factors, the next chunk's loads, then the
    // serial chain and the stores.
    const auto chunk = [&](int t0, auto full) {
        constexpr bool FULL = decltype(full)::value;
        const int rem = n - t0;
        float xv[T], base[T], amv[T];
#pragma unroll
        for (int j = 0; j < T; ++j) {
            if (!FULL && j >= rem) break;
            const bool alive_t = t0 + j < live;
            const float f_t = noise_lane ? nz[j] : fb[j];
            xv[j] = alive_t ? f_t : 0.0f;
            float g = amp;
            if (ENV) {
                const int tpos = a.cbase + t0 + j;
                const float tf = (float)(tpos - env_start);
                const float trf = (float)(tpos - env_relat);
                float v;
                if (tf < att) {
                    v = __fdiv_rn(tf, att);
                } else if (tf < att_dec) {
                    v = kfma(-__fdiv_rn(tf - att, dec), one_sus, 1.0f);
                } else if (env_relat == 0) {
                    v = sus;
                } else if (trf < rel) {
                    v = sus * (1.0f - __fdiv_rn(trf, rel));
                } else {
                    v = 0.0f;
                }
                if (!env_act) v = 0.0f;
                g = amp * (use_env ? v * vel : 1.0f);
            }
            const float amod = AM ? (am_ge ? s_am.at(j) * amdep_a : 1.0f)
                                  : 1.0f;
            if (AM_SELF) {
                base[j] = g;
                amv[j] = amod;
            } else {
                base[j] = g * amod;
            }
        }
        load(t0 + T);
#pragma unroll
        for (int j = 0; j < T; ++j) {
            if (!FULL && j >= rem) break;
            const bool alive_t = t0 + j < live;
            const float f_t = xv[j];
            float s1 = f_t;
            if (HOLD) {
                const float hv2 = (hold_on && hc == 0) ? f_t : hv;
                s1 = hold_on ? hv2 : f_t;
                int hcn = hc + 1;
                if (hcn >= hmax) hcn = 0;
                if (alive_t) hv = hv2;
                if (alive_t && hold_on) hc = hcn;
            }
            float x_t = s1;
            if (QUANT) {
                const float iv = (float)(int)kfma(s1, levels, 0.5f);
                if (quant_on) x_t = iv * inv_lev;
            }
            float s3 = x_t;
            if (FLT) {
                float fo = b1 * x1;
                fo = kfma(b0, x_t, fo);
                fo = kfma(b2, x2, fo);
                fo = kfma(na1, y1, fo);
                fo = kfma(na2, y2, fo);
                if (use_flt) s3 = fo;
                if (alive_t && use_flt) {
                    x2 = x1; x1 = x_t; y2 = y1; y1 = fo;
                }
            }
            float final_t = base[j];
            if (AM_SELF)
                final_t = base[j] * (am_self ? s3 * am_depth : amv[j]);
            float final2 = final_t;
            if (SM) {
                const float sg2 = kfma(smoothing, final_t - sg, sg);
                if (use_sm) final2 = sg2;
                if (alive_t && use_sm) sg = sg2;
            }
            op[(size_t)(t0 + j) * ostride] = alive_t ? s3 * final2 : 0.0f;
        }
    };

    load(0);
    int t0 = 0;
    for (; t0 + T <= n; t0 += T) chunk(t0, std::true_type());
    if (t0 < n) chunk(t0, std::false_type());

    if (FLT) {
        a.x1_e[m] = x1; a.x2_e[m] = x2; a.y1_e[m] = y1; a.y2_e[m] = y2;
    }
    if (SM) a.smoother_e[m] = sg;
    if (HOLD) { a.hold_count_e[m] = hc; a.hold_val_e[m] = hv; }
}

// -1: the arguments are not this build's key
extern "C" int filt_smooth_keyed_launch(const FiltNoiseArgs* a,
                                        void* stream) {
    const int want[] = {FS_FLT, FS_SM, FS_HOLD, FS_QUANT, FS_AM_SELF,
                        FS_ENV, FS_AM};
    const int got[] = {a->has_flt, a->has_sm, a->has_hold, a->has_quant,
                       a->has_am_self, a->has_env, a->has_am};
    for (int i = 0; i < (int)(sizeof(want) / sizeof(want[0])); ++i)
        if (got[i] != want[i]) return -1;
    const int threads = 32;
    const int blocks = (a->m + threads - 1) / threads;
    if (blocks > 0)
        filt_smooth_keyed_kernel<<<blocks, threads, 0,
                                   (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}
