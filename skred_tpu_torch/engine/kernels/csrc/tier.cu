// The tier kernel for Hopper (sm_90a): one block of one tier's per-voice
// DSP chain, one thread per lane, with the modulator-bank fold and the
// static-pan stereo mix.
//
// Replaces skred_tpu/engine/kernels.py:tier_pallas (its kernel body at
// kernels.py:1075) whole: phases 0-4, the fold (its bank_read) and
// phase 5 (the mix with its out_last output).
//
// Bound on this card: per lane-sample the kernel must read each modulator
// stream the tier has (4 B each: a raw [N, M] stream, or with the fold
// the bank column of the lane's source voice) and write the output sample
// (4 B): at least 8 B per lane-sample for an FM tier, over 3.35 TB/s; the
// mix adds one read of the output and 8 B per (sample, batch row).  What
// limits it is latency: each thread walks the block's N samples, and a
// sample's modulator read and table load are global loads.  Only a few
// recurrences are truly serial (the phase walk, the biquad's y1/y2, the
// smoother, the hold count): the loads, the CZ warp and the gain are not
// on them.  Neighbouring threads own neighbouring lanes, so every [N, M]
// read and write coalesces.
//
// Built once per key (kernels/tier.py tier_key): the JAX kernel's
// 14-field static feature tuple, the arithmetic mode, the mix and which
// of fm / cz / am are folded are compile-time constants, as the JAX
// package compiles one kernel per feature tuple, so a stage the tier
// lacks costs no instruction and no register.  The block is walked in
// chunks of T samples per thread, the TPU kernel's phase split done in
// registers and software-pipelined: a chunk's modulator reads, which
// depend on no state, are issued a phase ahead of their use; the phase
// walk, CZ warp and index clip run over the chunk's T samples and its T
// table loads are issued back to back; the S&H / quantizer / biquad /
// smoother chain and the stores of the chunk before run after them, so
// the loads of one chunk are in flight during the walk of the next and
// the two serial chains share one basic block.  The phase wrap and the
// CZ divide run without their slow paths (wrap_fmod's two in-range
// cases; kdiv_inv while finite), and a lane whose operands leave that
// range renders the block again with the exact helpers, as the keyed
// cyclic kernel does.  A block is one warp, so that a narrow tier still
// reaches every SM.
//
// The fold.  The TPU kernel copies the earlier tiers' whole output into
// VMEM and picks (8,128) row windows of it through scalar-prefetched row
// maps, which needs one read topology for all batch rows.  Here lane
// v*B + b with source voice s reads column s*B + b of the bank straight
// from global memory: neighbouring threads read neighbouring addresses,
// so the read coalesces with no staging, and the source is per lane, so
// rows may differ.  A delayed lane (the reference's serial-order rule)
// reads the sample before: t = 0 takes the previous block's last sample.
// A source outside the bank's [0, W) voices reads +0.0, never another
// voice's column.  Every read adds +0.0, as the caller's one-hot read
// does, so a -0.0 sample reads as +0.0 and the folded kernel equals the
// unfolded one bit for bit.  The bank is the block buffer the earlier
// tiers' launches wrote their out columns into (out_stride), so nothing
// is gathered between launches.
//
// The mix.  acc[t, b] = sum over the tier's voices of out[t, v*B + b] *
// w[v*B + b], product and sum each rounded once, in ascending voice
// order from +0.0; with acc_add the sum is added onto the earlier tiers'
// acc.  A batch row's voices belong to different thread blocks of the
// tier kernel, and float atomics would leave the order open, so a second
// kernel of the same launch call (tier_mix_kernel, one thread per (t, b),
// coalesced over b) re-reads out once, most of it still in the L2 cache.
//
// Tables are read from the flat buffer in global memory through the
// read-only cache (__ldg): a PCM table can be larger than a block's
// shared memory, and a lane's lookups stay within one table.
//
// Numerics are the JAX kernel's, bit for bit: __fmaf_rn exactly where it
// calls _kfma (the reference binary's gcc-contracted sites), the same
// Newton/Markstein divide sequences where it calls _kdiv / _kdiv_inv
// (correctly rounded), IEEE division elsewhere.  Fast mode takes IEEE
// division for those sequences and keeps the fmas, also at the FM
// increment, the biquad, the smoother and the CZ warp, where the JAX
// kernel writes a*b + c: the card's own multiply-add, and what XLA
// contracts it into on the CPU (rounded apart, the FM increment's error
// integrates into the phase: -48.7 dB against the compat engine over a
// second of stress64).  Build with -fmad=false (no other contraction)
// and without --use_fast_math; denormals are kept.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "bank.cuh"
#include "numerics.cuh"

struct TierArgs {
    int n, m, cbase, exact;
    int has_fm, has_cz, has_czm, has_env, has_flt, has_sm, has_hold,
        has_quant, has_am, has_am_self, has_finish, has_direction, cz_mask,
        ts_pow2;
    int b;               // batch rows: lane = voice * b + row
    int out_stride;      // floats between two samples of out
    int has_mix, acc_add;
    int fold_fm, fold_cz, fold_am;
    int bank_w;          // voices in the bank (earlier tiers)
    int bank_stride;     // floats between two samples of the bank
    const float* table;
    const float* inc;    // [n, m] raw fm-read stream, or [m] increment
    const float* dm;     // [n, m] raw cz-read stream, or [m] offset
    const float* amod;   // [n, m] raw am-read stream
    const float* bank;   // [n, bank_stride]: columns [0, bank_w * b) read
    const float* prev;   // [bank_w * b] the bank's samples at t = -1
    const int* fm_src; const int* fm_del;   // [m] source voice, delay flag
    const int* cz_src; const int* cz_del;
    const int* am_src; const int* am_del;
    const float* wl; const float* wr;       // [m] stereo mix weights
    const int* use_fm; const float* mis; const float* pinc;
    const float* fm_depth; const int* dirneg;
    const int* cm_ge0; const float* cz_depth;
    const int* am_ge0; const float* am_depth_a;
    const int* base_off; const int* clip_i; const int* adv; const int* act;
    const float* lo; const float* hi; const float* L; const float* amp;
    const int* osn; const int* one_shot;
    const int* cz_mode; const float* cz_dist; const float* tsize;
    const int* use_env; const int* env_active; const int* env_start;
    const int* env_rel_at;
    const float* att; const float* dec; const float* sus; const float* rel;
    const float* vel;
    const float* b0; const float* b1; const float* b2; const float* na1;
    const float* na2; const int* use_flt;
    const int* use_sm; const float* smoothing;
    const int* am_self; const float* am_depth;
    const int* hold_on; const int* hold_max;
    const int* quant_on; const float* levels; const float* inv_levels;
    const float* phase_0; const int* finished_0;
    const float* x1_0; const float* x2_0; const float* y1_0;
    const float* y2_0; const float* smoother_0;
    const int* hold_count_0; const float* hold_val_0;
    float* out; int* cnt_e; float* phase_e; int* finished_e;
    float* x1_e; float* x2_e; float* y1_e; float* y2_e; float* smoother_e;
    int* hold_count_e; float* hold_val_e;
    float* acc_l; float* acc_r;   // [n, b]
    float* out_last;              // [m] out at the block's last sample
};


// Phase 5, the static-pan stereo mix: one thread per (sample, batch row)
// sums the tier's voices in ascending order (see the note at the top).
__global__ void __launch_bounds__(128) tier_mix_kernel(const TierArgs a) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)a.n * a.b) return;
    const int t = (int)(i / a.b), b = (int)(i % a.b);
    const int voices = a.m / a.b;
    const float* o = a.out + (size_t)t * a.out_stride + b;
    float sl = 0.0f, sr = 0.0f;
    for (int v = 0; v < voices; ++v) {
        const int lane = v * a.b;
        const float x = o[lane];
        sl = __fadd_rn(sl, __fmul_rn(x, a.wl[lane + b]));
        sr = __fadd_rn(sr, __fmul_rn(x, a.wr[lane + b]));
    }
    if (a.acc_add) {
        sl = __fadd_rn(a.acc_l[i], sl);
        sr = __fadd_rn(a.acc_r[i], sr);
    }
    a.acc_l[i] = sl;
    a.acc_r[i] = sr;
}

// Launches of tier_mix_kernel by this library since it was loaded: the
// count a timing-ablation build's skipped mix is checked by
// (tools/mega_ablate.py).
static long long mix_launches = 0;

extern "C" long long tier_mix_launch_count() { return mix_launches; }

// The mix alone (tier_keyed_launch runs it after the tier kernel when
// the key has a mix; chip_smoke.py also times it alone).
extern "C" int tier_mix_launch(const TierArgs* args, void* stream) {
    const int threads = 128;
    const size_t cells = (size_t)args->n * args->b;
    const int blocks = (int)((cells + threads - 1) / threads);
    if (blocks > 0) {
        tier_mix_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*args);
        ++mix_launches;
    }
    return (int)cudaGetLastError();
}


// ======================================================================
// The key's defines:
//   -DTIER_HAS_<FLAG>=<0|1> for the 12 flags of the feature tuple (FM,
//   CZ, CZM, ENV, FLT, SM, HOLD, QUANT, AM, AM_SELF, FINISH, DIRECTION),
//   -DTIER_CZ_MASK=<bit k: CZ mode k>, -DTIER_TS_POW2, -DTIER_EXACT,
//   -DTIER_MIX and -DTIER_FOLD_<FM|CZ|AM> (each 0 or 1); for timing
//   only, -DTIER_ABLATE_<PHASE>=1 stubs a phase (below).
// ======================================================================

// Timing ablation (SKRED_MEGA_ABLATE; tier.py tier_key adds a define per
// phase the key compiles in): each stub takes the place of one phase of
// the JAX kernel's, as kernels.py:1872-1924 stubs them, so that a phase's
// share of the kernel's time is the difference to the full build.  A
// render under a stub is invalid by design.
//   PHASE1  the walk: the lane's start phase at every sample, a live
//           lane alive at every sample (count n), no FM read
//   PHASE2  no CZ warp, no index clip, no dead mask, no cz read: the
//           index is the lane's base offset
//   LOOKUP  no table load: f = the index's bits as a float (the JAX
//           stub's (float)index * 1e-9 is an I2F and a multiply, which
//           cost the card as much as the load and its address: 107.75
//           SASS a sample step against the full 106.88, at tier 1 of
//           stress64; the bits keep the dependence at no cost)
//   GAIN    no envelope, no am read and product: base gain = amp
//   PHASE4  no S&H, quantizer, biquad or smoother: out = f (the gain is
//           kept live, f + gain * 0), the filter states as they came in
//   MIX     tier_keyed_launch does not launch tier_mix_kernel: the
//           accumulators stay as they are
// Each stub keeps a data dependence on what it replaces, as the JAX
// stubs do, and a stub whose value would be the same at every sample goes
// through opaque(), which the compilers cannot fold: otherwise nvcc would
// hoist the phases after it out of the sample loop, and the difference
// would count their time as the stub's.
#ifndef TIER_ABLATE_PHASE1
#define TIER_ABLATE_PHASE1 0
#endif
#ifndef TIER_ABLATE_PHASE2
#define TIER_ABLATE_PHASE2 0
#endif
#ifndef TIER_ABLATE_LOOKUP
#define TIER_ABLATE_LOOKUP 0
#endif
#ifndef TIER_ABLATE_GAIN
#define TIER_ABLATE_GAIN 0
#endif
#ifndef TIER_ABLATE_PHASE4
#define TIER_ABLATE_PHASE4 0
#endif
#ifndef TIER_ABLATE_MIX
#define TIER_ABLATE_MIX 0
#endif

constexpr bool FM = TIER_HAS_FM, CZ = TIER_HAS_CZ, CZM = CZ && TIER_HAS_CZM,
    ENV = TIER_HAS_ENV, FLT = TIER_HAS_FLT, SM = TIER_HAS_SM,
    HOLD = TIER_HAS_HOLD, QUANT = TIER_HAS_QUANT, AM = TIER_HAS_AM,
    AM_SELF = TIER_HAS_AM_SELF, FINISH = TIER_HAS_FINISH,
    DIRN = FM && TIER_HAS_DIRECTION;
constexpr int EXACT = TIER_EXACT;
constexpr int CZ_MASK = TIER_CZ_MASK;
constexpr bool TS_POW2 = TIER_TS_POW2, MIX = TIER_MIX;
constexpr bool FOLD_FM = FM && TIER_FOLD_FM, FOLD_CZ = CZM && TIER_FOLD_CZ,
    FOLD_AM = AM && TIER_FOLD_AM;
constexpr bool HOIST_AM = AM && !AM_SELF;
constexpr bool HOIST_GAIN = ENV || HOIST_AM;
constexpr bool A_WALK = TIER_ABLATE_PHASE1, A_WARP = TIER_ABLATE_PHASE2,
    A_LOOKUP = TIER_ABLATE_LOOKUP, A_GAIN = TIER_ABLATE_GAIN && HOIST_GAIN,
    A_FILT = TIER_ABLATE_PHASE4, A_MIX = TIER_ABLATE_MIX;
// the modulator reads a build makes: the fm read belongs to the walk, the
// cz read to the warp, the am read to the gain (or, with am self-reads,
// to phase 4)
constexpr bool FM_READ = FM && !A_WALK, CZM_READ = CZM && !A_WARP,
    AM_READ = AM && !(HOIST_AM ? A_GAIN : A_FILT);

// x at sample t of an n-sample block (t < n always holds), through a
// select the compilers cannot evaluate: a stub's per-sample value
// (a host build of this source, a test's shim, takes the plain select)
__device__ __forceinline__ float opaque(float x, int t, int n) {
#ifdef __CUDA_ARCH__
    float y;
    asm("{\n\t.reg .pred p;\n\tsetp.lt.s32 p, %2, %3;\n\t"
        "selp.f32 %0, %1, 0f00000000, p;\n\t}"
        : "=f"(y) : "f"(x), "r"(t), "r"(n));
    return y;
#else
    return t < n ? x : 0.0f;
#endif
}

__device__ __forceinline__ int opaque(int x, int t, int n) {
#ifdef __CUDA_ARCH__
    int y;
    asm("{\n\t.reg .pred p;\n\tsetp.lt.s32 p, %2, %3;\n\t"
        "selp.b32 %0, %1, 0, p;\n\t}"
        : "=r"(y) : "r"(x), "r"(t), "r"(n));
    return y;
#else
    return t < n ? x : 0;
#endif
}

// Samples a thread walks per chunk.  Live across a chunk: T table
// samples of the chunk behind, T indices of this one and T reads of
// each modulator stream.  At 8, stress64's tier-1 key fits 128
// registers (chip_smoke.py's build phase prints them): 16 warps share
// an SM, and its 57,344 lanes run in one wave.  16 and 32 take more
// registers (32 spills) and are slower there; tier 0 times the same.
constexpr int T = 8;

// T, for code that counts the chunk loop's instructions per sample step
extern "C" int tier_chunk_samples() { return T; }

// The block runs first with a phase wrap and a CZ divide that have no
// slow path (FAST): exact wherever their operands are in range, and a
// lane whose operand is not sets `slow` and renders the block again with
// the exact helpers (wrap_fmod with its fmodf call, kdiv_inv), from the
// same inputs, writing every output again.  A branch on the walk would
// end the basic block in which the compiler interleaves the walk of one
// chunk with the S&H / filter / smoother chain of the chunk before.
template <bool FAST>
__device__ __forceinline__ float div_inv(float a, float y1, float b,
                                         bool& slow) {
    if (!FAST) return kdiv_inv(a, y1, b);
    const float q0 = __fmul_rn(a, y1);          // kdiv_inv while finite
    const float q = kfma(kfma(-b, q0, a), y1, q0);
    slow = slow || !isfinite(q);
    return q;
}

// One pass over the block for lane m; returns whether a FAST helper met
// an operand outside its range.
template <bool FAST>
__device__ __forceinline__ bool run_lane(const TierArgs& a, int m) {
    const int M = a.m;
    const int n = a.n;
    bool slow = false;
    const auto wrap1 = [&](float x, float L) {
        return wrap<FAST>(x, L, slow);
    };

    // ---- per-lane parameters, held in registers for the whole block ----
    const float lo = a.lo[m], hi = a.hi[m], L = a.L[m];
    const bool adv = a.adv[m] != 0, act = a.act[m] != 0;
    const bool osn = FINISH && a.osn[m] != 0;
    const bool one_shot = FINISH && a.one_shot[m] != 0;
    const int clip = a.clip_i[m];
    const float amp = a.amp[m];
    const float hi_os = hi - 1e-6f;

    bool use_fm = false, dirneg = false;
    float mis = 0.0f, pinc = 0.0f, fmdep = 0.0f, inc_const = 0.0f;
    if (FM) {
        use_fm = a.use_fm[m] != 0;
        mis = a.mis[m]; pinc = a.pinc[m]; fmdep = a.fm_depth[m];
        dirneg = DIRN && a.dirneg[m] != 0;
    } else {
        inc_const = a.inc[m];
    }

    int mode = 0;
    float dist = 0.0f, tsz = 0.0f, inv_ts = 0.0f, czdep = 0.0f;
    bool cm_ge = false;
    CzCoeffs coeffs;
    coeffs.is_pl = coeffs.is_4 = coeffs.is_pw = 0;
    if (CZ) {
        mode = a.cz_mode[m]; dist = a.cz_dist[m]; tsz = a.tsize[m];
        if (EXACT) inv_ts = kdiv(1.0f, tsz);
        if (CZM) {
            cm_ge = a.cm_ge0[m] != 0;
            czdep = a.cz_depth[m];
        } else {
            // d is constant across the block: hoist scales and curve
            CzScales s = cz_scales(dist + a.dm[m], EXACT, CZ_MASK);
            coeffs = cz_coeffs(mode, s, CZ_MASK);
        }
    }

    bool use_env = false, env_act = false;
    int env_start = 0, env_relat = 0;
    float att = 0.0f, dec = 0.0f, sus = 0.0f, rel = 0.0f, vel = 0.0f,
          att_dec = 0.0f;
    if (ENV) {
        use_env = a.use_env[m] != 0; env_act = a.env_active[m] != 0;
        env_start = a.env_start[m]; env_relat = a.env_rel_at[m];
        att = a.att[m]; dec = a.dec[m]; sus = a.sus[m]; rel = a.rel[m];
        vel = a.vel[m];
        att_dec = att + dec;
    }
    bool am_ge = false;
    float amdep_a = 0.0f;
    if (AM) { am_ge = a.am_ge0[m] != 0; amdep_a = a.am_depth_a[m]; }

    Stream<T, FOLD_FM> s_fm;
    Stream<T, FOLD_CZ> s_cz;
    Stream<T, FOLD_AM> s_am;
    if (FOLD_FM) s_fm.fold(a.bank, a.prev, a.bank_w, a.bank_stride, a.b,
                       use_fm, a.fm_src, a.fm_del, m);
    else s_fm.raw(a.inc, m, M, FM);
    if (FOLD_CZ) s_cz.fold(a.bank, a.prev, a.bank_w, a.bank_stride, a.b,
                       cm_ge, a.cz_src, a.cz_del, m);
    else s_cz.raw(a.dm, m, M, CZM && cm_ge);
    if (FOLD_AM) s_am.fold(a.bank, a.prev, a.bank_w, a.bank_stride, a.b,
                       am_ge, a.am_src, a.am_del, m);
    else s_am.raw(a.amod, m, M, AM && am_ge);

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

    float ph_c = a.phase_0[m];
    int fin_c = FINISH ? a.finished_0[m] : 0;
    int cnt = 0;
    float o_last = 0.0f;
    float* const out = a.out + m;
    const size_t ostride = (size_t)a.out_stride;
    const int base = a.base_off[m];

    // A chunk's phases 0-3 (FULL: all T samples lie inside the block):
    // the FM increment, the serial phase walk, the CZ warp and index clip
    // per sample, then the chunk's T table loads back to back into fv;
    // alive[j] whether sample j is live.
    float fv[T];
    bool alive[T];
    const auto walk = [&](int t0, auto full) {
        constexpr bool FULL = decltype(full)::value;
        const int rem = n - t0;
        int idxv[T];
#pragma unroll
        for (int j = 0; j < T; ++j) {
            if (!FULL && j >= rem) break;
            float ph2;
            bool alive_t;
            if (A_WALK) {
                // stub: a frozen phase (kernels.py:1878-1882)
                ph2 = opaque(ph_c, t0 + j, n);
                alive_t = act;
            } else {
                float inc_t;
                if (FM) {
                    const float g3 = s_fm.at(j) * fmdep;
                    inc_t = use_fm ? kfma(mis, g3, pinc) : pinc;
                    if (dirneg) inc_t = -inc_t;
                } else {
                    inc_t = inc_const;
                }
                const float ph = ph_c + inc_t;
                const bool bad = !isfinite(ph);
                const bool over = ph >= hi;
                const bool under = ph < lo;
                const float r = wrap1(ph - lo, L);
                const float wrap_over = lo + r;
                const float wrap_under = hi + r;
                if (FINISH)
                    ph2 = over ? (osn ? hi_os : wrap_over)
                               : (under ? (osn ? lo : wrap_under) : ph);
                else
                    ph2 = over ? wrap_over : (under ? wrap_under : ph);
                if (bad) ph2 = 0.0f;
                if (FINISH) {
                    const bool fin_new = (bad && one_shot)
                                         || ((over || under) && osn);
                    const bool fin_b = fin_c != 0;
                    const bool step_on = adv && !fin_b;
                    alive_t = act && !fin_b;
                    if (step_on) ph_c = ph2;
                    if (step_on && fin_new) fin_c = 1;
                    cnt += alive_t ? 1 : 0;
                } else {
                    alive_t = act;
                    if (adv) ph_c = ph2;
                }
            }
            if (A_WARP) {
                // stub: the lane's base offset (kernels.py:1887-1888)
                idxv[j] = opaque(base, t0 + j, n);
                alive[j] = alive_t;
                continue;
            }
            // ---- phase 2: CZ warp + index clip + dead masking ----
            float idx_f = ph2;
            if (CZ) {
                float phase;
                if (EXACT && TS_POW2) phase = ph2 * inv_ts;
                else if (EXACT) phase = div_inv<FAST>(ph2, inv_ts, tsz, slow);
                else phase = __fdiv_rn(ph2, tsz);
                float warped;
                if (CZM) {
                    const float dm3 = cm_ge ? s_cz.at(j) * czdep : 1.0f;
                    CzScales s = cz_scales(dist + dm3, EXACT, CZ_MASK);
                    warped = cz_warp_k(mode, phase, s, tsz, CZ_MASK, wrap1);
                } else {
                    warped = cz_warp_fast(coeffs, phase, tsz, wrap1);
                }
                if (mode != 0) idx_f = warped;
            }
            int idx = (int)idx_f;
            idx = idx < 0 ? 0 : idx;
            idx = idx > clip ? clip : idx;
            if (!alive_t) idx = 0;
            idxv[j] = base + idx;
            alive[j] = alive_t;
        }
        if (FM_READ) s_fm.next(t0, n);
        if (CZM_READ) s_cz.next(t0, n);
        // ---- phase 3: the table loads ----
#pragma unroll
        for (int j = 0; j < T; ++j) {
            if (!FULL && j >= rem) break;
            // stub: no table load (kernels.py:1892-1893)
            fv[j] = A_LOOKUP ? __int_as_float(idxv[j])
                             : __ldg(a.table + idxv[j]);
        }
    };

    // A chunk's phases 3.5 and 4 on its table samples f and live bits:
    // gain, S&H, quantizer, biquad, smoother, the stores.
    const auto finish = [&](int t0, const float (&f)[T],
                            const bool (&live)[T], auto full) {
        constexpr bool FULL = decltype(full)::value;
        const int rem = n - t0;
#pragma unroll
        for (int j = 0; j < T; ++j) {
            if (!FULL && j >= rem) break;
            const bool alive_t = live[j];
            float amod_t = 1.0f;
            if (AM_READ) amod_t = am_ge ? s_am.at(j) * amdep_a : 1.0f;
            float base_gain = amp;
            // stub: no envelope or am precompute (kernels.py:1672)
            if (HOIST_GAIN && !A_GAIN) {
                float g = amp;
                if (ENV) {
                    const int tpos = a.cbase + t0 + j;
                    const float tf = (float)(tpos - env_start);
                    const float trf = (float)(tpos - env_relat);
                    float v;
                    if (tf < att) v = __fdiv_rn(tf, att);
                    else if (tf < att_dec)
                        v = kfma(-__fdiv_rn(tf - att, dec), 1.0f - sus, 1.0f);
                    else if (env_relat == 0) v = sus;
                    else if (trf < rel) v = sus * (1.0f - __fdiv_rn(trf, rel));
                    else v = 0.0f;
                    if (!env_act) v = 0.0f;
                    const float env_t = use_env ? v * vel : 1.0f;
                    g = amp * env_t;
                }
                if (HOIST_AM) g = g * amod_t;
                base_gain = g;
            }
            if (A_FILT) {
                // stub: raw f out, the states as they came in
                // (kernels.py:1897-1899)
                const float o = f[j] + base_gain * 0.0f;
                out[(size_t)(t0 + j) * ostride] = o;
                if (MIX) o_last = o;
                continue;
            }
            const float f_t = alive_t ? f[j] : 0.0f;
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
            float final_t = base_gain;
            if (AM_SELF) {
                if (am_self) amod_t = s3 * am_depth;
                final_t = base_gain * amod_t;
            }
            float final2 = final_t;
            if (SM) {
                const float sg2 = kfma(smoothing, final_t - sg, sg);
                if (use_sm) final2 = sg2;
                if (alive_t && use_sm) sg = sg2;
            }
            const float o = alive_t ? s3 * final2 : 0.0f;
            out[(size_t)(t0 + j) * ostride] = o;
            if (MIX) o_last = o;
        }
        if (AM_READ) s_am.next(t0, n);
    };

    using Full = std::true_type;
    using Part = std::false_type;
    if (FM_READ) s_fm.fetch(0, n);
    if (CZM_READ) s_cz.fetch(0, n);
    if (AM_READ) s_am.fetch(0, n);
    if (T <= n) walk(0, Full());
    else walk(0, Part());
    // Software-pipelined: the walk of the next chunk, then phases 3.5-4
    // of this one, whose table loads were issued one walk earlier.  The
    // two are independent chains in one basic block.
    int t0 = 0;
    float fc[T];
    bool live[T];
    for (; t0 + 2 * T <= n; t0 += T) {
#pragma unroll
        for (int j = 0; j < T; ++j) { fc[j] = fv[j]; live[j] = alive[j]; }
        walk(t0 + T, Full());
        finish(t0, fc, live, Full());
    }
    if (t0 < n) {
#pragma unroll
        for (int j = 0; j < T; ++j) { fc[j] = fv[j]; live[j] = alive[j]; }
        if (t0 + T < n) walk(t0 + T, Part());
        if (t0 + T <= n) finish(t0, fc, live, Full());
        else finish(t0, fc, live, Part());
        t0 += T;
        if (t0 < n) finish(t0, fv, alive, Part());
    }
    if (MIX) a.out_last[m] = o_last;

    a.phase_e[m] = ph_c;
    a.cnt_e[m] = FINISH && !A_WALK ? cnt : (act ? n : 0);
    if (FINISH) a.finished_e[m] = fin_c;
    if (FLT) {
        a.x1_e[m] = x1; a.x2_e[m] = x2; a.y1_e[m] = y1; a.y2_e[m] = y2;
    }
    if (SM) a.smoother_e[m] = sg;
    if (HOLD) { a.hold_count_e[m] = hc; a.hold_val_e[m] = hv; }
    return slow;
}

__global__ void __launch_bounds__(128) tier_keyed_kernel(const TierArgs a) {
    const int m = blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= a.m) return;
    if (run_lane<true>(a, m)) run_lane<false>(a, m);
}

// One warp a block: a narrow tier (8,192 lanes: 256 blocks) spreads
// over every SM, and a wide one balances to a warp.  On an H100, 32-,
// 64- and 128-thread blocks time the same at both of stress64's tiers:
// a tier-0 warp runs alone on its scheduler either way, and tier 1's
// 1,792 warps fit the card in one wave at 128 registers.
constexpr int TIER_THREADS = 32;

// -1: the arguments are not this build's key (features, mode, mix, fold)
extern "C" int tier_keyed_launch(const TierArgs* a, void* stream) {
    const int want[] = {TIER_HAS_FM, TIER_HAS_CZ, TIER_HAS_CZM, TIER_HAS_ENV,
                        TIER_HAS_FLT, TIER_HAS_SM, TIER_HAS_HOLD,
                        TIER_HAS_QUANT, TIER_HAS_AM, TIER_HAS_AM_SELF,
                        TIER_HAS_FINISH, TIER_HAS_DIRECTION, TIER_TS_POW2,
                        TIER_EXACT, TIER_MIX, FOLD_FM, FOLD_CZ, FOLD_AM};
    const int got[] = {a->has_fm, a->has_cz, a->has_czm, a->has_env,
                       a->has_flt, a->has_sm, a->has_hold, a->has_quant,
                       a->has_am, a->has_am_self, a->has_finish,
                       a->has_direction, a->ts_pow2, a->exact, a->has_mix,
                       a->fold_fm, a->fold_cz, a->fold_am};
    bool same = !CZ || a->cz_mask == CZ_MASK;
    for (int i = 0; i < (int)(sizeof(want) / sizeof(want[0])); ++i)
        same = same && (got[i] != 0) == (want[i] != 0);
    if (!same) return -1;
    const int blocks = (a->m + TIER_THREADS - 1) / TIER_THREADS;
    if (blocks > 0)
        tier_keyed_kernel<<<blocks, TIER_THREADS, 0,
                            (cudaStream_t)stream>>>(*a);
    const int rc = (int)cudaGetLastError();
    if (rc != 0 || !MIX || A_MIX) return rc;
    return tier_mix_launch(a, stream);
}
