// The tier kernel for Hopper (sm_90a): one block of one tier's per-voice
// DSP chain, one thread per lane.
//
// Replaces skred_tpu/engine/kernels.py:tier_pallas (body
// _make_tier_kernel), without its in-kernel mix (phase 5) and
// modulator-bank fold; the caller does those two steps in torch.
//
// Bound on this card: per lane-sample the kernel must read the raw
// modulator-read streams (inc / dm / amod, 4 B each where the tier has
// them) and write the output sample (4 B): at least 8 B per lane-sample
// for an FM tier, over 3.35 TB/s.  Its real limit is the serial
// dependency chain of each sample (phase walk -> warp -> lookup ->
// biquad -> smoother, with fmodf and exact fmas on it), which is why the
// TPU kernel's phase split over (8,128) planes is not carried over: each
// thread keeps its lane's whole state in registers and walks the block's
// N samples once, running phases 0-4 per sample.  Neighbouring threads
// own neighbouring lanes, so every [N, M] read and write coalesces.
//
// Tables are read from the flat buffer in global memory through the
// read-only cache (__ldg): a PCM table can be larger than a block's
// shared memory, and a lane's lookups stay within one table.
//
// Numerics are the JAX kernel's, bit for bit: __fmaf_rn exactly where it
// calls _kfma (the reference binary's gcc-contracted sites), the same
// Newton/Markstein divide sequences where it calls _kdiv / _kdiv_inv
// (correctly rounded), IEEE division elsewhere.  Build with -fmad=false
// (no other contraction) and without --use_fast_math; denormals are kept.
//
// Features: the JAX kernel's 14-field static tuple arrives as runtime
// ints in TierArgs (uniform across the grid, so the branches never
// diverge within a warp); cz_modes is a bit mask.

#include <cuda_runtime.h>
#include <math.h>

#include "numerics.cuh"

struct TierArgs {
    int n, m, cbase, exact;
    int has_fm, has_cz, has_czm, has_env, has_flt, has_sm, has_hold,
        has_quant, has_am, has_am_self, has_finish, has_direction, cz_mask,
        ts_pow2;
    const float* table;
    const float* inc;    // [n, m] raw fm-read stream, or [m] increment
    const float* dm;     // [n, m] raw cz-read stream, or [m] offset
    const float* amod;   // [n, m] raw am-read stream
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
};

__global__ void __launch_bounds__(128) tier_kernel(const TierArgs a) {
    const int m = blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= a.m) return;
    const int M = a.m;
    const int n = a.n;
    const int exact = a.exact;

    // ---- per-lane parameters, held in registers for the whole block ----
    const float lo = a.lo[m], hi = a.hi[m], L = a.L[m];
    const bool adv = a.adv[m] != 0, act = a.act[m] != 0;
    const bool osn = a.has_finish && a.osn[m] != 0;
    const bool one_shot = a.has_finish && a.one_shot[m] != 0;
    const int base = a.base_off[m], clip = a.clip_i[m];
    const float amp = a.amp[m];
    const float hi_os = hi - 1e-6f;

    bool use_fm = false, dirneg = false;
    float mis = 0.0f, pinc = 0.0f, fmdep = 0.0f, inc_const = 0.0f;
    if (a.has_fm) {
        use_fm = a.use_fm[m] != 0;
        mis = a.mis[m]; pinc = a.pinc[m]; fmdep = a.fm_depth[m];
        dirneg = a.has_direction && a.dirneg[m] != 0;
    } else {
        inc_const = a.inc[m];
    }

    int mode = 0;
    float dist = 0.0f, tsz = 0.0f, inv_ts = 0.0f, czdep = 0.0f;
    bool cm_ge = false;
    CzCoeffs coeffs;
    coeffs.is_pl = coeffs.is_4 = coeffs.is_pw = 0;
    if (a.has_cz) {
        mode = a.cz_mode[m]; dist = a.cz_dist[m]; tsz = a.tsize[m];
        if (exact) inv_ts = kdiv(1.0f, tsz);
        if (a.has_czm) {
            cm_ge = a.cm_ge0[m] != 0;
            czdep = a.cz_depth[m];
        } else {
            // d is constant across the block: hoist scales and curve
            CzScales s = cz_scales(dist + a.dm[m], exact, a.cz_mask);
            coeffs = cz_coeffs(mode, s, a.cz_mask);
        }
    }

    bool use_env = false, env_act = false;
    int env_start = 0, env_relat = 0;
    float att = 0.0f, dec = 0.0f, sus = 0.0f, rel = 0.0f, vel = 0.0f,
          att_dec = 0.0f;
    if (a.has_env) {
        use_env = a.use_env[m] != 0; env_act = a.env_active[m] != 0;
        env_start = a.env_start[m]; env_relat = a.env_rel_at[m];
        att = a.att[m]; dec = a.dec[m]; sus = a.sus[m]; rel = a.rel[m];
        vel = a.vel[m];
        att_dec = att + dec;
    }
    bool am_ge = false;
    float amdep_a = 0.0f;
    if (a.has_am) { am_ge = a.am_ge0[m] != 0; amdep_a = a.am_depth_a[m]; }
    const bool hoist_am = a.has_am && !a.has_am_self;
    const bool hoist_gain = a.has_env || hoist_am;

    float b0 = 0, b1 = 0, b2 = 0, na1 = 0, na2 = 0;
    bool use_flt = false;
    float x1 = 0, x2 = 0, y1 = 0, y2 = 0;
    if (a.has_flt) {
        b0 = a.b0[m]; b1 = a.b1[m]; b2 = a.b2[m];
        na1 = a.na1[m]; na2 = a.na2[m]; use_flt = a.use_flt[m] != 0;
        x1 = a.x1_0[m]; x2 = a.x2_0[m]; y1 = a.y1_0[m]; y2 = a.y2_0[m];
    }
    bool use_sm = false;
    float smoothing = 0, sg = 0;
    if (a.has_sm) {
        use_sm = a.use_sm[m] != 0; smoothing = a.smoothing[m];
        sg = a.smoother_0[m];
    }
    bool am_self = false;
    float am_depth = 0;
    if (a.has_am_self) { am_self = a.am_self[m] != 0; am_depth = a.am_depth[m]; }
    bool hold_on = false;
    int hmax = 1, hc = 0;
    float hv = 0;
    if (a.has_hold) {
        hold_on = a.hold_on[m] != 0; hmax = a.hold_max[m];
        hc = a.hold_count_0[m]; hv = a.hold_val_0[m];
    }
    bool quant_on = false;
    float levels = 0, inv_lev = 0;
    if (a.has_quant) {
        quant_on = a.quant_on[m] != 0; levels = a.levels[m];
        inv_lev = a.inv_levels[m];
    }

    float ph_c = a.phase_0[m];
    int fin_c = a.has_finish ? a.finished_0[m] : 0;
    int cnt = 0;

    for (int t = 0; t < n; ++t) {
        const size_t tm = (size_t)t * M + m;
        // ---- phase 0: FM increment ----
        float inc_t;
        if (a.has_fm) {
            float g3 = a.inc[tm] * fmdep;
            inc_t = use_fm ? xfma(mis, g3, pinc, exact) : pinc;
            if (dirneg) inc_t = -inc_t;
        } else {
            inc_t = inc_const;
        }
        // ---- phase 1: phase walk (osc_next), one step ----
        float ph = ph_c + inc_t;
        bool bad = !isfinite(ph);
        bool over = ph >= hi;
        bool under = ph < lo;
        float r = fmodf(ph - lo, L);
        float wrap_over = lo + r;
        float wrap_under = hi + r;
        float ph2;
        if (a.has_finish)
            ph2 = over ? (osn ? hi_os : wrap_over)
                       : (under ? (osn ? lo : wrap_under) : ph);
        else
            ph2 = over ? wrap_over : (under ? wrap_under : ph);
        if (bad) ph2 = 0.0f;
        bool alive_t;
        if (a.has_finish) {
            bool fin_new = (bad && one_shot) || ((over || under) && osn);
            bool fin_b = fin_c != 0;
            bool step_on = adv && !fin_b;
            alive_t = act && !fin_b;     // dead is monotone in a block:
            if (step_on) ph_c = ph2;     // this is t < cnt_e
            if (step_on && fin_new) fin_c = 1;
            cnt += alive_t ? 1 : 0;
        } else {
            alive_t = act;
            if (adv) ph_c = ph2;
        }
        // ---- phase 2: CZ warp + index clip + dead masking ----
        float idx_f = ph2;
        if (a.has_cz) {
            float phase;
            if (exact && a.ts_pow2) phase = ph2 * inv_ts;
            else if (exact) phase = kdiv_inv(ph2, inv_ts, tsz);
            else phase = __fdiv_rn(ph2, tsz);
            float warped;
            if (a.has_czm) {
                float dm3 = cm_ge ? a.dm[tm] * czdep : 1.0f;
                CzScales s = cz_scales(dist + dm3, exact, a.cz_mask);
                warped = cz_warp_k(mode, phase, s, tsz, exact, a.cz_mask);
            } else {
                warped = cz_warp_fast(coeffs, phase, tsz, exact);
            }
            if (mode != 0) idx_f = warped;
        }
        int idx = (int)idx_f;
        idx = idx < 0 ? 0 : idx;
        idx = idx > clip ? clip : idx;
        if (!alive_t) idx = 0;
        // ---- phase 3: table lookup ----
        float f = __ldg(a.table + (base + idx));
        // ---- phase 3.5: gain amp·env(·amod) ----
        float base_gain = amp;
        if (hoist_gain) {
            float g = amp;
            if (a.has_env) {
                int tpos = a.cbase + t;
                float tf = (float)(tpos - env_start);
                float trf = (float)(tpos - env_relat);
                float v;
                if (tf < att) v = __fdiv_rn(tf, att);
                else if (tf < att_dec)
                    v = kfma(-__fdiv_rn(tf - att, dec), 1.0f - sus, 1.0f);
                else if (env_relat == 0) v = sus;
                else if (trf < rel) v = sus * (1.0f - __fdiv_rn(trf, rel));
                else v = 0.0f;
                if (!env_act) v = 0.0f;
                float env_t = use_env ? v * vel : 1.0f;
                g = amp * env_t;
            }
            if (hoist_am) g = g * (am_ge ? a.amod[tm] * amdep_a : 1.0f);
            base_gain = g;
        }
        // ---- phase 4: S&H + quantize + biquad + smoother ----
        float f_t = alive_t ? f : 0.0f;
        float s1 = f_t;
        if (a.has_hold) {
            float hv2 = (hold_on && hc == 0) ? f_t : hv;
            s1 = hold_on ? hv2 : f_t;
            int hcn = hc + 1;
            if (hcn >= hmax) hcn = 0;
            if (alive_t) hv = hv2;
            if (alive_t && hold_on) hc = hcn;
        }
        float x_t = s1;
        if (a.has_quant) {
            float iv = (float)(int)kfma(s1, levels, 0.5f);
            if (quant_on) x_t = iv * inv_lev;
        }
        float s3 = x_t;
        if (a.has_flt) {
            float fv = b1 * x1;
            fv = xfma(b0, x_t, fv, exact);
            fv = xfma(b2, x2, fv, exact);
            fv = xfma(na1, y1, fv, exact);
            fv = xfma(na2, y2, fv, exact);
            if (use_flt) s3 = fv;
            if (alive_t && use_flt) {
                x2 = x1; x1 = x_t; y2 = y1; y1 = fv;
            }
        }
        float final_t = base_gain;
        if (a.has_am_self) {
            float amod_t = 1.0f;
            if (a.has_am) amod_t = am_ge ? a.amod[tm] * amdep_a : 1.0f;
            if (am_self) amod_t = s3 * am_depth;
            final_t = base_gain * amod_t;
        }
        float final2 = final_t;
        if (a.has_sm) {
            float sg2 = xfma(smoothing, final_t - sg, sg, exact);
            if (use_sm) final2 = sg2;
            if (alive_t && use_sm) sg = sg2;
        }
        a.out[tm] = alive_t ? s3 * final2 : 0.0f;
    }

    a.phase_e[m] = ph_c;
    a.cnt_e[m] = a.has_finish ? cnt : (act ? n : 0);
    if (a.has_finish) a.finished_e[m] = fin_c;
    if (a.has_flt) {
        a.x1_e[m] = x1; a.x2_e[m] = x2; a.y1_e[m] = y1; a.y2_e[m] = y2;
    }
    if (a.has_sm) a.smoother_e[m] = sg;
    if (a.has_hold) { a.hold_count_e[m] = hc; a.hold_val_e[m] = hv; }
}

extern "C" int tier_launch(const TierArgs* args, void* stream) {
    const int threads = 128;
    const int blocks = (args->m + threads - 1) / threads;
    if (blocks > 0)
        tier_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
