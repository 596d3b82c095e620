// The cyclic kernel for Hopper (sm_90a): one block of the reference's
// serial per-frame voice loop (synth.c:526-612) for scripts whose
// modulation graph has a cycle, one thread per batch row.
//
// Replaces skred_tpu/engine/cyclic.py:cyclic_block_pallas (body
// _make_cyclic_kernel).
//
// Bound on this card: the kernel must read the per-voice vectors and
// states once and write two [n, rows] output streams, a few megabytes at
// 1024 rows, microseconds at 3.35 TB/s.  Its real limit is latency: each
// thread walks n frames, and inside a frame the k voices in order, every
// voice a dependent chain (modulator read -> fmodf -> warp -> table load
// -> biquad -> smoother -> pan) that the next voice may read.  Nothing of
// the TPU kernel's memory plan is carried over:
//   * tables stay in the flat buffer in global memory and are read
//     through the read-only cache (__ldg) at table_off[v] + idx; there is
//     no per-voice window, so a table larger than shared memory (a
//     60,406-sample PCM loop is 236 KB) needs no special case;
//   * a modulator read is one dynamically indexed shared-memory load
//     (cur/prev sample of voice m), not a k-deep select chain;
//   * k and the feature set are run-time arguments (uniform across the
//     grid, so branches never diverge inside a warp): nothing is rebuilt
//     per script.  The per-voice states, which cannot live in registers
//     for k up to 64, sit in shared memory as [field][k][thread] columns
//     (bank-conflict free); the per-voice parameters, [k, rows] with
//     the rows contiguous, are re-read each frame from global memory
//     through L1, coalesced.  The states come and go through strides, so
//     the renderer's [rows, k] carry needs no transpose;
//   * blocks are one warp (32 rows), so a 1024-row batch spreads over 32
//     SMs instead of 8.
//
// Numerics are the JAX kernel's, bit for bit: __fmaf_rn where it calls
// _kfma whatever the mode (quantizer, envelope decay) and, in exact mode,
// at its fma sites (FM increment, biquad, smoother, pan, volume
// smoother); the hoisted-reciprocal Markstein divide for the CZ
// normalisation; IEEE division in the envelope.  Build with -fmad=false
// and without --use_fast_math; denormals are kept.

#include <cuda_runtime.h>
#include <math.h>

#include "numerics.cuh"

struct CyclicArgs {
    int n, rows, k, cbase, exact;
    int has_fm, has_cz, has_czm, has_am, has_am_self, has_pm, has_pm_self,
        has_env, has_flt, has_sm, has_hold, has_quant, has_noise, has_finish,
        has_direction, has_disc;
    int cz_mask, st_sv, st_sb;
    const float* table; const int* table_off; const float* noise;
    const float* vf;
    const float* amp; const float* pinc; const float* lo; const float* hi;
    const float* L; const int* clip_i;
    const int* fm_osc; const int* fm_del; const int* use_fm;
    const float* mis; const float* fm_dep;
    const int* dirneg;
    const int* cz_mode; const float* cz_dist; const float* tsize;
    const float* inv_ts;
    const int* cm_osc; const int* cm_del; const int* cm_ge;
    const float* cm_dep;
    const float* dm_row;
    const int* is_noise;
    const int* one_shot; const int* osn;
    const int* hold_on; const int* hmax;
    const int* quant_on; const float* levels; const float* inv_lev;
    const float* b0; const float* b1; const float* b2; const float* na1;
    const float* na2; const int* use_flt;
    const int* use_env; const int* env_act; const int* env_start;
    const int* env_relat;
    const float* att; const float* dec; const float* sus; const float* rel;
    const float* vel;
    const int* am_osc; const int* am_del; const float* am_dep;
    const int* pm_osc; const int* pm_del; const float* pm_dep;
    const int* pm_self;
    const int* disconn;
    const int* use_sm; const float* smoothing;
    const float* phase_0; const float* sample_0; const int* finished_0;
    const int* hold_count_0; const float* hold_val_0;
    const float* x1_0; const float* x2_0; const float* y1_0;
    const float* y2_0; const float* smoother_0;
    const float* pan_l_0; const float* pan_r_0; const float* vol_gain_0;
    float* phase_e; float* sample_e; int* finished_e;
    int* hold_count_e; float* hold_val_e;
    float* x1_e; float* x2_e; float* y1_e; float* y2_e; float* smoother_e;
    float* pan_l_e; float* pan_r_e; float* vol_gain_e;
    float* out_l; float* out_r;
};

#define CYC_THREADS 32

// [k][CYC_THREADS] shared-memory columns a block needs for these features
__host__ __device__ inline int cyclic_fields(const CyclicArgs& a) {
    int f = 5;                               // two sample buffers, phase, pan
    if (a.has_finish) f += 1;
    if (a.has_hold) f += 2;
    if (a.has_flt) f += 4;
    if (a.has_sm) f += 1;
    if (a.has_cz && !a.has_czm) f += 7;      // the hoisted warp scales
    return f;
}

// the read of voice m's sample under the serial-frame rule: voices
// below `done` already hold this frame's sample in cur; a delayed edge,
// and a voice not rendered yet, read the previous frame's
__device__ __forceinline__ float read_mod(const float* cur, const float* prev,
                                          int m, int delayed, int done,
                                          int k) {
    if (m < 0 || m >= k) return 0.0f;
    const int o = m * CYC_THREADS;
    return (delayed != 0 || m >= done) ? prev[o] : cur[o];
}

__global__ void __launch_bounds__(CYC_THREADS)
cyclic_kernel(const CyclicArgs a) {
    extern __shared__ float smem[];
    const int tid = threadIdx.x;
    const int b = blockIdx.x * CYC_THREADS + tid;
    if (b >= a.rows) return;
    const int k = a.k, n = a.n, exact = a.exact, B = a.rows;
    const int KT = k * CYC_THREADS;

    // ---- carve the per-voice columns; each thread owns column tid ----
    float* p = smem + tid;
    float* buf0 = p; p += KT;
    float* buf1 = p; p += KT;
    float* s_ph = p; p += KT;
    float* s_pnl = p; p += KT;
    float* s_pnr = p; p += KT;
    int* s_fin = nullptr;
    if (a.has_finish) { s_fin = (int*)p; p += KT; }
    int* s_hc = nullptr; float* s_hv = nullptr;
    if (a.has_hold) { s_hc = (int*)p; p += KT; s_hv = p; p += KT; }
    float *s_x1 = nullptr, *s_x2 = nullptr, *s_y1 = nullptr, *s_y2 = nullptr;
    if (a.has_flt) {
        s_x1 = p; p += KT; s_x2 = p; p += KT;
        s_y1 = p; p += KT; s_y2 = p; p += KT;
    }
    float* s_sg = nullptr;
    if (a.has_sm) { s_sg = p; p += KT; }
    float* s_cz = nullptr;                    // 7 scale columns per voice
    const bool cz_const = a.has_cz && !a.has_czm;
    if (cz_const) { s_cz = p; p += 7 * KT; }

    // ---- states in; hoisted warp scales ----
    for (int v = 0; v < k; ++v) {
        const int so = v * a.st_sv + b * a.st_sb;
        const int c = v * CYC_THREADS;
        buf0[c] = a.sample_0[so];
        s_ph[c] = a.phase_0[so];
        s_pnl[c] = a.pan_l_0[so];
        s_pnr[c] = a.pan_r_0[so];
        if (a.has_finish) s_fin[c] = a.finished_0[so];
        if (a.has_hold) { s_hc[c] = a.hold_count_0[so];
                          s_hv[c] = a.hold_val_0[so]; }
        if (a.has_flt) { s_x1[c] = a.x1_0[so]; s_x2[c] = a.x2_0[so];
                         s_y1[c] = a.y1_0[so]; s_y2[c] = a.y2_0[so]; }
        if (a.has_sm) s_sg[c] = a.smoother_0[so];
        if (cz_const) {
            const int vo = v * B + b;
            CzScales s = cz_scales(a.cz_dist[vo] + a.dm_row[vo], exact,
                                   a.cz_mask);
            float* q = s_cz + 7 * c;
            q[0] = s.d; q[CYC_THREADS] = s.s1a; q[2 * CYC_THREADS] = s.s1b;
            q[3 * CYC_THREADS] = s.sc2; q[4 * CYC_THREADS] = s.sc5b;
            q[5 * CYC_THREADS] = s.p6; q[6 * CYC_THREADS] = s.p7;
        }
    }
    const float vf = a.vf[b];
    float vg = a.vol_gain_0[b];
    float* prev = buf0;
    float* cur = buf1;

    for (int t = 0; t < n; ++t) {
        const float whiteish = a.has_noise ? __ldg(a.noise + t) : 0.0f;
        float mix_l = 0.0f, mix_r = 0.0f;
        for (int v = 0; v < k; ++v) {
            const int vo = v * B + b;
            const int c = v * CYC_THREADS;
            const float amp = __ldg(a.amp + vo);
            const bool fin_b = a.has_finish && s_fin[c] != 0;
            const bool active = !fin_b && amp != 0.0f;
            // ---- oscillator (osc_next, synth.c:217-275) ----
            const float pinc = __ldg(a.pinc + vo);
            float inc = pinc;
            if (a.has_fm) {
                float g = read_mod(cur, prev, __ldg(a.fm_osc + vo),
                                   __ldg(a.fm_del + vo), v, k)
                          * __ldg(a.fm_dep + vo);
                if (__ldg(a.use_fm + vo) != 0)
                    inc = xfma(__ldg(a.mis + vo), g, pinc, exact);
            }
            if (a.has_direction && __ldg(a.dirneg + vo) != 0) inc = -inc;
            const float lo = __ldg(a.lo + vo), hi = __ldg(a.hi + vo);
            const float ph_c = s_ph[c];
            const float phv = ph_c + inc;
            const bool bad = !isfinite(phv);
            const bool over = phv >= hi;
            const bool under = phv < lo;
            const float r = fmodf(phv - lo, __ldg(a.L + vo));
            const float wrap_over = lo + r;
            const float wrap_under = hi + r;
            bool osn_b = false;
            float ph2;
            if (a.has_finish) {
                osn_b = __ldg(a.osn + vo) != 0;
                ph2 = over ? (osn_b ? hi - 1e-6f : wrap_over)
                           : (under ? (osn_b ? lo : wrap_under) : phv);
            } else {
                ph2 = over ? wrap_over : (under ? wrap_under : phv);
            }
            if (bad) ph2 = 0.0f;
            // ---- CZ warp, index, lookup ----
            float idx_f = ph2;
            if (a.has_cz) {
                const int mode = __ldg(a.cz_mode + vo);
                const float tsz = __ldg(a.tsize + vo);
                CzScales s;
                if (a.has_czm) {
                    float rdm = read_mod(cur, prev, __ldg(a.cm_osc + vo),
                                         __ldg(a.cm_del + vo), v, k);
                    float dm = __ldg(a.cm_ge + vo) != 0
                        ? rdm * __ldg(a.cm_dep + vo) : 1.0f;
                    s = cz_scales(__ldg(a.cz_dist + vo) + dm, exact,
                                  a.cz_mask);
                } else {
                    const float* q = s_cz + 7 * c;
                    s.d = q[0]; s.s1a = q[CYC_THREADS];
                    s.s1b = q[2 * CYC_THREADS]; s.sc2 = q[3 * CYC_THREADS];
                    s.sc5b = q[4 * CYC_THREADS]; s.p6 = q[5 * CYC_THREADS];
                    s.p7 = q[6 * CYC_THREADS];
                }
                const float phase3 = exact
                    ? kdiv_inv(ph2, __ldg(a.inv_ts + vo), tsz)
                    : __fdiv_rn(ph2, tsz);
                const float warped = cz_warp_k(mode, phase3, s, tsz, exact,
                                               a.cz_mask);
                if (mode != 0) idx_f = warped;
            }
            int idx = (int)idx_f;
            idx = idx < 0 ? 0 : idx;
            const int clip = __ldg(a.clip_i + vo);
            idx = idx > clip ? clip : idx;
            float f = __ldg(a.table + (__ldg(a.table_off + v) + idx));
            if (bad) f = 0.0f;
            bool adv = active;
            if (a.has_noise && __ldg(a.is_noise + vo) != 0) {
                f = whiteish;
                adv = false;
            }
            if (adv) s_ph[c] = ph2;
            if (a.has_finish) {
                const bool fin_osc = (bad && __ldg(a.one_shot + vo) != 0)
                                     || ((over || under) && osn_b);
                if (adv && fin_osc) s_fin[c] = 1;
            }
            // ---- sample & hold (synth.c:560-571) ----
            float s1 = f;
            if (a.has_hold) {
                const bool h_on = __ldg(a.hold_on + vo) != 0;
                const int hc = s_hc[c];
                const float hv2 = (h_on && hc == 0) ? f : s_hv[c];
                if (h_on) s1 = hv2;
                int hcn = hc + 1;
                if (hcn >= __ldg(a.hmax + vo)) hcn = 0;
                if (active && h_on) s_hc[c] = hcn;
                if (active) s_hv[c] = hv2;
            }
            // ---- bit quantizer (synth.c:341-345) ----
            float s2 = s1;
            if (a.has_quant) {
                const float iv =
                    (float)(int)kfma(s1, __ldg(a.levels + vo), 0.5f);
                if (__ldg(a.quant_on + vo) != 0)
                    s2 = iv * __ldg(a.inv_lev + vo);
            }
            // ---- biquad (mmf_process, synth.c:349-364) ----
            float s3 = s2;
            if (a.has_flt) {
                const float x1 = s_x1[c], x2 = s_x2[c];
                const float y1 = s_y1[c], y2 = s_y2[c];
                float fv = __ldg(a.b1 + vo) * x1;
                fv = xfma(__ldg(a.b0 + vo), s2, fv, exact);
                fv = xfma(__ldg(a.b2 + vo), x2, fv, exact);
                fv = xfma(__ldg(a.na1 + vo), y1, fv, exact);
                fv = xfma(__ldg(a.na2 + vo), y2, fv, exact);
                const bool uf = __ldg(a.use_flt + vo) != 0;
                if (uf) s3 = fv;
                if (active && uf) {
                    s_x2[c] = x1; s_x1[c] = s2; s_y2[c] = y1; s_y1[c] = fv;
                }
            }
            // ---- amp, envelope, amp-mod, smoother ----
            float final_g = amp;
            if (a.has_env) {
                const int count = a.cbase + t;
                const int env_relat = __ldg(a.env_relat + vo);
                const float tf = (float)(count - __ldg(a.env_start + vo));
                const float trf = (float)(count - env_relat);
                const float att = __ldg(a.att + vo);
                const float dec = __ldg(a.dec + vo);
                const float sus = __ldg(a.sus + vo);
                const float rel = __ldg(a.rel + vo);
                float ev;
                if (tf < att) ev = __fdiv_rn(tf, att);
                else if (tf < att + dec)
                    ev = kfma(-__fdiv_rn(tf - att, dec), 1.0f - sus, 1.0f);
                else if (env_relat == 0) ev = sus;
                else if (trf < rel)
                    ev = sus * (1.0f - __fdiv_rn(trf, rel));
                else ev = 0.0f;
                if (__ldg(a.env_act + vo) == 0) ev = 0.0f;
                const float env = __ldg(a.use_env + vo) != 0
                    ? ev * __ldg(a.vel + vo) : 1.0f;
                final_g = amp * env;
            }
            if (a.has_am) {
                const int am_osc = __ldg(a.am_osc + vo);
                float amr = read_mod(cur, prev, am_osc, __ldg(a.am_del + vo),
                                     v, k);
                if (a.has_am_self && am_osc == v) amr = s3;
                const float ampmod = am_osc >= 0
                    ? amr * __ldg(a.am_dep + vo) : 1.0f;
                final_g = final_g * ampmod;
            }
            float final2 = final_g;
            if (a.has_sm) {
                const float sg = s_sg[c];
                const float sg2 = xfma(__ldg(a.smoothing + vo), final_g - sg,
                                       sg, exact);
                const bool u_sm = __ldg(a.use_sm + vo) != 0;
                if (u_sm) final2 = sg2;
                if (active && u_sm) s_sg[c] = sg2;
            }
            const float sample_out = active ? s3 * final2 : 0.0f;
            cur[c] = sample_out;
            // ---- pan (+ pan-mod) and mix (synth.c:595-612) ----
            const bool dc0 = !a.has_disc || __ldg(a.disconn + vo) == 0;
            float plv = s_pnl[c], prv = s_pnr[c];
            if (a.has_pm) {
                const int pm_osc = __ldg(a.pm_osc + vo);
                float pmr = read_mod(cur, prev, pm_osc, __ldg(a.pm_del + vo),
                                     v + 1, k);
                if (a.has_pm_self && __ldg(a.pm_self + vo) != 0)
                    pmr = sample_out;
                const bool pan_on = pm_osc >= 0 && dc0;
                const float dep = __ldg(a.pm_dep + vo);
                const float one_m_q = xfma(-pmr, dep, 1.0f, exact);
                const float one_p_q = xfma(pmr, dep, 1.0f, exact);
                if (pan_on) { plv = one_m_q * 0.5f; prv = one_p_q * 0.5f; }
                if (active && pan_on) { s_pnl[c] = plv; s_pnr[c] = prv; }
            }
            const bool contrib = active && dc0;
            mix_l = mix_l + (contrib ? sample_out * plv : 0.0f);
            mix_r = mix_r + (contrib ? sample_out * prv : 0.0f);
        }
        // every voice wrote cur: it is the next frame's prev
        float* swap = prev; prev = cur; cur = swap;
        // ---- master-volume smoother (synth.c:616-624) ----
        vg = xfma(0.002f, vf - vg, vg, exact);
        a.out_l[(size_t)t * B + b] = mix_l * vg;
        a.out_r[(size_t)t * B + b] = mix_r * vg;
    }

    // ---- states out ----
    for (int v = 0; v < k; ++v) {
        const int so = v * a.st_sv + b * a.st_sb;
        const int c = v * CYC_THREADS;
        a.sample_e[so] = prev[c];
        a.phase_e[so] = s_ph[c];
        a.pan_l_e[so] = s_pnl[c];
        a.pan_r_e[so] = s_pnr[c];
        if (a.has_finish) a.finished_e[so] = s_fin[c];
        if (a.has_hold) { a.hold_count_e[so] = s_hc[c];
                          a.hold_val_e[so] = s_hv[c]; }
        if (a.has_flt) { a.x1_e[so] = s_x1[c]; a.x2_e[so] = s_x2[c];
                         a.y1_e[so] = s_y1[c]; a.y2_e[so] = s_y2[c]; }
        if (a.has_sm) a.smoother_e[so] = s_sg[c];
    }
    a.vol_gain_e[b] = vg;
}

extern "C" int cyclic_launch(const CyclicArgs* args, void* stream) {
    const int blocks = (args->rows + CYC_THREADS - 1) / CYC_THREADS;
    if (blocks <= 0 || args->k <= 0) return (int)cudaGetLastError();
    const size_t smem = (size_t)cyclic_fields(*args) * args->k * CYC_THREADS
                        * sizeof(float);
    if (smem > 48 * 1024) {
        // above 48 KB a block's dynamic shared memory is an opt-in
        cudaError_t rc = cudaFuncSetAttribute(
            cyclic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    cyclic_kernel<<<blocks, CYC_THREADS, smem, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
