// The cyclic kernel for Hopper (sm_90a): one block of the reference's
// serial per-frame voice loop (synth.c:526-612) for scripts whose
// modulation graph has a cycle.
//
// Replaces skred_tpu/engine/cyclic.py:cyclic_block_pallas (body
// _make_cyclic_kernel).
//
// Bound on this card: the kernel must read the per-voice vectors and
// states once and write two [n, rows] output streams, a few megabytes at
// 1024 rows, microseconds at 3.35 TB/s.  Its real limit is latency: a
// frame's voices form a dependent chain (modulator read -> phase wrap ->
// warp -> table load -> biquad -> smoother -> pan) that a later voice may
// read.  The keyed variant walks it with one thread per row (at 1024 rows
// 32 one-warp blocks, one warp per SM: nothing hides that latency, so its
// design shortens the chain); the general one spreads a frame's voices
// over threads (below).  Nothing of the TPU kernel's memory plan is
// carried over: tables stay in the flat buffer in global memory and are
// read through the read-only cache (__ldg) at table_off[v] + idx, so a
// table larger than shared memory (a 60,406-sample PCM loop is 236 KB)
// needs no special case.
//
// One source, two variants:
//   * built with -DCYC_K=<k> and the feature defines below (the keyed
//     variant, cyclic_fixed_launch): k, the feature set, the CZ mode mask
//     and the arithmetic mode are compile-time constants, as in the JAX
//     package, which compiles one kernel per (features, cz modes, k).
//     The voice loop is unrolled into one frame body without uniform
//     branches; every per-voice state, the current and the previous
//     frame's samples and the volume gain live in registers; a modulator
//     read is a select over those registers by the lane's source index
//     (no store-to-load round trip through memory); the per-voice
//     parameters are built once per block (booleans in one flag word,
//     source indices resolved against the serial-frame rule, the CZ
//     scales hoisted) and held in registers or read from shared memory
//     as 16-byte quads (PREG); the phase wrap and the CZ divide run
//     without their slow paths, and a row whose operands need one
//     renders the block again with the exact helpers (run_block);
//   * built without them (the general variant, cyclic_general_launch):
//     any k up to 256 (the engine has 64 voices); k and the feature
//     flags are run-time arguments.
//     A thread per voice and row, not per row: at k = 64 a row's serial
//     chain is 64 voice steps a frame, and a call at 512 rows would be 16
//     one-warp blocks on 132 SMs.  What bounds it on this card is the
//     chain a frame (the waves' voice steps, a barrier each, and the
//     row's mix), not bytes.  So a frame's voices run in waves by their
//     same-frame reads (a schedule built once per batch on the host,
//     kernels/cyclic.py cyclic_levels): czfb64's graph is 2 waves, a
//     chain of k reads k.  Voices exchange samples through shared
//     memory; each thread holds its voice's parameters and states in
//     registers for the whole block (read and written once a call); the
//     mix, summed in voice order one add after another as the serial
//     loop sums it, runs in a warp of its own a frame behind the voices,
//     so it leaves the chain.  4 rows of 64 voices a block: 128 blocks
//     at 512 rows, one an SM.
// The wrapper (kernels/cyclic.py) takes the keyed variant for k up to its
// cap and builds each key at first use; both share CyclicArgs.  With
// CYC_SHIM defined the general variant's block body builds without its
// kernel and launch, for g++ and a shim that runs a thread per CUDA
// thread (tests/test_torch_cyclic_waves.py).
//
// Numerics are the JAX kernel's, bit for bit in exact mode: __fmaf_rn
// where it calls _kfma (quantizer, envelope decay) and at its fma sites
// (FM increment, biquad, smoother, pan, volume smoother); the
// hoisted-reciprocal Markstein divide for the CZ normalisation; IEEE
// division in the envelope.  Fast mode keeps the fma at those sites too:
// it is the card's plain multiply-add, and what the JAX package's fast
// mode gives on the CPU, where XLA contracts its a * b + c.  A separately
// rounded product differs in the last bit, and a feedback loop (fb1,
// fb4) grows that to the scale of the signal.  Fast mode differs only in
// the CZ scales and the warp's phase (IEEE divides: cz_scales and
// phase3), whose fmas it keeps as well.  Build with -fmad=false
// and without --use_fast_math; denormals are kept.

#include <cuda_runtime.h>
#include <math.h>

#include "numerics.cuh"

struct CyclicArgs {
    int n, rows, k, cbase, exact;
    int has_fm, has_cz, has_czm, has_am, has_am_self, has_pm, has_pm_self,
        has_env, has_flt, has_sm, has_hold, has_quant, has_noise, has_finish,
        has_direction, has_disc;
    int cz_mask, st_sv, st_sb, n_waves;
    const float* table; const int* table_off; const float* noise;
    const float* vf; const int* wave;
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

#ifndef CYC_K

// ======================================================================
// The general variant: k and the features at run time.  A thread a voice
// of a row; a CUDA block renders gen_rows(k) rows, and one more warp sums
// their mixes.  Inside a frame the voices run in waves (CyclicArgs::wave,
// kernels/cyclic.py cyclic_levels): a voice reads this frame's sample of
// a voice of a lower wave, through shared memory, after the barrier that
// ends that wave.  A frame's critical path is n_waves voice steps and
// barriers, not k.
// ======================================================================

constexpr int GEN_MIX = 32;                  // the mix warp
constexpr int GEN_THREADS = 256 + GEN_MIX;   // the most a block takes

// rows a block: about 256 voice threads, at most 16 rows (the mix warp
// takes a lane a row and channel).  At k = 64, 4 rows: a warp's lanes
// are 8 voices of 4 rows, where 2 rows (16 voices) branched apart more
// (1.74 against 1.66 ms a block of czfb64 at 512 rows on the H100).
__host__ __device__ inline int gen_rows(int k) {
    return k > 16 ? 256 / k : 16;
}

// voice threads a block: whole warps, so that no warp holds both a voice
// and a mix lane (each kind meets the barrier at its own instruction)
__host__ __device__ inline int gen_voice_threads(int k) {
    return (gen_rows(k) * k + 31) & ~31;
}

// A modulator edge resolved once a call against the serial-frame rule:
// voices below `done` already hold this frame's sample; a delayed edge,
// and a voice not rendered yet, read the previous frame's.  -1 reads
// +0.0; else the source's slot in a row's sample column, + GEN_SAME for
// this frame's.  The schedule puts every this-frame source in a lower
// wave; a voice's read of itself (pan-mod, done = v + 1) finds the sample
// the thread has just written.  A read whose value the voice discards
// (fm without use_fm, cz-mod at CZ mode 0, pan-mod with the pan off) is
// none, as kernels/cyclic.py wave_reads leaves it out of the schedule.
constexpr int GEN_SAME = 1 << 30;

__device__ __forceinline__ int gen_slot(int m, int delayed, int done, int k,
                                        int R) {
    if (m < 0 || m >= k) return -1;
    return m * R + ((delayed == 0 && m < done) ? GEN_SAME : 0);
}

__device__ __forceinline__ float gen_read(int slot, const float* cur,
                                          const float* prev) {
    if (slot < 0) return 0.0f;
    return (slot & GEN_SAME) ? cur[slot & ~GEN_SAME] : prev[slot];
}

// One voice of one row: its parameters, read once a call, and its
// states, in registers for the whole block.
struct GenVoice {
    float amp, pinc, lo, hi, hi_os, L, mis, fm_dep, tsz, inv_ts, cz_dist,
        cm_dep, levels, inv_lev, b0, b1, b2, na1, na2, att, dec, att_dec,
        sus, rel, vel, am_dep, pm_dep, smoothing;
    int toff, clip, fm_s, cm_s, am_s, pm_s, mode, hmax, env_start,
        env_relat;
    bool use_fm, dirneg, osn, one_shot, noise, hold_on, quant_on, use_flt,
        use_env, env_act, cm_ge, am_ge, am_self, pm_self, pan_on, dc0,
        use_sm;
    CzScales cz;
    float ph, hv, x1, x2, y1, y2, sg, pnl, pnr, last;
    int fin, hc;
};

__device__ __forceinline__ void gen_load(const CyclicArgs& a, GenVoice& p,
                                         int v, int b, int R) {
    const int B = a.rows, k = a.k;
    const int vo = v * B + b;
    p = GenVoice{};
    p.amp = a.amp[vo];
    p.pinc = a.pinc[vo];
    p.lo = a.lo[vo];
    p.hi = a.hi[vo];
    p.L = a.L[vo];
    p.clip = a.clip_i[vo];
    p.toff = a.table_off[v];
    p.fm_s = p.cm_s = p.am_s = p.pm_s = -1;
    if (a.has_fm) {
        p.use_fm = a.use_fm[vo] != 0;
        if (p.use_fm)
            p.fm_s = gen_slot(a.fm_osc[vo], a.fm_del[vo], v, k, R);
        p.mis = a.mis[vo];
        p.fm_dep = a.fm_dep[vo];
    }
    if (a.has_direction) p.dirneg = a.dirneg[vo] != 0;
    if (a.has_finish) {
        p.hi_os = p.hi - 1e-6f;
        p.osn = a.osn[vo] != 0;
        p.one_shot = a.one_shot[vo] != 0;
    }
    if (a.has_cz) {
        p.mode = a.cz_mode[vo];
        p.tsz = a.tsize[vo];
        p.inv_ts = a.inv_ts[vo];
        p.cz_dist = a.cz_dist[vo];
        if (a.has_czm) {
            if (p.mode != 0)
                p.cm_s = gen_slot(a.cm_osc[vo], a.cm_del[vo], v, k, R);
            p.cm_ge = a.cm_ge[vo] != 0;
            p.cm_dep = a.cm_dep[vo];
        } else {
            p.cz = cz_scales(p.cz_dist + a.dm_row[vo], a.exact, a.cz_mask);
        }
    }
    if (a.has_noise) p.noise = a.is_noise[vo] != 0;
    if (a.has_hold) {
        p.hold_on = a.hold_on[vo] != 0;
        p.hmax = a.hmax[vo];
    }
    if (a.has_quant) {
        p.quant_on = a.quant_on[vo] != 0;
        p.levels = a.levels[vo];
        p.inv_lev = a.inv_lev[vo];
    }
    if (a.has_flt) {
        p.b0 = a.b0[vo]; p.b1 = a.b1[vo]; p.b2 = a.b2[vo];
        p.na1 = a.na1[vo]; p.na2 = a.na2[vo];
        p.use_flt = a.use_flt[vo] != 0;
    }
    if (a.has_env) {
        p.use_env = a.use_env[vo] != 0;
        p.env_act = a.env_act[vo] != 0;
        p.env_start = a.env_start[vo];
        p.env_relat = a.env_relat[vo];
        p.att = a.att[vo]; p.dec = a.dec[vo]; p.att_dec = p.att + p.dec;
        p.sus = a.sus[vo]; p.rel = a.rel[vo]; p.vel = a.vel[vo];
    }
    p.dc0 = !a.has_disc || a.disconn[vo] == 0;
    if (a.has_am) {
        const int am_osc = a.am_osc[vo];
        p.am_s = gen_slot(am_osc, a.am_del[vo], v, k, R);
        p.am_ge = am_osc >= 0;
        p.am_self = a.has_am_self && am_osc == v;
        p.am_dep = a.am_dep[vo];
    }
    if (a.has_pm) {
        const int pm_osc = a.pm_osc[vo];
        p.pan_on = pm_osc >= 0 && p.dc0;
        // the pan read comes after the voice's own sample
        if (p.pan_on) p.pm_s = gen_slot(pm_osc, a.pm_del[vo], v + 1, k, R);
        p.pm_self = a.has_pm_self && a.pm_self[vo] != 0;
        p.pm_dep = a.pm_dep[vo];
    }
    if (a.has_sm) {
        p.use_sm = a.use_sm[vo] != 0;
        p.smoothing = a.smoothing[vo];
    }
    // ---- states in ----
    const int so = v * a.st_sv + b * a.st_sb;
    p.ph = a.phase_0[so];
    p.last = a.sample_0[so];
    p.pnl = a.pan_l_0[so];
    p.pnr = a.pan_r_0[so];
    if (a.has_finish) p.fin = a.finished_0[so];
    if (a.has_hold) { p.hc = a.hold_count_0[so]; p.hv = a.hold_val_0[so]; }
    if (a.has_flt) {
        p.x1 = a.x1_0[so]; p.x2 = a.x2_0[so];
        p.y1 = a.y1_0[so]; p.y2 = a.y2_0[so];
    }
    if (a.has_sm) p.sg = a.smoother_0[so];
}

__device__ __forceinline__ void gen_store(const CyclicArgs& a,
                                          const GenVoice& p, int v, int b) {
    const int so = v * a.st_sv + b * a.st_sb;
    a.sample_e[so] = p.last;
    a.phase_e[so] = p.ph;
    a.pan_l_e[so] = p.pnl;
    a.pan_r_e[so] = p.pnr;
    if (a.has_finish) a.finished_e[so] = p.fin;
    if (a.has_hold) { a.hold_count_e[so] = p.hc; a.hold_val_e[so] = p.hv; }
    if (a.has_flt) {
        a.x1_e[so] = p.x1; a.x2_e[so] = p.x2;
        a.y1_e[so] = p.y1; a.y2_e[so] = p.y2;
    }
    if (a.has_sm) a.smoother_e[so] = p.sg;
}

// One voice's sample of frame t: the reference's voice body (synth.c:
// 526-612), site for site the serial kernel's.  cur / prev: the row's
// sample columns of this frame and the last; slot: the voice's; part_l
// / part_r: the row's mix terms of this frame.
__device__ __forceinline__ void gen_step(const CyclicArgs& a, GenVoice& p,
                                         int t, float* cur, const float* prev,
                                         float* part_l, float* part_r,
                                         int slot) {
    const int exact = a.exact;
    const bool fin_b = a.has_finish && p.fin != 0;
    const bool active = !fin_b && p.amp != 0.0f;
    // ---- oscillator (osc_next, synth.c:217-275) ----
    float inc = p.pinc;
    if (a.has_fm) {
        const float g = gen_read(p.fm_s, cur, prev) * p.fm_dep;
        if (p.use_fm) inc = kfma(p.mis, g, p.pinc);
    }
    if (a.has_direction && p.dirneg) inc = -inc;
    const float phv = p.ph + inc;
    const bool bad = !isfinite(phv);
    const bool over = phv >= p.hi;
    const bool under = phv < p.lo;
    const float r = fmodf(phv - p.lo, p.L);
    const float wrap_over = p.lo + r;
    const float wrap_under = p.hi + r;
    bool osn_b = false;
    float ph2;
    if (a.has_finish) {
        osn_b = p.osn;
        ph2 = over ? (osn_b ? p.hi_os : wrap_over)
                   : (under ? (osn_b ? p.lo : wrap_under) : phv);
    } else {
        ph2 = over ? wrap_over : (under ? wrap_under : phv);
    }
    if (bad) ph2 = 0.0f;
    // ---- CZ warp, index, lookup ----
    float idx_f = ph2;
    if (a.has_cz) {
        CzScales s = p.cz;
        if (a.has_czm) {
            const float rdm = gen_read(p.cm_s, cur, prev);
            const float dm = p.cm_ge ? rdm * p.cm_dep : 1.0f;
            s = cz_scales(p.cz_dist + dm, exact, a.cz_mask);
        }
        const float phase3 = exact ? kdiv_inv(ph2, p.inv_ts, p.tsz)
                                   : __fdiv_rn(ph2, p.tsz);
        const float warped = cz_warp_k(p.mode, phase3, s, p.tsz, a.cz_mask);
        if (p.mode != 0) idx_f = warped;
    }
    int idx = (int)idx_f;
    idx = idx < 0 ? 0 : idx;
    idx = idx > p.clip ? p.clip : idx;
    float f = __ldg(a.table + (p.toff + idx));
    if (bad) f = 0.0f;
    bool adv = active;
    if (a.has_noise && p.noise) {
        f = __ldg(a.noise + t);
        adv = false;
    }
    if (adv) p.ph = ph2;
    if (a.has_finish) {
        const bool fin_osc = (bad && p.one_shot) || ((over || under) && osn_b);
        if (adv && fin_osc) p.fin = 1;
    }
    // ---- sample & hold (synth.c:560-571) ----
    float s1 = f;
    if (a.has_hold) {
        const int hc = p.hc;
        const float hv2 = (p.hold_on && hc == 0) ? f : p.hv;
        if (p.hold_on) s1 = hv2;
        int hcn = hc + 1;
        if (hcn >= p.hmax) hcn = 0;
        if (active && p.hold_on) p.hc = hcn;
        if (active) p.hv = hv2;
    }
    // ---- bit quantizer (synth.c:341-345) ----
    float s2 = s1;
    if (a.has_quant) {
        const float iv = (float)(int)kfma(s1, p.levels, 0.5f);
        if (p.quant_on) s2 = iv * p.inv_lev;
    }
    // ---- biquad (mmf_process, synth.c:349-364) ----
    float s3 = s2;
    if (a.has_flt) {
        float fv = p.b1 * p.x1;
        fv = kfma(p.b0, s2, fv);
        fv = kfma(p.b2, p.x2, fv);
        fv = kfma(p.na1, p.y1, fv);
        fv = kfma(p.na2, p.y2, fv);
        if (p.use_flt) s3 = fv;
        if (active && p.use_flt) {
            p.x2 = p.x1; p.x1 = s2; p.y2 = p.y1; p.y1 = fv;
        }
    }
    // ---- amp, envelope, amp-mod, smoother ----
    float final_g = p.amp;
    if (a.has_env) {
        const int count = a.cbase + t;
        const float tf = (float)(count - p.env_start);
        const float trf = (float)(count - p.env_relat);
        float ev;
        if (tf < p.att) ev = __fdiv_rn(tf, p.att);
        else if (tf < p.att_dec)
            ev = kfma(-__fdiv_rn(tf - p.att, p.dec), 1.0f - p.sus, 1.0f);
        else if (p.env_relat == 0) ev = p.sus;
        else if (trf < p.rel)
            ev = p.sus * (1.0f - __fdiv_rn(trf, p.rel));
        else ev = 0.0f;
        if (!p.env_act) ev = 0.0f;
        const float env = p.use_env ? ev * p.vel : 1.0f;
        final_g = p.amp * env;
    }
    if (a.has_am) {
        float amr = gen_read(p.am_s, cur, prev);
        if (p.am_self) amr = s3;
        const float ampmod = p.am_ge ? amr * p.am_dep : 1.0f;
        final_g = final_g * ampmod;
    }
    float final2 = final_g;
    if (a.has_sm) {
        const float sg2 = kfma(p.smoothing, final_g - p.sg, p.sg);
        if (p.use_sm) final2 = sg2;
        if (active && p.use_sm) p.sg = sg2;
    }
    const float sample_out = active ? s3 * final2 : 0.0f;
    cur[slot] = sample_out;
    p.last = sample_out;
    // ---- pan (+ pan-mod); the mix term (synth.c:595-612) ----
    float plv = p.pnl, prv = p.pnr;
    if (a.has_pm) {
        float pmr = gen_read(p.pm_s, cur, prev);
        if (p.pm_self) pmr = sample_out;
        const float one_m_q = kfma(-pmr, p.pm_dep, 1.0f);
        const float one_p_q = kfma(pmr, p.pm_dep, 1.0f);
        if (p.pan_on) { plv = one_m_q * 0.5f; prv = one_p_q * 0.5f; }
        if (active && p.pan_on) { p.pnl = plv; p.pnr = prv; }
    }
    const bool contrib = active && p.dc0;
    part_l[slot] = contrib ? sample_out * plv : 0.0f;
    part_r[slot] = contrib ? sample_out * prv : 0.0f;
}

// Block bx of the general variant, as thread tid; smem: gen_smem_bytes.
// Threads below gen_voice_threads(k) are voice lanes (lane l, row r =
// tid / R, tid % R: a warp holds few lanes, so mostly one wave); the last
// warp's lane c * R + r sums channel c of row r.  Frame t's samples and
// mix terms go to the buffers of parity t & 1: the mix warp sums frame
// t - 1 in frame t's first wave, so the voices of frame t + 1 write those
// terms again only after a barrier that it has passed.
__device__ __forceinline__ void cyclic_general_block(const CyclicArgs& a,
                                                     float* smem, int bx,
                                                     int tid) {
    const int k = a.k, n = a.n, B = a.rows;
    const int R = gen_rows(k), KR = k * R, VT = gen_voice_threads(k);
    const int W = a.n_waves > 1 ? a.n_waves : 1;
    float* samp = smem;                       // [2][k][R]
    float* part = smem + 2 * KR;              // [2][2][k][R]: parity, channel
    int* order = (int*)(smem + 6 * KR);       // [k]: the voice of lane l

    // ---- lanes in (wave, CZ mode, voice) order: the lanes of a warp
    // mostly share a wave, and the warp curve's branch on the mode (the
    // block's first row's) ----
    if (tid < k) {
        auto key = [&](int u) {
            int mode = a.has_cz ? a.cz_mode[u * B + bx * R] : 0;
            mode = mode < 0 ? 0 : (mode > 7 ? 8 : mode);
            return __ldg(a.wave + u) * 16 + mode;
        };
        const int w = key(tid);
        int rank = 0;
        for (int u = 0; u < k; ++u) {
            const int wu = key(u);
            rank += (wu < w || (wu == w && u < tid)) ? 1 : 0;
        }
        order[rank] = tid;
    }
    __syncthreads();

    const bool voice = tid < KR;
    const int m = tid - VT;                   // the mix lane
    const bool mixer = m >= 0 && m < 2 * R;
    const int r = voice ? tid % R : (mixer ? m % R : 0);
    const int c = mixer ? m / R : 0;
    const int b = bx * R + r;
    const bool live = (voice || mixer) && b < B;
    GenVoice p;
    int v = 0, my_w = -1;
    if (voice && live) {
        v = order[tid / R];
        my_w = __ldg(a.wave + v);
        gen_load(a, p, v, b, R);
        samp[KR + v * R + r] = p.last;        // frame 0's prev
    }
    const float vf = mixer && live ? a.vf[b] : 0.0f;
    float vg = mixer && live ? a.vol_gain_0[b] : 0.0f;
    float* out = c ? a.out_r : a.out_l;
    // frame tm's mix, in voice order, and the master volume (synth.c:
    // 616-624)
    auto mix_frame = [&](int tm) {
        const float* pc = part + (2 * (tm & 1) + c) * KR + r;
        float mix = 0.0f;
        for (int u = 0; u < k; ++u) mix = mix + pc[u * R];
        vg = kfma(0.002f, vf - vg, vg);
        out[(size_t)tm * B + b] = mix * vg;
    };
    __syncthreads();

    for (int t = 0; t < n; ++t) {
        const int par = t & 1;
        float* cur = samp + par * KR + r;
        const float* prev = samp + (par ^ 1) * KR + r;
        for (int w = 0; w < W; ++w) {
            if (w == my_w)
                gen_step(a, p, t, cur, prev, part + 2 * par * KR + r,
                         part + (2 * par + 1) * KR + r, v * R);
            if (mixer && live && w == 0 && t > 0) mix_frame(t - 1);
            __syncthreads();
        }
    }
    if (mixer && live && n > 0) mix_frame(n - 1);

    // ---- states out ----
    if (voice && live) gen_store(a, p, v, b);
    if (mixer && live && c == 0) a.vol_gain_e[b] = vg;
}

__host__ __device__ inline size_t gen_smem_bytes(int k) {
    return (size_t)(6 * gen_rows(k) * k + k) * sizeof(float);
}

#ifndef CYC_SHIM
__global__ void __launch_bounds__(GEN_THREADS)
cyclic_general_kernel(const CyclicArgs a) {
    extern __shared__ float smem[];
    cyclic_general_block(a, smem, blockIdx.x, threadIdx.x);
}

extern "C" int cyclic_general_launch(const CyclicArgs* args, void* stream) {
    const int k = args->k;
    if (args->rows <= 0 || k <= 0) return (int)cudaGetLastError();
    const int R = gen_rows(k);
    if (R < 1) return (int)cudaErrorInvalidValue;      // k above 256
    const int blocks = (args->rows + R - 1) / R;
    cyclic_general_kernel<<<blocks, gen_voice_threads(k) + GEN_MIX,
                            gen_smem_bytes(k), (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
#endif  // CYC_SHIM

#else  // CYC_K

// ======================================================================
// The keyed variant: built with
//   -DCYC_K=<voices> -DCYC_EXACT=<0|1> -DCYC_CZ_MASK=<bit m: CZ mode m>
//   -DCYC_HAS_<FEATURE>=<0|1> for every flag of CyclicArgs (FM, CZ, CZM, AM, AM_SELF, PM, PM_SELF,
// ENV, FLT, SM, HOLD, QUANT, NOISE, FINISH, DIRECTION, DISC); for timing
// only, -DCYC_ABLATE_<PHASE>=1 stubs a phase (below).
// ======================================================================

// Timing ablation (SKRED_CYC_ABLATE; cyclic.py fixed_key adds a define
// per phase the key compiles in): each stub takes the place of the JAX
// kernel's (skred_tpu/engine/cyclic.py:66-72), so that a phase's share
// of the kernel's time is the difference to the full build.  A render
// under a stub is invalid by design.
//   READS   the fm modulator read gives +0.0 (cyclic.py:294); the
//           other three reads belong to the phase they sit in (the
//           cz-mod read to CZ, the am read to DSP, the pan-mod read to
//           PAN), so that no instruction is in two stubs' shares (the
//           JAX stub takes all four reads)
//   LOOKUP  no table load: f = the index's bits as a float (:274; the
//           JAX stub's (float)index * 1e-9 costs an I2F and a multiply,
//           as much as the load: see tier.cu)
//   CZ      no CZ warp: the index is the wrapped phase (:360)
//   DSP     no hold, quantizer, biquad, envelope, am or smoother: the
//           sample is f * amp (:395-461)
//   PAN     no per-sample pan: the voice's pan as it came in (:473)
//   ALL     no voice body: a voice's sample is its amp, and both
//           channels sum the amps (:324)
// Each stub keeps a data dependence on what it replaces, as the JAX
// stubs do.
#ifndef CYC_ABLATE_READS
#define CYC_ABLATE_READS 0
#endif
#ifndef CYC_ABLATE_LOOKUP
#define CYC_ABLATE_LOOKUP 0
#endif
#ifndef CYC_ABLATE_CZ
#define CYC_ABLATE_CZ 0
#endif
#ifndef CYC_ABLATE_DSP
#define CYC_ABLATE_DSP 0
#endif
#ifndef CYC_ABLATE_PAN
#define CYC_ABLATE_PAN 0
#endif
#ifndef CYC_ABLATE_ALL
#define CYC_ABLATE_ALL 0
#endif

constexpr int K = CYC_K;
constexpr int EXACT = CYC_EXACT;
constexpr int CZ_MASK = CYC_CZ_MASK;
constexpr int TF = 32;                    // rows a block: one warp
constexpr bool FM = CYC_HAS_FM, CZ = CYC_HAS_CZ, CZM = CYC_HAS_CZM,
    AM = CYC_HAS_AM, AM_SELF = CYC_HAS_AM_SELF, PM = CYC_HAS_PM,
    PM_SELF = CYC_HAS_PM_SELF, ENV = CYC_HAS_ENV, FLT = CYC_HAS_FLT,
    SM = CYC_HAS_SM, HOLD = CYC_HAS_HOLD, QUANT = CYC_HAS_QUANT,
    NOISE = CYC_HAS_NOISE, FINISH = CYC_HAS_FINISH, DIRN = CYC_HAS_DIRECTION,
    DISC = CYC_HAS_DISC;
constexpr bool CZC = CZ && !CZM;          // CZ scales constant over a block
constexpr bool A_READS = CYC_ABLATE_READS, A_LOOKUP = CYC_ABLATE_LOOKUP,
    A_CZ = CYC_ABLATE_CZ, A_DSP = CYC_ABLATE_DSP, A_PAN = CYC_ABLATE_PAN,
    A_ALL = CYC_ABLATE_ALL;

// the per-voice booleans of one row, one bit each
enum : int {
    F_LIVE = 1 << 0,      // amp != 0
    F_USE_FM = 1 << 1, F_DIRNEG = 1 << 2, F_OSN = 1 << 3,
    F_ONE_SHOT = 1 << 4, F_NOISE = 1 << 5, F_HOLD = 1 << 6,
    F_QUANT = 1 << 7, F_FLT = 1 << 8, F_USE_ENV = 1 << 9,
    F_ENV_ACT = 1 << 10, F_NO_REL = 1 << 11, F_CM_GE = 1 << 12,
    F_AM_GE = 1 << 13, F_AM_SELF = 1 << 14, F_PAN_ON = 1 << 15,
    F_PM_SELF = 1 << 16, F_DC0 = 1 << 17, F_USE_SM = 1 << 18,
};

// slots of a voice's parameter record (ints stored as their bits); a
// feature's slots exist only when it is compiled in
constexpr int P_FLAGS = 0, P_PINC = 1, P_LO = 2, P_HI = 3, P_L = 4,
    P_AMP = 5, P_CLIP = 6, P_TOFF = 7;
constexpr int P_FM = 8;                              // src, mis, fm_dep
constexpr int P_HIOS = P_FM + (FM ? 3 : 0);          // hi - 1e-6
constexpr int P_CZ = P_HIOS + (FINISH ? 1 : 0);      // mode, tsize, inv_ts
constexpr int P_CZM = P_CZ + (CZ ? 3 : 0);           // src, cz_dist, cm_dep
constexpr int P_CZC = P_CZM + (CZM ? 3 : 0);         // the 7 CzScales
constexpr int P_HOLD = P_CZC + (CZC ? 7 : 0);        // hmax
constexpr int P_QUANT = P_HOLD + (HOLD ? 1 : 0);     // levels, inv_lev
constexpr int P_FLT = P_QUANT + (QUANT ? 2 : 0);     // b0 b1 b2 na1 na2
constexpr int P_ENV = P_FLT + (FLT ? 5 : 0);
    // env_start, env_relat, att, dec, sus, rel, vel, att + dec
constexpr int P_AM = P_ENV + (ENV ? 8 : 0);          // src, am_dep
constexpr int P_PM = P_AM + (AM ? 2 : 0);            // src, pm_dep
constexpr int P_SM = P_PM + (PM ? 2 : 0);            // smoothing
constexpr int NP = P_SM + (SM ? 1 : 0);
constexpr int NQ = (NP + 3) / 4;                     // 16-byte quads

// Where a frame reads the parameter records from: registers, loaded once
// per block, where they fit beside the states (K * (4 NQ + NS) <= 200;
// fb2's 5 voices take 188 registers, no spill); shared memory, one
// 128-bit load per quad, otherwise.
constexpr int NS = 5 + FINISH + 2 * HOLD + 4 * FLT + SM;  // states a voice
constexpr bool PREG = K * (4 * NQ + NS) <= 200;

// a modulator edge resolved once per block against the serial-frame rule
// (read_mod): -1 reads +0.0, j < K the previous frame's sample of voice
// j, K + j this frame's (a voice below `done`, not delayed)
__device__ __forceinline__ int src_code(int m, int delayed, int done) {
    if (m < 0 || m >= K) return -1;
    return (delayed == 0 && m < done) ? K + m : m;
}

// the read: a select over the sample registers, this frame's last, so
// the voice rendered just before is the last select of the chain
__device__ __forceinline__ float read_src(int code, const float* cur,
                                          const float* prev, int done) {
    float val = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) val = code == j ? prev[j] : val;
#pragma unroll
    for (int j = 0; j < K; ++j)
        if (j < done) val = code == K + j ? cur[j] : val;
    return val;
}

// The block runs first with the wrap and the CZ divide that have no slow
// path (FAST): exact wherever their operands are in range, and a lane
// whose operand is not sets `slow` and renders the block again with the
// exact helpers (it reads the same inputs; every output is written
// again).  The slow paths are branches, and a branch in the frame body
// keeps the compiler from overlapping one voice's chain with another's.
template <bool FAST>
__device__ __forceinline__ float div_inv(float a, float y1, float b,
                                         bool& slow) {
    if (!FAST) return kdiv_inv(a, y1, b);
    const float q0 = __fmul_rn(a, y1);          // kdiv_inv while finite
    const float q = kfma(kfma(-b, q0, a), y1, q0);
    slow = slow || !isfinite(q);
    return q;
}

// cz_warp_k over the compiled modes only, as selects
template <bool FAST>
__device__ __forceinline__ float cz_warp_fixed(int mode, float phase,
                                               const CzScales& s, float tsz,
                                               bool& slow) {
    float out = phase;
    if (CZ_MASK & (1 << 1)) {
        const float w = phase < s.d ? phase * s.s1a
                                    : kfma(phase - s.d, s.s1b, 0.5f);
        out = mode == 1 ? w : out;
    }
    if (CZ_MASK & (1 << 2)) {
        const float w = phase < 0.5f ? phase * s.sc2
                                     : kfma(-(1.0f - phase), s.sc2, 1.0f);
        out = mode == 2 ? w : out;
    }
    if (CZ_MASK & (1 << 3)) {
        const float w = phase < 0.5f ? phase * s.sc2
                                     : kfma(phase - 0.5f, s.sc2, 0.5f);
        out = mode == 3 ? w : out;
    }
    if (CZ_MASK & (1 << 4)) {
        const float w = wrap<FAST>(phase * 2.0f, 1.0f, slow);
        out = mode == 4 ? w : out;
    }
    if (CZ_MASK & (1 << 5)) {
        const float w = phase < 0.5f ? phase * s.sc2
                                     : kfma(phase - 0.5f, s.sc5b, 0.5f);
        out = mode == 5 ? w : out;
    }
    if (CZ_MASK & (1 << 6)) {
        const float w = k_fast_pow(phase, s.p6);
        out = mode == 6 ? w : out;
    }
    if (CZ_MASK & (1 << 7)) {
        const float w = k_fast_pow(phase, s.p7);
        out = mode == 7 ? w : out;
    }
    return out * tsz;
}

__device__ __forceinline__ int as_i(float x) { return __float_as_int(x); }
__device__ __forceinline__ float as_f(int x) { return __int_as_float(x); }

// States in, the frame loop, states out, for row b; returns whether a
// fast helper met an operand outside its range (FAST only).
template <bool FAST>
__device__ __forceinline__ bool run_block(const CyclicArgs& a,
                                          const float4* par4, int b,
                                          int tid) {
    const int n = a.n, B = a.rows;
    bool slow = false;
    // ---- states in, into registers ----
    float ph[K], prev[K], cur[K], pnl[K], pnr[K];
    int fin[K], hc[K];
    float hv[K], x1[K], x2[K], y1[K], y2[K], sg[K];
#pragma unroll
    for (int v = 0; v < K; ++v) {
        const int so = v * a.st_sv + b * a.st_sb;
        ph[v] = a.phase_0[so];
        prev[v] = a.sample_0[so];
        cur[v] = prev[v];
        pnl[v] = a.pan_l_0[so];
        pnr[v] = a.pan_r_0[so];
        fin[v] = FINISH ? a.finished_0[so] : 0;
        hc[v] = HOLD ? a.hold_count_0[so] : 0;
        hv[v] = HOLD ? a.hold_val_0[so] : 0.0f;
        x1[v] = FLT ? a.x1_0[so] : 0.0f;
        x2[v] = FLT ? a.x2_0[so] : 0.0f;
        y1[v] = FLT ? a.y1_0[so] : 0.0f;
        y2[v] = FLT ? a.y2_0[so] : 0.0f;
        sg[v] = SM ? a.smoother_0[so] : 0.0f;
    }
    const float vf = a.vf[b];
    float vg = a.vol_gain_0[b];
    float4 preg[K][NQ];                      // unused unless PREG
    if (PREG) {
#pragma unroll
        for (int v = 0; v < K; ++v)
#pragma unroll
            for (int q = 0; q < NQ; ++q)
                preg[v][q] = par4[(v * NQ + q) * TF + tid];
    }

    for (int t = 0; t < n; ++t) {
        const float whiteish = NOISE ? __ldg(a.noise + t) : 0.0f;
        float mix_l = 0.0f, mix_r = 0.0f;
#pragma unroll
        for (int v = 0; v < K; ++v) {
            float p[NQ * 4];
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const float4 x = PREG ? preg[v][q]
                                      : par4[(v * NQ + q) * TF + tid];
                p[4 * q] = x.x; p[4 * q + 1] = x.y;
                p[4 * q + 2] = x.z; p[4 * q + 3] = x.w;
            }
            const int fl = as_i(p[P_FLAGS]);
            const float amp = p[P_AMP];
            if (A_ALL) {                     // stub: no voice body
                cur[v] = amp;
                mix_l = mix_l + amp;
                mix_r = mix_r + amp;
                continue;
            }
            const bool active = (fl & F_LIVE) && !(FINISH && fin[v] != 0);
            // ---- mod read ----
            const float pinc = p[P_PINC];
            float g = 0.0f;
            if (FM)                          // stub: no fm read
                g = (A_READS ? 0.0f : read_src(as_i(p[P_FM]), cur, prev, v))
                    * p[P_FM + 2];
            // ---- increment ----
            float inc = pinc;
            if (FM && (fl & F_USE_FM)) inc = kfma(p[P_FM + 1], g, pinc);
            if (DIRN && (fl & F_DIRNEG)) inc = -inc;
            // ---- wrap ----
            const float lo = p[P_LO], hi = p[P_HI];
            const float phv = ph[v] + inc;
            const bool bad = !isfinite(phv);
            const bool over = phv >= hi;
            const bool under = phv < lo;
            const float r = wrap<FAST>(phv - lo, p[P_L], slow);
            const float wrap_over = lo + r;
            const float wrap_under = hi + r;
            const bool osn_b = FINISH && (fl & F_OSN);
            float ph2 = over ? (osn_b ? (FINISH ? p[P_HIOS] : 0.0f)
                                      : wrap_over)
                             : (under ? (osn_b ? lo : wrap_under) : phv);
            if (bad) ph2 = 0.0f;
            // ---- cz warp ----
            float idx_f = ph2;
            if (CZ && !A_CZ) {
                const int mode = as_i(p[P_CZ]);
                const float tsz = p[P_CZ + 1];
                CzScales s;
                if (CZM) {
                    const float rdm = read_src(as_i(p[P_CZM]), cur, prev, v);
                    const float dm = (fl & F_CM_GE) ? rdm * p[P_CZM + 2]
                                                    : 1.0f;
                    s = cz_scales(p[P_CZM + 1] + dm, EXACT, CZ_MASK);
                } else {
                    s.d = p[P_CZC]; s.s1a = p[P_CZC + 1];
                    s.s1b = p[P_CZC + 2]; s.sc2 = p[P_CZC + 3];
                    s.sc5b = p[P_CZC + 4]; s.p6 = p[P_CZC + 5];
                    s.p7 = p[P_CZC + 6];
                }
                const float phase3 = EXACT
                    ? div_inv<FAST>(ph2, p[P_CZ + 2], tsz, slow)
                    : __fdiv_rn(ph2, tsz);
                const float warped = cz_warp_fixed<FAST>(mode, phase3, s,
                                                         tsz, slow);
                if (mode != 0) idx_f = warped;
            }
            // ---- lookup ----
            int idx = (int)idx_f;
            idx = idx < 0 ? 0 : idx;
            const int clip = as_i(p[P_CLIP]);
            idx = idx > clip ? clip : idx;
            float f = A_LOOKUP ? __int_as_float(idx)    // stub: no load
                               : __ldg(a.table + (as_i(p[P_TOFF]) + idx));
            if (bad) f = 0.0f;
            bool adv = active;
            if (NOISE && (fl & F_NOISE)) {
                f = whiteish;
                adv = false;
            }
            if (adv) ph[v] = ph2;
            if (FINISH) {
                const bool fin_osc = (bad && (fl & F_ONE_SHOT))
                                     || ((over || under) && osn_b);
                if (adv && fin_osc) fin[v] = 1;
            }
            // ---- dsp ----
            float s1 = f;
            if (HOLD && !A_DSP) {
                const bool h_on = fl & F_HOLD;
                const float hv2 = (h_on && hc[v] == 0) ? f : hv[v];
                if (h_on) s1 = hv2;
                int hcn = hc[v] + 1;
                if (hcn >= as_i(p[P_HOLD])) hcn = 0;
                if (active && h_on) hc[v] = hcn;
                if (active) hv[v] = hv2;
            }
            float s2 = s1;
            if (QUANT && !A_DSP) {
                const float iv = (float)(int)kfma(s1, p[P_QUANT], 0.5f);
                if (fl & F_QUANT) s2 = iv * p[P_QUANT + 1];
            }
            float s3 = s2;
            if (FLT && !A_DSP) {
                float fv = p[P_FLT + 1] * x1[v];
                fv = kfma(p[P_FLT], s2, fv);
                fv = kfma(p[P_FLT + 2], x2[v], fv);
                fv = kfma(p[P_FLT + 3], y1[v], fv);
                fv = kfma(p[P_FLT + 4], y2[v], fv);
                const bool uf = fl & F_FLT;
                if (uf) s3 = fv;
                if (active && uf) {
                    x2[v] = x1[v]; x1[v] = s2; y2[v] = y1[v]; y1[v] = fv;
                }
            }
            // ---- gain and smoother ----
            float final_g = amp;
            if (ENV && !A_DSP) {
                const int count = a.cbase + t;
                const int env_relat = as_i(p[P_ENV + 1]);
                const float tf = (float)(count - as_i(p[P_ENV]));
                const float trf = (float)(count - env_relat);
                const float att = p[P_ENV + 2], dec = p[P_ENV + 3];
                const float sus = p[P_ENV + 4], rel = p[P_ENV + 5];
                float ev;
                if (tf < att) ev = __fdiv_rn(tf, att);
                else if (tf < p[P_ENV + 7])
                    ev = kfma(-__fdiv_rn(tf - att, dec), 1.0f - sus, 1.0f);
                else if (fl & F_NO_REL) ev = sus;
                else if (trf < rel)
                    ev = sus * (1.0f - __fdiv_rn(trf, rel));
                else ev = 0.0f;
                if (!(fl & F_ENV_ACT)) ev = 0.0f;
                const float env = (fl & F_USE_ENV) ? ev * p[P_ENV + 6]
                                                   : 1.0f;
                final_g = amp * env;
            }
            if (AM && !A_DSP) {
                float amr = read_src(as_i(p[P_AM]), cur, prev, v);
                if (AM_SELF && (fl & F_AM_SELF)) amr = s3;
                const float ampmod = (fl & F_AM_GE) ? amr * p[P_AM + 1]
                                                    : 1.0f;
                final_g = final_g * ampmod;
            }
            float final2 = final_g;
            if (SM && !A_DSP) {
                const float sg2 = kfma(p[P_SM], final_g - sg[v], sg[v]);
                const bool u_sm = fl & F_USE_SM;
                if (u_sm) final2 = sg2;
                if (active && u_sm) sg[v] = sg2;
            }
            const float sample_out = active ? s3 * final2 : 0.0f;
            cur[v] = sample_out;
            // ---- pan and mix ----
            float plv = pnl[v], prv = pnr[v];
            if (PM && !A_PAN) {
                float pmr = read_src(as_i(p[P_PM]), cur, prev, v + 1);
                if (PM_SELF && (fl & F_PM_SELF)) pmr = sample_out;
                const bool pan_on = fl & F_PAN_ON;
                const float dep = p[P_PM + 1];
                const float one_m_q = kfma(-pmr, dep, 1.0f);
                const float one_p_q = kfma(pmr, dep, 1.0f);
                if (pan_on) { plv = one_m_q * 0.5f; prv = one_p_q * 0.5f; }
                if (active && pan_on) { pnl[v] = plv; pnr[v] = prv; }
            }
            const bool contrib = active && (fl & F_DC0);
            mix_l = mix_l + (contrib ? sample_out * plv : 0.0f);
            mix_r = mix_r + (contrib ? sample_out * prv : 0.0f);
        }
        // ---- master volume ----
#pragma unroll
        for (int v = 0; v < K; ++v) prev[v] = cur[v];
        vg = kfma(0.002f, vf - vg, vg);
        a.out_l[(size_t)t * B + b] = mix_l * vg;
        a.out_r[(size_t)t * B + b] = mix_r * vg;
    }

    // ---- states out ----
#pragma unroll
    for (int v = 0; v < K; ++v) {
        const int so = v * a.st_sv + b * a.st_sb;
        a.sample_e[so] = prev[v];
        a.phase_e[so] = ph[v];
        a.pan_l_e[so] = pnl[v];
        a.pan_r_e[so] = pnr[v];
        if (FINISH) a.finished_e[so] = fin[v];
        if (HOLD) { a.hold_count_e[so] = hc[v]; a.hold_val_e[so] = hv[v]; }
        if (FLT) { a.x1_e[so] = x1[v]; a.x2_e[so] = x2[v];
                   a.y1_e[so] = y1[v]; a.y2_e[so] = y2[v]; }
        if (SM) a.smoother_e[so] = sg[v];
    }
    a.vol_gain_e[b] = vg;
    return slow;
}

__global__ void __launch_bounds__(TF)
cyclic_fixed_kernel(const CyclicArgs a) {
    extern __shared__ float4 par4[];         // [K][NQ][TF] quads
    const int tid = threadIdx.x;
    const int b = blockIdx.x * TF + tid;
    if (b >= a.rows) return;
    const int B = a.rows;

    // ---- per-voice parameter records, once per block ----
#pragma unroll
    for (int v = 0; v < K; ++v) {
        const int vo = v * B + b;
        float p[NQ * 4];
#pragma unroll
        for (int i = 0; i < NQ * 4; ++i) p[i] = 0.0f;
        const float amp = a.amp[vo];
        int fl = amp != 0.0f ? F_LIVE : 0;
        p[P_PINC] = a.pinc[vo];
        p[P_LO] = a.lo[vo];
        p[P_HI] = a.hi[vo];
        p[P_L] = a.L[vo];
        p[P_AMP] = amp;
        p[P_CLIP] = as_f(a.clip_i[vo]);
        p[P_TOFF] = as_f(a.table_off[v]);
        if (FM) {
            p[P_FM] = as_f(src_code(a.fm_osc[vo], a.fm_del[vo], v));
            p[P_FM + 1] = a.mis[vo];
            p[P_FM + 2] = a.fm_dep[vo];
            if (a.use_fm[vo] != 0) fl |= F_USE_FM;
        }
        if (DIRN && a.dirneg[vo] != 0) fl |= F_DIRNEG;
        if (FINISH) {
            p[P_HIOS] = p[P_HI] - 1e-6f;
            if (a.osn[vo] != 0) fl |= F_OSN;
            if (a.one_shot[vo] != 0) fl |= F_ONE_SHOT;
        }
        if (CZ) {
            p[P_CZ] = as_f(a.cz_mode[vo]);
            p[P_CZ + 1] = a.tsize[vo];
            p[P_CZ + 2] = a.inv_ts[vo];
        }
        if (CZM) {
            p[P_CZM] = as_f(src_code(a.cm_osc[vo], a.cm_del[vo], v));
            p[P_CZM + 1] = a.cz_dist[vo];
            p[P_CZM + 2] = a.cm_dep[vo];
            if (a.cm_ge[vo] != 0) fl |= F_CM_GE;
        }
        if (CZC) {
            const CzScales s = cz_scales(a.cz_dist[vo] + a.dm_row[vo], EXACT,
                                         CZ_MASK);
            p[P_CZC] = s.d; p[P_CZC + 1] = s.s1a; p[P_CZC + 2] = s.s1b;
            p[P_CZC + 3] = s.sc2; p[P_CZC + 4] = s.sc5b;
            p[P_CZC + 5] = s.p6; p[P_CZC + 6] = s.p7;
        }
        if (NOISE && a.is_noise[vo] != 0) fl |= F_NOISE;
        if (HOLD) {
            p[P_HOLD] = as_f(a.hmax[vo]);
            if (a.hold_on[vo] != 0) fl |= F_HOLD;
        }
        if (QUANT) {
            p[P_QUANT] = a.levels[vo];
            p[P_QUANT + 1] = a.inv_lev[vo];
            if (a.quant_on[vo] != 0) fl |= F_QUANT;
        }
        if (FLT) {
            p[P_FLT] = a.b0[vo]; p[P_FLT + 1] = a.b1[vo];
            p[P_FLT + 2] = a.b2[vo]; p[P_FLT + 3] = a.na1[vo];
            p[P_FLT + 4] = a.na2[vo];
            if (a.use_flt[vo] != 0) fl |= F_FLT;
        }
        if (ENV) {
            const int relat = a.env_relat[vo];
            p[P_ENV] = as_f(a.env_start[vo]);
            p[P_ENV + 1] = as_f(relat);
            p[P_ENV + 2] = a.att[vo]; p[P_ENV + 3] = a.dec[vo];
            p[P_ENV + 4] = a.sus[vo]; p[P_ENV + 5] = a.rel[vo];
            p[P_ENV + 6] = a.vel[vo];
            p[P_ENV + 7] = a.att[vo] + a.dec[vo];
            if (a.use_env[vo] != 0) fl |= F_USE_ENV;
            if (a.env_act[vo] != 0) fl |= F_ENV_ACT;
            if (relat == 0) fl |= F_NO_REL;
        }
        const bool dc0 = !DISC || a.disconn[vo] == 0;
        if (dc0) fl |= F_DC0;
        if (AM) {
            const int am_osc = a.am_osc[vo];
            p[P_AM] = as_f(src_code(am_osc, a.am_del[vo], v));
            p[P_AM + 1] = a.am_dep[vo];
            if (am_osc >= 0) fl |= F_AM_GE;
            if (AM_SELF && am_osc == v) fl |= F_AM_SELF;
        }
        if (PM) {
            const int pm_osc = a.pm_osc[vo];
            // the pan read comes after the voice's own sample
            p[P_PM] = as_f(src_code(pm_osc, a.pm_del[vo], v + 1));
            p[P_PM + 1] = a.pm_dep[vo];
            if (pm_osc >= 0 && dc0) fl |= F_PAN_ON;
            if (PM_SELF && a.pm_self[vo] != 0) fl |= F_PM_SELF;
        }
        if (SM) {
            p[P_SM] = a.smoothing[vo];
            if (a.use_sm[vo] != 0) fl |= F_USE_SM;
        }
        p[P_FLAGS] = as_f(fl);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
            par4[(v * NQ + q) * TF + tid] =
                make_float4(p[4 * q], p[4 * q + 1], p[4 * q + 2],
                            p[4 * q + 3]);
    }

    if (run_block<true>(a, par4, b, tid))
        run_block<false>(a, par4, b, tid);
}

// -1: the arguments are not this build's key (k, mode, features)
extern "C" int cyclic_fixed_launch(const CyclicArgs* a, void* stream) {
    const int want[] = {FM, CZ, CZM, AM, AM_SELF, PM, PM_SELF, ENV, FLT, SM,
                        HOLD, QUANT, NOISE, FINISH, DIRN, DISC};
    const int got[] = {a->has_fm, a->has_cz, a->has_czm, a->has_am,
                       a->has_am_self, a->has_pm, a->has_pm_self, a->has_env,
                       a->has_flt, a->has_sm, a->has_hold, a->has_quant,
                       a->has_noise, a->has_finish, a->has_direction,
                       a->has_disc};
    bool same = a->k == K && (a->exact != 0) == (EXACT != 0)
                && (!CZ || a->cz_mask == CZ_MASK);
    for (int i = 0; i < 16; ++i)
        same = same && (got[i] != 0) == (want[i] != 0);
    if (!same) return -1;
    const int blocks = (a->rows + TF - 1) / TF;
    if (blocks <= 0) return (int)cudaGetLastError();
    const size_t smem = (size_t)K * NQ * TF * sizeof(float4);
    if (smem > 48 * 1024) {
        // above 48 KB a block's dynamic shared memory is an opt-in
        cudaError_t rc = cudaFuncSetAttribute(
            cyclic_fixed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    cyclic_fixed_kernel<<<blocks, TF, smem, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

#endif  // CYC_K
