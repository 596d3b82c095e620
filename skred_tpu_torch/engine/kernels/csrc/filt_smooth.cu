// The filter/smoother kernel for Hopper (sm_90a): a noise-voice tier's
// serial sample & hold, quantizer, biquad and amp smoother over one
// block, one thread per lane.
//
// Replaces skred_tpu/engine/kernels.py:filt_smooth_pallas (body
// _make_fs_kernel).  Per lane and per sample (synth.c:560-592): the S&H
// refresh on its counter wrap, the bit quantizer, the biquad, the gain
// amp·env·amod (amod from the voice's own filtered sample for am-self
// lanes), the one-pole amp smoother and the dead mask; the end states of
// the stages that are on.  The arithmetic is tier.cu's phase 4, with the
// gain formed per sample as the JAX kernel forms it.
//
// Bound on this card: bytes.  Per lane-sample the kernel must read the
// oscillator sample and, where the tier has them, the envelope, the
// amp-mod stream and the alive mask (4 B each), and write the sample
// (4 B): up to 20 B per lane-sample over 3.35 TB/s.  Its real limit is
// the serial chain (hold -> quantize -> four fmas -> smoother fma) of each
// lane, so each thread keeps its lane's state in registers and walks the
// N samples once; neighbouring threads own neighbouring lanes, so every
// [N, M] read and write coalesces.
//
// Numerics are the JAX kernel's, bit for bit: __fmaf_rn where it calls
// _kfma (the quantizer always; the biquad and the smoother when exact),
// separately rounded multiply and add elsewhere.  Build with -fmad=false
// and without --use_fast_math; denormals are kept.

#include <cuda_runtime.h>

struct FiltSmoothArgs {
    int n, m, exact;
    int has_flt, has_sm, has_hold, has_quant, has_am_self, has_env, has_am,
        alive_arr;
    const float* x;         // [n, m]
    const int* alive;       // [n, m] when alive_arr, else [m]
    const float* env;       // [n, m]
    const float* amod;      // [n, m]
    const float* amp;
    const float* b0; const float* b1; const float* b2; const float* na1;
    const float* na2; const int* use_flt;
    const int* use_sm; const float* smoothing;
    const int* am_self; const float* am_depth;
    const int* hold_on; const int* hold_max;
    const int* quant_on; const float* levels; const float* inv_levels;
    const float* x1_0; const float* x2_0; const float* y1_0;
    const float* y2_0; const float* sg_0;
    const int* hc_0; const float* hv_0;
    float* out;
    float* x1_e; float* x2_e; float* y1_e; float* y2_e; float* sg_e;
    int* hc_e; float* hv_e;
};

// exact mode: fma; fast mode: separately rounded multiply and add
__device__ __forceinline__ float xfma(float a, float b, float c, int exact) {
    return exact ? __fmaf_rn(a, b, c) : __fadd_rn(__fmul_rn(a, b), c);
}

__global__ void __launch_bounds__(128) filt_smooth_kernel(
        const FiltSmoothArgs a) {
    const int m = blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= a.m) return;
    const int M = a.m;
    const int exact = a.exact;
    const float amp = a.amp[m];
    const bool alive_row = a.alive_arr ? false : a.alive[m] != 0;

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
        sg = a.sg_0[m];
    }
    bool am_self = false;
    float am_depth = 0;
    if (a.has_am_self) {
        am_self = a.am_self[m] != 0; am_depth = a.am_depth[m];
    }
    bool hold_on = false;
    int hmax = 1, hc = 0;
    float hv = 0;
    if (a.has_hold) {
        hold_on = a.hold_on[m] != 0; hmax = a.hold_max[m];
        hc = a.hc_0[m]; hv = a.hv_0[m];
    }
    bool quant_on = false;
    float levels = 0, inv_lev = 0;
    if (a.has_quant) {
        quant_on = a.quant_on[m] != 0; levels = a.levels[m];
        inv_lev = a.inv_levels[m];
    }

    for (int t = 0; t < a.n; ++t) {
        const size_t tm = (size_t)t * M + m;
        const float f_t = a.x[tm];
        const bool alive_t = a.alive_arr ? a.alive[tm] != 0 : alive_row;
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
            float iv = (float)(int)__fmaf_rn(s1, levels, 0.5f);
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
        float amod = a.has_am ? a.amod[tm] : 1.0f;
        if (a.has_am_self && am_self) amod = s3 * am_depth;
        float final_t = a.has_env ? amp * a.env[tm] : amp;
        final_t = final_t * amod;
        float final2 = final_t;
        if (a.has_sm) {
            float sg2 = xfma(smoothing, final_t - sg, sg, exact);
            if (use_sm) final2 = sg2;
            if (alive_t && use_sm) sg = sg2;
        }
        a.out[tm] = alive_t ? s3 * final2 : 0.0f;
    }

    if (a.has_flt) {
        a.x1_e[m] = x1; a.x2_e[m] = x2; a.y1_e[m] = y1; a.y2_e[m] = y2;
    }
    if (a.has_sm) a.sg_e[m] = sg;
    if (a.has_hold) { a.hc_e[m] = hc; a.hv_e[m] = hv; }
}

extern "C" int filt_smooth_launch(const FiltSmoothArgs* args, void* stream) {
    const int threads = 128;
    const int blocks = (args->m + threads - 1) / threads;
    if (blocks > 0)
        filt_smooth_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            *args);
    return (int)cudaGetLastError();
}
