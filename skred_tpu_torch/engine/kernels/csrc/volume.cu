// The master-volume kernel for Hopper (sm_90a): the block's volume
// smoother and its stereo output, one launch a block (volume.py: volume).
//
// Replaces no TPU kernel.  It takes the place of
// skred_tpu/engine/fused.py:_affine_scan (:167-180), the
// jax.lax.associative_scan that the block step runs at :1479-1484, which
// the port ran as some 285 torch operations a block (volume_plain): the
// host's launching of them, not the card, set the pace.  Per row b and
// sample t:
//
//     vg_t       = 0.998 * vg_{t-1} + 0.002 * volume_final     (vg_{-1}: vg0)
//     out[t,b,:] = (mix_l[t,b] * vg_t, mix_r[t,b] * vg_t)
//     vg_end[b]  = vg_{n-1}
//
// Every vg_t rounds as the associative scan's combine tree rounds it, bit
// for bit: combine(l, r) = (l.a*r.a, l.b*r.a + r.b), each product and sum
// rounded on its own (__fmul_rn, __fadd_rn; build with -fmad=false).  A
// serial recurrence would drift a few ulps from it.
//
// The tree has closed form here.  Its leaves are (a, b_0) and (a, c) for
// t >= 1, where a = 1 - 0.002 and c = 0.002 * volume_final, with b_0 =
// c + a*vg0.  So at level k of the tree (nodes over 2^k leaves), every
// node's a is A_k = A_{k-1}^2, the same for every row; every node but the
// first has b = C_k = C_{k-1}*A_{k-1} + C_{k-1}, and the first D_k =
// D_{k-1}*A_{k-1} + C_{k-1}.  The tree's scan of position t is then a
// chain over the set bits of m = t + 1 from the top one down: D at the
// top bit's level, then v = v*A_k + C_k for each lower set bit k.  That
// is the down-sweep's order (an even node combines the prefix before it
// with its own node, whose b is C_k), so each vg_t rounds as the tree
// rounds it.  A thread keeps its row's A, C and D levels in registers
// (nothing of the tree goes to memory) and runs at most log2(n)
// combines a sample.
//
// Bound on this card: bytes.  Each sample of a row reads mix_l and mix_r
// and writes the stereo pair, 16 B; at 1024 rows x 512 samples 8 MiB,
// 2.5 us at 3.35 TB/s.  Threads run along rows (a warp: 32 rows of one
// sample), so the reads and the interleaved float2 write coalesce, and a
// warp's bit chain is uniform; a block's 8 warps take 8 samples each, so
// some 64K threads keep enough loads in flight at 1024 rows.  The levels
// cost a thread about 65 operations, against its 8 samples' up to 8 x 26.
//
// With VOL_SHIM defined the thread body builds without its kernel and
// launch, for g++ and a shim that runs it thread by thread
// (tests/test_torch_volume.py).

#ifndef VOL_SHIM
#include <cuda_runtime.h>
#endif

struct VolumeArgs {
    int n, b;               // samples (1 <= n <= VOL_MAX_N), rows
    const float* mix_l;     // [n, b]
    const float* mix_r;     // [n, b]
    const float* vf;        // [b] volume_final
    const float* vg0;       // [b] the gain at the end of the last block
    float* out;             // [n, b, 2]
    float* vg_end;          // [b]
};

constexpr int VOL_MAX_N = 4096;
constexpr int LEVELS = 13;          // levels 0..12: 2^12 = VOL_MAX_N
constexpr int ROWS = 32;            // a warp's rows: threadIdx.x
constexpr int WARPS = 8;            // threadIdx.y
constexpr int STEPS = 8;            // samples a thread
constexpr int SPAN = WARPS * STEPS; // samples a block

extern "C" int volume_max_n() { return VOL_MAX_N; }

__device__ __forceinline__ float combine_b(float lb, float ra, float rb) {
    return __fadd_rn(__fmul_rn(lb, ra), rb);
}

// Row r's samples t0 + w, t0 + w + WARPS, ... (STEPS of them, below n).
__device__ __forceinline__ void volume_thread(const VolumeArgs& p, int r,
                                              int t0, int w) {
    if (r >= p.b)
        return;
    const float c = __fmul_rn(0.002f, __ldg(p.vf + r));
    float A[LEVELS], C[LEVELS], D[LEVELS];
    A[0] = __fsub_rn(1.0f, 0.002f);
    C[0] = c;
    D[0] = __fadd_rn(c, __fmul_rn(A[0], __ldg(p.vg0 + r)));
#pragma unroll
    for (int k = 1; k < LEVELS; ++k) {
        A[k] = __fmul_rn(A[k - 1], A[k - 1]);
        C[k] = combine_b(C[k - 1], A[k - 1], C[k - 1]);
        D[k] = combine_b(D[k - 1], A[k - 1], C[k - 1]);
    }
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
        const int t = t0 + i * WARPS + w;
        if (t >= p.n)
            break;
        const unsigned m = (unsigned)t + 1u;
        const int top = 31 - __clz((int)m);
        float v = D[0];
#pragma unroll
        for (int k = 1; k < LEVELS; ++k)
            if (k == top)
                v = D[k];
#pragma unroll
        for (int k = LEVELS - 2; k >= 0; --k)
            if (k < top && ((m >> k) & 1u))
                v = combine_b(v, A[k], C[k]);
        const size_t e = (size_t)t * p.b + r;
        reinterpret_cast<float2*>(p.out)[e] = make_float2(
            __fmul_rn(__ldg(p.mix_l + e), v), __fmul_rn(__ldg(p.mix_r + e), v));
        if (t == p.n - 1)
            p.vg_end[r] = v;
    }
}

#ifndef VOL_SHIM
__global__ void __launch_bounds__(ROWS * WARPS)
volume_kernel(const VolumeArgs p) {
    volume_thread(p, blockIdx.x * ROWS + threadIdx.x, blockIdx.y * SPAN,
                  threadIdx.y);
}

extern "C" int volume_launch(const VolumeArgs* args, void* stream) {
    const VolumeArgs& p = *args;
    if (p.n < 1 || p.n > VOL_MAX_N || p.b < 0)
        return (int)cudaErrorInvalidValue;
    if (p.b == 0)
        return (int)cudaGetLastError();
    const dim3 grid((p.b + ROWS - 1) / ROWS, (p.n + SPAN - 1) / SPAN);
    volume_kernel<<<grid, dim3(ROWS, WARPS), 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
#endif  // VOL_SHIM
