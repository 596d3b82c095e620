// The table-lookup kernel for Hopper (sm_90a): wavetable reads from the
// packed table buffer.
//
// Replaces skred_tpu/engine/kernels.py:table_lookup_grouped (body
// _make_lut_kernel_grouped) and table_lookup_pallas (body
// _make_lut_kernel), and serves the noise pass's time-major form:
//
//     out = 0 <= idx < limit[lane] ? table[base[lane] + idx] : 0
//
// on an index block that is time-major [n, m] (lanes last, the noise
// pass) or lane-major [m, n] (the JAX kernels' layout).  The TPU kernels
// DMA a lane's whole slot into VMEM and resolve 128-entry rows with
// masked lane gathers; here the tables stay in global memory and every
// gather goes through the read-only path, served from L1 and L2 (noise64's
// whole buffer is 640 KB, a 32768-sample slot 128 KB).
//
// Bound on this card: bytes.  The function must read each index (4 B) and
// write each sample (4 B), plus each lane's base and limit once: 8 B an
// element over 3.35 TB/s.
//
// What held the first kernel back (one element a thread in a grid-stride
// loop): each thread had one 4-byte index load in flight, followed by its
// dependent gather and store, and every element paid a 64-bit divide and
// modulo for its lane and reloaded the lane's base and limit: 76 SASS
// instructions an element, an issue floor above the bytes bound.
//
// This design: one kernel per layout, so no element divides.
// * Time-major: a thread owns 4 consecutive lanes, loads their base and
//   limit once (one 16-byte vector each) and walks batches of U rows, a
//   batch per gridDim.y; per row one int4 index load (streaming: read
//   once), 4 gathers and one float4 store.  The grid is 2-D, lane quads by
//   batch rows, as many blocks as the card holds at once.
// * Lane-major: a warp owns a lane row (base and limit uniform, loaded
//   once) and walks it in int4 vectors, U a thread in flight; the index
//   loads take no L1 line, which the table's lines need.
// Index arithmetic is 32-bit (the wrapper refuses 2^31 elements); only
// the final address is 64-bit.  Lanes not a multiple of 4 (rows not a
// multiple of 4, lane-major), or a pointer not 16-byte aligned, take the
// same kernel with scalar loads and stores.
//
// Not taken (A/B on the card): a block's slot staged into shared memory
// by one TMA bulk copy (cp.async.bulk with an mbarrier), lane-major: it
// copies a whole slot for the few gathers of a block's 8 lane rows (128 KB
// for 16 KB of gathers at 32768-sample slots) and lost.  Neither did the
// largest L1 carveout, nor a batch of indices loaded a batch ahead.

#include <cuda_runtime.h>
#include <stdint.h>

struct LookupArgs {
    int n, m;               // idx is [n, m], or [m, n] with lane_major
    int lane_major;
    const float* table;
    const int* base;        // [m]
    const int* limit;       // [m]
    const int* idx;
    float* out;             // idx's shape
};

constexpr int U = 4;                // vectors a thread has in flight
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Elements a thread handles in one pass of either vector kernel's main
// loop (U vectors of 4), for counting SASS instructions an element.
extern "C" int lookup_step_elements() { return 4 * U; }

// One index vector of a lane row, through the read-only path without a
// line in L1, which the lane-major gathers need for the table.
__device__ __forceinline__ int4 load_row4(const int* p) {
    int4 v;
    asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
}

// limit <= 0 reads nothing: clamping it to 0 once lets one unsigned
// compare stand for 0 <= i < lim
__device__ __forceinline__ float gather(const float* table, int b, int lim,
                                        int i) {
    return (unsigned)i < (unsigned)lim ? __ldg(table + (b + i)) : 0.0f;
}

__device__ __forceinline__ float4 gather4(const float* table, const int* b,
                                          const int* lim, int4 i) {
    return make_float4(gather(table, b[0], lim[0], i.x),
                       gather(table, b[1], lim[1], i.y),
                       gather(table, b[2], lim[2], i.z),
                       gather(table, b[3], lim[3], i.w));
}

// A thread's rows come in batches of U, gridDim.y batches apart, so that
// every thread has the same number of batches give or take one.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
lookup_time_major_kernel(const LookupArgs a) {
    const int m0 = 4 * (blockIdx.x * THREADS + threadIdx.x);
    if (m0 >= a.m)
        return;
    int b[4], lim[4];
    if (VEC) {
        const int4 bv = __ldg(reinterpret_cast<const int4*>(a.base + m0));
        const int4 lv = __ldg(reinterpret_cast<const int4*>(a.limit + m0));
        b[0] = bv.x, b[1] = bv.y, b[2] = bv.z, b[3] = bv.w;
        lim[0] = lv.x, lim[1] = lv.y, lim[2] = lv.z, lim[3] = lv.w;
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const bool in = m0 + j < a.m;
            b[j] = in ? __ldg(a.base + m0 + j) : 0;
            lim[j] = in ? __ldg(a.limit + m0 + j) : 0;
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
        lim[j] = max(lim[j], 0);
    const int row = a.m;
    const unsigned full = a.n - a.n % U;    // rows in whole batches
    const unsigned step = gridDim.y * U;
    unsigned r = blockIdx.y * U;
    const int lanes = min(4, a.m - m0);
    if (VEC) {
#pragma unroll 1
        for (; r < full; r += step) {
            const int e = r * row + m0;
            int4 iv[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
                iv[u] = __ldcs(reinterpret_cast<const int4*>(
                    a.idx + (e + u * row)));
#pragma unroll
            for (int u = 0; u < U; ++u)
                *reinterpret_cast<float4*>(a.out + (e + u * row)) =
                    gather4(a.table, b, lim, iv[u]);
        }
    } else {
#pragma unroll 1
        for (; r < full; r += step) {
            const int e = r * row + m0;
            int iv[U][4];
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    iv[u][j] = j < lanes ? __ldg(a.idx + (e + u * row + j))
                                         : -1;
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (j < lanes)
                        a.out[e + u * row + j] =
                            gather(a.table, b[j], lim[j], iv[u][j]);
        }
    }
    // the last, partial batch: its first row is `full`
#pragma unroll 1
    for (unsigned rr = r; rr < (unsigned)a.n; ++rr) {
        const int e = rr * row + m0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (j < lanes)
                a.out[e + j] = gather(a.table, b[j], lim[j],
                                      __ldg(a.idx + (e + j)));
    }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
lookup_lane_major_kernel(const LookupArgs a) {
    const int m = blockIdx.x * WARPS + threadIdx.x / 32;
    if (m >= a.m)
        return;
    const int t = threadIdx.x % 32;
    const int b0 = __ldg(a.base + m), l = max(__ldg(a.limit + m), 0);
    const int b[4] = {b0, b0, b0, b0}, lim[4] = {l, l, l, l};
    const int e0 = m * a.n;         // the lane row's first element
    if (VEC) {
        const int nv = a.n / 4;     // once a thread: vectors in the row
        int v = t;
#pragma unroll 1
        for (; v + 32 * (U - 1) < nv; v += 32 * U) {
            int4 iv[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
                iv[u] = load_row4(a.idx + (e0 + 4 * (v + 32 * u)));
#pragma unroll
            for (int u = 0; u < U; ++u)
                *reinterpret_cast<float4*>(a.out + (e0 + 4 * (v + 32 * u)))
                    = gather4(a.table, b, lim, iv[u]);
        }
#pragma unroll 1
        for (; v < nv; v += 32)
            *reinterpret_cast<float4*>(a.out + (e0 + 4 * v)) = gather4(
                a.table, b, lim, load_row4(a.idx + (e0 + 4 * v)));
    } else {
        int k = t;
#pragma unroll 1
        for (; k + 32 * (U - 1) < a.n; k += 32 * U) {
            int iv[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
                iv[u] = __ldg(a.idx + (e0 + k + 32 * u));
#pragma unroll
            for (int u = 0; u < U; ++u)
                a.out[e0 + k + 32 * u] = gather(a.table, b0, l, iv[u]);
        }
#pragma unroll 1
        for (; k < a.n; k += 32)
            a.out[e0 + k] = gather(a.table, b0, l,
                                   __ldg(a.idx + (e0 + k)));
    }
}

static bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Blocks of a time-major kernel that fit on the card at once, per device.
template <bool VEC>
static int wave() {
    static int blocks[64];
    int dev = 0;
    cudaGetDevice(&dev);
    int& w = blocks[dev < 64 ? dev : 63];
    if (!w) {
        int sms = 0, per_sm = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, lookup_time_major_kernel<VEC>, THREADS, 0);
        w = sms * (per_sm > 0 ? per_sm : 1);
    }
    return w;
}

template <bool VEC>
static void launch_time_major(const LookupArgs& a, cudaStream_t stream) {
    const int quads = (a.m + 3) / 4;
    const int bx = (quads + THREADS - 1) / THREADS;
    // as many batch rows of blocks as one wave holds beside the lane
    // blocks, at most one a batch
    const int batches = (a.n + U - 1) / U;
    int by = wave<VEC>() / bx;
    by = by < 1 ? 1 : by > batches ? batches : by > 65535 ? 65535 : by;
    lookup_time_major_kernel<VEC><<<dim3(bx, by), THREADS, 0, stream>>>(a);
}

extern "C" int lookup_launch(const LookupArgs* args, void* stream) {
    const LookupArgs& a = *args;
    cudaStream_t s = (cudaStream_t)stream;
    if (a.n <= 0 || a.m <= 0)
        return (int)cudaGetLastError();
    const bool ptrs = aligned16(a.idx) && aligned16(a.out);
    if (a.lane_major) {
        const int blocks = (a.m + WARPS - 1) / WARPS;
        if (ptrs && a.n % 4 == 0)
            lookup_lane_major_kernel<true><<<blocks, THREADS, 0, s>>>(a);
        else
            lookup_lane_major_kernel<false><<<blocks, THREADS, 0, s>>>(a);
    } else if (ptrs && a.m % 4 == 0 && aligned16(a.base)
               && aligned16(a.limit)) {
        launch_time_major<true>(a, s);
    } else {
        launch_time_major<false>(a, s);
    }
    return (int)cudaGetLastError();
}
