// The table-lookup kernel for Hopper (sm_90a): one gather from the packed
// wavetable buffer per element, one thread per element.
//
// Replaces skred_tpu/engine/kernels.py:table_lookup_grouped (body
// _make_lut_kernel_grouped) and table_lookup_pallas (body
// _make_lut_kernel):
//
//     out[e] = 0 <= idx[e] < limit[lane] ? table[base[lane] + idx[e]] : 0
//
// where lane = (e / lane_div) % lanes.  A time-major [N, M] index block
// has lane_div = 1 (lane = e % M); the JAX kernels' lane-major [M, N]
// block has lane_div = N.  The TPU kernels DMA a lane's whole table slot
// into VMEM and resolve 128-entry rows with masked lane gathers; here the
// tables stay in global memory (a PCM table can exceed a block's shared
// memory) and each thread reads its one entry through the read-only
// cache (__ldg).  Lanes binding one table hit the same lines, which stay
// in L2 (the whole noise64 buffer is 640 KB).
//
// Bound on this card: bytes.  Per element the kernel must read the index
// (4 B) and write the sample (4 B), plus each lane's base and limit once:
// 8 B per element over 3.35 TB/s.  Consecutive threads take consecutive
// elements, so the index reads and output writes coalesce; the table
// reads are the scattered part.

#include <cuda_runtime.h>

struct LookupArgs {
    long long total;        // elements
    int lanes, lane_div;
    const float* table;
    const int* base;        // [lanes]
    const int* limit;       // [lanes]
    const int* idx;         // [total]
    float* out;             // [total]
};

__global__ void __launch_bounds__(256) lookup_kernel(const LookupArgs a) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < a.total; e += stride) {
        const int lane = (int)((e / a.lane_div) % a.lanes);
        const int i = a.idx[e];
        const int lim = __ldg(a.limit + lane);
        a.out[e] = (unsigned)i < (unsigned)lim
                       ? __ldg(a.table + ((long long)__ldg(a.base + lane) + i))
                       : 0.0f;
    }
}

extern "C" int lookup_launch(const LookupArgs* args, void* stream) {
    const int threads = 256;
    long long want = (args->total + threads - 1) / threads;
    const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
    if (blocks > 0)
        lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
