// Does nvcc contract a*b + c into one fma under the port's flags?
//
// The counterpart of tools/fma_probe.py, which asks the same of Mosaic
// for the JAX package's Pallas kernels.  The port's bit parity rests on
// that boundary: every kernel builds with -fmad=false, so that no
// multiply-add is contracted but those it spells out as __fmaf_rn (the
// JAX kernels' _kfma sites and, in both modes, their a*b + c sites;
// engine/kernels/build.py).  One thread an element writes the plain
// expression and the intrinsic; tools/fma_probe.py compares them over
// adversarial inputs, built once with the port's flags and once with
// -fmad=true (a key of its own: build.py), to show that the flag
// decides.  Bound: bytes, 20 B an element, microseconds; it is a probe,
// not a path kernel.

#include <cuda_runtime.h>

struct FmaArgs {
    int n;
    const float* a; const float* b; const float* c;
    float* plain;        // a * b + c as the compiler takes it
    float* fused;        // __fmaf_rn(a, b, c)
};

__global__ void fma_probe_kernel(const FmaArgs p) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n) return;
    const float a = p.a[i], b = p.b[i], c = p.c[i];
    p.plain[i] = a * b + c;
    p.fused[i] = __fmaf_rn(a, b, c);
}

extern "C" int fma_probe_launch(const FmaArgs* p, void* stream) {
    const int threads = 256;
    const int blocks = (p->n + threads - 1) / threads;
    if (blocks > 0)
        fma_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}
