// One modulator stream of one lane, chunk by chunk, for the port's
// chunked kernels (tier.cu, phase_walk.cu, filt_smooth.cu): the raw
// [N, M] stream or (FOLD) the source voice's column of the bank of
// earlier tiers, tier.py's fold_read_plain.
//
// A null `p` reads +0.0 (a lane whose select drops the read loads
// nothing).  Lane m (voice-major: m = v*b + row) reads column src*b +
// m % b of the bank; a source outside [0, w) reads +0.0, and every fold
// read adds +0.0, as the JAX package's one-hot product does.  A delayed
// fold lane (the serial-order rule, synth.c:526) reads its column one
// sample late: its loads are shifted by one sample, and the block's first
// sample takes the previous block's last.  The loads of a chunk depend on
// no state: a kernel issues them as soon as the chunk before has been
// read, a whole phase before their use.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

template <int T, bool FOLD>
struct Stream {
    const float* p;
    int stride;          // floats between two samples
    float prev;          // FOLD: the column's sample at t = -1
    int shift;           // FOLD: 1 on a delayed lane
    float buf[T];

    __device__ __forceinline__ void clear() {
        p = nullptr; prev = 0.0f; shift = 0;
#pragma unroll
        for (int j = 0; j < T; ++j) buf[j] = 0.0f;
    }

    __device__ __forceinline__ void raw(const float* base, int m, int M,
                                        bool on) {
        clear();
        stride = M;
        if (on) p = base + m;
    }

    // bank [N, >= w*b] with `bank_stride` floats between samples, prv its
    // samples at t = -1; on: the lane's select takes the read
    __device__ __forceinline__ void fold(const float* bank, const float* prv,
                                         int w, int bank_stride, int b,
                                         bool on, const int* src,
                                         const int* dly, int m) {
        clear();
        stride = bank_stride;
        if (!on) return;
        const int s = src[m];
        if (s < 0 || s >= w) return;
        const int c = s * b + m % b;
        p = bank + c;
        prev = prv[c];
        shift = dly[m] != 0 ? 1 : 0;
    }

    // issue the loads of the chunk that starts at t0 (none past n)
    __device__ __forceinline__ void fetch(int t0, int n) {
        if (p == nullptr || t0 >= n) return;
        const int t1 = t0 - shift;            // the sample buf[0] holds
        const float* q = p + (ptrdiff_t)t1 * (ptrdiff_t)stride;
        if (t0 + T <= n) {
#pragma unroll
            for (int j = 0; j < T; ++j)
                buf[j] = (j == 0 && t1 < 0) ? prev : __ldg(q + j * stride);
        } else {
#pragma unroll
            for (int j = 0; j < T; ++j)
                if (t0 + j < n)
                    buf[j] = (j == 0 && t1 < 0) ? prev
                                                : __ldg(q + j * stride);
        }
    }

    // the read at offset j of the chunk
    __device__ __forceinline__ float at(int j) const {
        return FOLD ? buf[j] + 0.0f : buf[j];
    }

    // the chunk is read: issue the next one's loads
    __device__ __forceinline__ void next(int t0, int n) { fetch(t0 + T, n); }
};
