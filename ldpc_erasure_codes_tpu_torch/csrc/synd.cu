// GF(2) syndrome of packed words through the code's topology, the walk
// route of ops/synd.py::syndrome_from_topo:
//   rhs[b, c, :] = XOR over j < vlist_len[c] of values[b, vlist_idx[c, j], :]
// with values (B, n, W) and rhs (B, m, W), 32-bit words.
//
// syndrome_from_topo (the counterpart of the TPU kernel
// ldpc_erasure_codes_tpu/ops/pallas_synd.py::f2_syndrome_tiled) runs
// f2_matvec_wide's list route (csrc/f2mm.cu) with the Vlist as its row
// lists wherever that route's slab fits; this kernel is kept for the
// shapes where none does (n >= 65535, checks wider than n / 8, a slab over
// shared memory even at 4 words: ops/synd.py::synd_route). Erased slots
// hold zero (the repo's invariant), so H . y over all neighbours is the
// known-only sum and no masking is needed.
//
// Design: a warp owns one (frame, chunk of 32*VEC words) and walks the
// checks in order; each lane XORs and stores its own VEC words, so every
// row access is a coalesced 512-byte transaction (VEC = 4) and no barrier
// is needed. The Vlist is read through the read-only cache (the same index
// for every lane: a broadcast).
//
// What bounds it on an H100: memory latency, not bandwidth. Each check is a
// chain of ~13 dependent index-then-row loads, one in flight at a time, and
// at the (2040,1530) GE bucket (448 frames, W = 256) there are 896 warps
// for the card, about 7 per SM: 2.116 ms against the 0.349 ms byte bound,
// where the list route takes 0.534 ms on the same operands (chip_smoke.py
// phase 5 on NVIDIA H100 80GB HBM3, 700.00 W). It stays only as the route
// for the shapes the slab cannot take.

#include <cstdint>

#include <cuda_runtime.h>

#include "words.cuh"

namespace {

constexpr int kThreads = 128;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
synd_kernel(const int32_t* __restrict__ values, const int32_t* __restrict__ vlist_idx,
            const int32_t* __restrict__ vlist_len, int32_t* __restrict__ out, int B, int n,
            int m, int dmax, int W) {
    using V = Words<VEC>;
    constexpr int kChunk = 32 * VEC;
    const int n_chunks = (W + kChunk - 1) / kChunk;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long task = t / 32;
    if (task >= (long long)B * n_chunks) return;
    const int b = (int)(task / n_chunks);
    const int w0 = (int)(task % n_chunks) * kChunk + (int)(t % 32) * VEC;
    if (w0 >= W) return;
    const int32_t* v = values + (size_t)b * n * W + w0;
    int32_t* o = out + (size_t)b * m * W + w0;
    for (int c = 0; c < m; ++c) {
        const int32_t* nb = vlist_idx + (size_t)c * dmax;
        const int d = __ldg(vlist_len + c);
        V acc = V::zero();
        for (int j = 0; j < d; ++j) acc ^= V::load_ro(v + (size_t)__ldg(nb + j) * W);
        acc.store(o + (size_t)c * W);
    }
}

template <int VEC>
cudaError_t launch(const int32_t* values, const int32_t* vlist_idx, const int32_t* vlist_len,
                   int32_t* out, int B, int n, int m, int dmax, int W, cudaStream_t stream) {
    const int n_chunks = (W + 32 * VEC - 1) / (32 * VEC);
    const long long threads = (long long)B * n_chunks * 32;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    synd_kernel<VEC><<<blocks, kThreads, 0, stream>>>(values, vlist_idx, vlist_len, out, B,
                                                      n, m, dmax, W);
    return cudaGetLastError();
}

}  // namespace

extern "C" int ldpc_synd_launch(const int32_t* values, const int32_t* vlist_idx,
                                const int32_t* vlist_len, int32_t* out, int B, int n, int m,
                                int dmax, int W, cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (vec4_ok(W, {values, out}))
        return (int)launch<4>(values, vlist_idx, vlist_len, out, B, n, m, dmax, W, stream);
    return (int)launch<1>(values, vlist_idx, vlist_len, out, B, n, m, dmax, W, stream);
}
