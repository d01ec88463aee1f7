// Systematic triangular LDPC encode over GF(2) on packed 32-bit words.
//
// Replaces the TPU kernel ldpc_erasure_codes_tpu/ops/pallas_encode.py::
// encode_packed_vmem (bodies _make_kernel and _make_unrolled_kernel), which
// stages a tile of frames in VMEM and walks the parity rows in order.
//
// Function: out[b, :k] = src[b]; then for parity row i = 0..m-1 in order,
//   out[b, k+i] = XOR of src[b, enc_src_idx[i, :]]      (pad k: skipped)
//               ^ XOR of out[b, k+enc_par_idx[i, :]]    (pad m: skipped)
// (the reference's back-substitution p_i = H[i, :k+i] . v[:k+i]).
//
// What bounds it on an H100: device-memory bytes. Per frame it reads the k
// source symbols, writes n symbols, and re-reads about m * (row degree)
// neighbour symbols, most of which miss L2 at B = 2048 (a frame is 2 MB at
// W = 256 and thousands of frames are in flight). There is no arithmetic
// to speak of: one XOR per word read.
//
// Design: a warp per (frame, chunk of 32*VEC words); each lane owns VEC
// words of every symbol and walks the rows in order on its own words only.
// A lane only ever re-reads parity words it wrote itself, so no barrier or
// shared memory is needed, and the sequential row order costs nothing but
// latency, which the many independent warps hide. Source neighbours are
// read from the input through the read-only path.

#include <cstdint>

#include <cuda_runtime.h>

#include "words.cuh"

namespace {

constexpr int kThreads = 128;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ src_idx,
              const int32_t* __restrict__ par_idx, int32_t* __restrict__ out,
              int B, int k, int m, int W, int dmax, int pmax) {
    using V = Words<VEC>;
    constexpr int kChunk = 32 * VEC;
    const int n_chunks = (W + kChunk - 1) / kChunk;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long task = t / 32;
    if (task >= (long long)B * n_chunks) return;
    const int b = (int)(task / n_chunks);
    const int w0 = (int)(task % n_chunks) * kChunk + (int)(t % 32) * VEC;
    if (w0 >= W) return;
    const int n = k + m;
    const int32_t* s = src + (size_t)b * k * W + w0;
    int32_t* o = out + (size_t)b * n * W + w0;

#pragma unroll 4
    for (int i = 0; i < k; ++i) V::load_ro(s + (size_t)i * W).store(o + (size_t)i * W);

    for (int r = 0; r < m; ++r) {
        V acc = V::zero();
        const int32_t* si = src_idx + (size_t)r * dmax;
        for (int j = 0; j < dmax; ++j) {
            const int c = __ldg(si + j);
            if (c < k) acc ^= V::load_ro(s + (size_t)c * W);
        }
        const int32_t* pi = par_idx + (size_t)r * pmax;
        for (int j = 0; j < pmax; ++j) {
            const int p = __ldg(pi + j);
            if (p < m) acc ^= V::load(o + (size_t)(k + p) * W);
        }
        acc.store(o + (size_t)(k + r) * W);
    }
}

template <int VEC>
cudaError_t launch(const int32_t* src, const int32_t* src_idx, const int32_t* par_idx,
                   int32_t* out, int B, int k, int m, int W, int dmax, int pmax,
                   cudaStream_t stream) {
    const int n_chunks = (W + 32 * VEC - 1) / (32 * VEC);
    const long long threads = (long long)B * n_chunks * 32;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    encode_kernel<VEC><<<blocks, kThreads, 0, stream>>>(src, src_idx, par_idx, out, B, k,
                                                        m, W, dmax, pmax);
    return cudaGetLastError();
}

}  // namespace

extern "C" int ldpc_encode_launch(const int32_t* src, const int32_t* src_idx,
                                  const int32_t* par_idx, int32_t* out, int B, int k,
                                  int m, int W, int dmax, int pmax, cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (vec4_ok(W, {src, out}))
        return (int)launch<4>(src, src_idx, par_idx, out, B, k, m, W, dmax, pmax, stream);
    return (int)launch<1>(src, src_idx, par_idx, out, B, k, m, W, dmax, pmax, stream);
}

extern "C" const char* ldpc_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
