// Systematic triangular LDPC encode over GF(2) or GF(256) on packed 32-bit
// words.
//
// Replaces the TPU kernel ldpc_erasure_codes_tpu/ops/pallas_encode.py::
// encode_packed_vmem (bodies _make_kernel and _make_unrolled_kernel, both
// fields), which stages a tile of frames in VMEM and walks the parity rows
// in order.
//
// Function: out[b, :k] = src[b]; then for parity row i = 0..m-1 in order,
//   out[b, k+i] = XOR of src[b, enc_src_idx[i, :]]      (pad k: skipped)
//               ^ XOR of out[b, k+enc_par_idx[i, :]]    (pad m: skipped)
// (the reference's back-substitution p_i = H[i, :k+i] . v[:k+i]). In the
// GF(256) mode (kNB; four byte symbols per word) every term is first
// multiplied by its coefficient (enc_src_val, enc_par_val) and the row's sum
// by the inverse of its diagonal coefficient (enc_diag_inv)
// (ErasureCodes_NonBinaryLDPCSim.m:172-182).
//
// What bounds it on an H100: device-memory bytes. Per frame it reads the k
// source symbols, writes n symbols, and re-reads about m * (row degree)
// neighbour symbols, most of which miss L2 at B = 2048 (a frame is 2 MB at
// W = 256 and thousands of frames are in flight). There is no arithmetic
// to speak of: one XOR per word read. The GF(256) mode adds a
// double-and-add product per term (about 6 integer operations per set
// coefficient bit and doubling, for four bytes), which the same memory
// latency mostly hides.
//
// Design: a warp per (frame, chunk of 32*VEC words); each lane owns VEC
// words of every symbol and walks the rows in order on its own words only.
// A lane only ever re-reads parity words it wrote itself, so no barrier or
// shared memory is needed, and the sequential row order costs nothing but
// latency, which the many independent warps hide. Source neighbours are
// read from the input through the read-only path.

#include <cstdint>

#include <cuda_runtime.h>

#include "gf256.cuh"
#include "words.cuh"

namespace {

constexpr int kThreads = 128;

template <int VEC, bool kNB>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ src_idx,
              const int32_t* __restrict__ par_idx, const uint8_t* __restrict__ src_val,
              const uint8_t* __restrict__ par_val, const uint8_t* __restrict__ diag_inv,
              int32_t* __restrict__ out, int B, int k, int m, int W, int dmax, int pmax) {
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
            if (c >= k) continue;
            V t = V::load_ro(s + (size_t)c * W);
            if (kNB) t = gf_mul<VEC>(t, __ldg(src_val + (size_t)r * dmax + j));
            acc ^= t;
        }
        const int32_t* pi = par_idx + (size_t)r * pmax;
        for (int j = 0; j < pmax; ++j) {
            const int p = __ldg(pi + j);
            if (p >= m) continue;
            V t = V::load(o + (size_t)(k + p) * W);
            if (kNB) t = gf_mul<VEC>(t, __ldg(par_val + (size_t)r * pmax + j));
            acc ^= t;
        }
        if (kNB) acc = gf_mul<VEC>(acc, __ldg(diag_inv + r));
        acc.store(o + (size_t)(k + r) * W);
    }
}

template <int VEC, bool kNB>
cudaError_t launch(const int32_t* src, const int32_t* src_idx, const int32_t* par_idx,
                   const uint8_t* src_val, const uint8_t* par_val, const uint8_t* diag_inv,
                   int32_t* out, int B, int k, int m, int W, int dmax, int pmax,
                   cudaStream_t stream) {
    const int n_chunks = (W + 32 * VEC - 1) / (32 * VEC);
    const long long threads = (long long)B * n_chunks * 32;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    encode_kernel<VEC, kNB><<<blocks, kThreads, 0, stream>>>(
        src, src_idx, par_idx, src_val, par_val, diag_inv, out, B, k, m, W, dmax, pmax);
    return cudaGetLastError();
}

template <bool kNB>
cudaError_t launch_field(const int32_t* src, const int32_t* src_idx, const int32_t* par_idx,
                         const uint8_t* src_val, const uint8_t* par_val,
                         const uint8_t* diag_inv, int32_t* out, int B, int k, int m, int W,
                         int dmax, int pmax, cudaStream_t stream) {
    if (vec4_ok(W, {src, out}))
        return launch<4, kNB>(src, src_idx, par_idx, src_val, par_val, diag_inv, out, B, k, m,
                              W, dmax, pmax, stream);
    return launch<1, kNB>(src, src_idx, par_idx, src_val, par_val, diag_inv, out, B, k, m, W,
                          dmax, pmax, stream);
}

}  // namespace

// nb = 0: GF(2), the coefficient tables are not read; nb = 1: GF(256).
extern "C" int ldpc_encode_launch(const int32_t* src, const int32_t* src_idx,
                                  const int32_t* par_idx, const uint8_t* src_val,
                                  const uint8_t* par_val, const uint8_t* diag_inv,
                                  int32_t* out, int B, int k, int m, int W, int dmax, int pmax,
                                  int nb, cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (nb)
        return (int)launch_field<true>(src, src_idx, par_idx, src_val, par_val, diag_inv, out,
                                       B, k, m, W, dmax, pmax, stream);
    return (int)launch_field<false>(src, src_idx, par_idx, src_val, par_val, diag_inv, out, B,
                                    k, m, W, dmax, pmax, stream);
}

extern "C" const char* ldpc_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
