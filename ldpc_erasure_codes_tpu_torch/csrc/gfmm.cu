// GF(256) products of byte matrices with wide byte rows, on packed 32-bit
// words (four payload bytes per word), three entries:
//   - ldpc_gf_matvec_launch: rhs[b, i, :] = sum_s coef[i, s] * y[b, idx[i, s], :]
//     over each output row's list of nonzero (row, coefficient) pairs, the
//     product y . M with a constant (n, m) matrix M whose columns the lists
//     hold. With the Vlist it is the syndrome H . y of the GE solver, for the
//     sparse LDPC H and the dense RS H alike. Entries with idx outside [0, n)
//     or coef 0 add nothing.
//   - ldpc_gf_apply_launch: out[b, idx[b, e], :] ^= sum_i T[b, e, i] *
//     rhs[b, i, :], a per-frame (E, m) byte matrix applied and its rows
//     placed in the erased slots (which hold zero); rows whose target is
//     outside [0, n) are dropped.
//   - ldpc_gf_matmul_launch: out[b, e, :] = sum_i M[b, e, i] * rhs[b, i, :],
//     the same product with its rows written in order (no placement).
//
// Replaces the TPU kernels ldpc_erasure_codes_tpu/ops/pallas_nbmm.py::
// gf_matvec_wide and gf_apply_scatter, which lift the byte matrix to its
// GF(2) bit image and contract eight int8 bit planes of the payload on the
// MXU (the apply places rows with a one-hot MXU product).
//
// What bounds it on an H100: integer operations. At the RS(255,192) point
// (B = 1024, 1 KB payloads) the syndrome is 1024 x 63 rows x 192 terms x
// 256 words ~ 3.2e9 packed products against ~0.33 GB of device memory
// traffic, so it is compute-bound by two orders of magnitude over its byte
// bound. The design keeps the arithmetic to Horner's rule: per output word
// and per 32 terms, for each coefficient bit from the top down, one
// multiply-by-x of the partial sum and one XOR per term whose coefficient
// has that bit (ballot and __ffs over the lanes' coefficients, so only the
// set bits cost work), instead of a full double-and-add product per term.
// A tensor-core route (int8 bit-image products, as the TPU's MXU) is left
// for a later change.
//
// The apply's kernel also serves gf_matmul_batched (pallas_nbmm.py::
// gf_matmul_batched, ldpc_gf_matmul_launch): the same per-frame product
// with its rows written in order, (B, E, W), instead of placed.
//
// Design: a block per (frame, chunk of 32 words); a warp per output row,
// its lanes on the chunk's words, so a row's coefficients are uniform
// across the warp. The right-hand side's chunk is staged in shared memory
// (the apply: m rows; the matvec: n rows when they fit, else read through
// L1 from device memory, as for the sparse LDPC H).

#include <cstdint>

#include <cuda_runtime.h>

#include "gf256.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;                    // words per block and row
constexpr size_t kStageBudget = 96 * 1024;    // staged rows x 128 bytes

// sum over the 32 terms held by the lanes (lane t: coefficient c, the
// term's row `row`) of c * y(row), for this lane's word: Horner over the
// coefficient bits. `stage` holds rows of kChunk words (row r at r * kChunk)
// or, when null, the rows are read from `y` with row stride W.
__device__ __forceinline__ uint32_t horner32(uint32_t c, int row, const uint32_t* stage,
                                             const int32_t* y, size_t W, int lane, bool own) {
    const uint32_t any = __reduce_or_sync(0xffffffffu, c);
    if (any == 0) return 0;
    uint32_t acc = 0;
    for (int bit = 31 - __clz(any); bit >= 0; --bit) {
        acc = gf_xtime4(acc);
        uint32_t set = __ballot_sync(0xffffffffu, (c >> bit) & 1u);
        while (set) {
            const int t = __ffs(set) - 1;
            set &= set - 1;
            const int r = __shfl_sync(0xffffffffu, row, t);
            if (own)
                acc ^= stage ? stage[r * kChunk + lane] : (uint32_t)__ldg(y + r * W);
        }
    }
    return acc;
}

template <bool kStage>
__global__ void __launch_bounds__(kThreads)
gf_matvec_kernel(const int32_t* __restrict__ values, const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ coef, int32_t* __restrict__ out, int n, int m,
                 int d, int W) {
    extern __shared__ uint32_t stage[];
    const int n_chunks = (W + kChunk - 1) / kChunk;
    const int b = blockIdx.x / n_chunks;
    const int w0 = (blockIdx.x % n_chunks) * kChunk;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const bool own = w0 + lane < W;
    const int32_t* y = values + (size_t)b * n * W + w0;
    if (kStage) {
        for (int i = threadIdx.x; i < n * kChunk; i += kThreads) {
            const int r = i / kChunk, w = i % kChunk;
            stage[i] = w0 + w < W ? (uint32_t)__ldg(y + (size_t)r * W + w) : 0u;
        }
        __syncthreads();
    }
    for (int i = warp; i < m; i += kThreads / 32) {
        uint32_t acc = 0;
        for (int s0 = 0; s0 < d; s0 += 32) {
            const int s = s0 + lane;
            int row = 0;
            uint32_t c = 0;
            if (s < d) {
                row = __ldg(idx + (size_t)i * d + s);
                c = __ldg(coef + (size_t)i * d + s);
                if (row < 0 || row >= n) row = 0, c = 0;
            }
            acc ^= horner32(c, row, kStage ? stage : nullptr, y + lane, (size_t)W, lane, own);
        }
        if (own) out[((size_t)b * m + i) * W + w0 + lane] = (int32_t)acc;
    }
}

// kPlace: out (B, n, W) ^= row e at idx[b, e] (the apply); else out
// (B, E, W) = the rows (gf_matmul_batched).
template <bool kPlace>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const int32_t* __restrict__ rhs, const uint8_t* __restrict__ mats,
                const int32_t* __restrict__ idx, int32_t* __restrict__ out, int m, int E,
                int W, int n) {
    extern __shared__ uint32_t stage[];
    const int n_chunks = (W + kChunk - 1) / kChunk;
    const int b = blockIdx.x / n_chunks;
    const int w0 = (blockIdx.x % n_chunks) * kChunk;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const bool own = w0 + lane < W;
    const int32_t* r = rhs + (size_t)b * m * W + w0;
    for (int i = threadIdx.x; i < m * kChunk; i += kThreads) {
        const int j = i / kChunk, w = i % kChunk;
        stage[i] = w0 + w < W ? (uint32_t)__ldg(r + (size_t)j * W + w) : 0u;
    }
    __syncthreads();
    for (int e = warp; e < E; e += kThreads / 32) {
        size_t dst = ((size_t)b * E + e) * W;
        if (kPlace) {
            const int t = __ldg(idx + (size_t)b * E + e);
            if (t < 0 || t >= n) continue;  // a dump row: dropped
            dst = ((size_t)b * n + t) * W;
        }
        const uint8_t* row = mats + ((size_t)b * E + e) * m;
        uint32_t acc = 0;
        for (int j0 = 0; j0 < m; j0 += 32) {
            const int j = j0 + lane;
            const uint32_t c = j < m ? __ldg(row + j) : 0u;
            acc ^= horner32(c, j, stage, nullptr, 0, lane, own);
        }
        if (!own) continue;
        if (kPlace)
            out[dst + w0 + lane] ^= (int32_t)acc;
        else
            out[dst + w0 + lane] = (int32_t)acc;
    }
}

cudaError_t opt_in(const void* kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// out (B, m, W) = rows of the lists (m, d) over values (B, n, W).
extern "C" int ldpc_gf_matvec_launch(const int32_t* values, const int32_t* idx,
                                     const uint8_t* coef, int32_t* out, int B, int n, int m,
                                     int d, int W, cudaStream_t stream) {
    if (B == 0 || m == 0) return (int)cudaSuccess;
    const long long blocks = (long long)B * ((W + kChunk - 1) / kChunk);
    const size_t smem = (size_t)n * kChunk * sizeof(uint32_t);
    if (smem <= kStageBudget) {
        const cudaError_t err = opt_in((const void*)gf_matvec_kernel<true>, smem);
        if (err != cudaSuccess) return (int)err;
        gf_matvec_kernel<true><<<(unsigned)blocks, kThreads, smem, stream>>>(
            values, idx, coef, out, n, m, d, W);
    } else {
        gf_matvec_kernel<false><<<(unsigned)blocks, kThreads, 0, stream>>>(
            values, idx, coef, out, n, m, d, W);
    }
    return (int)cudaGetLastError();
}

// out (B, n, W), holding the values, ^= rows of T_b (E, m) . rhs_b placed at idx (B, E).
extern "C" int ldpc_gf_apply_launch(const int32_t* rhs, const uint8_t* mats, const int32_t* idx,
                                    int32_t* out, int B, int m, int E, int W, int n,
                                    cudaStream_t stream) {
    if (B == 0 || E == 0) return (int)cudaSuccess;
    const size_t smem = (size_t)m * kChunk * sizeof(uint32_t);
    const cudaError_t err = opt_in((const void*)gf_apply_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)B * ((W + kChunk - 1) / kChunk);
    gf_apply_kernel<true><<<(unsigned)blocks, kThreads, smem, stream>>>(rhs, mats, idx, out, m,
                                                                       E, W, n);
    return (int)cudaGetLastError();
}

// out (B, E, W) = M_b (E, m) . rhs_b (m, W) per frame, over GF(256).
extern "C" int ldpc_gf_matmul_launch(const int32_t* rhs, const uint8_t* mats, int32_t* out,
                                     int B, int m, int E, int W, cudaStream_t stream) {
    if (B == 0 || E == 0) return (int)cudaSuccess;
    const size_t smem = (size_t)m * kChunk * sizeof(uint32_t);
    const cudaError_t err = opt_in((const void*)gf_apply_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)B * ((W + kChunk - 1) / kChunk);
    gf_apply_kernel<false><<<(unsigned)blocks, kThreads, smem, stream>>>(rhs, mats, nullptr, out,
                                                                        m, E, W, 0);
    return (int)cudaGetLastError();
}
