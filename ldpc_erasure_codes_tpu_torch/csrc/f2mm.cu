// GF(2) products of packed 0/1 matrices with word rows, one body, three
// entries:
//   x[b, e, :] = XOR over the set bits j < K of row e of M_b of rhs[b, j, :]
// with M packed (E, ceil(K/32)) words (bit j of a row is bit j & 31 of word
// j >> 5) and rhs (B, K, W) 32-bit words.
//   - ldpc_f2_matvec_launch: one M for every frame (H, the dense syndrome);
//   - ldpc_f2_matmul_launch: a matrix per frame, x written as (B, E, W);
//   - ldpc_f2_apply_launch:  a matrix per frame, row e XORed into
//     out[b, idx[b, e], :] (out holds the frame's values, erased slots
//     zero); rows whose target is outside [0, n) are dropped.
//
// Replaces the TPU kernels of ldpc_erasure_codes_tpu/ops/pallas_nbmm.py:
// f2_matvec_wide, f2_matmul_batched and f2_apply_scatter, which share the
// body _f2_matmul_body: eight int8 MXU contractions, one per bit plane of
// the byte-viewed words, with an int8 0/1 matrix, then parity; the apply
// places rows with a one-hot MXU product. A GF(2) product acts on every
// bit position alone, so XOR of whole 32-bit rows gives the same bits.
//
// What bounds it on an H100: shared-memory XORs. At the (2040,1530) GE
// point the transform apply is 448 frames x 512 rows x ~255 set bits x 256
// words ~ 1.5e10 word XORs (plus a bit scan per set bit); device memory
// sees the rhs once (0.23 GB), the matrices once per W chunk and the output
// once. The dense syndrome (K = n = 2040, ~13 bits per row) is bound by
// staging the values (0.9 GB) instead.
//
// Design: a block per (frame, chunk of WC words); it stages the chunk of
// all K rhs rows in shared memory (WC = 32 words: 65 KB at K = 510; WC
// shrinks for larger K to stay within 128 KB), then each thread owns one
// output word (row e, word w) and walks the set bits of row e with __ffs.
// The lanes that share a row read consecutive words (no bank conflict) and
// the same matrix word (a broadcast). The tensor-core route (mma b1 with
// XOR/popc) is left for a later change.
//
// The list route of the matvec (ldpc_f2_matvec_rows_launch), for sparse
// matrices such as an LDPC H (~13 set bits in 2040 per row at (2040,1530)):
// the bit scan above reads all KW matrix words of a row, and runs a
// divergent __ffs loop, for each output word, and its 128 KB staging cap
// cut the chunk to 8 words at K = 2040 with no load in flight while it
// computes. Here the host lists each row's set columns once
// (ops/nbmm.py::f2_matrix_rows, cached as CodeArrays.h_rows). A block per
// (frame, chunk of Wc words) fills a slab of all K rows with cp.async
// (slab.cuh), all copies in flight at once, stages the lists as uint16
// beside it, then each thread owns (row e, part p of the chunk) and XORs
// the len[e] listed rows from the slab, eight reads in flight: no bit scan
// and no matrix word per output word. Each output word is written once.
// What bounds it: the values read once (0.94 GB at 448 frames, W = 256);
// the lists are 13 KB per block from L2.

#include <cstdint>

#include <cuda_runtime.h>

#include "slab.cuh"
#include "words.cuh"

namespace {

constexpr int kThreads = 512;
constexpr size_t kSmemBudget = 128 * 1024;

template <bool kShared, bool kScatter>
__global__ void __launch_bounds__(kThreads)
f2mm_kernel(const int32_t* __restrict__ rhs, const uint32_t* __restrict__ mat,
            const int32_t* __restrict__ idx, int32_t* out, int K, int KW, int E, int W,
            int n, int wc_shift) {
    extern __shared__ int32_t s_rhs[];
    const int WC = 1 << wc_shift;
    const int n_chunks = (W + WC - 1) >> wc_shift;
    const int b = blockIdx.x / n_chunks;
    const int w0 = (blockIdx.x % n_chunks) << wc_shift;
    const int32_t* r = rhs + (size_t)b * K * W + w0;
    for (int i = threadIdx.x; i < K * WC; i += kThreads) {
        const int j = i >> wc_shift;
        const int w = i & (WC - 1);
        s_rhs[i] = w0 + w < W ? __ldg(r + (size_t)j * W + w) : 0;
    }
    __syncthreads();

    const uint32_t* M = mat + (kShared ? 0 : (size_t)b * E * KW);
    const int w = threadIdx.x & (WC - 1);
    const bool own = w0 + w < W;
    const int rows_per_pass = kThreads >> wc_shift;
    const uint32_t last = (K & 31) ? (1u << (K & 31)) - 1u : 0xffffffffu;
    for (int e = threadIdx.x >> wc_shift; e < E; e += rows_per_pass) {
        const uint32_t* row = M + (size_t)e * KW;
        int32_t acc = 0;
        for (int kw = 0; kw < KW; ++kw) {
            uint32_t bits = __ldg(row + kw);
            if (kw == KW - 1) bits &= last;
            const int32_t* s = s_rhs + ((kw * 32) << wc_shift) + w;
            while (bits) {
                const int j = __ffs(bits) - 1;
                bits &= bits - 1;
                acc ^= s[j << wc_shift];
            }
        }
        if (!own) continue;
        if (kScatter) {
            const int t = __ldg(idx + (size_t)b * E + e);
            if (t >= 0 && t < n) out[((size_t)b * n + t) * W + w0 + w] ^= acc;
        } else {
            out[((size_t)b * E + e) * W + w0 + w] = acc;
        }
    }
}

// log2 of the chunk width: the smallest power of two >= W (at most 32),
// halved until the K staged rows fit the shared-memory budget; -1 when
// even one word per row does not fit.
int chunk_shift(int K, int W) {
    int s = 5;
    while (s > 0 && (1 << (s - 1)) >= W) --s;
    while (s >= 0 && (size_t)K * (1u << s) * sizeof(int32_t) > kSmemBudget) --s;
    return s;
}

template <bool kShared, bool kScatter>
int launch(const int32_t* rhs, const uint32_t* mat, const int32_t* idx, int32_t* out, int B,
           int K, int KW, int E, int W, int n, cudaStream_t stream) {
    if (B == 0 || E == 0) return (int)cudaSuccess;
    const int s = chunk_shift(K, W);
    if (s < 0) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)K * (1u << s) * sizeof(int32_t);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            f2mm_kernel<kShared, kScatter>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const long long blocks = (long long)B * ((W + (1 << s) - 1) >> s);
    f2mm_kernel<kShared, kScatter><<<(unsigned)blocks, kThreads, smem, stream>>>(
        rhs, mat, idx, out, K, KW, E, W, n, s);
    return (int)cudaGetLastError();
}

constexpr int kRowsThreads = 512;

// The list route's shared memory: the slab of K rows and one zero row
// (which pad entries read) of Wc words, the lists as uint16, the lengths.
__host__ __device__ inline int rows_bytes(int K, int m, int d, int wc) {
    return 4 * (K + 1) * wc + round16(2 * m * d) + round16(2 * m);
}

// A block per (frame, chunk of VEC * P words). Entries of a list past its
// length, or outside [0, K), read the zero row K.
template <int VEC, int P>
__global__ void __launch_bounds__(kRowsThreads)
f2_rows_kernel(const int32_t* __restrict__ values, const int32_t* __restrict__ idx,
               const int32_t* __restrict__ len, int32_t* __restrict__ out, int K, int m, int d,
               int W, int n_chunks) {
    using V = Words<VEC>;
    extern __shared__ __align__(16) uint8_t smem_raw[];
    V* slab = reinterpret_cast<V*>(smem_raw);
    uint16_t* s_idx = reinterpret_cast<uint16_t*>(smem_raw + (size_t)4 * (K + 1) * VEC * P);
    uint16_t* s_len = s_idx + round16(2 * m * d) / 2;

    const int b = blockIdx.x / n_chunks;
    const int w0 = (blockIdx.x % n_chunks) * VEC * P;
    slab_load<VEC, P>(slab, values + (size_t)b * K * W + w0, K, W, w0, threadIdx.x,
                      kRowsThreads);
    if (threadIdx.x < P) slab[K * P + threadIdx.x] = V::zero();
    for (int i = threadIdx.x; i < m * d; i += kRowsThreads) {
        const int j = __ldg(idx + i);
        s_idx[i] = (uint16_t)(j >= 0 && j < K ? j : K);
    }
    for (int i = threadIdx.x; i < m; i += kRowsThreads) {
        const int l = __ldg(len + i);
        s_len[i] = (uint16_t)(l < 0 ? 0 : l > d ? d : l);
    }
    copy_async_wait();
    __syncthreads();

    int32_t* o = out + (size_t)b * m * W + w0;
    for (int i = threadIdx.x; i < m * P; i += kRowsThreads) {
        const int e = i / P, p = i % P;
        const uint16_t* row = s_idx + e * d;
        const int dl = s_len[e];
        V acc = V::zero();
        for (int j0 = 0; j0 < dl; j0 += 8) {
            int ix[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) ix[u] = j0 + u < dl ? row[j0 + u] : K;
#pragma unroll
            for (int u = 0; u < 8; ++u) acc ^= slab[ix[u] * P + p];
        }
        if (w0 + p * VEC < W) acc.store(o + (size_t)e * W + p * VEC);
    }
}

template <int VEC, int P>
cudaError_t launch_rows(const int32_t* values, const int32_t* idx, const int32_t* len,
                        int32_t* out, int B, int K, int m, int d, int W, cudaStream_t stream) {
    const size_t smem = rows_bytes(K, m, d, VEC * P);
    const auto kernel = f2_rows_kernel<VEC, P>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int n_chunks = (W + VEC * P - 1) / (VEC * P);
    kernel<<<(unsigned)((long long)B * n_chunks), kRowsThreads, smem, stream>>>(
        values, idx, len, out, K, m, d, W, n_chunks);
    return cudaGetLastError();
}

}  // namespace

// The list route: out (B, m, W) = M . values (B, K, W), row e of M given
// as its set columns idx[e, :len[e]] ((m, d) int32); Wc = wc words (4, 8
// or 16) per block. K < 65535, and the slab with the lists must fit a
// block's shared memory.
extern "C" int ldpc_f2_matvec_rows_launch(const int32_t* values, const int32_t* idx,
                                          const int32_t* len, int32_t* out, int B, int K,
                                          int m, int d, int W, int wc, cudaStream_t stream) {
    if (B == 0 || m == 0) return (int)cudaSuccess;
    if (K >= 65535 || d < 1 || rows_bytes(K, m, d, wc) > kMaxSmem)
        return (int)cudaErrorInvalidValue;
#define F2_ROWS(VEC, P) \
    return (int)launch_rows<VEC, P>(values, idx, len, out, B, K, m, d, W, stream)
    if (vec4_ok(W, {values, out})) {
        switch (wc) {
            case 4: F2_ROWS(4, 1);
            case 8: F2_ROWS(4, 2);
            case 16: F2_ROWS(4, 4);
        }
    } else {
        switch (wc) {
            case 4: F2_ROWS(1, 4);
            case 8: F2_ROWS(1, 8);
            case 16: F2_ROWS(1, 16);
        }
    }
#undef F2_ROWS
    return (int)cudaErrorInvalidValue;
}

// out (B, m, W) = H (m rows of KW words over K = n columns) . values (B, n, W).
extern "C" int ldpc_f2_matvec_launch(const int32_t* values, const uint32_t* h, int32_t* out,
                                     int B, int n, int KW, int m, int W,
                                     cudaStream_t stream) {
    return launch<true, false>(values, h, nullptr, out, B, n, KW, m, W, 0, stream);
}

// out (B, E, W) = T_b (E rows of KW words over K columns) . rhs_b (K, W).
extern "C" int ldpc_f2_matmul_launch(const int32_t* rhs, const uint32_t* t, int32_t* out,
                                     int B, int K, int KW, int E, int W,
                                     cudaStream_t stream) {
    return launch<false, false>(rhs, t, nullptr, out, B, K, KW, E, W, 0, stream);
}

// out (B, n, W), holding the values, ^= rows of T_b . rhs_b placed at idx (B, E).
extern "C" int ldpc_f2_apply_launch(const int32_t* rhs, const uint32_t* t, const int32_t* idx,
                                    int32_t* out, int B, int K, int KW, int E, int W, int n,
                                    cudaStream_t stream) {
    return launch<false, true>(rhs, t, idx, out, B, K, KW, E, W, n, stream);
}
