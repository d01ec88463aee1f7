// GF(256) products of byte matrices with wide byte rows, on packed 32-bit
// words (four payload bytes per word), three entries:
//   - ldpc_gf_matvec_tiled_launch / ldpc_gf_matvec_launch: rhs[b, i, :] =
//     sum_s coef[i, s] * y[b, idx[i, s], :], the product y . M with a
//     constant (n, m) matrix M given by the nonzero lists of its columns.
//     With the Vlist it is the syndrome H . y of the GE solver. The tiled
//     entry takes the dense RS H (ops/nbmm.py::matrix_tiles), the list
//     entry a sparse LDPC Vlist (the wrapper chooses by the lists' fill).
//   - ldpc_gf_apply_launch: out[b, idx[b, e], :] ^= sum_i T[b, e, i] *
//     rhs[b, i, :], a per-frame (E, m) byte matrix applied and its rows
//     placed in the erased slots (which hold zero); rows whose target is
//     outside [0, n) are dropped.
//   - ldpc_gf_matmul_launch: out[b, e, :] = sum_i M[b, e, i] * rhs[b, i, :],
//     the same product with its rows written in order (no placement).
//
// Replaces the TPU kernels ldpc_erasure_codes_tpu/ops/pallas_nbmm.py::
// gf_matvec_wide, gf_apply_scatter and gf_matmul_batched, which lift the
// byte matrix to its GF(2) bit image and contract eight int8 bit planes of
// the payload on the MXU (the apply places rows with a one-hot MXU
// product).
//
// gf_matvec_wide on the dense RS H. What bounds it on an H100: integer
// operations. At RS(255,192), B = 1024, 1 KB payloads, the least work is one
// XOR per set coefficient bit plus 7 doublings per output word (PERF.md's
// bound, 0.805 ms at the INT32 rate), against ~0.33 GB of memory traffic.
// The list kernel it replaced there (a warp per output row; per 32 terms,
// Horner over the coefficient bits with a ballot, __ffs and shuffle per set
// bit) took 10.341 ms on NVIDIA H100 80GB HBM3, 700 W: ~7 serial
// instructions and a shuffle latency per set bit.
//
// Design of the dense route: a register-blocked product. A thread owns one
// payload word of one frame and a tile of up to 64 output rows, whose sums
// stay in registers (the RS H's 63 rows are one tile). Per column s of the
// tile it reads y_s once, coalesced, forms its 8 multiples y * x^t (7
// doublings), and writes the 30 nonzero XOR combinations of the low four
// and of the high four into its own column of a shared-memory table (the
// "nibble products"; rows 0 and 16 hold zero). Then each row i adds
// c_is * y_s = lo[c & 15] ^ hi[c >> 4]: two table reads and one XOR, with
// the table offsets of c_is precomputed on the host and read as
// warp-uniform words. Per (row, column) that is ~4 instructions where a
// masked-XOR form (one AND-XOR per coefficient bit, y * x^t & mask(c, t))
// needs 8 plus the masks' making, and no ballot, shuffle or __ffs remains.
// Table rows are TILE_THREADS words apart, so a warp's reads of one row hit
// 32 banks.
//
// Why not tensor cores: the int8 bit-image product (the TPU's MXU form,
// pallas_nbmm.py:132-189) at that point has M = 504, K ~ 1544 and N = 2^20
// payload bytes: 1.6e12 int8 operations, ~0.82 ms at the 1979 TOPS peak,
// no better than the 0.805 ms INT32-lane bound, and it adds the payload's
// bit-plane expansion and repacking. It is a later option only if this
// kernel stays above twice its bound.
//
// The list route (sparse Vlists: each row has few terms, and a tile of rows
// shares few columns) keeps the earlier kernel: a block per (frame, chunk
// of 32 words), a warp per output row whose coefficients are uniform over
// the warp, Horner over the coefficient bits per 32 terms, the rows staged
// in shared memory where they fit. The apply's kernel (also serving
// gf_matmul_batched) has the same shape over the per-frame matrix.
//
// Measured by chip_smoke.py on NVIDIA H100 80GB HBM3, 700 W: the dense
// route 2.193 ms at RS(255,192), B = 1024, 1 KB payloads, against the
// 0.805 ms operations bound (PERF.md section 6, row 13).

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

constexpr int kTileThreads = 64;  // ops/nbmm.py::TILE_THREADS

__device__ __forceinline__ uint32_t lookup(const uint8_t* tab, uint32_t off) {
    return *reinterpret_cast<const uint32_t*>(tab + off);
}

// A block per (frame, chunk of kTileThreads words) and tile: rhs rows
// tile * R .. of the frame at this thread's word.
template <int R>
__global__ void __launch_bounds__(kTileThreads)
gf_matvec_tiled_kernel(const int32_t* __restrict__ values, const int32_t* __restrict__ cols,
                       const int32_t* __restrict__ ncols, const int32_t* __restrict__ offs,
                       int32_t* __restrict__ out, int n, int m, int W, int C) {
    __shared__ uint32_t tab[32 * kTileThreads];
    const int n_chunks = (W + kTileThreads - 1) / kTileThreads;
    const int b = blockIdx.x / n_chunks;
    const int w = (blockIdx.x % n_chunks) * kTileThreads + threadIdx.x;
    const int t = blockIdx.y;
    const bool own = w < W;
    uint32_t* tb = tab + threadIdx.x;
    const uint8_t* tbytes = reinterpret_cast<const uint8_t*>(tb);
    tb[0] = 0;
    tb[16 * kTileThreads] = 0;
    const int32_t* y = values + (size_t)b * n * W + w;
    const int32_t* cl = cols + (size_t)t * C;
    const int4* of = reinterpret_cast<const int4*>(offs + (size_t)t * C * R);
    const int nc = __ldg(ncols + t);
    uint32_t acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    uint32_t next = (own && nc > 0) ? (uint32_t)__ldg(y + (size_t)__ldg(cl) * W) : 0u;
    for (int sp = 0; sp < nc; ++sp) {
        const uint32_t x0 = next;
        if (sp + 1 < nc) next = own ? (uint32_t)__ldg(y + (size_t)__ldg(cl + sp + 1) * W) : 0u;
        const uint32_t x1 = gf_xtime4(x0), x2 = gf_xtime4(x1), x3 = gf_xtime4(x2);
        const uint32_t x4 = gf_xtime4(x3), x5 = gf_xtime4(x4), x6 = gf_xtime4(x5);
        const uint32_t x7 = gf_xtime4(x6);
        uint32_t* lo = tb;
        uint32_t* hi = tb + 16 * kTileThreads;
        const uint32_t a3 = x0 ^ x1, b3 = x4 ^ x5;
        const uint32_t a[15] = {x0, x1, a3, x2, x2 ^ x0, x2 ^ x1, x2 ^ a3, x3, x3 ^ x0, x3 ^ x1,
                                x3 ^ a3, x3 ^ x2, x3 ^ x2 ^ x0, x3 ^ x2 ^ x1, x3 ^ x2 ^ a3};
        const uint32_t h[15] = {x4, x5, b3, x6, x6 ^ x4, x6 ^ x5, x6 ^ b3, x7, x7 ^ x4, x7 ^ x5,
                                x7 ^ b3, x7 ^ x6, x7 ^ x6 ^ x4, x7 ^ x6 ^ x5, x7 ^ x6 ^ b3};
#pragma unroll
        for (int k = 0; k < 15; ++k) {
            lo[(k + 1) * kTileThreads] = a[k];
            hi[(k + 1) * kTileThreads] = h[k];
        }
        const int4* o = of + (size_t)sp * (R / 4);
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
            const int4 v = __ldg(o + q);
            const uint32_t u[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
                acc[4 * q + r] ^= lookup(tbytes, u[r] & 0xFFFFu) ^ lookup(tbytes, u[r] >> 16);
        }
    }
    if (!own) return;
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int row = t * R + i;
        if (row < m) out[((size_t)b * m + row) * W + w] = (int32_t)acc[i];
    }
}

cudaError_t opt_in(const void* kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// out (B, m, W) = the tiled matrix over values (B, n, W): T tiles of R
// (16, 32 or 64) rows, cols (T, C), ncols (T,), offs (T, C, R).
extern "C" int ldpc_gf_matvec_tiled_launch(const int32_t* values, const int32_t* cols,
                                           const int32_t* ncols, const int32_t* offs,
                                           int32_t* out, int B, int n, int m, int W, int T,
                                           int C, int R, cudaStream_t stream) {
    if (B == 0 || m == 0) return (int)cudaSuccess;
    const dim3 grid((unsigned)((long long)B * ((W + kTileThreads - 1) / kTileThreads)),
                    (unsigned)T);
    switch (R) {
        case 16:
            gf_matvec_tiled_kernel<16><<<grid, kTileThreads, 0, stream>>>(
                values, cols, ncols, offs, out, n, m, W, C);
            break;
        case 32:
            gf_matvec_tiled_kernel<32><<<grid, kTileThreads, 0, stream>>>(
                values, cols, ncols, offs, out, n, m, W, C);
            break;
        case 64:
            gf_matvec_tiled_kernel<64><<<grid, kTileThreads, 0, stream>>>(
                values, cols, ncols, offs, out, n, m, W, C);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

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
