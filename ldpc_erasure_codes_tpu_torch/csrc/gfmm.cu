// GF(256) products of byte matrices with wide byte rows, on packed 32-bit
// words (four payload bytes per word), three entries:
//   - ldpc_gf_matvec_tiled_launch / ldpc_gf_matvec_launch: rhs[b, i, :] =
//     sum_s coef[i, s] * y[b, idx[i, s], :], the product y . M with a
//     constant (n, m) matrix M given by the nonzero lists of its columns.
//     With the Vlist it is the syndrome H . y of the GE solver. The tiled
//     entry takes the dense RS H (ops/nbmm.py::matrix_tiles), the list
//     entry a sparse LDPC Vlist (the wrapper chooses by the lists' fill).
//   - ldpc_gf_apply_launch: out = values with row e of T_b . rhs_b XORed
//     into symbol idx[b, e], a per-frame (E, m) byte matrix applied and its
//     rows placed in the erased slots (which hold zero); rows whose target
//     is outside [0, n) are dropped.
//   - ldpc_gf_matmul_launch: out[b, e, :] = sum_i M[b, e, i] * rhs[b, i, :],
//     the apply's product over every row, written in order (no placement).
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
// "nibble products", gf256.cuh's nibble_products; rows 0 and 16 hold
// zero). Then each row i adds c_is * y_s = lo[c & 15] ^ hi[c >> 4]: two
// table reads and one XOR, with the table offsets of c_is precomputed on
// the host and read as warp-uniform words. Per (row, column) that is ~4 instructions where a
// masked-XOR form (one AND-XOR per coefficient bit, y * x^t & mask(c, t))
// needs 8 plus the masks' making, and no ballot, shuffle or __ffs remains.
// Table rows are kTileThreads words apart, so a warp's reads of one row hit
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
// in shared memory where they fit.
//
// The transform apply (gf_apply_tiled_kernel). At RS(255,192), B = 1024,
// 1 KB payloads (m = E = 63), i.i.d. PER .15 places ~38 of a frame's 63
// rows. What bounds it on an H100: device memory, the frame's values
// copied to the output and the rhs read once (0.61 GB, PERF.md's bound
// 0.181 ms); the placed rows' Horner work is ~0.1 ms at the INT32 rate.
// The kernel it replaced (the list route's body over the per-frame matrix,
// with placement: a warp per row, Horner with a ballot, __ffs and shuffle
// per set coefficient bit, after a separate clone of the values) took 1.242
// ms on NVIDIA H100 80GB HBM3, 700 W. Design, a block per (frame, chunk of
// kTileThreads words, tile of R placed rows; R = 16 up to E = 16, else 32,
// chosen on the host):
//   1. the frame's placed rows (target in [0, n)) are listed first, in row
//      order, by one warp's ballots over the targets staged in shared
//      memory, with the targets as a bit per symbol; the tile takes places
//      t * R .. of that list, so dropped rows are never computed;
//   2. every block copies 1 / (chunks x tiles) of the frame's symbols that
//      are not targets to the output, whole rows, 16 bytes a lane where
//      aligned; a block whose tile holds no placed row does only this;
//   3. the dense route's product over the tile's rows (tile_rows, shared
//      with gf_matmul_batched): per column i the thread reads rhs[b, i, w]
//      (the next row prefetched), writes its nibble products, and each
//      placed row adds two table reads. The coefficients are per frame, so
//      the block stages the table offsets of its rows for a panel of kPanel
//      columns in shared memory (read as warp-uniform 16-byte words), and
//      rows past the tile's count are skipped four at a time. Tiles of 64
//      rows (the dense route's) ran slower than two of 32 at every shape
//      tried, RS's and the NB escalation's: the 96 registers a thread needs
//      for 64 sums leave too few warps an SM to cover the table reads;
//   4. each placed row is written once, values[idx] ^ sum; no other write
//      touches it.
//
// The in-order product (gf_matmul_tiled_kernel, gf_matmul_batched). At
// RS(255,192), B = 1024, 1 KB payloads, all 63 rows of every frame: what
// bounds it on an H100 is integer operations, one XOR per set coefficient
// bit plus 7 doublings per output word (PERF.md's bound, 0.155 ms), against
// ~0.13 GB of memory traffic. The kernel it replaced (the list route's body:
// a warp per row, Horner with a ballot, __ffs and shuffle per set bit) took
// 1.622 ms on NVIDIA H100 80GB HBM3, 700 W. Design: the apply's steps 3-4
// without the listing, the targets or the copy. A block per (frame, chunk
// of kTileThreads words, tile t of R rows) takes rows t * R .. min(E, (t +
// 1) * R) - 1 in order (R = 16 up to E = 16, else 32, chosen on the host as
// the apply's), runs tile_rows over them, and writes each sum once. Its
// shared memory is the table and a panel's offsets only (12 KB at R = 32),
// so one route serves every E and m.
//
// Measured by chip_smoke.py on NVIDIA H100 80GB HBM3, 700 W: the dense
// route 2.193 ms at RS(255,192), B = 1024, 1 KB payloads, against the
// 0.805 ms operations bound (PERF.md section 6, row 13); the apply 0.479 ms
// there (700.00 W), against its 0.181 ms byte bound: its copy alone 0.199
// ms beside a clone's 0.180, its rows alone 0.382 ms. The in-order product
// 0.496 ms there (700.00 W; 1.630 before, in the same call), against its
// 0.155 ms operations bound (row 14), with the apply unchanged at 0.471.

#include <cstdint>

#include <cuda_runtime.h>

#include "gf256.cuh"
#include "slab.cuh"

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

constexpr int kTileThreads = 64;  // ops/nbmm.py::TILE_THREADS
constexpr int kTabBytes = 4 * 32 * kTileThreads;
constexpr int kPanel = 32;        // ops/nbmm.py::GF_APPLY_PANEL

// The nibble-product table (nibble_products, nibble_product, nibble_offsets
// in gf256.cuh, shared with csrc/elim.cu's GF(256) kernel): each thread's
// column of 32 rows kTileThreads words apart.

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
        nibble_products(tb, x0, kTileThreads);
        const int4* o = of + (size_t)sp * (R / 4);
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
            const int4 v = __ldg(o + q);
            acc[4 * q] ^= nibble_product(tbytes, (uint32_t)v.x);
            acc[4 * q + 1] ^= nibble_product(tbytes, (uint32_t)v.y);
            acc[4 * q + 2] ^= nibble_product(tbytes, (uint32_t)v.z);
            acc[4 * q + 3] ^= nibble_product(tbytes, (uint32_t)v.w);
        }
    }
    if (!own) return;
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int row = t * R + i;
        if (row < m) out[((size_t)b * m + row) * W + w] = (int32_t)acc[i];
    }
}

// The product of both tiled entries: acc[r] = sum_i mf[row r, i] * rhs[i]
// at this thread's word, for the tile's `rows` rows of the frame's (E, m)
// matrix mf, row r being rows_e[r] (the apply's placed rows) or, where
// rows_e is null, e0 + r (rows in order). y points at rhs row 0 of the
// frame at this thread's word. Per column i the thread reads rhs[i] (the
// next row prefetched) and writes its nibble products into its column of
// the table; each row adds two table reads, four rows at a time, rows past
// `rows` skipped four at a time. The coefficients are per frame, so the
// block stages the table offsets of its rows for a panel of kPanel columns
// in shared memory (read as warp-uniform 16-byte words). smem holds the
// table (kTabBytes) and then the panel's offsets (4 kPanel R bytes). Every
// thread of the block calls it: it holds barriers.
template <int R>
__device__ __forceinline__ void tile_rows(uint32_t (&acc)[R], uint8_t* smem, const int32_t* y,
                                          const uint8_t* mf, const int* rows_e, int e0, int rows,
                                          int m, int W, bool own) {
    uint32_t* tb = reinterpret_cast<uint32_t*>(smem) + threadIdx.x;
    uint32_t* offs = reinterpret_cast<uint32_t*>(smem + kTabBytes);
    const uint8_t* tbytes = reinterpret_cast<const uint8_t*>(tb);
    tb[0] = 0;
    tb[16 * kTileThreads] = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    uint32_t next = (own && m > 0) ? (uint32_t)__ldg(y) : 0u;
    for (int p0 = 0; p0 < m; p0 += kPanel) {
        const int pc = min(kPanel, m - p0);
        __syncthreads();  // the previous panel's offsets are read
        for (int i = threadIdx.x; i < pc * R; i += kTileThreads) {
            const int col = i / R, r = i % R;
            const int e = rows_e ? rows_e[r] : e0 + r;
            const uint32_t c = r < rows ? __ldg(mf + (size_t)e * m + p0 + col) : 0u;
            offs[i] = nibble_offsets(c, kTileThreads);
        }
        __syncthreads();
        for (int sp = 0; sp < pc; ++sp) {
            const uint32_t x0 = next;
            if (p0 + sp + 1 < m) next = own ? (uint32_t)__ldg(y + (size_t)(p0 + sp + 1) * W) : 0u;
            nibble_products(tb, x0, kTileThreads);
            const uint4* o = reinterpret_cast<const uint4*>(offs + sp * R);
#pragma unroll
            for (int q = 0; q < R / 4; ++q) {
                if (4 * q < rows) {
                    const uint4 u = o[q];
                    acc[4 * q] ^= nibble_product(tbytes, u.x);
                    acc[4 * q + 1] ^= nibble_product(tbytes, u.y);
                    acc[4 * q + 2] ^= nibble_product(tbytes, u.z);
                    acc[4 * q + 3] ^= nibble_product(tbytes, u.w);
                }
            }
        }
    }
}

// out (B, E, W) = M_b . rhs_b, the rows in order (gf_matmul_batched): a
// block per (frame, chunk of kTileThreads words) and tile t, rows t * R ..
// min(E, (t + 1) * R) - 1, each sum written once. Its shared memory is the
// table and a panel's offsets at every E and m.
template <int R>
__global__ void __launch_bounds__(kTileThreads)
gf_matmul_tiled_kernel(const int32_t* __restrict__ rhs, const uint8_t* __restrict__ mats,
                       int32_t* __restrict__ out, int m, int E, int W, int n_chunks) {
    __shared__ __align__(16) uint8_t smem[kTabBytes + 4 * kPanel * R];
    const int b = blockIdx.x / n_chunks;
    const int w = (blockIdx.x % n_chunks) * kTileThreads + threadIdx.x;
    const int e0 = blockIdx.y * R;
    const int rows = min(R, E - e0);
    const bool own = w < W;
    uint32_t acc[R];
    tile_rows<R>(acc, smem, rhs + (size_t)b * m * W + w, mats + (size_t)b * E * m, nullptr, e0,
                 rows, m, W, own);
    if (!own) return;
    int32_t* o = out + ((size_t)b * E + e0) * W + w;
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (r < rows) o[(size_t)r * W] = (int32_t)acc[r];
}

// The apply's shared memory: the nibble-product table, the offsets of a
// panel of kPanel columns for R rows, the tile's placed rows, their count,
// every row's target, and a bit per symbol (set where a row is placed).
__host__ __device__ inline int apply_bytes(int E, int n, int R) {
    return kTabBytes + 4 * kPanel * R + round16(4 * R) + 16 + round16(4 * E) +
           round16(4 * ((n + 31) / 32));
}

// A block per (frame, chunk of kTileThreads words) and tile t of R placed
// rows (csrc header, the transform apply). VEC: the copy's words per lane.
template <int R, int VEC>
__global__ void __launch_bounds__(kTileThreads)
gf_apply_tiled_kernel(const int32_t* __restrict__ values, const int32_t* __restrict__ rhs,
                      const uint8_t* __restrict__ mats, const int32_t* __restrict__ idx,
                      int32_t* __restrict__ out, int m, int E, int W, int n, int n_chunks,
                      int copy) {
    extern __shared__ __align__(16) uint8_t smem_raw[];
    int* rows_e = reinterpret_cast<int*>(smem_raw + kTabBytes + 4 * kPanel * R);
    int* count = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(rows_e) + round16(4 * R));
    int* to = count + 4;
    const int nw = (n + 31) / 32;
    uint32_t* targets = reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(to) +
                                                    round16(4 * E));
    const int chunk = blockIdx.x % n_chunks;
    const int b = blockIdx.x / n_chunks;
    const int t = blockIdx.y;

    // 1. The placed rows in row order (every block of the frame lists the
    //    same), this tile's share of them, and the targets as bits.
    for (int i = threadIdx.x; i < E; i += kTileThreads) to[i] = __ldg(idx + (size_t)b * E + i);
    for (int i = threadIdx.x; i < nw; i += kTileThreads) targets[i] = 0;
    __syncthreads();
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        int base = 0;
        for (int e0 = 0; e0 < E; e0 += 32) {
            const int e = e0 + lane;
            const int s = e < E ? to[e] : -1;
            const bool keep = s >= 0 && s < n;
            const uint32_t bal = __ballot_sync(0xffffffffu, keep);
            if (keep) {
                atomicOr(targets + (s >> 5), 1u << (s & 31));
                const int q = base + __popc(bal & ((1u << lane) - 1u)) - t * R;
                if (q >= 0 && q < R) rows_e[q] = e;
            }
            base += __popc(bal);
        }
        if (lane == 0) *count = base;
    }
    __syncthreads();
    const int rows = min(R, *count - t * R);

    // 2. This block's share of the frame's symbols, all but the targets:
    //    step 4 writes those, so no barrier orders the two.
    if (copy) {
        const int part = t * n_chunks + chunk, parts = gridDim.y * n_chunks;
        const int s0 = (int)((long long)part * n / parts);
        const int s1 = (int)((long long)(part + 1) * n / parts);
        const int wv = W / VEC;
        const int32_t* vf = values + (size_t)b * n * W;
        int32_t* of = out + (size_t)b * n * W;
#pragma unroll 4
        for (int i = threadIdx.x; i < (s1 - s0) * wv; i += kTileThreads) {
            const int s = s0 + i / wv;
            const size_t off = (size_t)s * W + (i % wv) * VEC;
            if (!((targets[s >> 5] >> (s & 31)) & 1u))
                Words<VEC>::load_ro(vf + off).store(of + off);
        }
    }
    if (rows <= 0) return;

    // 3. The tile's placed rows (tile_rows).
    const int w = chunk * kTileThreads + threadIdx.x;
    const bool own = w < W;
    uint32_t acc[R];
    tile_rows<R>(acc, smem_raw, rhs + (size_t)b * m * W + w, mats + (size_t)b * E * m, rows_e, 0,
                 rows, m, W, own);

    // 4. Each placed row, once: values[idx] ^ its sum.
    if (!own) return;
    const int32_t* vf = values + (size_t)b * n * W + w;
    int32_t* of = out + (size_t)b * n * W + w;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (r < rows) {
            const size_t off = (size_t)to[rows_e[r]] * W;
            of[off] = __ldg(vf + off) ^ (int32_t)acc[r];
        }
    }
}

cudaError_t opt_in(const void* kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int R, int VEC>
cudaError_t launch_apply(const int32_t* values, const int32_t* rhs, const uint8_t* mats,
                         const int32_t* idx, int32_t* out, int B, int m, int E, int W, int n,
                         int copy, cudaStream_t stream) {
    const size_t smem = apply_bytes(E, n, R);
    const auto kernel = gf_apply_tiled_kernel<R, VEC>;
    const cudaError_t err = opt_in((const void*)kernel, smem);
    if (err != cudaSuccess) return err;
    const int n_chunks = (W + kTileThreads - 1) / kTileThreads;
    const int tiles = E > 0 ? (E + R - 1) / R : 1;
    const dim3 grid((unsigned)((long long)B * n_chunks), (unsigned)tiles);
    kernel<<<grid, kTileThreads, smem, stream>>>(values, rhs, mats, idx, out, m, E, W, n,
                                                 n_chunks, copy);
    return cudaGetLastError();
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

// out (B, n, W) = values (B, n, W) with row e of T_b (E, m) . rhs_b (m, W)
// XORed into symbol idx[b, e] where that lies in [0, n); tiles of R (16
// or 32) placed rows. copy = 0 leaves the symbols that are not targets
// unwritten (the rows alone, for timing). The block must fit shared memory.
extern "C" int ldpc_gf_apply_launch(const int32_t* values, const int32_t* rhs,
                                    const uint8_t* mats, const int32_t* idx, int32_t* out, int B,
                                    int m, int E, int W, int n, int R, int copy,
                                    cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (apply_bytes(E, n, R) > kMaxSmem) return (int)cudaErrorInvalidValue;
#define GF_APPLY(R_, VEC) \
    return (int)launch_apply<R_, VEC>(values, rhs, mats, idx, out, B, m, E, W, n, copy, stream)
    if (vec4_ok(W, {values, out})) {
        switch (R) {
            case 16: GF_APPLY(16, 4);
            case 32: GF_APPLY(32, 4);
        }
    } else {
        switch (R) {
            case 16: GF_APPLY(16, 1);
            case 32: GF_APPLY(32, 1);
        }
    }
#undef GF_APPLY
    return (int)cudaErrorInvalidValue;
}

// out (B, E, W) = M_b (E, m) . rhs_b (m, W) per frame, over GF(256), the
// rows in order; tiles of R (16 or 32) rows.
extern "C" int ldpc_gf_matmul_launch(const int32_t* rhs, const uint8_t* mats, int32_t* out,
                                     int B, int m, int E, int W, int R, cudaStream_t stream) {
    if (R != 16 && R != 32) return (int)cudaErrorInvalidValue;
    if (B == 0 || E == 0 || W == 0) return (int)cudaSuccess;
    const int n_chunks = (W + kTileThreads - 1) / kTileThreads;
    const dim3 grid((unsigned)((long long)B * n_chunks), (unsigned)((E + R - 1) / R));
    switch (R) {
        case 16:
            gf_matmul_tiled_kernel<16><<<grid, kTileThreads, 0, stream>>>(rhs, mats, out, m, E, W,
                                                                          n_chunks);
            break;
        case 32:
            gf_matmul_tiled_kernel<32><<<grid, kTileThreads, 0, stream>>>(rhs, mats, out, m, E, W,
                                                                          n_chunks);
            break;
    }
    return (int)cudaGetLastError();
}
