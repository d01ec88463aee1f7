// Swap-free Gauss-Jordan elimination over GF(2) of packed-bit [A | T] rows,
// one frame per block.
//
// Replaces the TPU kernel ldpc_erasure_codes_tpu/ops/pallas_elim.py::
// f2_eliminate, which holds a (C, m_pad, 128-frame) cube in VMEM with the
// batch on the 128 lanes and walks the pivot columns in a fori_loop.
//
// Function, per frame (rows r < m of C words; bit col of a row is bit
// col & 31 of word col >> 5), for col = 0 .. ub-1:
//   1. pivot p = the first row not yet used as a pivot whose bit col is set;
//   2. mark p used; pivrow[col] = p, or 0 when there is no pivot;
//   3. every other row with bit col set XORs in row p;
//   4. failed |= (no pivot) && col < nreal.
// ub = emax, or with a_words > 0 the batch's widest residual
// min(max(nreal), emax), read from a device scalar (*ncols). With
// a_words > 0 the words w < min(col >> 5, a_words) are skipped: they hold A
// columns already eliminated, zero in the pivot row of every frame that
// has not failed (pallas_elim.py:272-287). pivrow is 0 past ub.
//
// What bounds it on an H100: not the work (at the (2040,1530) GE bucket,
// 448 frames of 510 rows x 32 words, ~7e7 word XORs, a few microseconds at
// the INT32 rate) and not the bytes (the cube in and out once, 58 MB), but
// the chain of dependent steps per column: a pivot search over the rows,
// then the update of the rows that hold the column's bit.
//
// Design: the same function computed 32 columns (one word j, a "panel") at
// a time, the blocked order of ops/elim.py::f2_eliminate_panels_reference.
// A frame is one block of 8 warps; its cube sits in dynamic shared memory
// (rows at an odd stride where that fits, so a column of 32 rows hits 32
// banks) where it fits and in device memory where it does not ((4000,2000):
// 2000 rows of up to 95 words). Per panel j:
//   1. the block copies word j of every row to a panel array and ORs it
//      (__syncthreads_or): a panel that is zero in every row finds no pivot
//      and changes nothing, so it only sets failed where 32j < nreal (at
//      the bucket about half the panels below the batch's widest residual
//      are such);
//   2. warp 0 runs the panel's column steps in registers: lane l holds the
//      panel words of rows l, l + 32, ... (R = 8..64 of them, a template
//      parameter) and a combination word S_r per row, the panel's pivots
//      whose starting rows row r has absorbed. Per column: each lane's
//      first unused candidate from a bit mask over its rows,
//      __reduce_min_sync for the pivot, two shuffles for its word and S,
//      and every row that holds the bit takes row ^= pivot word and
//      S_r ^= S_p | 1 << i: no shared-memory round trip and no barrier;
//   3. the block stages the panel's pivot rows as they were before the panel
//      (words [c0, C), c0 = min(j, a_words) with the cuts, else 0: the words
//      the column order updates for each column of the panel), in groups of
//      G words where shared memory is short, and every row with S_r != 0
//      XORs in the staged rows of S_r (a warp per row, lanes on words).
// A live panel costs four block barriers where the column order took two
// per column and a 32-row walk per warp.
//
// GF(256) (gf256_elim_kernel) replaces pallas_elim.py::gf256_eliminate, the
// elimination of ge.py::ge_solve_wide_nb, a column at a time on byte
// columns (byte col & 3 of word col >> 2, four bytes per word), one frame
// per block of 16 warps (4 for cubes of at most 128 rows), the cube in
// shared memory (rows padded to an odd stride) or in device memory, chosen
// by size. Per column:
//   1. pivot p = the first unused row whose byte col is nonzero (ballot of
//      byte != 0 per 32 rows, __ffs, atomicMin on a shared slot, double-
//      buffered; the choice of ge.py:589-594); each
//      row's byte is kept in shared memory as its elimination factor;
//   2. the pivot row, multiplied by the inverse of its pivot byte (a
//      256-entry table in device memory; the TPU computed x^254 for want
//      of gathers), goes to a shared buffer, all threads on its words;
//   3. every other row with factor f != 0 takes row ^= f * pivot_row, a
//      warp per row (f uniform across its lanes), and the pivot row takes
//      the normalised words.
// Three block barriers per column: the search, the normalised row, the
// update. The a_words cuts and the device-scalar loop bound are the binary
// kernel's. What bounds it: the double-and-add products of step 3, ~8
// doublings per word of every eliminated row (integer operations on shared
// memory); at the RS(255,192) point a frame's cube is 63 rows x 32 words
// (8 KB, shared memory), at the (2040,1530) escalation 510 rows x up to 256
// words (~520 KB, device memory).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "gf256.cuh"

namespace {

constexpr int kThreads = 512;  // the GF(256) kernel's block
constexpr unsigned kFull = 0xffffffffu;

// The GF(256) kernel's cube rows, padded to an odd stride in shared memory.
int row_stride(int C) { return C | 1; }

// The binary kernel: a block of 8 warps; warp 0 holds a frame's panel words
// in registers, R per lane (rows lane, lane + 32, ...), R = 8, 16, 32 or 64.
constexpr int kElimThreads = 256;
constexpr int kElimWarps = kElimThreads / 32;
constexpr int kMaxRows = 64 * 32;

// Shared memory of the binary kernel, in words, besides the union U: the
// panel's 32 pivot rows, the combination words, and the cube's rows at
// ``stride`` words when it lives there.
size_t elim_fixed_words(int m, int stride, bool in_smem) {
    return 32 + (size_t)m + (in_smem ? (size_t)m * stride : 0);
}

// U holds the panel words (m) while warp 0 loads them, then the staged
// pivot rows (32 x G words); G = C where that fits the device's opt-in
// limit, else the widest group that does. 0 when even G = 1 does not fit.
int staged_words(int m, int C, int stride, bool in_smem, size_t optin_bytes) {
    const size_t fixed = elim_fixed_words(m, stride, in_smem);
    const size_t room = optin_bytes / 4 > fixed ? optin_bytes / 4 - fixed : 0;
    if (room < (size_t)std::max(m, 32)) return 0;
    return (int)std::min<size_t>(C, room / 32);
}

struct ElimPlan {
    int stride = 0;  // of the cube's rows (C | 1 in shared memory where it fits)
    int G = 0;       // words per staged group; 0: does not fit
    size_t bytes = 0;
};

ElimPlan elim_plan(int m, int C, bool in_smem, size_t optin_bytes) {
    ElimPlan plan;
    for (const int stride : {in_smem ? (C | 1) : C, C}) {
        const int G = staged_words(m, C, stride, in_smem, optin_bytes);
        if (G > 0) {
            plan.stride = stride;
            plan.G = G;
            plan.bytes = 4 * (elim_fixed_words(m, stride, in_smem) + std::max(m, 32 * G));
            return plan;
        }
    }
    return plan;
}

template <int R>
using RowMask = typename std::conditional<(R > 32), unsigned long long, uint32_t>::type;

template <bool kSmem, int R>
__global__ void __launch_bounds__(kElimThreads)
elim_kernel(const uint32_t* __restrict__ in, uint32_t* out, const int32_t* __restrict__ nreal,
            const int32_t* __restrict__ ncols, int32_t* __restrict__ pivrow,
            int32_t* __restrict__ failed, int m, int C, int emax, int a_words, int stride,
            int G, bool vec4) {
    using Mask = RowMask<R>;
    extern __shared__ uint32_t smem[];
    const int b = blockIdx.x;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    int* piv = reinterpret_cast<int*>(smem);
    uint32_t* comb = smem + 32;
    uint32_t* u = comb + m;  // panel words, then staged pivot rows
    const uint32_t* src = in + (size_t)b * m * C;
    uint32_t* dst = out + (size_t)b * m * C;
    uint32_t* cube = kSmem ? u + max(m, 32 * G) : dst;
    // The frame in (16-byte pieces where the frame and its rows allow).
    if (vec4) {
#pragma unroll 4
        for (int i = threadIdx.x; i < m * C / 4; i += kElimThreads) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = (4 * i + q) / C;
                cube[(size_t)r * stride + (4 * i + q - r * C)] = w[q];
            }
        }
    } else {
        for (int i = threadIdx.x; i < m * C; i += kElimThreads) {
            const int r = i / C;
            cube[(size_t)r * stride + (i - r * C)] = src[i];
        }
    }
    __syncthreads();

    const int ub = a_words ? min(max(*ncols, 0), emax) : emax;
    const int nr = nreal[b];
    int fail = 0;  // thread 0's
    Mask used = 0;  // warp 0's: bit k of lane l is row l + 32k
    int32_t* prow_out = pivrow + (size_t)b * emax;
    for (int j = 0; 32 * j < ub; ++j) {
        const int ncol = min(32, ub - 32 * j);
        // 1. The panel words, and the zero-panel skip.
        uint32_t any = 0;
        for (int r = threadIdx.x; r < m; r += kElimThreads) {
            const uint32_t w = cube[(size_t)r * stride + j];
            u[r] = w;
            any |= w;
        }
        if (!__syncthreads_or(any != 0)) {
            if ((int)threadIdx.x < ncol) prow_out[32 * j + threadIdx.x] = 0;
            if (threadIdx.x == 0) fail |= 32 * j < nr;
            continue;
        }
        // 2. The column steps on word j, in warp 0's registers.
        if (warp == 0) {
            uint32_t pw[R], cw[R];
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const int r = 32 * k + lane;
                pw[k] = r < m ? u[r] : 0u;
                cw[k] = 0;
            }
            for (int i = 0; i < ncol; ++i) {
                Mask col = 0;
#pragma unroll
                for (int k = 0; k < R; ++k) col |= (Mask)((pw[k] >> i) & 1u) << k;
                const Mask cand = col & ~used;
                int first = 0;
                if (cand) first = R > 32 ? __ffsll((long long)cand) : __ffs((uint32_t)cand);
                const unsigned p = __reduce_min_sync(
                    kFull, cand ? (unsigned)(lane + 32 * (first - 1)) : 0xffffffffu);
                if (lane == 0) {
                    const bool has = p != 0xffffffffu;
                    prow_out[32 * j + i] = has ? (int)p : 0;
                    piv[i] = has ? (int)p : -1;
                    fail |= !has && 32 * j + i < nr;
                }
                if (p == 0xffffffffu) continue;
                const int kp = p >> 5;
                uint32_t sw = 0, sc = 0;
#pragma unroll
                for (int k = 0; k < R; ++k)
                    if (k == kp) {
                        sw = pw[k];
                        sc = cw[k];
                    }
                const uint32_t pv = __shfl_sync(kFull, sw, p & 31);
                const uint32_t ps = __shfl_sync(kFull, sc, p & 31) | (1u << i);
                const Mask self = lane == (int)(p & 31) ? (Mask)1 << kp : 0;
                used |= self;
                const Mask take = col & ~self;
#pragma unroll
                for (int k = 0; k < R; ++k)
                    if ((take >> k) & 1u) {
                        pw[k] ^= pv;
                        cw[k] ^= ps;
                    }
            }
#pragma unroll
            for (int k = 0; k < R; ++k)
                if (32 * k + lane < m) comb[32 * k + lane] = cw[k];
        }
        __syncthreads();
        // 3. The staged pivot rows into every row that absorbed them.
        const int c0 = a_words ? min(j, a_words) : 0;
        for (int g0 = c0; g0 < C; g0 += G) {
            const int gw = min(G, C - g0);
            for (int t = threadIdx.x; t < ncol * gw; t += kElimThreads) {
                const int i = t / gw;
                const int p = piv[i];
                if (p >= 0) u[i * G + (t - i * gw)] = cube[(size_t)p * stride + g0 + (t - i * gw)];
            }
            __syncthreads();
            for (int r = warp; r < m; r += kElimWarps) {
                const uint32_t s = comb[r];
                if (!s) continue;
                uint32_t* row = cube + (size_t)r * stride + g0;
                for (int w = lane; w < gw; w += 32) {
                    uint32_t acc = row[w];
                    for (uint32_t bits = s; bits; bits &= bits - 1)
                        acc ^= u[(__ffs(bits) - 1) * G + w];
                    row[w] = acc;
                }
            }
            __syncthreads();
        }
    }

    for (int col = ub + threadIdx.x; col < emax; col += kElimThreads) prow_out[col] = 0;
    if (threadIdx.x == 0) failed[b] = fail;
    if (kSmem && vec4) {
#pragma unroll 4
        for (int i = threadIdx.x; i < m * C / 4; i += kElimThreads) {
            uint32_t w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = (4 * i + q) / C;
                w[q] = cube[(size_t)r * stride + (4 * i + q - r * C)];
            }
            reinterpret_cast<uint4*>(dst)[i] = make_uint4(w[0], w[1], w[2], w[3]);
        }
    } else if (kSmem) {
        for (int i = threadIdx.x; i < m * C; i += kElimThreads) {
            const int r = i / C;
            dst[i] = cube[(size_t)r * stride + (i - r * C)];
        }
    }
}

size_t optin_bytes() {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
        return 0;
    return (size_t)optin;
}

template <bool kSmem, int R>
cudaError_t launch_rows(const uint32_t* in, uint32_t* out, const int32_t* nreal,
                        const int32_t* ncols, int32_t* pivrow, int32_t* failed, int B, int m,
                        int C, int emax, int a_words, const ElimPlan& plan,
                        cudaStream_t stream) {
    const auto kernel = elim_kernel<kSmem, R>;
    if (plan.bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.bytes);
        if (err != cudaSuccess) return err;
    }
    // 16-byte pieces where every frame starts on a 16-byte boundary.
    const bool vec4 = (size_t)m * C % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
    kernel<<<B, kElimThreads, plan.bytes, stream>>>(in, out, nreal, ncols, pivrow, failed, m,
                                                    C, emax, a_words, plan.stride, plan.G, vec4);
    return cudaGetLastError();
}

// Rows per lane of warp 0: the least of 8, 16, 32, 64 that holds m rows.
template <bool kSmem>
cudaError_t launch(const uint32_t* in, uint32_t* out, const int32_t* nreal,
                   const int32_t* ncols, int32_t* pivrow, int32_t* failed, int B, int m,
                   int C, int emax, int a_words, cudaStream_t stream) {
    const ElimPlan plan = elim_plan(m, C, kSmem, optin_bytes());
    if (plan.G < 1 || m > kMaxRows) return cudaErrorInvalidValue;
    const int chunks = (m + 31) / 32;
#define ELIM_ROWS(R) \
    launch_rows<kSmem, R>(in, out, nreal, ncols, pivrow, failed, B, m, C, emax, a_words, plan, \
                          stream)
    if (chunks <= 8) return ELIM_ROWS(8);
    if (chunks <= 16) return ELIM_ROWS(16);
    if (chunks <= 32) return ELIM_ROWS(32);
    return ELIM_ROWS(64);
#undef ELIM_ROWS
}

// Shared memory of the GF(256) kernel: used bits, the column's bytes (one
// per row, as words), two pivot slots, the normalised pivot row, and the
// cube when it lives there.
size_t gf256_smem_bytes(int m, int C, bool in_smem) {
    const size_t chunks = (m + 31) / 32;
    size_t words = chunks + (m + 3) / 4 + 2 + C;
    if (in_smem) words += (size_t)m * row_stride(C);
    return words * sizeof(uint32_t);
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
gf256_elim_kernel(const uint32_t* __restrict__ in, uint32_t* out,
                  const int32_t* __restrict__ nreal, const int32_t* __restrict__ ncols,
                  int32_t* __restrict__ pivrow, int32_t* __restrict__ failed,
                  const uint8_t* __restrict__ inv_tab, int m, int C, int emax, int a_words,
                  int stride) {
    extern __shared__ uint32_t smem[];
    const int b = blockIdx.x;
    const int nthreads = blockDim.x;
    const int nwarps = nthreads / 32;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int chunks = (m + 31) / 32;
    uint32_t* used = smem;
    uint8_t* colv = reinterpret_cast<uint8_t*>(used + chunks);
    int* piv_slot = reinterpret_cast<int*>(used + chunks + (m + 3) / 4);
    uint32_t* nrow = reinterpret_cast<uint32_t*>(piv_slot + 2);
    const uint32_t* src = in + (size_t)b * m * C;
    uint32_t* dst = out + (size_t)b * m * C;
    uint32_t* cube;
    if (kSmem) {
        cube = nrow + C;
        for (int i = threadIdx.x; i < m * C; i += nthreads) {
            const int r = i / C;
            cube[r * stride + (i - r * C)] = src[i];
        }
    } else {
        cube = dst;
        for (int i = threadIdx.x; i < m * C; i += nthreads) dst[i] = src[i];
    }
    for (int j = threadIdx.x; j < chunks; j += nthreads) used[j] = 0;
    if (threadIdx.x < 2) piv_slot[threadIdx.x] = INT_MAX;
    __syncthreads();

    const int ub = a_words ? min(max(*ncols, 0), emax) : emax;
    const int nr = nreal[b];
    int fail = 0;
    for (int col = 0; col < ub; ++col) {
        const int cw = col >> 2;
        const unsigned sh = 8u * (col & 3);
        int best = INT_MAX;
        for (int j = warp; j < chunks; j += nwarps) {
            const int r = j * 32 + lane;
            uint32_t byte = 0;
            if (r < m) {
                byte = (cube[(size_t)r * stride + cw] >> sh) & 0xFFu;
                colv[r] = (uint8_t)byte;
            }
            const uint32_t cand = __ballot_sync(0xffffffffu, byte != 0) & ~used[j];
            if (cand && best == INT_MAX) best = j * 32 + __ffs(cand) - 1;
        }
        if (lane == 0 && best != INT_MAX) atomicMin(&piv_slot[col & 1], best);
        __syncthreads();
        const int p = piv_slot[col & 1];
        const bool has = p != INT_MAX;  // the same in every thread
        if (threadIdx.x == 0) {
            piv_slot[(col + 1) & 1] = INT_MAX;  // read by nobody until the next column
            pivrow[(size_t)b * emax + col] = has ? p : 0;
            if (has) used[p >> 5] |= 1u << (p & 31);
            fail |= (!has && col < nr);
        }
        if (has) {
            const int c0 = a_words ? min(cw, a_words) : 0;
            const uint32_t pinv = __ldg(inv_tab + colv[p]);
            const uint32_t* prow = cube + (size_t)p * stride;
            for (int w = c0 + threadIdx.x; w < C; w += nthreads) nrow[w] = gf_mul4(prow[w], pinv);
            __syncthreads();
            for (int r = warp; r < m; r += nwarps) {
                uint32_t* row = cube + (size_t)r * stride;
                if (r == p) {
                    for (int w = c0 + lane; w < C; w += 32) row[w] = nrow[w];
                    continue;
                }
                const uint32_t f = colv[r];
                if (f == 0) continue;
                for (int w = c0 + lane; w < C; w += 32) row[w] ^= gf_mul4(nrow[w], f);
            }
        }
        __syncthreads();
    }

    for (int col = ub + threadIdx.x; col < emax; col += nthreads)
        pivrow[(size_t)b * emax + col] = 0;
    if (threadIdx.x == 0) failed[b] = fail;
    if (kSmem) {
        for (int i = threadIdx.x; i < m * C; i += nthreads) {
            const int r = i / C;
            dst[i] = cube[r * stride + (i - r * C)];
        }
    }
}

template <bool kSmem>
cudaError_t gf256_launch(const uint32_t* in, uint32_t* out, const int32_t* nreal,
                         const int32_t* ncols, int32_t* pivrow, int32_t* failed,
                         const uint8_t* inv_tab, int B, int m, int C, int emax, int a_words,
                         cudaStream_t stream) {
    const size_t smem = gf256_smem_bytes(m, C, kSmem);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            gf256_elim_kernel<kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int stride = kSmem ? row_stride(C) : C;
    // Small cubes (the RS point: 63 rows) take 4 warps, so that more frames
    // share an SM; the LDPC cubes take the full 16.
    const int threads = m <= 128 ? 128 : kThreads;
    gf256_elim_kernel<kSmem><<<B, threads, smem, stream>>>(
        in, out, nreal, ncols, pivrow, failed, inv_tab, m, C, emax, a_words, stride);
    return cudaGetLastError();
}
}  // namespace

// 1 when a frame's GF(256) cube of m rows x C words fits in the shared
// memory that one block of the current device may opt in to, else 0.
extern "C" int ldpc_gf256_elim_fits_smem(int m, int C) {
    return gf256_smem_bytes(m, C, true) <= optin_bytes() ? 1 : 0;
}

extern "C" int ldpc_gf256_elim_launch(const uint32_t* in, uint32_t* out, const int32_t* nreal,
                                      const int32_t* ncols, int32_t* pivrow, int32_t* failed,
                                      const uint8_t* inv_tab, int B, int m, int C, int emax,
                                      int a_words, int in_smem, cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (in_smem)
        return (int)gf256_launch<true>(in, out, nreal, ncols, pivrow, failed, inv_tab, B, m, C,
                                       emax, a_words, stream);
    return (int)gf256_launch<false>(in, out, nreal, ncols, pivrow, failed, inv_tab, B, m, C,
                                    emax, a_words, stream);
}
// 1 when a frame's cube of m rows x C words fits in the shared memory that
// one block of the current device may opt in to, else 0.
extern "C" int ldpc_elim_fits_smem(int m, int C) {
    return elim_plan(m, C, true, optin_bytes()).G > 0 ? 1 : 0;
}

extern "C" int ldpc_elim_launch(const uint32_t* in, uint32_t* out, const int32_t* nreal,
                                const int32_t* ncols, int32_t* pivrow, int32_t* failed,
                                int B, int m, int C, int emax, int a_words, int in_smem,
                                cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (in_smem)
        return (int)launch<true>(in, out, nreal, ncols, pivrow, failed, B, m, C, emax,
                                 a_words, stream);
    return (int)launch<false>(in, out, nreal, ncols, pivrow, failed, B, m, C, emax, a_words,
                              stream);
}
