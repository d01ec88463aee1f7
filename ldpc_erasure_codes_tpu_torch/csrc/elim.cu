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
// What bounds it on an H100: shared-memory passes and barriers. A frame's
// cube is m x C words, 65 KB at the (2040,1530) GE point (m = 510, emax
// 512: C = 16 + 16), and the work is up to emax passes over it, each a
// column read, two block barriers and an XOR of the pivot row into the
// rows that hold the column's bit: at most 448 x 512 x 510 x 32 ~ 3.7e9
// word XORs for the 448-frame bucket, a fraction of that in practice.
// Device memory sees the cube once in and once out.
//
// Design: the TPU's batch-on-lanes layout exists for its 128-lane vectors;
// here a frame is one block of 16 warps and its cube sits in dynamic shared
// memory (rows padded to an odd stride, so the column read of 32 rows by a
// warp hits 32 banks). A warp reads the column bit of 32 rows and ballots
// them into a bitmask; the first unused candidate comes from __ffs, and the
// block-wide first row from atomicMin on a shared slot (double-buffered, so
// one barrier separates the search from the update). In the update a warp
// owns a row and its lanes own the words. When the cube does not fit in
// shared memory ((4000,2000): m = 2000 rows of up to 95 words), the same
// kernel runs on the cube in device memory (kSmem = false), which the
// wrapper chooses by size; the bitmasks stay in shared memory.
//
// GF(256) (gf256_elim_kernel) replaces pallas_elim.py::gf256_eliminate, the
// elimination of ge.py::ge_solve_wide_nb: the same design on byte columns
// (byte col & 3 of word col >> 2, four bytes per word). Per column:
//   1. pivot p = the first unused row whose byte col is nonzero (ballot of
//      byte != 0, __ffs, atomicMin; the choice of ge.py:589-594); each
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
// words (~520 KB, device memory, chosen by size as in the binary kernel).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "gf256.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

int row_stride(int C) { return C | 1; }

size_t smem_bytes(int m, int C, bool in_smem) {
    const size_t chunks = (m + 31) / 32;
    size_t words = 2 * chunks + 2;  // used and column bitmasks, two pivot slots
    if (in_smem) words += (size_t)m * row_stride(C);
    return words * sizeof(uint32_t);
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
elim_kernel(const uint32_t* __restrict__ in, uint32_t* out, const int32_t* __restrict__ nreal,
            const int32_t* __restrict__ ncols, int32_t* __restrict__ pivrow,
            int32_t* __restrict__ failed, int m, int C, int emax, int a_words, int stride) {
    extern __shared__ uint32_t smem[];
    const int b = blockIdx.x;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int chunks = (m + 31) / 32;
    uint32_t* used = smem;
    uint32_t* colbits = used + chunks;
    int* piv_slot = reinterpret_cast<int*>(colbits + chunks);
    const uint32_t* src = in + (size_t)b * m * C;
    uint32_t* dst = out + (size_t)b * m * C;
    uint32_t* cube;
    if (kSmem) {
        cube = reinterpret_cast<uint32_t*>(piv_slot + 2);
        for (int i = threadIdx.x; i < m * C; i += kThreads) {
            const int r = i / C;
            cube[r * stride + (i - r * C)] = src[i];
        }
    } else {
        cube = dst;
        for (int i = threadIdx.x; i < m * C; i += kThreads) dst[i] = src[i];
    }
    for (int j = threadIdx.x; j < chunks; j += kThreads) used[j] = 0;
    if (threadIdx.x < 2) piv_slot[threadIdx.x] = INT_MAX;
    __syncthreads();

    const int ub = a_words ? min(max(*ncols, 0), emax) : emax;
    const int nr = nreal[b];
    int fail = 0;
    for (int col = 0; col < ub; ++col) {
        const int cw = col >> 5;
        const unsigned cb = col & 31;
        int best = INT_MAX;
        for (int j = warp; j < chunks; j += kWarps) {
            const int r = j * 32 + lane;
            const uint32_t bit = r < m ? (cube[(size_t)r * stride + cw] >> cb) & 1u : 0u;
            const uint32_t bits = __ballot_sync(0xffffffffu, bit);
            if (lane == 0) colbits[j] = bits;
            const uint32_t cand = bits & ~used[j];
            if (cand && best == INT_MAX) best = j * 32 + __ffs(cand) - 1;
        }
        if (lane == 0 && best != INT_MAX) atomicMin(&piv_slot[col & 1], best);
        __syncthreads();
        const int p = piv_slot[col & 1];
        const bool has = p != INT_MAX;
        if (threadIdx.x == 0) {
            piv_slot[(col + 1) & 1] = INT_MAX;  // read by nobody until the next column
            pivrow[(size_t)b * emax + col] = has ? p : 0;
            if (has) used[p >> 5] |= 1u << (p & 31);
            fail |= (!has && col < nr);
        }
        if (has) {
            const int c0 = a_words ? min(cw, a_words) : 0;
            const uint32_t* prow = cube + (size_t)p * stride;
            for (int r = warp; r < m; r += kWarps) {
                if (r == p || !((colbits[r >> 5] >> (r & 31)) & 1u)) continue;
                uint32_t* row = cube + (size_t)r * stride;
                for (int w = c0 + lane; w < C; w += 32) row[w] ^= prow[w];
            }
        }
        __syncthreads();
    }

    for (int col = ub + threadIdx.x; col < emax; col += kThreads)
        pivrow[(size_t)b * emax + col] = 0;
    if (threadIdx.x == 0) failed[b] = fail;
    if (kSmem) {
        for (int i = threadIdx.x; i < m * C; i += kThreads) {
            const int r = i / C;
            dst[i] = cube[r * stride + (i - r * C)];
        }
    }
}

template <bool kSmem>
cudaError_t launch(const uint32_t* in, uint32_t* out, const int32_t* nreal,
                   const int32_t* ncols, int32_t* pivrow, int32_t* failed, int B, int m,
                   int C, int emax, int a_words, cudaStream_t stream) {
    const size_t smem = smem_bytes(m, C, kSmem);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            elim_kernel<kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    // Rows in shared memory are padded to an odd stride; in device memory
    // the cube keeps its dense (m, C) layout.
    const int stride = kSmem ? row_stride(C) : C;
    elim_kernel<kSmem><<<B, kThreads, smem, stream>>>(in, out, nreal, ncols, pivrow, failed,
                                                       m, C, emax, a_words, stride);
    return cudaGetLastError();
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
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
        return 0;
    return gf256_smem_bytes(m, C, true) <= (size_t)optin ? 1 : 0;
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
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
        return 0;
    return smem_bytes(m, C, true) <= (size_t)optin ? 1 : 0;
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
