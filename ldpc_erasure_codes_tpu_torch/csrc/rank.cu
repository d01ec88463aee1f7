// Pattern-only GF(2) rank check of a frame's erased columns of H, one frame
// per block: failed = (nreal > emax) || rank(H[:, erased]) < nreal.
//
// Replaces the TPU kernel ldpc_erasure_codes_tpu/ops/pallas_ge.py::
// ge_rank_pallas, the drop-in for ops/ge.py::ge_rank_check(gf_order=2). The
// TPU kernel takes a (B, m + emax, emax) int8 augmented matrix built in HBM
// ([H columns of the erased symbols; identity rows for the pad slots]) and
// runs ge_rank_check's pivot loop on it in VMEM. Here that matrix is never
// built: erased_indices lists every real column before the pad slots, and the
// identity rows only ever pivot pad columns, so a frame fails exactly when
// its nreal real columns are linearly dependent (a real column without a
// pivot is a column in the span of the ones before it) or when it has more
// than emax of them. Only the m x nreal block is eliminated.
//
// Every route shares the set-up:
//   1. count the frame's erasures from the (B, n) mask: per 32-symbol chunk a
//      ballot and popcount, then a prefix over the chunks (one warp's scan);
//      a frame with nreal > emax fails and one with nreal = 0 passes, with
//      no matrix;
//   2. build the erased columns of H, bit-packed (column j = the frame's j-th
//      erased symbol, bit j & 31 of word j >> 5 of each of the m rows), by
//      walking each erased symbol's checks in the Clist and setting its bit
//      in those rows (atomicOr): the matrix costs
//      nreal x (symbol degree) writes, never a read of H's dense form, and
//      never a read at a pad slot's sentinel index;
// then forward elimination without swaps: for column j, the first row not
// yet used as a pivot that holds bit j; none: the frame fails and the block
// stops; else every other unused row holding bit j XORs in the pivot row's
// words j >> 5 .. (nreal-1) >> 5 (unused rows are zero in every earlier
// pivot column, so the words to the left are zero in both).
//
// What bounds it on an H100: not bytes (device memory sees the mask once,
// the erased symbols' Clist rows once and one flag per frame: 0.0004 ms for
// a 512-frame bucket) but the latency of a frame's chain of dependent column
// steps, up to emax of them. Of a bucket, most frames are empty and leave at
// once; the time is the widest eliminated frame's chain.
//
// Routes, chosen by the wrapper from the shapes (the first that fits):
//   kRegisters (rank_rows_kernel): one thread per row (m <= 1024), the row's
//      ceil(emax/32) words (at most 16) in registers. A column step is one
//      ballot per warp over its rows' bits; each warp's first candidate
//      row writes its words to a slot in shared memory and lane 0 the
//      warp's ballot; one block barrier; then every thread reads the 32
//      ballots with one load a lane and one ballot, takes the first warp
//      that has a candidate (so the pivot is the first candidate row, as in
//      the column step) and XORs the pivot's words into its own row if it
//      is a candidate. One barrier per column and no loop over rows: every
//      row updates at once. The slots and ballots alternate between two
//      buffers, so the next column's writes never meet this column's reads.
//   kSmem (rank_kernel<true>), where the register route does not fit and
//      the matrix fits in shared memory ((4000,2000) at emax 128 or 256:
//      2000 rows; (2000,1000) at emax 1024: 33 words a row): 256 threads,
//      the matrix in shared memory (rows padded to an odd stride, so a
//      warp's column read hits 32 banks). A column step scans the rows 32 at
//      a time (a ballot per warp, atomicMin across warps), waits at a
//      barrier, then each warp walks its candidate rows one after another
//      with the lanes over the pivot's words, and waits at a second barrier.
//   kDevice (rank_kernel<false>), for the rest ((4000,2000) at emax 1024:
//      2000 rows x 33 words, 264 KB): the same column step on a scratch
//      matrix in device memory.
// At (2040,1530) emax 256 on 9b's 512-frame bucket (NVIDIA H100 80GB HBM3,
// 700 W) the register route takes 0.067 ms, 0.26 us per column step of the
// widest frame (255 steps); the 256-thread column step took 0.266 ms with
// its matrix in shared memory, about 1.0 us a step (PERF.md section 6, row
// 16).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

enum Route { kRegisters = 0, kSmem = 1, kDevice = 2 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // the column-step routes
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 1024;  // the register route: a thread per row

int row_stride(int wa) { return wa | 1; }

// The register route's words per row: ceil(emax/32) rounded up to a power
// of two (a template argument).
int row_words(int emax) {
    const int wa = (emax + 31) / 32;
    return wa <= 1 ? 1 : wa <= 2 ? 2 : wa <= 4 ? 4 : wa <= 8 ? 8 : wa <= 16 ? 16 : 0;
}

// The column-step routes: used and column bitmasks (m bits each), two pivot
// slots, nreal, the per-chunk erasure counts of the mask, and the matrix
// (wa words a row) when it lives here.
size_t smem_bytes(int n, int m, int wa, bool in_smem) {
    size_t words = 2 * (size_t)((m + 31) / 32) + 3 + (n + 31) / 32;
    if (in_smem) words += (size_t)m * row_stride(wa);
    return words * sizeof(uint32_t);
}

// The register route: for each of two buffers 32 pivot slots of NW words
// (first, so 16-byte aligned) and 32 warp ballots, then the per-chunk
// erasure counts, nreal and the matrix for the build (stride NW | 1).
size_t rows_smem_bytes(int n, int m, int nw) {
    return (2 * 32 * (size_t)nw + 2 * 32 + (n + 31) / 32 + 1 + (size_t)m * row_stride(nw)) *
           sizeof(uint32_t);
}

int optin_smem() {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
        return 0;
    return optin;
}

bool route_fits(int route, int n, int m, int emax) {
    switch (route) {
        case kRegisters: {
            const int nw = row_words(emax);
            return m <= kMaxRows && nw > 0 && rows_smem_bytes(n, m, nw) <= (size_t)optin_smem();
        }
        case kSmem: return smem_bytes(n, m, (emax + 31) / 32, true) <= (size_t)optin_smem();
        case kDevice: return smem_bytes(n, m, 0, false) <= 48 * 1024;
    }
    return false;
}

// Step 1, by every thread of the block: chunk_base[j] = the erasures of
// chunks before j, *nreal_s = the frame's erasures. Ends at a barrier.
__device__ void count_erasures(const uint8_t* er, int n, int* chunk_base, int* nreal_s) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
    const int nch = (n + 31) / 32;
    for (int j = warp; j < nch; j += warps) {
        const int s = j * 32 + lane;
        const uint32_t bits = __ballot_sync(kFull, s < n && er[s]);
        if (lane == 0) chunk_base[j] = __popc(bits);
    }
    __syncthreads();
    if (warp == 0) {
        int carry = 0;
        for (int j0 = 0; j0 < nch; j0 += 32) {
            const int j = j0 + lane;
            const int v = j < nch ? chunk_base[j] : 0;
            int incl = v;
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(kFull, incl, o);
                if (lane >= o) incl += u;
            }
            if (j < nch) chunk_base[j] = carry + incl - v;
            carry += __shfl_sync(kFull, incl, 31);
        }
        if (lane == 0) *nreal_s = carry;
    }
    __syncthreads();
}

// Step 2, by every thread of the block, on a zeroed matrix (row stride
// `stride` words): each erased symbol's bit set in its checks' rows.
__device__ void build_columns(const uint8_t* er, int n, int m, int cmax,
                              const int32_t* __restrict__ clist_idx,
                              const int32_t* __restrict__ clist_len, const int* chunk_base,
                              uint32_t* mat, int stride) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
    for (int j = warp; j < (n + 31) / 32; j += warps) {
        const int s = j * 32 + lane;
        const bool e = s < n && er[s];
        const uint32_t bits = __ballot_sync(kFull, e);
        if (!e) continue;
        const int col = chunk_base[j] + __popc(bits & ((1u << lane) - 1u));
        const uint32_t bit = 1u << (col & 31);
        const int deg = __ldg(clist_len + s);
        for (int t = 0; t < deg; ++t) {
            const int c = __ldg(clist_idx + (size_t)s * cmax + t);
            if (c >= 0 && c < m) atomicOr(mat + (size_t)c * stride + (col >> 5), bit);
        }
    }
}

// A row's NW words to or from a pivot slot, 16 bytes at a time where NW
// allows. The whole row moves: words left of the current column's are zero
// in the pivot and in every unused row, and words past the real block's
// are zero everywhere.
template <int NW>
__device__ __forceinline__ void put_row(uint32_t* dst, const uint32_t (&a)[NW]) {
    if constexpr (NW % 4 == 0) {
#pragma unroll
        for (int k = 0; k < NW; k += 4)
            reinterpret_cast<uint4*>(dst)[k / 4] = make_uint4(a[k], a[k + 1], a[k + 2], a[k + 3]);
    } else {
#pragma unroll
        for (int k = 0; k < NW; ++k) dst[k] = a[k];
    }
}
template <int NW>
__device__ __forceinline__ void xor_row(uint32_t (&a)[NW], const uint32_t* src) {
    if constexpr (NW % 4 == 0) {
#pragma unroll
        for (int k = 0; k < NW; k += 4) {
            const uint4 v = reinterpret_cast<const uint4*>(src)[k / 4];
            a[k] ^= v.x, a[k + 1] ^= v.y, a[k + 2] ^= v.z, a[k + 3] ^= v.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < NW; ++k) a[k] ^= src[k];
    }
}

// The register route: a block of ceil(m / 32) warps, thread r holding row r
// in a[0 .. NW-1]; rows past m are zero and never pivot.
template <int NW>
__global__ void __launch_bounds__(kMaxRows)
rank_rows_kernel(const uint8_t* __restrict__ erased, const int32_t* __restrict__ clist_idx,
                 const int32_t* __restrict__ clist_len, uint8_t* __restrict__ failed, int n,
                 int m, int cmax, int emax) {
    extern __shared__ uint32_t smem[];
    constexpr int stride = NW | 1;
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const int warp = r / 32, lane = r % 32, warps = blockDim.x / 32;
    uint32_t* slots = smem;                   // [2][32][NW]
    uint32_t* ballots = slots + 2 * 32 * NW;  // [2][32]
    int* chunk_base = reinterpret_cast<int*>(ballots + 2 * 32);
    int* nreal_s = chunk_base + (n + 31) / 32;
    uint32_t* mat = reinterpret_cast<uint32_t*>(nreal_s + 1);
    const uint8_t* er = erased + (size_t)b * n;

    count_erasures(er, n, chunk_base, nreal_s);
    const int nreal = *nreal_s;
    if (nreal > emax || nreal == 0) {
        if (r == 0) failed[b] = nreal > emax;
        return;  // the whole block: no barrier follows
    }
    const int nw = (nreal + 31) / 32;  // the words of the real block
    for (int i = r; i < m * nw; i += blockDim.x) {
        const int row = i / nw;
        mat[(size_t)row * stride + (i - row * nw)] = 0u;
    }
    __syncthreads();
    build_columns(er, n, m, cmax, clist_idx, clist_len, chunk_base, mat, stride);
    __syncthreads();
    uint32_t a[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) a[k] = (r < m && k < nw) ? mat[(size_t)r * stride + k] : 0u;

    bool used = false;
    int fail = 0, buf = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
        if (fail || w >= nw) break;  // the same in every thread
        const int cols = min(32, nreal - 32 * w);
        for (int bit = 0; bit < cols; ++bit) {
            const bool cand = !used && ((a[w] >> bit) & 1u);
            const unsigned bal = __ballot_sync(kFull, cand);
            const int first = __ffs(bal) - 1;  // this warp's first candidate lane
            if (lane == 0) ballots[buf * 32 + warp] = bal;
            if (lane == first) put_row<NW>(slots + (buf * 32 + warp) * NW, a);
            __syncthreads();
            const unsigned has = __ballot_sync(kFull, lane < warps && ballots[buf * 32 + lane]);
            if (has == 0) {  // read alike by every thread
                fail = 1;
                break;
            }
            const int pw = __ffs(has) - 1;  // the pivot's warp
            if (warp == pw && lane == first) {
                used = true;
            } else if (cand) {
                xor_row<NW>(a, slots + (buf * 32 + pw) * NW);
            }
            buf ^= 1;
        }
    }
    if (r == 0) failed[b] = (uint8_t)fail;
}

template <int NW>
cudaError_t launch_rows(const uint8_t* erased, const int32_t* clist_idx,
                        const int32_t* clist_len, uint8_t* failed, int B, int n, int m,
                        int cmax, int emax, cudaStream_t stream) {
    const size_t smem = rows_smem_bytes(n, m, NW);
    const auto kernel = rank_rows_kernel<NW>;
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kernel<<<B, (m + 31) / 32 * 32, smem, stream>>>(erased, clist_idx, clist_len, failed, n, m,
                                                    cmax, emax);
    return cudaGetLastError();
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
rank_kernel(const uint8_t* __restrict__ erased, const int32_t* __restrict__ clist_idx,
            const int32_t* __restrict__ clist_len, uint32_t* __restrict__ scratch,
            uint8_t* __restrict__ failed, int n, int m, int cmax, int emax, int stride) {
    extern __shared__ uint32_t smem[];
    const int b = blockIdx.x;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int chunks = (m + 31) / 32;
    const int nch = (n + 31) / 32;
    uint32_t* used = smem;
    uint32_t* colbits = used + chunks;
    int* piv_slot = reinterpret_cast<int*>(colbits + chunks);
    int* nreal_s = piv_slot + 2;
    int* chunk_base = nreal_s + 1;
    uint32_t* mat = kSmem ? reinterpret_cast<uint32_t*>(chunk_base + nch)
                          : scratch + (size_t)b * m * stride;
    const uint8_t* er = erased + (size_t)b * n;

    if (threadIdx.x == 0) piv_slot[0] = piv_slot[1] = INT_MAX;
    count_erasures(er, n, chunk_base, nreal_s);
    const int nreal = *nreal_s;
    if (nreal > emax || nreal == 0) {
        if (threadIdx.x == 0) failed[b] = nreal > emax;
        return;  // the whole block: no barrier follows
    }
    const int nw = (nreal + 31) / 32;  // the words of the real block

    for (int i = threadIdx.x; i < m * nw; i += kThreads) {
        const int r = i / nw;
        mat[(size_t)r * stride + (i - r * nw)] = 0u;
    }
    for (int j = threadIdx.x; j < chunks; j += kThreads) used[j] = 0u;
    __syncthreads();
    build_columns(er, n, m, cmax, clist_idx, clist_len, chunk_base, mat, stride);
    __syncthreads();

    int fail = 0;
    for (int col = 0; col < nreal; ++col) {
        const int cw = col >> 5;
        const unsigned cb = col & 31;
        int best = INT_MAX;
        for (int j = warp; j < chunks; j += kWarps) {
            const int r = j * 32 + lane;
            const uint32_t bit = r < m ? (mat[(size_t)r * stride + cw] >> cb) & 1u : 0u;
            const uint32_t cand = __ballot_sync(kFull, bit) & ~used[j];
            if (lane == 0) colbits[j] = cand;
            if (cand && best == INT_MAX) best = j * 32 + __ffs(cand) - 1;
        }
        if (lane == 0 && best != INT_MAX) atomicMin(&piv_slot[col & 1], best);
        __syncthreads();
        const int p = piv_slot[col & 1];
        if (p == INT_MAX) {  // the same in every thread
            fail = 1;
            break;
        }
        if (threadIdx.x == 0) {
            piv_slot[(col + 1) & 1] = INT_MAX;  // read by nobody until the next column
            used[p >> 5] |= 1u << (p & 31);
        }
        const uint32_t* prow = mat + (size_t)p * stride;
        for (int j = warp; j < chunks; j += kWarps) {
            uint32_t rows = colbits[j];
            if (j == (p >> 5)) rows &= ~(1u << (p & 31));
            while (rows) {
                const int r = j * 32 + __ffs(rows) - 1;
                rows &= rows - 1;
                uint32_t* row = mat + (size_t)r * stride;
                for (int w = cw + lane; w < nw; w += 32) row[w] ^= prow[w];
            }
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) failed[b] = (uint8_t)fail;
}

template <bool kSmem>
cudaError_t launch_columns(const uint8_t* erased, const int32_t* clist_idx,
                           const int32_t* clist_len, uint32_t* scratch, uint8_t* failed, int B,
                           int n, int m, int cmax, int emax, cudaStream_t stream) {
    const int wa = (emax + 31) / 32;
    const size_t smem = smem_bytes(n, m, wa, kSmem);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            rank_kernel<kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    rank_kernel<kSmem><<<B, kThreads, smem, stream>>>(erased, clist_idx, clist_len, scratch,
                                                      failed, n, m, cmax, emax, row_stride(wa));
    return cudaGetLastError();
}

}  // namespace

// 1 when route (0 registers, 1 shared memory, 2 device memory) takes a
// frame of n symbols, m rows and emax columns on the current device, else 0.
extern "C" int ldpc_rank_fits(int route, int n, int m, int emax) {
    return route_fits(route, n, m, emax) ? 1 : 0;
}

// Words of device-memory scratch per frame for the device-memory route.
extern "C" int ldpc_rank_scratch_words(int m, int emax) {
    return m * row_stride((emax + 31) / 32);
}

// failed (B,) uint8 from erased (B, n) uint8 0/1 by `route`; scratch (B, m,
// stride) words for the device-memory route (else unused).
extern "C" int ldpc_rank_launch(const uint8_t* erased, const int32_t* clist_idx,
                                const int32_t* clist_len, uint32_t* scratch, uint8_t* failed,
                                int B, int n, int m, int cmax, int emax, int route,
                                cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (!route_fits(route, n, m, emax)) return (int)cudaErrorInvalidValue;
    if (route == kSmem)
        return (int)launch_columns<true>(erased, clist_idx, clist_len, scratch, failed, B, n, m,
                                         cmax, emax, stream);
    if (route == kDevice)
        return (int)launch_columns<false>(erased, clist_idx, clist_len, scratch, failed, B, n, m,
                                          cmax, emax, stream);
#define RANK_ROWS(NW)                                                                          \
    return (int)launch_rows<NW>(erased, clist_idx, clist_len, failed, B, n, m, cmax, emax, \
                                stream)
    switch (row_words(emax)) {
        case 1: RANK_ROWS(1);
        case 2: RANK_ROWS(2);
        case 4: RANK_ROWS(4);
        case 8: RANK_ROWS(8);
        case 16: RANK_ROWS(16);
    }
#undef RANK_ROWS
    return (int)cudaErrorInvalidValue;
}
