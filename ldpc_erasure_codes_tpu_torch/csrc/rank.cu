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
// Design, per block (one frame):
//   1. count the frame's erasures from the (B, n) mask: per 32-symbol chunk a
//      ballot and popcount, then a prefix over the chunks (thread 0); a frame
//      with nreal > emax fails and one with nreal = 0 passes, with no matrix;
//   2. build the erased columns of H, bit-packed (column j = the frame's j-th
//      erased symbol, bit j & 31 of word j >> 5 of each of the m rows), by
//      walking each erased symbol's checks in the Clist and setting its bit
//      in those rows (shared-memory atomicOr): the matrix costs
//      nreal x (symbol degree) writes, never a read of H's dense form, and
//      never a read at a pad slot's sentinel index;
//   3. forward elimination without swaps: for column j, the first row not
//      yet used as a pivot that holds bit j (a warp ballots 32 rows, __ffs,
//      atomicMin across warps); none: the frame fails and the block stops;
//      else every other unused row holding bit j XORs in the pivot row's
//      words j >> 5 .. (nreal-1) >> 5 (unused rows are zero in every earlier
//      pivot column, so the words to the left are zero in both).
// The matrix, m x ceil(emax/32) words (rows padded to an odd stride so a
// warp's column read hits 32 banks), lives in shared memory: 16 KB at
// (2040,1530) emax 256, 32 KB at emax 512. Where it does not fit ((4000,2000)
// at emax 1024: 2000 rows x 33 words, 264 KB), the same kernel runs on a
// scratch matrix in device memory (kSmem = false), chosen by the wrapper.
//
// What bounds it on an H100: the elimination's block barriers and shared-
// memory passes (two barriers per column, a column read of m rows), not
// bytes: device memory sees the mask once, the erased symbols' Clist rows
// once and one flag per frame.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

int row_stride(int wa) { return wa | 1; }

// used and column bitmasks (m bits each), two pivot slots, nreal, the
// per-chunk erasure counts of the mask, and the matrix when it lives here.
size_t smem_bytes(int n, int m, int wa, bool in_smem) {
    const size_t chunks = (m + 31) / 32;
    size_t words = 2 * chunks + 3 + (n + 31) / 32;
    if (in_smem) words += (size_t)m * row_stride(wa);
    return words * sizeof(uint32_t);
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

    // 1. erasures per 32-symbol chunk, then their prefix.
    for (int j = warp; j < nch; j += kWarps) {
        const int s = j * 32 + lane;
        const uint32_t bits = __ballot_sync(0xffffffffu, s < n && er[s]);
        if (lane == 0) chunk_base[j] = __popc(bits);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
        for (int j = 0; j < nch; ++j) {
            const int c = chunk_base[j];
            chunk_base[j] = total;
            total += c;
        }
        *nreal_s = total;
        piv_slot[0] = piv_slot[1] = INT_MAX;
    }
    __syncthreads();
    const int nreal = *nreal_s;
    if (nreal > emax || nreal == 0) {
        if (threadIdx.x == 0) failed[b] = nreal > emax;
        return;  // the whole block: no barrier follows
    }
    const int nw = (nreal + 31) / 32;  // the words of the real block

    // 2. the erased columns of H, through the Clist.
    for (int i = threadIdx.x; i < m * nw; i += kThreads) {
        const int r = i / nw;
        mat[(size_t)r * stride + (i - r * nw)] = 0u;
    }
    for (int j = threadIdx.x; j < chunks; j += kThreads) used[j] = 0u;
    __syncthreads();
    for (int j = warp; j < nch; j += kWarps) {
        const int s = j * 32 + lane;
        const bool e = s < n && er[s];
        const uint32_t bits = __ballot_sync(0xffffffffu, e);
        if (!e) continue;
        const int col = chunk_base[j] + __popc(bits & ((1u << lane) - 1u));
        const uint32_t bit = 1u << (col & 31);
        const int deg = __ldg(clist_len + s);
        for (int t = 0; t < deg; ++t) {
            const int c = __ldg(clist_idx + (size_t)s * cmax + t);
            if (c >= 0 && c < m) atomicOr(mat + (size_t)c * stride + (col >> 5), bit);
        }
    }
    __syncthreads();

    // 3. forward elimination of the m x nreal block.
    int fail = 0;
    for (int col = 0; col < nreal; ++col) {
        const int cw = col >> 5;
        const unsigned cb = col & 31;
        int best = INT_MAX;
        for (int j = warp; j < chunks; j += kWarps) {
            const int r = j * 32 + lane;
            const uint32_t bit = r < m ? (mat[(size_t)r * stride + cw] >> cb) & 1u : 0u;
            const uint32_t cand = __ballot_sync(0xffffffffu, bit) & ~used[j];
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
cudaError_t launch(const uint8_t* erased, const int32_t* clist_idx, const int32_t* clist_len,
                   uint32_t* scratch, uint8_t* failed, int B, int n, int m, int cmax, int emax,
                   cudaStream_t stream) {
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

// 1 when a frame's matrix (m rows, emax columns) fits in the shared memory
// that one block of the current device may opt in to, else 0.
extern "C" int ldpc_rank_fits_smem(int n, int m, int emax) {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
        return 0;
    return smem_bytes(n, m, (emax + 31) / 32, true) <= (size_t)optin ? 1 : 0;
}

// Words of device-memory scratch per frame when the matrix does not fit.
extern "C" int ldpc_rank_scratch_words(int m, int emax) {
    return m * row_stride((emax + 31) / 32);
}

// failed (B,) uint8 from erased (B, n) uint8 0/1; scratch (B, m, stride)
// words when in_smem is 0 (else unused).
extern "C" int ldpc_rank_launch(const uint8_t* erased, const int32_t* clist_idx,
                                const int32_t* clist_len, uint32_t* scratch, uint8_t* failed,
                                int B, int n, int m, int cmax, int emax, int in_smem,
                                cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (in_smem)
        return (int)launch<true>(erased, clist_idx, clist_len, scratch, failed, B, n, m, cmax,
                                 emax, stream);
    return (int)launch<false>(erased, clist_idx, clist_len, scratch, failed, B, n, m, cmax, emax,
                              stream);
}
