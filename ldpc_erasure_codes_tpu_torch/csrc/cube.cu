// The binary GE's packed [A | T] coefficient cube, built from the erasure
// mask in one launch, one block per frame.
//
// Replaces no Pallas kernel. The JAX package builds the cube in XLA
// (ldpc_erasure_codes_tpu/ops/ge.py:234-251: a stable argsort of the
// inverted mask, a gather of H's erased columns, a bit packing, the identity
// beside it), and the port's plain path does the same in PyTorch
// (ops/ge.py::erased_indices and coefficient_cube): some fifteen launches a
// cube, a (B, m, emax) byte intermediate gathered from the dense H and an
// unsigned byte reduction to pack it. This kernel writes the same three
// outputs, bit for bit:
//   er_idx (B, emax) int32: the erased positions ascending, then the other
//     positions ascending in the pad slots (the stable argsort's order);
//   nreal (B,) int32: every erasure of the frame, also past emax (overflow);
//   cube (B, m, wa + wt) int32: row r's A words (wa = ceil(emax/32)) hold
//     bit p for each of the row's neighbours that is the frame's p-th
//     erased symbol with p < emax; its T words (wt = ceil(m/32)) hold bit r.
//
// Phase 1, the listing: each warp ballots 32 symbols of the mask at a time,
// one warp scans the chunk counts, and every symbol gets its position in the
// argsort's order: its rank among the erased symbols, or nreal plus its rank
// among the others. A slot table in shared memory (n int16) keeps the
// position of each erased symbol below emax, -1 elsewhere; er_idx takes
// every position below emax.
// Phase 2, the rows, a tile of them at a time (as many as have their wa
// words in 32 KB of shared memory: all 510 rows of the (2040,1530) code up
// to emax 512): the block zeroes the tile's A words; its threads take the
// tile's Vlist entries (vlist_idx[r, t], t < vlist_len[r]) in order, so
// that the loads are coalesced and independent, and an entry whose symbol
// has a slot p sets bit p of its row (atomicOr in shared memory); then the
// tile's rows go out as one run of words, A words from shared memory, T
// words computed, consecutive threads on consecutive words.
//
// What bounds it on an H100: bytes, the cube's write (B * m * (wa + wt)
// words: 29.2 MB at the hybrid's 448-frame bucket at emax 512, 8.7 us at
// 3.35 TB/s); the mask (B * n bytes) and er_idx (B * emax words) add 6% to
// that. The design reads nothing but the mask and the Vlist (which stays in
// L1 and L2: every block reads the same 28 KB), keeps the listing in shared
// memory, never reads the dense H and writes each output word once,
// coalesced.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

constexpr int kTileWords = 8192;  // a tile's A words: 32 KB

// Rows of a tile: all m where the A words allow, at least one.
int tile_rows(int m, int wa) { return wa == 0 ? m : std::max(1, std::min(m, kTileWords / wa)); }

// Chunk ballots and erasures before each chunk (n/32 words each), nreal,
// the tile's A words, then the slot table (n int16).
size_t smem_bytes(int n, int m, int wa) {
    const size_t nch = (n + 31) / 32;
    return (2 * nch + 1 + (size_t)tile_rows(m, wa) * wa) * sizeof(uint32_t) +
           (size_t)n * sizeof(int16_t);
}

__global__ void __launch_bounds__(kThreads)
cube_kernel(const uint8_t* __restrict__ erased, const int32_t* __restrict__ vlist_idx,
            const int32_t* __restrict__ vlist_len, int32_t* __restrict__ er_idx,
            int32_t* __restrict__ nreal_out, uint32_t* __restrict__ cube, int n, int m, int dmax,
            int emax, int wa, int wt, int rt) {
    extern __shared__ uint32_t smem[];
    const int b = blockIdx.x;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nch = (n + 31) / 32;
    uint32_t* bits = smem;                                   // [nch]
    int* base = reinterpret_cast<int*>(bits + nch);          // [nch]
    int* nreal_s = base + nch;                               // [1]
    uint32_t* a = reinterpret_cast<uint32_t*>(nreal_s + 1);  // [rt][wa]
    int16_t* slot = reinterpret_cast<int16_t*>(a + rt * wa);  // [n]
    const uint8_t* er = erased + (size_t)b * n;

    // Phase 1: ballots and counts per chunk, then the exclusive scan.
    for (int j = warp; j < nch; j += kWarps) {
        const int s = j * 32 + lane;
        const uint32_t bal = __ballot_sync(kFull, s < n && er[s]);
        if (lane == 0) {
            bits[j] = bal;
            base[j] = __popc(bal);
        }
    }
    __syncthreads();
    if (warp == 0) {
        int carry = 0;
        for (int j0 = 0; j0 < nch; j0 += 32) {
            const int j = j0 + lane;
            const int v = j < nch ? base[j] : 0;
            int incl = v;
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(kFull, incl, o);
                if (lane >= o) incl += u;
            }
            if (j < nch) base[j] = carry + incl - v;
            carry += __shfl_sync(kFull, incl, 31);
        }
        if (lane == 0) *nreal_s = carry;
    }
    __syncthreads();
    const int nreal = *nreal_s;
    int32_t* idx = er_idx + (size_t)b * emax;
    for (int i = threadIdx.x; i < n; i += kThreads) {
        const uint32_t bal = bits[i >> 5];
        const int l = i & 31;
        const int before = base[i >> 5] + __popc(bal & ((1u << l) - 1u));  // erased before i
        const bool e = (bal >> l) & 1u;
        const int pos = e ? before : nreal + i - before;
        slot[i] = (int16_t)(e && pos < emax ? pos : -1);
        if (pos < emax) idx[pos] = i;
    }
    if (threadIdx.x == 0) nreal_out[b] = nreal;
    __syncthreads();

    // Phase 2: the rows, rt at a time.
    const int c = wa + wt;
    for (int r0 = 0; r0 < m; r0 += rt) {
        const int rn = min(rt, m - r0);
        for (int i = threadIdx.x; i < rn * wa; i += kThreads) a[i] = 0u;
        __syncthreads();
        const int32_t* nbr = vlist_idx + (size_t)r0 * dmax;
#pragma unroll 4
        for (int i = threadIdx.x; i < rn * dmax && wa > 0; i += kThreads) {
            const int rr = i / dmax;
            const int s = __ldg(nbr + i), deg = __ldg(vlist_len + r0 + rr);  // independent loads
            const int p = i - rr * dmax < deg && s >= 0 && s < n ? slot[s] : -1;
            if (p >= 0) atomicOr(a + rr * wa + (p >> 5), 1u << (p & 31));
        }
        __syncthreads();
        uint32_t* out = cube + ((size_t)b * m + r0) * c;
        for (int i = threadIdx.x; i < rn * c; i += kThreads) {
            const int rr = i / c, w = i - rr * c, r = r0 + rr;
            out[i] = w < wa ? a[rr * wa + w] : w - wa == (r >> 5) ? 1u << (r & 31) : 0u;
        }
        __syncthreads();  // the tile's words are read before the next tile zeroes them
    }
}

}  // namespace

// er_idx (B, emax), nreal (B,) and cube (B, m, ceil(emax/32) + ceil(m/32))
// int32 from erased (B, n) uint8 0/1 and the Vlist (m, dmax) with its
// lengths (m,). Takes n <= 32767 (int16 slots) and emax <= n; a block then
// needs at most 106 KB of shared memory.
extern "C" int ldpc_cube_launch(const uint8_t* erased, const int32_t* vlist_idx,
                                const int32_t* vlist_len, int32_t* er_idx, int32_t* nreal,
                                uint32_t* cube, int B, int n, int m, int dmax, int emax,
                                cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (n > INT16_MAX || emax < 0 || emax > n) return (int)cudaErrorInvalidValue;
    const int wa = (emax + 31) / 32, wt = (m + 31) / 32;
    const size_t smem = smem_bytes(n, m, wa);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            cube_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    cube_kernel<<<B, kThreads, smem, stream>>>(erased, vlist_idx, vlist_len, er_idx, nreal, cube,
                                               n, m, dmax, emax, wa, wt, tile_rows(m, wa));
    return (int)cudaGetLastError();
}
