// GF(2) products of packed 0/1 matrices with word rows:
//   x[b, e, :] = XOR over the set bits j < K of row e of M_b of rhs[b, j, :]
// with M packed (E, ceil(K/32)) words (bit j of a row is bit j & 31 of word
// j >> 5) and rhs (B, K, W) 32-bit words. Entries:
//   - ldpc_f2_matvec_launch: one M for every frame (a dense H), bit scan;
//   - ldpc_f2_matvec_rows_launch: one M given as its rows' column lists (an
//     LDPC H), the list route; also the topology syndrome
//     (ops/synd.py::syndrome_from_topo), with the Vlist as the lists;
//   - ldpc_f2_matmul_rows_launch / ldpc_f2_matmul_launch: a matrix per
//     frame, x written as (B, E, W): every row listed and summed out of a
//     slab (f2_matmul_rows_kernel, below), or the bit scan where no slab
//     fits;
//   - ldpc_f2_apply_rows_launch: a matrix per frame, out = values with row e
//     XORed into out[b, idx[b, e], :]; rows whose target is outside [0, n)
//     are dropped.
//
// Replaces the TPU kernels of ldpc_erasure_codes_tpu/ops/pallas_nbmm.py:
// f2_matvec_wide, f2_matmul_batched and f2_apply_scatter, which share the
// body _f2_matmul_body: eight int8 MXU contractions, one per bit plane of
// the byte-viewed words, with an int8 0/1 matrix, then parity; the apply
// places rows with a one-hot MXU product. A GF(2) product acts on every
// bit position alone, so XOR of whole 32-bit rows gives the same bits.
//
// The bit scan (f2mm_kernel). What bounds it on an H100: shared-memory
// reads, one per set bit per output word, plus a scan of every matrix word
// per output word. Design: a block per (frame, chunk of WC words); it
// stages the chunk of all K rhs rows in shared memory (WC = 32 words: 65 KB
// at K = 510; WC shrinks for larger K to stay within 128 KB), then each
// thread owns one output word (row e, word w) and walks the set bits of row
// e with __ffs. The lanes that share a row read consecutive words (no bank
// conflict) and the same matrix word (a broadcast).
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
//
// The same route is the topology syndrome syndrome_from_topo, which
// replaces the TPU kernel ldpc_erasure_codes_tpu/ops/pallas_synd.py::
// f2_syndrome_tiled (the Vlist baked into the program as constant-offset
// slice XORs over a tile-major block in VMEM): the code's Vlist is already
// a row list in this format (vlist_idx (m, dmax) padded with n, vlist_len),
// so it goes in as it is, over K = n symbols, and the kernel's count is
// syndrome_from_topo's. Bounded, as H's product, by the bytes of the
// values (0.349 ms at the bucket): 0.534 ms at Wc 16 against 2.116 ms for
// the warp walk it replaced there (csrc/synd.cu: a chain of dependent
// index-then-row loads per check, ~7 warps an SM), which stays the route
// for the shapes where no slab fits (n >= 65535, checks wider than n / 8,
// a slab over shared memory even at 4 words; ops/synd.py::synd_route).
//
// The transform apply (f2_apply_rows_kernel). At the (2040,1530) GE bucket
// (448 frames, K = m = 510 syndrome rows, E = 512 transform rows, W = 256)
// 37% of the rows have a target in [0, n), each with ~96 set bits of 510;
// at the whole-batch GE of the simulation's value-tracking shape (2048
// frames, E = 128) 1.2% have one, and most frames place none. What bounds
// it: device memory, the frame's values copied to the output (0.94 GB each
// way at the bucket) and the rhs read once (0.23 GB); the placed rows' ~2e9
// word XORs are shared-memory reads well below that. Design, a block per
// (frame, chunk of Wc = VEC * P words):
//   1. the frame's placed rows are listed first (a ballot per 32 rows and a
//      shared count); discarded rows are never computed;
//   2. a block with a placed row starts cp.async copies of the chunk of the
//      K rhs rows into a slab (slab.cuh);
//   3. every block copies 1 / n_chunks of the frame's symbols to the
//      output, whole rows (contiguous, as a clone reads them), 16 bytes a
//      lane, while the slab loads, skipping the targets (a bit per symbol
//      in shared memory); a block without a placed row does only this;
//   4. a warp per placed row lists the row's set columns in its own uint16
//      list (popc and a warp prefix count over the row's words), then its
//      lanes, P on each part of the chunk, sum a share of the listed slab
//      rows each, eight reads in flight, XOR-reduce the shares (shfl) and
//      write values[idx] ^ sum to the chunk's words of out[idx]; no other
//      write touches them.
//
// The transform rows (f2_matmul_batched: the hybrid's solved rows, which
// its tiled writeback places itself). At the GE bucket E = 512 rows are
// written; every transform row has set bits, but only the ~37% whose slot
// is written matter, and ge_solve_packed zeroes the others before the
// product (85587 of 229376 rows keep a set bit, ~96 each). What bounds it
// then: device memory, 0.23 GB of rhs read and 0.23 GB of rows written
// (PERF.md's bound, 0.144 ms); the listed rows' XORs are ~2.4e9 word
// operations. The bit scan it replaced there (f2mm_kernel: a thread per
// output word walking all KW matrix words of its row with a divergent
// __ffs loop, the rhs rows staged with no load in flight) took 2.303 ms on
// every row, uncut, on NVIDIA H100 80GB HBM3, 700.00 W. Design
// (f2_matmul_rows_kernel): the apply without steps 1 and 3: the slab of
// the K rhs rows filled by cp.async, then step 4 over every row in order,
// each written once to out[b, e]; a row with an empty list skips the sum
// and writes zeros, and each warp's next matrix row is loaded while it
// sums the current one. The list and the sum are the apply's device
// functions (list_row, sum_list); the two kernels stay apart so that each
// gets its own register allocation (one template with a mode flag slowed
// both). Wc = 32 (two blocks an SM) halves the lists made per row against
// the apply's 16. The bit scan stays the route for K whose slab and lists
// do not fit (chosen on the host, ops/nbmm.py::f2_matmul_route).
//
// Measured by chip_smoke.py on NVIDIA H100 80GB HBM3, 700.00 W at the GE
// bucket: the list route 0.751 ms on the rows ge_solve_packed passes (the
// bit scan 1.757 ms on the same rows) and 1.108 ms on every row, uncut.

#include <cstdint>

#include <cuda_runtime.h>

#include "slab.cuh"
#include "words.cuh"

namespace {

constexpr int kThreads = 512;
constexpr size_t kSmemBudget = 128 * 1024;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
f2mm_kernel(const int32_t* __restrict__ rhs, const uint32_t* __restrict__ mat, int32_t* out,
            int K, int KW, int E, int W, int wc_shift) {
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
        if (own) out[((size_t)b * E + e) * W + w0 + w] = acc;
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

template <bool kShared>
int launch(const int32_t* rhs, const uint32_t* mat, int32_t* out, int B, int K, int KW, int E,
           int W, cudaStream_t stream) {
    if (B == 0 || E == 0) return (int)cudaSuccess;
    const int s = chunk_shift(K, W);
    if (s < 0) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)K * (1u << s) * sizeof(int32_t);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            f2mm_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const long long blocks = (long long)B * ((W + (1 << s) - 1) >> s);
    f2mm_kernel<kShared><<<(unsigned)blocks, kThreads, smem, stream>>>(rhs, mat, out, K, KW, E,
                                                                       W, s);
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

constexpr int kApplyThreads = 512;
constexpr int kApplyWarps = kApplyThreads / 32;

// The shared memory of f2_matmul_rows_kernel: the slab of K rows of Wc
// words and a list of up to K uint16 columns per warp; the apply's adds the
// placed rows, a bit per symbol (set where a row is placed) and the count.
__host__ __device__ inline int rows_mode_bytes(int K, int wc) {
    return 4 * K * wc + round16(2 * kApplyWarps * K);
}
__host__ __device__ inline int apply_bytes(int K, int E, int n, int wc) {
    return rows_mode_bytes(K, wc) + round16(4 * E) + round16(4 * ((n + 31) / 32)) + 16;
}

// Lists the set columns below K of one packed matrix row into `list`, in
// ascending order (popc and a warp prefix count per 32 words); returns
// their number, the same in every lane. `first` is the lane's word of the
// first 32 (0 past KW); the others are read from `row`.
__device__ __forceinline__ int list_row(const uint32_t* row, uint32_t first, int KW, int K,
                                        uint16_t* list, int lane) {
    const uint32_t last = (K & 31) ? (1u << (K & 31)) - 1u : 0xffffffffu;
    int len = 0;
    for (int kw0 = 0; kw0 < KW; kw0 += 32) {
        const int kw = kw0 + lane;
        uint32_t bits = kw0 == 0 ? first : kw < KW ? __ldg(row + kw) : 0u;
        if (kw == KW - 1) bits &= last;
        const int c = __popc(bits);
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += v;
        }
        for (int pos = len + incl - c; bits; bits &= bits - 1)
            list[pos++] = (uint16_t)(32 * kw + __ffs(bits) - 1);
        len += __shfl_sync(0xffffffffu, incl, 31);
    }
    __syncwarp();
    return len;
}

// The XOR of the listed slab rows at part p of the chunk: the lanes with
// this p (share = 0 .. 32 / P - 1) sum a share of the list each, eight
// reads in flight, then XOR-reduce the shares (shfl); every lane takes part.
template <int VEC, int P>
__device__ __forceinline__ Words<VEC> sum_list(const Words<VEC>* slab, const uint16_t* list,
                                               int len, int p, int share) {
    using V = Words<VEC>;
    constexpr int kShares = 32 / P;  // lanes on each part of the chunk
    V acc = V::zero();
    for (int j0 = share; j0 < len; j0 += 8 * kShares) {
        V v[8];  // eight predicated reads in flight, none past the list
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int j = j0 + u * kShares;
            v[u] = j < len ? slab[list[j] * P + p] : V::zero();
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) acc ^= v[u];
    }
#pragma unroll
    for (int o = P; o < 32; o <<= 1) acc ^= acc.shfl_xor(o);
    return acc;
}

template <int VEC, int P>
__global__ void __launch_bounds__(kApplyThreads)
f2_apply_rows_kernel(const int32_t* __restrict__ values, const int32_t* __restrict__ rhs,
                     const uint32_t* __restrict__ t, const int32_t* __restrict__ idx,
                     int32_t* __restrict__ out, int K, int KW, int E, int W, int n,
                     int n_chunks) {
    using V = Words<VEC>;
    extern __shared__ __align__(16) uint8_t smem_raw[];
    V* slab = reinterpret_cast<V*>(smem_raw);
    uint16_t* lists = reinterpret_cast<uint16_t*>(smem_raw + (size_t)4 * K * VEC * P);
    int* placed = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(lists) +
                                         round16(2 * kApplyWarps * K));
    uint32_t* targets = reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(placed) +
                                                    round16(4 * E));
    const int nw = (n + 31) / 32;
    int* count = reinterpret_cast<int*>(targets + round16(4 * nw) / 4);
    const int chunk = blockIdx.x % n_chunks;
    const int b = blockIdx.x / n_chunks;
    const int w0 = chunk * VEC * P;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int32_t* tg = idx + (size_t)b * E;

    // 1. The rows with a target in [0, n), in any order (targets are
    //    distinct), and the targets as a bit per symbol.
    if (threadIdx.x == 0) *count = 0;
    for (int i = threadIdx.x; i < nw; i += kApplyThreads) targets[i] = 0;
    __syncthreads();
    for (int e0 = 32 * warp; e0 < E; e0 += kApplyThreads) {
        const int e = e0 + lane;
        const int to = e < E ? __ldg(tg + e) : -1;
        const bool keep = to >= 0 && to < n;
        const uint32_t bal = __ballot_sync(0xffffffffu, keep);
        int base = 0;
        if (lane == 0 && bal) base = atomicAdd(count, __popc(bal));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (keep) {
            placed[base + __popc(bal & ((1u << lane) - 1u))] = e;
            atomicOr(targets + (to >> 5), 1u << (to & 31));
        }
    }
    __syncthreads();
    const int np = *count;

    // 2-3. The slab in flight while the block copies its share of the
    //    frame's symbols, whole rows (n / n_chunks of them), all but the
    //    targets: step 4 writes those, so no barrier orders the two.
    if (np > 0)
        slab_load<VEC, P>(slab, rhs + (size_t)b * K * W + w0, K, W, w0, threadIdx.x,
                          kApplyThreads);
    const int32_t* vf = values + (size_t)b * n * W;
    int32_t* of = out + (size_t)b * n * W;
    {
        const int s0 = (int)((long long)chunk * n / n_chunks);
        const int s1 = (int)((long long)(chunk + 1) * n / n_chunks);
        const int wv = W / VEC;
#pragma unroll 4
        for (int i = threadIdx.x; i < (s1 - s0) * wv; i += kApplyThreads) {
            const int s = s0 + i / wv;
            const size_t off = (size_t)s * W + (i % wv) * VEC;
            if (!((targets[s >> 5] >> (s & 31)) & 1u)) V::load_ro(vf + off).store(of + off);
        }
    }
    if (np == 0) return;
    copy_async_wait();
    __syncthreads();

    // 4. A warp per placed row: its list of set columns, then its sum.
    uint16_t* list = lists + warp * K;
    const int p = lane % P, share = lane / P;
    for (int q = warp; q < np; q += kApplyWarps) {
        const int e = placed[q];
        const uint32_t* row = t + ((size_t)b * E + e) * KW;
        const int len = list_row(row, lane < KW ? __ldg(row + lane) : 0u, KW, K, list, lane);
        const V acc = sum_list<VEC, P>(slab, list, len, p, share);
        if (share == 0 && w0 + p * VEC < W) {
            const size_t off = (size_t)__ldg(tg + e) * W + w0 + p * VEC;
            V v = V::load_ro(vf + off);
            v ^= acc;
            v.store(of + off);
        }
        __syncwarp();  // the list is rewritten for the next row
    }
}

// The transform rows (f2_matmul_batched): a block per (frame, chunk of VEC
// * P words), the slab of the K rhs rows, then a warp per row of T_b in
// order, its list and sum as the apply's step 4, written to out[b, e]; each
// lane's first matrix word of the warp's next row is loaded one row ahead.
template <int VEC, int P>
__global__ void __launch_bounds__(kApplyThreads)
f2_matmul_rows_kernel(const int32_t* __restrict__ rhs, const uint32_t* __restrict__ t,
                      int32_t* __restrict__ out, int K, int KW, int E, int W, int n_chunks) {
    using V = Words<VEC>;
    extern __shared__ __align__(16) uint8_t smem_raw[];
    V* slab = reinterpret_cast<V*>(smem_raw);
    uint16_t* list = reinterpret_cast<uint16_t*>(smem_raw + (size_t)4 * K * VEC * P) +
                     (threadIdx.x / 32) * K;
    const int b = blockIdx.x / n_chunks;
    const int w0 = (blockIdx.x % n_chunks) * VEC * P;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    slab_load<VEC, P>(slab, rhs + (size_t)b * K * W + w0, K, W, w0, threadIdx.x,
                      kApplyThreads);
    const uint32_t* tf = t + (size_t)b * E * KW;
    uint32_t ahead = warp < E && lane < KW ? __ldg(tf + (size_t)warp * KW + lane) : 0u;
    copy_async_wait();
    __syncthreads();

    const int p = lane % P, share = lane / P;
    int32_t* of = out + (size_t)b * E * W + w0 + p * VEC;
    for (int e = warp; e < E; e += kApplyWarps) {
        const uint32_t* row = tf + (size_t)e * KW;
        const uint32_t first = ahead;
        ahead = e + kApplyWarps < E && lane < KW ? __ldg(row + kApplyWarps * KW + lane) : 0u;
        const int len = list_row(row, first, KW, K, list, lane);
        // len is the same in every lane: an empty list writes zeros.
        const V acc = len > 0 ? sum_list<VEC, P>(slab, list, len, p, share) : V::zero();
        if (share == 0 && w0 + p * VEC < W) acc.store(of + (size_t)e * W);
        __syncwarp();  // the list is rewritten for the next row
    }
}

template <int VEC, int P>
cudaError_t launch_apply(const int32_t* values, const int32_t* rhs, const uint32_t* t,
                         const int32_t* idx, int32_t* out, int B, int K, int KW, int E, int W,
                         int n, cudaStream_t stream) {
    const size_t smem = apply_bytes(K, E, n, VEC * P);
    const auto kernel = f2_apply_rows_kernel<VEC, P>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int n_chunks = (W + VEC * P - 1) / (VEC * P);
    kernel<<<(unsigned)((long long)B * n_chunks), kApplyThreads, smem, stream>>>(
        values, rhs, t, idx, out, K, KW, E, W, n, n_chunks);
    return cudaGetLastError();
}

template <int VEC, int P>
cudaError_t launch_matmul_rows(const int32_t* rhs, const uint32_t* t, int32_t* out, int B,
                               int K, int KW, int E, int W, cudaStream_t stream) {
    const size_t smem = rows_mode_bytes(K, VEC * P);
    const auto kernel = f2_matmul_rows_kernel<VEC, P>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int n_chunks = (W + VEC * P - 1) / (VEC * P);
    kernel<<<(unsigned)((long long)B * n_chunks), kApplyThreads, smem, stream>>>(
        rhs, t, out, K, KW, E, W, n_chunks);
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
    return launch<true>(values, h, out, B, n, KW, m, W, stream);
}

// out (B, E, W) = T_b (E rows of KW words over K columns) . rhs_b (K, W),
// the bit scan (f2_matmul_batched's route where no slab fits).
extern "C" int ldpc_f2_matmul_launch(const int32_t* rhs, const uint32_t* t, int32_t* out,
                                     int B, int K, int KW, int E, int W,
                                     cudaStream_t stream) {
    return launch<false>(rhs, t, out, B, K, KW, E, W, stream);
}

// The same product by f2_matmul_rows_kernel: every row of T_b listed and
// summed out of a slab of Wc = wc words (4, 8, 16 or 32) and written in
// order. K < 65535, and the slab with the lists must fit a
// block's shared memory.
extern "C" int ldpc_f2_matmul_rows_launch(const int32_t* rhs, const uint32_t* t, int32_t* out,
                                          int B, int K, int KW, int E, int W, int wc,
                                          cudaStream_t stream) {
    if (B == 0 || E == 0) return (int)cudaSuccess;
    if (K >= 65535 || rows_mode_bytes(K, wc) > kMaxSmem) return (int)cudaErrorInvalidValue;
#define F2_MATMUL(VEC, P) \
    return (int)launch_matmul_rows<VEC, P>(rhs, t, out, B, K, KW, E, W, stream)
    if (vec4_ok(W, {rhs, out})) {
        switch (wc) {
            case 4: F2_MATMUL(4, 1);
            case 8: F2_MATMUL(4, 2);
            case 16: F2_MATMUL(4, 4);
            case 32: F2_MATMUL(4, 8);
        }
    } else {
        switch (wc) {
            case 4: F2_MATMUL(1, 4);
            case 8: F2_MATMUL(1, 8);
            case 16: F2_MATMUL(1, 16);
            case 32: F2_MATMUL(1, 32);
        }
    }
#undef F2_MATMUL
    return (int)cudaErrorInvalidValue;
}

// out (B, n, W) = values with row e of T_b . rhs_b (T_b: E rows of KW words
// over K columns) XORed into symbol idx[b, e] where that lies in [0, n);
// Wc = wc words (4, 8 or 16) per block. K < 65535, and the slab with the
// lists must fit a block's shared memory.
extern "C" int ldpc_f2_apply_rows_launch(const int32_t* values, const int32_t* rhs,
                                         const uint32_t* t, const int32_t* idx, int32_t* out,
                                         int B, int K, int KW, int E, int W, int n, int wc,
                                         cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (K >= 65535 || apply_bytes(K, E, n, wc) > kMaxSmem) return (int)cudaErrorInvalidValue;
#define F2_APPLY(VEC, P) \
    return (int)launch_apply<VEC, P>(values, rhs, t, idx, out, B, K, KW, E, W, n, stream)
    if (vec4_ok(W, {values, rhs, out})) {
        switch (wc) {
            case 4: F2_APPLY(4, 1);
            case 8: F2_APPLY(4, 2);
            case 16: F2_APPLY(4, 4);
        }
    } else {
        switch (wc) {
            case 4: F2_APPLY(1, 4);
            case 8: F2_APPLY(1, 8);
            case 16: F2_APPLY(1, 16);
        }
    }
#undef F2_APPLY
    return (int)cudaErrorInvalidValue;
}
