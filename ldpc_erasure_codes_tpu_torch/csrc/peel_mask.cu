// Pattern-only Jacobi peel of the FER simulation, with the batch-wide stop of
// the JAX decoders decided on the card: two launches, no host read.
//
// Replaces no Pallas kernel. The JAX package runs the pattern-only decode in
// XLA (ldpc_erasure_codes_tpu/ops/peel.py::peel_decode_mask, :382-433), and
// the port's plain version (ops/peel_jacobi.py::peel_decode_mask_reference)
// does the same in PyTorch: per sweep two float32 products of 0/1 operands
// with the dense H and two host reads for the loop's stop. This kernel gives
// its outputs bit for bit: the residual mask (B, n) bool and iters (B,) int32.
//
// The stop, rebuilt from per-frame quantities. Let M_f(t) be frame f's mask
// after t Jacobi sweeps (a symbol is cleared when one of its checks has it as
// its only erased neighbour at the sweep's start). A mask only shrinks, and
// M_f(t + 1) is a function of M_f(t) alone. Define per frame:
//   d_f: the first t >= 1 after which the frame's first k_stop symbols are
//        known; 0 when none of them was lost; "never" (max_iters + 1 here)
//        when it does not happen within max_iters sweeps;
//   c_f: the first t with M_f(t + 1) = M_f(t) (the fixed point), capped at
//        max_iters.
// The loop (peel.py:189-238) tests, before sweep it (it = 0, 1, ...): all
// frames done, which at it is max_f d_f <= it (done frames stay done); and,
// from it = 1, that the batch's erasure count did not fall, which is
// M_f(it) = M_f(it - 1) for every frame, that is max_f c_f + 1 <= it. So the
// batch runs
//   T = min(max_iters, max_f d_f, max_f c_f + 1)
// sweeps, and frame f's residual is M_f(T) = M_f(min(T, c_f)). A frame's
// count is set after the first sweep that leaves it done, and a done frame
// with d_f >= 1 changed in sweep d_f, so c_f >= d_f and d_f <= T whenever
// d_f <= max_iters. Hence iters_f = 1 if d_f = 0, else d_f if d_f <=
// max_iters, else max_iters, whatever the rest of the batch does. A per-frame
// stop (csrc/peel.cu's schedule kernel) would leave M_f(c_f) or M_f(d_f) and
// differ in the parity region of done frames; this kernel keeps the batch's.
//
// Design. 32 frames are bit-sliced into one 32-bit word per symbol (bit l:
// frame 32g + l), a block per such group, the group's n words in shared
// memory beside the Vlist and the Clist staged as uint16 (entry-major, so
// consecutive threads read consecutive entries). A sweep is two phases on
// the sweep-start words: a thread per check folds its neighbours' words into
// "at least one" and "at least two" erased, and keeps "exactly one"; then a
// thread per symbol clears the frames in which any of its checks holds
// exactly one erasure. The same pass ORs, over the block, the bits that
// changed and the bits still erased among the first k_stop symbols, which
// give each frame's d and c. Two barriers a sweep. A group stops sweeping
// once every one of its frames is at its fixed point (S_g sweeps, at most
// max_iters): further sweeps would not change its words.
//   Launch 1 reads the group's masks (transposed on the way in: a thread per
// four symbols reads one 32-bit word of each of the 32 rows, coalesced along
// the rows), keeps the packed words in device memory, sweeps S_g times,
// writes iters, and folds max d and max c into two ints (atomicMax). Launch
// 2 reads T from them and sweeps each group's packed words again, min(T,
// S_g) times, which leaves M_f(T) in every frame; the residual goes back to
// (B, n) bool, transposed, coalesced along rows. Nothing reaches the host.
// The stop ints are cleared by a memset on the stream, and launch 2 leaves T
// in the third. Rows are read and written as 32-bit words, so n is a
// multiple of 4 (every shipped code's) and the masks are 4-byte aligned.
//
// Counting mode (kCount, the FER simulation's step): the kernel counts the
// batch's SimStats itself (sim/stats.py::batch_stats, field for field) and
// adds them into one int64 buffer, [frames, block_errors, rs_block_errors,
// rs_blocks, ml_failed, escalations, erased_symbols, residual_erasures,
// iters_hist[max_iters + 1]]. Launch 1 has every input word: it counts the
// erasures (a popcount of the group's words), each frame's erasures in each
// RS window of rs_n symbols (shared counts [n / rs_n][32]; a window fails
// past rs_n - rs_k; none where rs_n is 0 or does not divide n), the frames'
// iteration bins, the frames and the windows. Launch 2 has M_f(T): it
// counts the residual erasures and the frames with one among the first
// k_count symbols. Sums are reduced over the block (warp reductions into
// shared counters, one barrier) before one 64-bit atomic a block each; the
// histogram adds once a block per distinct bin. Neither the residual nor
// iters is written.
//
// What bounds it on an H100: bytes. Reading each mask byte once and writing
// each residual byte once, with iters: B * (2 n + 4) bytes, 16.7 MB at the
// simulation's B = 4096, n = 2040 (5.0 us at 3.35 TB/s); the packed words
// add n / 4 bytes a frame. The sweeps are integer work on shared memory, but
// a group's sweeps are serial, each a chain of shared-memory loads of words
// at random symbols, so each launch takes about the latency of its sweeps,
// not their operations over the INT32 rate: that latency is the gap to the
// bound. Counting reads no more bytes and writes no residual: B * n bytes
// read, with the packed words.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kMaxSmem = 232448;

__host__ __device__ constexpr size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// The group's words (n + 1, the last a zero pad), the checks' "exactly one"
// words (m + 1, the last a zero pad), the Vlist (dmax x m) and the Clist
// (cmax x n) as uint16.
size_t smem_bytes(int n, int m, int dmax, int cmax) {
    return round16(4 * ((size_t)n + 1)) + round16(4 * ((size_t)m + 1)) +
           round16(2 * (size_t)m * dmax) + round16(2 * (size_t)n * cmax);
}

// The counting mode's buffer: SimStats' scalars in order, then the bins.
enum Stat { kFrames, kBlockErrors, kRsBlockErrors, kRsBlocks, kErased = 6, kResidual, kHist };

// What counting needs besides the peel: the buffer, the first symbols that
// decide a block error, the RS windows (nwin of rs_n symbols, a window
// failing past rs_t erasures; nwin 0: none).
struct Count {
    unsigned long long* stats;
    int k_count, rs_n, rs_t, nwin;
};

// kFinal: launch 2 (the packed words in, the residual out); else launch 1
// (the mask in; the packed words, iters and the stop maxima out). packed
// holds each group's n words before the first sweep. kCount: the counters
// into cnt.stats in place of the residual and iters.
template <bool kFinal, bool kCount>
__global__ void __launch_bounds__(kThreads)
peel_mask_kernel(const uint8_t* __restrict__ erased, const int32_t* __restrict__ vlist_idx,
                 const int32_t* __restrict__ vlist_len, const int32_t* __restrict__ clist_idx,
                 const int32_t* __restrict__ clist_len, uint32_t* __restrict__ packed,
                 int32_t* __restrict__ stop, uint8_t* __restrict__ erased_out,
                 int32_t* __restrict__ iters_out, int B, int n, int m, int dmax, int cmax,
                 int k_stop, int max_iters, Count cnt) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* w = reinterpret_cast<uint32_t*>(smem_raw);                          // [n + 1]
    uint32_t* one = reinterpret_cast<uint32_t*>(smem_raw + round16(4 * (n + 1)));  // [m + 1]
    uint16_t* vl = reinterpret_cast<uint16_t*>(
        reinterpret_cast<unsigned char*>(one) + round16(4 * (m + 1)));              // [dmax][m]
    uint16_t* cl = reinterpret_cast<uint16_t*>(
        reinterpret_cast<unsigned char*>(vl) + round16(2 * (size_t)m * dmax));      // [cmax][n]
    __shared__ uint32_t red[2][2];  // by sweep parity: changed bits, bits still erased in k_stop
    __shared__ uint32_t left0;      // bits erased in k_stop before the first sweep
    __shared__ uint32_t sums[2];    // counting: the block's two sums (erasures; failed windows)
    __shared__ uint32_t lost;       // counting, launch 2: bits erased in k_count
    // Counting, launch 1: erasures by RS window and frame, [nwin][32].
    uint32_t* win = reinterpret_cast<uint32_t*>(
        reinterpret_cast<unsigned char*>(cl) + round16(2 * (size_t)n * cmax));

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int row0 = blockIdx.x * 32, rows = min(32, B - row0);
    const int nq = n / 4;
    uint32_t* first = packed + (size_t)blockIdx.x * n;

    // Launch 2 sweeps T times at most: the batch's stop.
    int limit = max_iters;
    if (kFinal) {
        limit = min(max_iters, min(stop[0], stop[1] + 1));
        if (blockIdx.x == 0 && tid == 0) stop[2] = limit;
    }

#pragma unroll 4
    for (int i = tid; i < m * dmax; i += kThreads) {
        const int r = i / dmax, t = i - r * dmax;
        vl[t * m + r] = (uint16_t)(t < __ldg(vlist_len + r) ? __ldg(vlist_idx + i) : n);
    }
#pragma unroll 4
    for (int i = tid; i < n * cmax; i += kThreads) {
        const int j = i / cmax, t = i - j * cmax;
        cl[t * n + j] = (uint16_t)(t < __ldg(clist_len + j) ? __ldg(clist_idx + i) : m);
    }
    if (tid == 0) {
        w[n] = 0u;
        one[m] = 0u;
        red[0][0] = red[0][1] = red[1][0] = red[1][1] = 0u;
        left0 = 0u;
        sums[0] = sums[1] = 0u;
        lost = 0u;
    }
    if (kCount && !kFinal)
        for (int i = tid; i < 32 * cnt.nwin; i += kThreads) win[i] = 0u;
    __syncthreads();

    // The group's words: launch 1 transposes the rows, launch 2 reads them back.
    if (kFinal) {
        for (int j = tid; j < n; j += kThreads) w[j] = first[j];
    } else {
        uint32_t left = 0u, pop = 0u;
        for (int q = tid; q < nq; q += kThreads) {
            uint32_t x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int r = 0; r < 32; ++r) {
                if (r >= rows) continue;
                const uint32_t v = __ldg(
                    reinterpret_cast<const uint32_t*>(erased + (size_t)(row0 + r) * n + 4 * q));
#pragma unroll
                for (int s = 0; s < 4; ++s) x[s] |= (uint32_t)(((v >> (8 * s)) & 0xffu) != 0u) << r;
            }
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                const int j = 4 * q + s;
                w[j] = x[s];
                first[j] = x[s];
                if (j < k_stop) left |= x[s];
                if (kCount) pop += __popc(x[s]);
            }
        }
        left = __reduce_or_sync(kFull, left);
        if (lane == 0 && left) atomicOr(&left0, left);
        if (kCount) {
            pop = __reduce_add_sync(kFull, pop);
            if (lane == 0 && pop) atomicAdd(&sums[0], pop);
        }
    }
    __syncthreads();

    // Counting, launch 1: each frame's erasures in each RS window, lane l
    // frame l, a warp per 64 symbols of a window. The sweeps write w only
    // after their first barrier; the counts are read after the kernel's last.
    if (kCount && !kFinal && cnt.nwin > 0) {
        const int chunks = (cnt.rs_n + 63) / 64;
        for (int it = warp; it < cnt.nwin * chunks; it += kThreads / 32) {
            const int v = it / chunks, j0 = v * cnt.rs_n + (it - v * chunks) * 64;
            const int j1 = min(j0 + 64, (v + 1) * cnt.rs_n);
            uint32_t c = 0u;
#pragma unroll 8
            for (int j = j0; j < j1; ++j) c += (w[j] >> lane) & 1u;
            if (c) atomicAdd(&win[32 * v + lane], c);
        }
    }

    uint32_t left = kFinal ? 0u : left0;  // frames not yet done
    uint32_t fixed = 0u;                  // frames at their fixed point
    int d = (left >> lane) & 1u ? max_iters + 1 : 0;  // lane l of warp 0: frame row0 + l
    int c = max_iters;
    int s = 0;  // sweeps made
    while (s < limit && fixed != kFull) {
        const int p = ++s & 1;
        for (int i = tid; i < m; i += kThreads) {
            uint32_t ones = 0u, twos = 0u;
#pragma unroll 4
            for (int t = 0; t < dmax; ++t) {
                const uint32_t x = w[vl[t * m + i]];
                twos |= ones & x;
                ones |= x;
            }
            one[i] = ones & ~twos;
        }
        __syncthreads();
        if (tid == 0) red[p ^ 1][0] = red[p ^ 1][1] = 0u;  // read in sweep s - 1, used in s + 1
        uint32_t chg = 0u, still = 0u;
        for (int j = tid; j < n; j += kThreads) {
            const uint32_t old = w[j];
            if (old == 0u) continue;
            uint32_t hit = 0u;
#pragma unroll 4
            for (int t = 0; t < cmax; ++t) hit |= one[cl[t * n + j]];
            const uint32_t now = old & ~hit;
            if (now != old) {
                w[j] = now;
                chg |= old ^ now;
            }
            if (j < k_stop) still |= now;
        }
        chg = __reduce_or_sync(kFull, chg);
        still = __reduce_or_sync(kFull, still);
        if (lane == 0) {
            if (chg) atomicOr(&red[p][0], chg);
            if (still) atomicOr(&red[p][1], still);
        }
        __syncthreads();
        chg = red[p][0];
        still = red[p][1];
        if (!kFinal && warp == 0) {
            if (((left & ~still) >> lane) & 1u) d = s;
            if (((~fixed & ~chg) >> lane) & 1u) c = s - 1;
        }
        left = still;
        fixed |= ~chg;
    }

    // Launch 2, counting: the residual's erasures and the frames with one in
    // the first k_count symbols (frames past B have no bits).
    if (kFinal && kCount) {
        uint32_t pop = 0u, any = 0u;
        for (int j = tid; j < n; j += kThreads) {
            const uint32_t x = w[j];
            pop += __popc(x);
            if (j < cnt.k_count) any |= x;
        }
        pop = __reduce_add_sync(kFull, pop);
        any = __reduce_or_sync(kFull, any);
        if (lane == 0) {
            if (pop) atomicAdd(&sums[0], pop);
            if (any) atomicOr(&lost, any);
        }
        __syncthreads();
        if (tid == 0) {
            atomicAdd(cnt.stats + kResidual, (unsigned long long)sums[0]);
            atomicAdd(cnt.stats + kBlockErrors, (unsigned long long)__popc(lost));
        }
        return;
    }
    // Launch 2: the residual back to rows of 0/1 bytes, a thread per four
    // symbols writing one 32-bit word of each row, coalesced.
    if (kFinal) {
        for (int q = tid; q < nq; q += kThreads) {
            uint32_t x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) x[u] = w[4 * q + u];
#pragma unroll
            for (int r = 0; r < 32; ++r) {
                if (r >= rows) continue;
                uint32_t v = 0u;
#pragma unroll
                for (int u = 0; u < 4; ++u) v |= ((x[u] >> r) & 1u) << (8 * u);
                *reinterpret_cast<uint32_t*>(erased_out + (size_t)(row0 + r) * n + 4 * q) = v;
            }
        }
        return;
    }
    if (warp == 0) {
        const bool valid = lane < rows;
        const int iters = d == 0 ? 1 : min(d, max_iters);
        if (!kCount && valid) iters_out[row0 + lane] = iters;
        const int dmax_g = __reduce_max_sync(kFull, valid ? d : 0);
        const int cmax_g = __reduce_max_sync(kFull, valid ? c : 0);
        if (lane == 0) {
            atomicMax(stop, dmax_g);
            atomicMax(stop + 1, cmax_g);
        }
        if (kCount) {
            // The histogram's bin (batch_stats clamps to 0..max_iters), one
            // add a block for each bin its frames fill.
            const int bin = min(iters, max_iters);
            const unsigned peers = __match_any_sync(kFull, valid ? bin : -1);
            if (valid && lane == __ffs(peers) - 1)
                atomicAdd(cnt.stats + kHist + bin, (unsigned long long)__popc(peers));
        }
    }
    if (kCount) {
        __syncthreads();  // the window counts, also where no sweep ran
        uint32_t fails = 0u;
        for (int i = tid; i < 32 * cnt.nwin; i += kThreads)
            fails += (i % 32 < rows && (int)win[i] > cnt.rs_t) ? 1u : 0u;
        fails = __reduce_add_sync(kFull, fails);
        if (lane == 0 && fails) atomicAdd(&sums[1], fails);
        __syncthreads();
        if (tid == 0) {
            atomicAdd(cnt.stats + kFrames, (unsigned long long)rows);
            atomicAdd(cnt.stats + kErased, (unsigned long long)sums[0]);
            if (cnt.nwin > 0) {
                atomicAdd(cnt.stats + kRsBlocks, (unsigned long long)rows * cnt.nwin);
                atomicAdd(cnt.stats + kRsBlockErrors, (unsigned long long)sums[1]);
            }
        }
    }
}

template <bool kFinal, bool kCount>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const uint8_t* erased,
                   const int32_t* vlist_idx, const int32_t* vlist_len, const int32_t* clist_idx,
                   const int32_t* clist_len, uint32_t* packed, int32_t* stop,
                   uint8_t* erased_out, int32_t* iters_out, int B, int n, int m, int dmax,
                   int cmax, int k_stop, int max_iters, Count cnt) {
    const auto kernel = peel_mask_kernel<kFinal, kCount>;
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kernel<<<grid, kThreads, smem, stream>>>(erased, vlist_idx, vlist_len, clist_idx, clist_len,
                                             packed, stop, erased_out, iters_out, B, n, m, dmax,
                                             cmax, k_stop, max_iters, cnt);
    return cudaGetLastError();
}

// Both launches, counting or not.
template <bool kCount>
cudaError_t launch_both(size_t smem1, size_t smem2, int groups, cudaStream_t stream,
                        const uint8_t* erased, const int32_t* vlist_idx,
                        const int32_t* vlist_len, const int32_t* clist_idx,
                        const int32_t* clist_len, uint32_t* packed, int32_t* stop,
                        uint8_t* erased_out, int32_t* iters_out, int B, int n, int m, int dmax,
                        int cmax, int k_stop, int max_iters, Count cnt) {
    const dim3 grid((unsigned)groups);
    const cudaError_t err = launch<false, kCount>(
        grid, smem1, stream, erased, vlist_idx, vlist_len, clist_idx, clist_len, packed, stop,
        erased_out, iters_out, B, n, m, dmax, cmax, k_stop, max_iters, cnt);
    if (err != cudaSuccess) return err;
    return launch<true, kCount>(grid, smem2, stream, erased, vlist_idx, vlist_len, clist_idx,
                                clist_len, packed, stop, erased_out, iters_out, B, n, m, dmax,
                                cmax, k_stop, max_iters, cnt);
}

}  // namespace

// The pattern-only peel of B masks (B, n) uint8 0/1: erased_out (B, n) 0/1
// and iters (B,) int32, the batch-wide stop of the JAX loop. scratch holds
// G * n + 3 ints, G = ceil(B / 32): each group's words, then the stop (max
// d, max c, T; cleared here, T left by launch 2). The Vlist is (m, dmax)
// with its lengths, the Clist (n, cmax) with its lengths. Takes n a
// multiple of 4, both masks 4-byte aligned, n, m < 65535, 0 <= k_stop <= n,
// 0 <= max_iters < INT_MAX and the staged tables within a block's shared
// memory.
//
// With stats (int64, 8 + max_iters + 1, the SimStats order) the batch's
// counters are added into it in place of erased_out and iters (both may be
// null): a block error is an erasure left among the first k_count symbols,
// 0 <= k_count <= n; RS windows are counted where rs_n > 0 divides n, a
// window failing past rs_n - rs_k erasures, and their counts take 128 *
// (n / rs_n) more bytes of launch 1's shared memory.
extern "C" int ldpc_peel_mask_launch(const uint8_t* erased, const int32_t* vlist_idx,
                                     const int32_t* vlist_len, const int32_t* clist_idx,
                                     const int32_t* clist_len, int32_t* scratch,
                                     uint8_t* erased_out, int32_t* iters_out, int B, int n,
                                     int m, int dmax, int cmax, int k_stop, int max_iters,
                                     int64_t* stats, int k_count, int rs_n, int rs_k,
                                     cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    const bool counting = stats != nullptr;
    const int nwin = counting && rs_n > 0 && n % rs_n == 0 ? n / rs_n : 0;
    const size_t smem = smem_bytes(n, m, dmax, cmax);
    const size_t smem1 = smem + round16(4 * 32 * (size_t)nwin);
    if (n % 4 != 0 || reinterpret_cast<uintptr_t>(erased) % 4 != 0 ||
        reinterpret_cast<uintptr_t>(erased_out) % 4 != 0 || n >= 65535 || m >= 65535 ||
        k_stop < 0 || k_stop > n || max_iters < 0 || max_iters == INT_MAX || smem1 > kMaxSmem ||
        (counting && (k_count < 0 || k_count > n)))
        return (int)cudaErrorInvalidValue;
    const int groups = (B + 31) / 32;
    uint32_t* packed = reinterpret_cast<uint32_t*>(scratch);
    int32_t* stop = scratch + (size_t)groups * n;
    cudaError_t err = cudaMemsetAsync(stop, 0, 3 * sizeof(int32_t), stream);
    if (err != cudaSuccess) return (int)err;
    const Count cnt{reinterpret_cast<unsigned long long*>(stats), k_count, rs_n, rs_n - rs_k,
                    nwin};
    err = counting ? launch_both<true>(smem1, smem, groups, stream, erased, vlist_idx, vlist_len,
                                       clist_idx, clist_len, packed, stop, erased_out,
                                       iters_out, B, n, m, dmax, cmax, k_stop, max_iters, cnt)
                   : launch_both<false>(smem, smem, groups, stream, erased, vlist_idx,
                                        vlist_len, clist_idx, clist_len, packed, stop,
                                        erased_out, iters_out, B, n, m, dmax, cmax, k_stop,
                                        max_iters, cnt);
    return (int)err;
}
