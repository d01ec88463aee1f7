// Systematic triangular LDPC encode over GF(2) or GF(256) on packed 32-bit
// words.
//
// Replaces the TPU kernel ldpc_erasure_codes_tpu/ops/pallas_encode.py::
// encode_packed_vmem (bodies _make_kernel and _make_unrolled_kernel, both
// fields), which stages a tile of frames in VMEM and walks the parity rows
// in order.
//
// Function: out[b, :k] = src[b]; then for parity row i = 0..m-1 in order,
//   out[b, k+i] = XOR of src[b, enc_src_idx[i, :]]      (pad k: skipped)
//               ^ XOR of out[b, k+enc_par_idx[i, :]]    (pad m: skipped)
// (the reference's back-substitution p_i = H[i, :k+i] . v[:k+i]). In the
// GF(256) mode (kNB; four byte symbols per word) every term is first
// multiplied by its coefficient (enc_src_val, enc_par_val) and the row's sum
// by the inverse of its diagonal coefficient (enc_diag_inv)
// (ErasureCodes_NonBinaryLDPCSim.m:172-182).
//
// What bounds it on an H100: device-memory bytes. The least traffic reads
// the k source symbols of a frame and writes its n symbols (2.235 ms at
// (2040,1530), B = 2048, W = 256); a frame (2 MB at W = 256) is far larger
// than an SM's shared memory, and the parity rows read each other. There
// is no arithmetic to speak of in GF(2): one XOR per neighbour word. The
// GF(256) mode sums products by the rows' coefficients, bit-sliced
// (gf256.cuh::BitSlicedSum: a masked XOR per coefficient bit and word,
// then 7 multiplies by x), and multiplies by the diagonal's inverse.
//
// Design, the slab route (ldpc_encode_slab_launch), for every code whose
// slab fits: the back-substitution is shallow. Give each parity row a
// level, 0 for a row with no parity neighbour, else 1 + the highest level
// among its parity neighbours (27 levels for the 510 rows at (2040,1530),
// 60 / 77 / 57 at (2000,1000), (4000,2000), (4080,3060)); the rows of one
// level depend only on earlier levels. The host sorts the rows by level
// once and tables each row's source and parity neighbours, the GF(256)
// coefficients multiplied by the row's diagonal inverse
// (ops/encode.py::encode_levels, cached as CodeArrays.enc_levels).
// Persistent blocks, as many as fit on the card, each walk tasks (frame,
// chunk of Wc words) with the tables staged once. Per task a block holds
// the chunk of all n symbols in shared memory: the k source rows, loaded
// by cp.async (slab.cuh), all in flight at once, and the m parity rows.
// It sums every row's source neighbours at once (threads over (row, part
// of the chunk): the bulk of the work, ~10 terms a row, with every thread
// busy); then one warp per part of the chunk adds the parity terms level
// by level (~2 a row; a warp barrier per level) while the other warps
// write the source rows out and start the next task's loads into them;
// then the parity rows are written out. Every byte is read from device
// memory once and written once: the bound's bytes. The levels are few
// rows each (~19 at (2040,1530)) and serial, so they run on one warp per
// part, beside the memory traffic of the next task, not on the whole
// block between barriers (PERF.md has the layouts measured). Wc is
// the first of ops/encode.py::SLAB_WORDS whose block fits (slab_words):
// 16, 8, 4. Not 12: its 48-byte runs split 32-byte sectors of device
// memory between blocks, it ran 1.35x slower than 16 in an earlier layout
// (PERF.md), and no shipped code's slab fits 12 words where 16 does not.
//
// The per-warp route (ldpc_encode_launch), kept for codes whose slab of
// n x 4 words does not fit a block: a warp per (frame, chunk of 32*VEC
// words); each lane owns VEC words of every symbol and walks the rows in
// order on its own words only, reading neighbours from device memory.
// A lane only ever re-reads parity words it wrote itself, so no barrier or
// shared memory is needed. At (2040,1530), B = 2048, W = 256 its re-reads
// come to about 19 GB by count, mostly L2 misses: 7.185 ms against the
// 2.235 ms byte bound (NVIDIA H100 80GB HBM3, 700 W).

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "gf256.cuh"
#include "slab.cuh"
#include "words.cuh"

namespace {

constexpr int kThreads = 128;

template <int VEC, bool kNB>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ src_idx,
              const int32_t* __restrict__ par_idx, const uint8_t* __restrict__ src_val,
              const uint8_t* __restrict__ par_val, const uint8_t* __restrict__ diag_inv,
              int32_t* __restrict__ out, int B, int k, int m, int W, int dmax, int pmax) {
    using V = Words<VEC>;
    constexpr int kChunk = 32 * VEC;
    const int n_chunks = (W + kChunk - 1) / kChunk;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long task = t / 32;
    if (task >= (long long)B * n_chunks) return;
    const int b = (int)(task / n_chunks);
    const int w0 = (int)(task % n_chunks) * kChunk + (int)(t % 32) * VEC;
    if (w0 >= W) return;
    const int n = k + m;
    const int32_t* s = src + (size_t)b * k * W + w0;
    int32_t* o = out + (size_t)b * n * W + w0;

#pragma unroll 4
    for (int i = 0; i < k; ++i) V::load_ro(s + (size_t)i * W).store(o + (size_t)i * W);

    for (int r = 0; r < m; ++r) {
        V acc = V::zero();
        const int32_t* si = src_idx + (size_t)r * dmax;
        for (int j = 0; j < dmax; ++j) {
            const int c = __ldg(si + j);
            if (c >= k) continue;
            V t = V::load_ro(s + (size_t)c * W);
            if (kNB) t = gf_mul<VEC>(t, __ldg(src_val + (size_t)r * dmax + j));
            acc ^= t;
        }
        const int32_t* pi = par_idx + (size_t)r * pmax;
        for (int j = 0; j < pmax; ++j) {
            const int p = __ldg(pi + j);
            if (p >= m) continue;
            V t = V::load(o + (size_t)(k + p) * W);
            if (kNB) t = gf_mul<VEC>(t, __ldg(par_val + (size_t)r * pmax + j));
            acc ^= t;
        }
        if (kNB) acc = gf_mul<VEC>(acc, __ldg(diag_inv + r));
        acc.store(o + (size_t)(k + r) * W);
    }
}

template <int VEC, bool kNB>
cudaError_t launch(const int32_t* src, const int32_t* src_idx, const int32_t* par_idx,
                   const uint8_t* src_val, const uint8_t* par_val, const uint8_t* diag_inv,
                   int32_t* out, int B, int k, int m, int W, int dmax, int pmax,
                   cudaStream_t stream) {
    const int n_chunks = (W + 32 * VEC - 1) / (32 * VEC);
    const long long threads = (long long)B * n_chunks * 32;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    encode_kernel<VEC, kNB><<<blocks, kThreads, 0, stream>>>(
        src, src_idx, par_idx, src_val, par_val, diag_inv, out, B, k, m, W, dmax, pmax);
    return cudaGetLastError();
}

template <bool kNB>
cudaError_t launch_field(const int32_t* src, const int32_t* src_idx, const int32_t* par_idx,
                         const uint8_t* src_val, const uint8_t* par_val,
                         const uint8_t* diag_inv, int32_t* out, int B, int k, int m, int W,
                         int dmax, int pmax, cudaStream_t stream) {
    if (vec4_ok(W, {src, out}))
        return launch<4, kNB>(src, src_idx, par_idx, src_val, par_val, diag_inv, out, B, k, m,
                              W, dmax, pmax, stream);
    return launch<1, kNB>(src, src_idx, par_idx, src_val, par_val, diag_inv, out, B, k, m, W,
                          dmax, pmax, stream);
}

// Threads per slab-route block: the GF(256) sums hold eight partial sums
// in registers, so that mode takes half as many.
template <bool kNB>
__host__ __device__ constexpr int slab_threads() {
    return kNB ? 512 : 1024;
}

// The slab route's shared memory: the slab of n symbols and a zero symbol
// x Wc words; the source and parity tables, the parity counts and the rows
// (uint16); the level offsets (int32) and, GF(256), the coefficients.
__host__ __device__ inline int slab_bytes(int n, int m, int ds, int dp, int L, int wc, bool nb) {
    return 4 * (n + 1) * wc + round16(2 * m * ds) + round16(2 * m * dp) + 2 * round16(2 * m) +
           round16(4 * (L + 1)) + (nb ? round16(m * ds) + round16(m * dp) : 0);
}

// Persistent blocks, each over tasks (frame, chunk of VEC * P words)
// blockIdx.x, + gridDim.x, ...; the tables are staged once per block.
// Tables, for the m parity rows in level order q (ops/encode.py::
// encode_levels): order[q] the row; sidx[q, :ds] its source neighbours and
// pidx[q, :plen[q]] its parity neighbours as codeword symbols (pad n),
// scoef / pcoef their coefficients times the row's diagonal inverse; level
// l holds q in [lvl[l], lvl[l+1]). Shared memory holds the task's source
// rows S (and a zero row S[k], which pads read) and its parity rows Pm.
// Per task: wait for S; every row's source sum into Pm, all rows at once;
// then warp p adds the parity terms of part p of the chunk level by level
// in Pm while the other warps write S out and start the next task's loads
// into it; then all write Pm out. P <= the block's warps.
template <int VEC, int P, bool kNB>
__global__ void __launch_bounds__(slab_threads<kNB>())
encode_slab_kernel(const int32_t* __restrict__ src, const int16_t* __restrict__ order,
                   const int32_t* __restrict__ lvl_off, const int16_t* __restrict__ sidx,
                   const uint8_t* __restrict__ scoef, const int16_t* __restrict__ pidx,
                   const uint8_t* __restrict__ pcoef, const int16_t* __restrict__ plen,
                   int32_t* __restrict__ out, int k, int m, int ds, int dp, int L, int W,
                   int n_chunks, long long tasks, int rows) {
    using V = Words<VEC>;
    constexpr int T = slab_threads<kNB>();
    static_assert(P <= T / 32, "a warp per part of the chunk");
    constexpr int TM = T - 32 * P;  // threads that write S out and load the next task
    extern __shared__ __align__(16) uint8_t smem_raw[];
    const int n = k + m;
    V* S = reinterpret_cast<V*>(smem_raw);
    V* Pm = S + (k + 1) * P;
    uint8_t* p8 = smem_raw + (size_t)4 * (n + 1) * VEC * P;
    uint16_t* s_src = reinterpret_cast<uint16_t*>(p8);
    p8 += round16(2 * m * ds);
    uint16_t* s_par = reinterpret_cast<uint16_t*>(p8);
    p8 += round16(2 * m * dp);
    uint16_t* s_plen = reinterpret_cast<uint16_t*>(p8);
    p8 += round16(2 * m);
    uint16_t* s_row = reinterpret_cast<uint16_t*>(p8);
    p8 += round16(2 * m);
    int32_t* s_lvl = reinterpret_cast<int32_t*>(p8);
    p8 += round16(4 * (L + 1));
    uint8_t* s_scoef = p8;
    uint8_t* s_pcoef = p8 + round16(m * ds);

    const int t = threadIdx.x;
    stage_async(s_src, sidx, 2 * m * ds, t, T);
    stage_async(s_par, pidx, 2 * m * dp, t, T);
    stage_async(s_plen, plen, 2 * m, t, T);
    stage_async(s_row, order, 2 * m, t, T);
    stage_async(s_lvl, lvl_off, 4 * (L + 1), t, T);
    if (kNB) {
        stage_async(s_scoef, scoef, m * ds, t, T);
        stage_async(s_pcoef, pcoef, m * dp, t, T);
    }
    if (t < P) S[k * P + t] = V::zero();
    long long task = blockIdx.x;
    if (task < tasks) {
        const int w0 = (int)(task % n_chunks) * VEC * P;
        slab_load<VEC, P>(S, src + (size_t)(task / n_chunks) * k * W + w0, k, W, w0, t, T);
    }
    for (; task < tasks; task += gridDim.x) {
        const long long b = task / n_chunks;
        const int w0 = (int)(task % n_chunks) * VEC * P;
        int32_t* o = out + (size_t)b * n * W + w0;
        copy_async_wait();
        __syncthreads();
        // Every row's source sum (rows = m; 0 leaves the loads and the
        // stores alone, to time them apart).
        for (int i = t; i < rows * P; i += T) {
            const int q = i / P, p = i % P;
            const uint16_t* nb = s_src + q * ds;
            V acc = V::zero();
            if (kNB) {
                BitSlicedSum<VEC> sum;
                const uint8_t* cf = s_scoef + q * ds;
                for (int j = 0; j < ds; j += 4) {
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        const bool in = j + u < ds && nb[j + u] < k;  // pads: the zero row
                        sum.add(S[(in ? nb[j + u] : k) * P + p], in ? cf[j + u] : 0u);
                    }
                }
                acc = sum.sum();
            } else {
                // Neighbour indices eight at a time, so their reads and the
                // slab reads they address overlap.
                for (int j = 0; j < ds; j += 8) {
                    int ix[8];
#pragma unroll
                    for (int u = 0; u < 8; ++u) ix[u] = j + u < ds ? min((int)nb[j + u], k) : k;
#pragma unroll
                    for (int u = 0; u < 8; ++u) acc ^= S[ix[u] * P + p];
                }
            }
            Pm[s_row[q] * P + p] = acc;
        }
        __syncthreads();
        // Levels 1.. (level 0 rows have no parity term): each row adds its
        // parity neighbours, all of earlier levels. The parts of the chunk
        // are independent, so warp p works part p alone, its lanes over
        // the rows of a level, with a warp barrier between levels; the
        // other warps meanwhile write S out, then (once all of them have
        // read it) start the next task's loads into it.
        const int warp = t / 32;
        const bool next = task + gridDim.x < tasks;
        const long long nt = task + gridDim.x;
        const int nw0 = (int)(nt % n_chunks) * VEC * P;
        const int32_t* nsrc = src + (size_t)(nt / n_chunks) * k * W + nw0;
        if (warp < P) {
            const int p = warp, lane = t % 32;
            for (int l = 1; l < (rows ? L : 0); ++l) {
                const int start = s_lvl[l], end = s_lvl[l + 1];
                for (int q = start + lane; q < end; q += 32) {
                    const uint16_t* nb = s_par + q * dp;
                    const int d = s_plen[q];
                    V* dst = Pm + s_row[q] * P + p;
                    V acc = *dst;
                    if (kNB) {
                        BitSlicedSum<VEC> sum;
                        const uint8_t* cf = s_pcoef + q * dp;
                        for (int j = 0; j < d; ++j) sum.add(Pm[(nb[j] - k) * P + p], cf[j]);
                        acc ^= sum.sum();
                    } else {
                        for (int j = 0; j < d; j += 4) {
                            int ix[4];
#pragma unroll
                            for (int u = 0; u < 4; ++u) ix[u] = j + u < d ? nb[j + u] - k : -1;
#pragma unroll
                            for (int u = 0; u < 4; ++u)
                                if (ix[u] >= 0) acc ^= Pm[ix[u] * P + p];
                        }
                    }
                    *dst = acc;
                }
                __syncwarp();
            }
        } else {
            slab_store<VEC, P>(S, o, k, W, w0, t - 32 * P, TM);
            asm volatile("bar.sync 1, %0;\n" ::"r"(TM) : "memory");
            if (next) slab_load<VEC, P>(S, nsrc, k, W, nw0, t - 32 * P, TM);
        }
        __syncthreads();
        if (TM == 0) {  // no warp was left beside the levels
            slab_store<VEC, P>(S, o, k, W, w0, t, T);
            __syncthreads();
            if (next) slab_load<VEC, P>(S, nsrc, k, W, nw0, t, T);
        }
        slab_store<VEC, P>(Pm, o + (size_t)k * W, m, W, w0, t, T);
    }
}

template <int VEC, int P, bool kNB>
cudaError_t launch_slab(const int32_t* src, const int16_t* order, const int32_t* lvl_off,
                        const int16_t* sidx, const uint8_t* scoef, const int16_t* pidx,
                        const uint8_t* pcoef, const int16_t* plen, int32_t* out, int B, int k,
                        int m, int ds, int dp, int L, int W, int rows, cudaStream_t stream) {
    const size_t smem = slab_bytes(k + m, m, ds, dp, L, VEC * P, kNB);
    const auto kernel = encode_slab_kernel<VEC, P, kNB>;
    cudaError_t err;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return err;
    }
    // As many blocks as fit on the card at once; each walks its tasks.
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, slab_threads<kNB>(),
                                                        smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int n_chunks = (W + VEC * P - 1) / (VEC * P);
    const long long tasks = (long long)B * n_chunks;
    const long long grid = std::min<long long>(tasks, (long long)sms * per_sm);
    kernel<<<(unsigned)grid, slab_threads<kNB>(), smem, stream>>>(
        src, order, lvl_off, sidx, scoef, pidx, pcoef, plen, out, k, m, ds, dp, L, W, n_chunks,
        tasks, rows);
    return cudaGetLastError();
}

template <bool kNB>
cudaError_t slab_field(const int32_t* src, const int16_t* order, const int32_t* lvl_off,
                       const int16_t* sidx, const uint8_t* scoef, const int16_t* pidx,
                       const uint8_t* pcoef, const int16_t* plen, int32_t* out, int B, int k,
                       int m, int ds, int dp, int L, int W, int wc, int rows,
                       cudaStream_t stream) {
#define ENCODE_SLAB(VEC, P)                                                                 \
    return launch_slab<VEC, P, kNB>(src, order, lvl_off, sidx, scoef, pidx, pcoef, plen, out, \
                                    B, k, m, ds, dp, L, W, rows, stream)
    if (vec4_ok(W, {src, out})) {
        switch (wc) {
            case 4: ENCODE_SLAB(4, 1);
            case 8: ENCODE_SLAB(4, 2);
            case 16: ENCODE_SLAB(4, 4);
        }
    } else {
        switch (wc) {
            case 4: ENCODE_SLAB(1, 4);
            case 8: ENCODE_SLAB(1, 8);
            case 16: ENCODE_SLAB(1, 16);
        }
    }
#undef ENCODE_SLAB
    return cudaErrorInvalidValue;
}

}  // namespace

// The slab route: out (B, n, W) from src (B, k, W) with the tables of
// ops/encode.py::encode_levels in level order (order (m,), lvl_off (L + 1,),
// sidx / scoef (m, ds), pidx / pcoef (m, dp), plen (m,); the index tables
// int16, every table 16-byte aligned); Wc = wc words (4, 8 or 16) per
// block. compute = 0 runs the loads and stores alone. n < 32767, and the
// slab with the tables must fit a block's shared memory. nb = 0: GF(2),
// the coefficients are not read; nb = 1: GF(256).
extern "C" int ldpc_encode_slab_launch(const int32_t* src, const int16_t* order,
                                       const int32_t* lvl_off, const int16_t* sidx,
                                       const uint8_t* scoef, const int16_t* pidx,
                                       const uint8_t* pcoef, const int16_t* plen, int32_t* out,
                                       int B, int k, int m, int ds, int dp, int L, int W, int wc,
                                       int compute, int nb, cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (k + m >= 32767 || slab_bytes(k + m, m, ds, dp, L, wc, nb != 0) > kMaxSmem)
        return (int)cudaErrorInvalidValue;
    const int rows = compute ? m : 0;
    if (nb)
        return (int)slab_field<true>(src, order, lvl_off, sidx, scoef, pidx, pcoef, plen, out,
                                     B, k, m, ds, dp, L, W, wc, rows, stream);
    return (int)slab_field<false>(src, order, lvl_off, sidx, scoef, pidx, pcoef, plen, out, B,
                                  k, m, ds, dp, L, W, wc, rows, stream);
}

// The per-warp route. nb = 0: GF(2), the coefficient tables are not read;
// nb = 1: GF(256).
extern "C" int ldpc_encode_launch(const int32_t* src, const int32_t* src_idx,
                                  const int32_t* par_idx, const uint8_t* src_val,
                                  const uint8_t* par_val, const uint8_t* diag_inv,
                                  int32_t* out, int B, int k, int m, int W, int dmax, int pmax,
                                  int nb, cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (nb)
        return (int)launch_field<true>(src, src_idx, par_idx, src_val, par_val, diag_inv, out,
                                       B, k, m, W, dmax, pmax, stream);
    return (int)launch_field<false>(src, src_idx, par_idx, src_val, par_val, diag_inv, out, B,
                                    k, m, W, dmax, pmax, stream);
}

extern "C" const char* ldpc_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
