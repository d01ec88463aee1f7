// The "counted" research schedule of the peeling decode, binary and
// GF(256), with the channel masking fused into the copy-in. The other two
// research schedules, "grouped" and "jacobi", are visit orders of
// csrc/peel.cu's schedule kernel and share its slab value kernel.
//
// Replaces the TPU kernel of ldpc_erasure_codes_tpu/ops/pallas_peel.py::
// peel_decode_vmem (:1281, pallas_call :1753) built by _make_counted_kernel
// (:586). It computes the function of the sequential kernel (csrc/peel.cu,
// the MATLAB Gauss-Seidel sweep), bit for bit, iteration counts included.
//
// A warp takes one (frame, chunk of 32*VEC words), holds its own copy of
// the frame's erasure flags in shared memory, and keeps the values in
// device memory; a frame stops after the first sweep that leaves its first
// k_stop symbols known (iters = that sweep) or that changes nothing (iters
// = max_iters); only chunk 0 writes the flags and the count. What bounds it
// on an H100 is per resolved symbol a chain of dependent reads of its
// check's neighbours from device memory (mostly L2 misses).
//
// The per-check erased counts are state, bytes in shared memory (cnt[m]
// beside the flags: n + m bytes per warp), counted once from the flags.
// When a check resolves symbol e, lane j decrements the count of e's j-th
// check (the Clist: distinct checks, no race). The sweep then reads counts
// 32 checks at a time, one byte a lane, and a ballot gives the first check
// of the window whose count is 1; after it resolves, the window is read
// again past it. A check whose count is not 1 when its turn comes is
// skipped, in order, so the schedule stays Gauss-Seidel: counts only fall,
// and a check that is not visited in the ballot's order is one the
// sequential sweep would skip too.
//
// GF(256) mode (kNB): a check's sum is weighted by its coefficients and the
// solved symbol is inv_s times it, as in csrc/peel.cu.

#include <cstdint>

#include <cuda_runtime.h>

#include "gf256.cuh"
#include "words.cuh"

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Tables {
    const int32_t* vlist_idx;
    const int32_t* vlist_len;
    const uint8_t* vlist_val;
    const uint8_t* vlist_inv;
    const int32_t* clist_idx;
    const int32_t* clist_len;
    int m, dmax, cmax;
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// Shared-memory bytes of one warp: the flags, then the per-check counts.
__host__ __device__ inline int warp_bytes(int n, int m) { return round16(n) + round16(m); }

// The weighted (GF(256)) or plain sum of check c's neighbours, over this
// lane's words.
template <int VEC, bool kNB>
__device__ __forceinline__ Words<VEC> check_sum(const int32_t* o, const Tables& t, int c,
                                                 int d, int W) {
    const int32_t* nb = t.vlist_idx + (size_t)c * t.dmax;
    Words<VEC> acc = Words<VEC>::zero();
    for (int j = 0; j < d; ++j) {
        Words<VEC> v = Words<VEC>::load(o + (size_t)__ldg(nb + j) * W);
        if (kNB) v = gf_mul<VEC>(v, __ldg(t.vlist_val + (size_t)c * t.dmax + j));
        acc ^= v;
    }
    return acc;
}

// Check c's erased neighbours, counted from the shared flags.
__device__ __forceinline__ int count_erased(const uint8_t* er, const Tables& t, int c, int d) {
    const int32_t* nb = t.vlist_idx + (size_t)c * t.dmax;
    int cnt = 0;
    for (int j = 0; j < d; ++j) cnt += er[__ldg(nb + j)];
    return cnt;
}

template <int VEC, bool kNB>
__global__ void __launch_bounds__(kWarps * 32)
peel_sched_kernel(const int32_t* __restrict__ values, const uint8_t* __restrict__ erased,
                  Tables t, int32_t* __restrict__ out, uint8_t* __restrict__ erased_out,
                  int32_t* __restrict__ iters_out, int B, int n, int W, int k_stop,
                  int max_iters) {
    using V = Words<VEC>;
    constexpr int kChunk = 32 * VEC;
    extern __shared__ __align__(16) uint8_t smem[];
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int m = t.m;
    const int n_chunks = (W + kChunk - 1) / kChunk;
    const long long task = (long long)blockIdx.x * kWarps + warp;
    if (task >= (long long)B * n_chunks) return;  // whole warp: no block barrier follows
    const int b = (int)(task / n_chunks);
    const int chunk = (int)(task % n_chunks);
    const int w0 = chunk * kChunk + lane * VEC;
    const bool own = w0 < W;  // lanes past the ragged edge keep only the flags
    uint8_t* er = smem + (size_t)warp * warp_bytes(n, m);
    uint8_t* cnt = er + round16(n);
    const int32_t* in = values + (size_t)b * n * W + w0;
    int32_t* o = out + (size_t)b * n * W + w0;

    for (int i = lane; i < n; i += 32) er[i] = erased[(size_t)b * n + i] != 0;
    __syncwarp();
    if (own) {
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
            const V v = er[i] ? V::zero() : V::load_ro(in + (size_t)i * W);
            v.store(o + (size_t)i * W);
        }
    }
    for (int c = lane; c < m; c += 32)
        cnt[c] = (uint8_t)count_erased(er, t, c, __ldg(t.vlist_len + c));
    __syncwarp();

    int iters = max_iters;
    for (int it = 0; it < max_iters; ++it) {
        int changed = 0;
        for (int c0 = 0; c0 < m; c0 += 32) {
            int next = c0;  // the first check of the window not yet visited
            while (true) {
                const int c = c0 + lane;
                const bool hit = c >= next && c < m && cnt[c] == 1;
                const unsigned bal = __ballot_sync(kFull, hit);
                if (bal == 0) break;
                const int cs = c0 + __ffs(bal) - 1;
                const int d = __ldg(t.vlist_len + cs);
                const int32_t* nb = t.vlist_idx + (size_t)cs * t.dmax;
                int e = 0, es = 0;
                for (int j0 = 0; j0 < d; j0 += 32) {  // the one erased neighbour
                    const int j = j0 + lane;
                    const int s = j < d ? __ldg(nb + j) : 0;
                    const unsigned eb = __ballot_sync(kFull, j < d && er[s]);
                    if (eb) {
                        es = j0 + __ffs(eb) - 1;
                        e = __shfl_sync(kFull, s, __ffs(eb) - 1);
                    }
                }
                if (own) {
                    V acc = check_sum<VEC, kNB>(o, t, cs, d, W);
                    if (kNB) acc = gf_mul<VEC>(acc, __ldg(t.vlist_inv + (size_t)cs * t.dmax + es));
                    acc.store(o + (size_t)e * W);
                }
                __syncwarp();
                if (lane == 0) er[e] = 0;
                const int32_t* cl = t.clist_idx + (size_t)e * t.cmax;
                const int dl = __ldg(t.clist_len + e);
                for (int j = lane; j < dl; j += 32) cnt[__ldg(cl + j)] -= 1;
                __syncwarp();
                ++changed;
                next = cs + 1;
            }
        }
        int resid = 0;
        for (int i = lane; i < k_stop; i += 32) resid += er[i];
        resid = __reduce_add_sync(kFull, resid);
        if (resid == 0) {
            iters = it + 1;
            break;
        }
        if (changed == 0) break;
    }

    if (chunk == 0) {
        for (int i = lane; i < n; i += 32) erased_out[(size_t)b * n + i] = er[i];
        if (lane == 0) iters_out[b] = iters;
    }
}

template <int VEC, bool kNB>
cudaError_t launch(const int32_t* values, const uint8_t* erased, const Tables& t, int32_t* out,
                   uint8_t* erased_out, int32_t* iters_out, int B, int n, int W, int k_stop,
                   int max_iters, cudaStream_t stream) {
    const size_t smem = (size_t)kWarps * warp_bytes(n, t.m);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            peel_sched_kernel<VEC, kNB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int n_chunks = (W + 32 * VEC - 1) / (32 * VEC);
    const long long tasks = (long long)B * n_chunks;
    const unsigned blocks = (unsigned)((tasks + kWarps - 1) / kWarps);
    peel_sched_kernel<VEC, kNB><<<blocks, kWarps * 32, smem, stream>>>(
        values, erased, t, out, erased_out, iters_out, B, n, W, k_stop, max_iters);
    return cudaGetLastError();
}

}  // namespace

// nb = 0: GF(2), the coefficient tables are not read; nb = 1: GF(256).
// dmax <= 255 (byte counts).
extern "C" int ldpc_peel_counted_launch(const int32_t* values, const uint8_t* erased,
                                        const int32_t* vlist_idx, const int32_t* vlist_len,
                                        const uint8_t* vlist_val, const uint8_t* vlist_inv,
                                        const int32_t* clist_idx, const int32_t* clist_len,
                                        int32_t* out, uint8_t* erased_out, int32_t* iters_out,
                                        int B, int n, int m, int dmax, int cmax, int W,
                                        int k_stop, int max_iters, int nb,
                                        cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (dmax > 255) return (int)cudaErrorInvalidValue;
    const Tables t{vlist_idx, vlist_len, vlist_val, vlist_inv, clist_idx, clist_len,
                   m, dmax, cmax};
    const bool v4 = vec4_ok(W, {values, out});
#define PEEL_COUNTED(VEC, NB)                                                            \
    return (int)launch<VEC, NB>(values, erased, t, out, erased_out, iters_out, B, n, W, \
                                k_stop, max_iters, stream)
    if (nb) {
        if (v4) PEEL_COUNTED(4, true);
        PEEL_COUNTED(1, true);
    }
    if (v4) PEEL_COUNTED(4, false);
    PEEL_COUNTED(1, false);
#undef PEEL_COUNTED
}
