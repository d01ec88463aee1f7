// The research schedules of the peeling decode: "counted", "grouped" and
// "jacobi", binary and GF(256), with the channel masking fused into the
// copy-in.
//
// Replaces the TPU kernels of ldpc_erasure_codes_tpu/ops/pallas_peel.py::
// peel_decode_vmem (:1281, pallas_call :1753) built by _make_counted_kernel
// (:586), _make_grouped_kernel (:1101) and _make_jacobi_kernel (:377).
// "counted" and "grouped" compute the function of the sequential kernel
// (csrc/peel.cu, the MATLAB Gauss-Seidel sweep), bit for bit, iteration
// counts included; "jacobi" computes the Jacobi sweep of the XLA decoders
// (ops/peel.py peel_step_gather): every check tests its erasure count on the
// sweep-start flags, and all degree-1 checks solve in that sweep.
//
// All three keep csrc/peel.cu's layout and its stop rule: a warp takes one
// (frame, chunk of 32*VEC words), holds its own copy of the frame's erasure
// flags in shared memory, and keeps the values in device memory; a frame
// stops after the first sweep that leaves its first k_stop symbols known
// (iters = that sweep) or that changes nothing (iters = max_iters); only
// chunk 0 writes the flags and the count. What bounds csrc/peel.cu on an
// H100 is per resolved symbol a chain of dependent reads of its check's
// neighbours from device memory (mostly L2 misses), plus, per sweep, every
// lane counting every check's erased neighbours from the shared flags.
// Each schedule attacks one part:
//
// counted: the per-check erased counts become state, bytes in shared memory
//   (cnt[m] beside the flags: n + m bytes per warp), counted once from the
//   flags. When a check resolves symbol e, lane j decrements the count of
//   e's j-th check (the Clist: distinct checks, no race). The sweep then
//   reads counts 32 checks at a time, one byte a lane, and a ballot gives the
//   first check of the window whose count is 1; after it resolves, the
//   window is read again past it. A check whose count is not 1 when its turn
//   comes is skipped, in order, so the schedule stays Gauss-Seidel: counts
//   only fall, and a check that is not visited in the ballot's order is one
//   the sequential sweep would skip too.
//
// grouped: consecutive checks come in pairwise-disjoint groups of up to 4
//   (CodeArrays.check_groups, pad = m). Disjoint checks commute under the
//   sequential sweep, so the members' degree-1 tests are made first and all
//   their neighbour loads are issued before any member stores: up to four
//   independent load chains per lane in flight against the latency of the
//   device-memory reads.
//
// jacobi: sweep-start detection. The 32 lanes count the erased neighbours of
//   32 checks at a time (a check each) from the shared flags and write the
//   degree-1 checks, as their Vlist slot c * dmax + es of the erased
//   neighbour, to a list in shared memory (4m bytes per warp) in check
//   order. Only the listed checks do wide work, and the flags are cleared
//   after the sweep. Two listed checks may share their erased slot s: each
//   writes the sum of its other neighbours, which were all known at sweep
//   start and are never written in the sweep, so the value is exact whether
//   or not s was written already, and the last check in order leaves its
//   value (the exclude-self identity of pallas_peel.py:415-421). A lane
//   reads only its own words, so listed checks need no barrier between them.
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

enum Schedule { kCounted = 0, kGrouped = 1, kJacobi = 2 };

struct Tables {
    const int32_t* vlist_idx;
    const int32_t* vlist_len;
    const uint8_t* vlist_val;
    const uint8_t* vlist_inv;
    const int32_t* clist_idx;
    const int32_t* clist_len;
    const int32_t* groups;
    int m, dmax, cmax, ngroups;
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// Shared-memory bytes of one warp: the flags, then the schedule's state.
__host__ __device__ inline int warp_bytes(int schedule, int n, int m) {
    if (schedule == kCounted) return round16(n) + round16(m);
    if (schedule == kJacobi) return round16(n) + 4 * m;
    return round16(n);
}

// The weighted (GF(256)) or plain sum of check c's neighbours other than
// slot `skip` (-1: all of them), over this lane's words.
template <int VEC, bool kNB>
__device__ __forceinline__ Words<VEC> check_sum(const int32_t* o, const Tables& t, int c,
                                                 int d, int skip, int W) {
    const int32_t* nb = t.vlist_idx + (size_t)c * t.dmax;
    Words<VEC> acc = Words<VEC>::zero();
    for (int j = 0; j < d; ++j) {
        if (j == skip) continue;
        Words<VEC> v = Words<VEC>::load(o + (size_t)__ldg(nb + j) * W);
        if (kNB) v = gf_mul<VEC>(v, __ldg(t.vlist_val + (size_t)c * t.dmax + j));
        acc ^= v;
    }
    return acc;
}

// Every lane counts check c's erased neighbours from the shared flags (a
// broadcast read): the count, the last erased slot and its neighbour index.
__device__ __forceinline__ int count_erased(const uint8_t* er, const Tables& t, int c, int d,
                                            int& e, int& es) {
    const int32_t* nb = t.vlist_idx + (size_t)c * t.dmax;
    int cnt = 0;
    for (int j = 0; j < d; ++j) {
        const int s = __ldg(nb + j);
        if (er[s]) {
            ++cnt;
            e = s;
            es = j;
        }
    }
    return cnt;
}

template <int VEC, bool kNB, int kSched>
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
    uint8_t* er = smem + (size_t)warp * warp_bytes(kSched, n, m);
    uint8_t* cnt = er + round16(n);                                // counted
    int32_t* list = reinterpret_cast<int32_t*>(er + round16(n));  // jacobi
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
    if (kSched == kCounted) {
        for (int c = lane; c < m; c += 32) {
            int e, es;
            cnt[c] = (uint8_t)count_erased(er, t, c, __ldg(t.vlist_len + c), e, es);
        }
        __syncwarp();
    }

    int iters = max_iters;
    for (int it = 0; it < max_iters; ++it) {
        int changed = 0;
        if (kSched == kCounted) {
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
                        V acc = check_sum<VEC, kNB>(o, t, cs, d, -1, W);
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
        } else if (kSched == kGrouped) {
            for (int g = 0; g < t.ngroups; ++g) {
                int c[4], d[4], e[4], es[4];
                bool fire[4];
                bool any = false;
                int dm = 0;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    c[q] = __ldg(t.groups + (size_t)g * 4 + q);
                    fire[q] = false;
                    d[q] = 0;
                    e[q] = es[q] = 0;
                    if (c[q] < m) {
                        d[q] = __ldg(t.vlist_len + c[q]);
                        fire[q] = count_erased(er, t, c[q], d[q], e[q], es[q]) == 1;
                    }
                    if (fire[q]) {
                        any = true;
                        dm = max(dm, d[q]);
                    }
                }
                if (!any) continue;  // the same decision in every lane
                if (own) {
                    V acc[4];
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[q] = V::zero();
                    // All members' loads before any member's store.
                    for (int j = 0; j < dm; ++j) {
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
                            if (!fire[q] || j >= d[q]) continue;
                            const size_t slot = (size_t)c[q] * t.dmax + j;
                            V v = V::load(o + (size_t)__ldg(t.vlist_idx + slot) * W);
                            if (kNB) v = gf_mul<VEC>(v, __ldg(t.vlist_val + slot));
                            acc[q] ^= v;
                        }
                    }
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        if (!fire[q]) continue;
                        if (kNB)
                            acc[q] = gf_mul<VEC>(acc[q],
                                                 __ldg(t.vlist_inv + (size_t)c[q] * t.dmax + es[q]));
                        acc[q].store(o + (size_t)e[q] * W);
                    }
                }
                __syncwarp();
                if (lane == 0) {
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        if (fire[q]) er[e[q]] = 0;
                }
                __syncwarp();
#pragma unroll
                for (int q = 0; q < 4; ++q) changed += fire[q];
            }
        } else {  // kJacobi
            int nlist = 0;
            for (int c0 = 0; c0 < m; c0 += 32) {
                const int c = c0 + lane;
                int k = 0, e = 0, es = 0;
                if (c < m) k = count_erased(er, t, c, __ldg(t.vlist_len + c), e, es);
                const unsigned bal = __ballot_sync(kFull, k == 1);
                if (k == 1) list[nlist + __popc(bal & ((1u << lane) - 1u))] = c * t.dmax + es;
                nlist += __popc(bal);
            }
            __syncwarp();
            if (own) {
                for (int i = 0; i < nlist; ++i) {
                    const int slot = list[i];
                    const int c = slot / t.dmax;
                    const int es = slot - c * t.dmax;
                    V acc = check_sum<VEC, kNB>(o, t, c, __ldg(t.vlist_len + c), es, W);
                    if (kNB) acc = gf_mul<VEC>(acc, __ldg(t.vlist_inv + slot));
                    acc.store(o + (size_t)__ldg(t.vlist_idx + slot) * W);
                }
            }
            __syncwarp();
            for (int i = lane; i < nlist; i += 32) er[__ldg(t.vlist_idx + list[i])] = 0;
            __syncwarp();
            changed = nlist;
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

template <int VEC, bool kNB, int kSched>
cudaError_t launch(const int32_t* values, const uint8_t* erased, const Tables& t, int32_t* out,
                   uint8_t* erased_out, int32_t* iters_out, int B, int n, int W, int k_stop,
                   int max_iters, cudaStream_t stream) {
    const size_t smem = (size_t)kWarps * warp_bytes(kSched, n, t.m);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            peel_sched_kernel<VEC, kNB, kSched>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int n_chunks = (W + 32 * VEC - 1) / (32 * VEC);
    const long long tasks = (long long)B * n_chunks;
    const unsigned blocks = (unsigned)((tasks + kWarps - 1) / kWarps);
    peel_sched_kernel<VEC, kNB, kSched><<<blocks, kWarps * 32, smem, stream>>>(
        values, erased, t, out, erased_out, iters_out, B, n, W, k_stop, max_iters);
    return cudaGetLastError();
}

template <int VEC, bool kNB>
cudaError_t launch_sched(int schedule, const int32_t* values, const uint8_t* erased,
                         const Tables& t, int32_t* out, uint8_t* erased_out, int32_t* iters_out,
                         int B, int n, int W, int k_stop, int max_iters, cudaStream_t stream) {
    switch (schedule) {
        case kCounted:
            return launch<VEC, kNB, kCounted>(values, erased, t, out, erased_out, iters_out, B, n,
                                              W, k_stop, max_iters, stream);
        case kGrouped:
            return launch<VEC, kNB, kGrouped>(values, erased, t, out, erased_out, iters_out, B, n,
                                              W, k_stop, max_iters, stream);
        case kJacobi:
            return launch<VEC, kNB, kJacobi>(values, erased, t, out, erased_out, iters_out, B, n,
                                             W, k_stop, max_iters, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// schedule: 0 counted, 1 grouped, 2 jacobi. nb = 0: GF(2), the coefficient
// tables are not read; nb = 1: GF(256). clist_idx/clist_len are read by
// "counted" only, groups (ngroups, 4) by "grouped" only.
extern "C" int ldpc_peel_sched_launch(int schedule, const int32_t* values, const uint8_t* erased,
                                      const int32_t* vlist_idx, const int32_t* vlist_len,
                                      const uint8_t* vlist_val, const uint8_t* vlist_inv,
                                      const int32_t* clist_idx, const int32_t* clist_len,
                                      const int32_t* groups, int32_t* out, uint8_t* erased_out,
                                      int32_t* iters_out, int B, int n, int m, int dmax, int cmax,
                                      int ngroups, int W, int k_stop, int max_iters, int nb,
                                      cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (schedule == kCounted && dmax > 255) return (int)cudaErrorInvalidValue;  // byte counts
    const Tables t{vlist_idx, vlist_len, vlist_val, vlist_inv, clist_idx, clist_len, groups,
                   m, dmax, cmax, ngroups};
    const bool v4 = vec4_ok(W, {values, out});
    if (nb) {
        if (v4)
            return (int)launch_sched<4, true>(schedule, values, erased, t, out, erased_out,
                                              iters_out, B, n, W, k_stop, max_iters, stream);
        return (int)launch_sched<1, true>(schedule, values, erased, t, out, erased_out, iters_out,
                                          B, n, W, k_stop, max_iters, stream);
    }
    if (v4)
        return (int)launch_sched<4, false>(schedule, values, erased, t, out, erased_out,
                                           iters_out, B, n, W, k_stop, max_iters, stream);
    return (int)launch_sched<1, false>(schedule, values, erased, t, out, erased_out, iters_out, B,
                                       n, W, k_stop, max_iters, stream);
}
