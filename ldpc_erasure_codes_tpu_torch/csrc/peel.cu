// Sequential (Gauss-Seidel) peeling decode of binary LDPC erasure codes on
// packed 32-bit words, with the channel masking fused into the copy-in.
//
// Replaces the TPU kernels of ldpc_erasure_codes_tpu/ops/pallas_peel.py::
// peel_decode_vmem: the constant-topology program _make_unrolled_kernel
// (with fence_gate) and the runtime-topology _make_kernel "seq" body. Both
// compute one function, the MATLAB sweep (utils/oracle.py::peel_decode):
// every sweep visits the checks in ROM order; a check whose neighbours hold
// exactly one erasure sets that symbol to the XOR of all its neighbours
// (erased slots hold zero) and clears its flag at once, so later checks of
// the same sweep see it. Unrolling and fence gating are devices for the
// TPU's compiler with identical results, and are not carried over.
//
// GF(256) mode (kNB, the kernels' gf_order=256 branch; four byte symbols per
// word): the degree-1 check's sum is weighted, acc = sum_j coef_j * y_j
// (the erased slot holds zero, so its term vanishes), and the solved symbol
// is inv_s * acc with inv_s the inverse of the erased slot's coefficient
// (pallas_peel.py:295-300, :1009-1036). The coefficients and inverses are
// read from device memory beside the Vlist (vlist_val, vlist_inv_val). The
// TPU's Horner form shares 8 doublings across a check's terms because its
// rows sit in vector registers; here each term is a load followed by its
// own double-and-add product with the coefficient's bits as warp-uniform
// branches, which keeps no per-check array of loaded words. The mask
// evolution is the binary decode's.
//
// Stopping is per frame (the TPU stops a whole 32-frame tile): a frame
// stops after the first sweep that leaves its first k_stop symbols known
// (iters = that sweep's number) or that changes nothing (iters = max_iters).
// Values, iteration counts and the first-k mask equal the TPU kernel's;
// with k_stop < n the parity-region residual may differ (its tile sweeps on
// for other frames).
//
// What bounds it on an H100: one frame is (n+1) symbols of W words, 2 MB at
// W = 256, so a frame cannot live in one SM's 227 KB of shared memory the
// way a TPU tile lives in VMEM. Values stay in device memory: one read and
// one write for the copy-in, then per resolved symbol a read of its check's
// neighbours and one write, about 15 symbol reads per erasure at the
// headline point. That traffic, mostly L2 misses, bounds the kernel; the
// per-check erasure counting is shared-memory work that overlaps it.
//
// Design: the erasure flags evolve independently of the values, and they
// fit (n bytes). A warp takes one (frame, chunk of 32*VEC words) and keeps
// its own copy of the frame's flags in shared memory. Every lane counts a
// check's erased neighbours itself from the shared flags (a broadcast read),
// so a degree-1 event is uniform across the warp; each lane XORs and stores
// only its own words of the symbol. Then __syncwarp(), lane 0 clears the
// flag, __syncwarp() again: no lane can see a symbol as known before every
// lane has written its words of it. Warps share nothing, so there is no
// block-wide barrier; the chunks of one frame repeat the same mask sweep,
// and only chunk 0 writes the erased flags and the iteration count. The
// topology is read through the read-only cache (__ldg), so no code is too
// large for shared memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "gf256.cuh"
#include "words.cuh"

namespace {

constexpr int kWarps = 4;

template <int VEC, bool kNB>
__global__ void __launch_bounds__(kWarps * 32)
peel_kernel(const int32_t* __restrict__ values, const uint8_t* __restrict__ erased,
            const int32_t* __restrict__ vlist_idx, const int32_t* __restrict__ vlist_len,
            const uint8_t* __restrict__ vlist_val, const uint8_t* __restrict__ vlist_inv,
            int32_t* __restrict__ out, uint8_t* __restrict__ erased_out,
            int32_t* __restrict__ iters_out, int B, int n, int m, int dmax, int W,
            int k_stop, int max_iters, int flag_stride) {
    using V = Words<VEC>;
    constexpr int kChunk = 32 * VEC;
    extern __shared__ uint8_t smem[];
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int n_chunks = (W + kChunk - 1) / kChunk;
    const long long task = (long long)blockIdx.x * kWarps + warp;
    if (task >= (long long)B * n_chunks) return;  // whole warp: no block barrier follows
    const int b = (int)(task / n_chunks);
    const int chunk = (int)(task % n_chunks);
    const int w0 = chunk * kChunk + lane * VEC;
    const bool own = w0 < W;  // lanes past the ragged edge keep only the flags
    uint8_t* er = smem + (size_t)warp * flag_stride;
    const int32_t* in = values + (size_t)b * n * W + w0;
    int32_t* o = out + (size_t)b * n * W + w0;

    for (int i = lane; i < n; i += 32) er[i] = erased[(size_t)b * n + i] != 0;
    __syncwarp();

    // Copy-in with the channel masking fused: erased slots hold zero.
    if (own) {
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
            const V v = er[i] ? V::zero() : V::load_ro(in + (size_t)i * W);
            v.store(o + (size_t)i * W);
        }
    }

    int iters = max_iters;
    for (int it = 0; it < max_iters; ++it) {
        int changed = 0;
        for (int c = 0; c < m; ++c) {
            const int32_t* nb = vlist_idx + (size_t)c * dmax;
            const int d = __ldg(vlist_len + c);
            int cnt = 0;
            int e = 0;
            int es = 0;
            for (int j = 0; j < d; ++j) {
                const int s = __ldg(nb + j);
                if (er[s]) {
                    ++cnt;
                    e = s;
                    es = j;
                }
            }
            if (cnt != 1) continue;  // the same decision in every lane
            if (own) {
                V acc = V::zero();
                for (int j = 0; j < d; ++j) {
                    V t = V::load(o + (size_t)__ldg(nb + j) * W);
                    if (kNB) t = gf_mul<VEC>(t, __ldg(vlist_val + (size_t)c * dmax + j));
                    acc ^= t;
                }
                if (kNB) acc = gf_mul<VEC>(acc, __ldg(vlist_inv + (size_t)c * dmax + es));
                acc.store(o + (size_t)e * W);
            }
            __syncwarp();
            if (lane == 0) er[e] = 0;
            __syncwarp();
            ++changed;
        }
        int resid = 0;
        for (int i = lane; i < k_stop; i += 32) resid += er[i];
        resid = __reduce_add_sync(0xffffffffu, resid);
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
cudaError_t launch(const int32_t* values, const uint8_t* erased, const int32_t* vlist_idx,
                   const int32_t* vlist_len, const uint8_t* vlist_val, const uint8_t* vlist_inv,
                   int32_t* out, uint8_t* erased_out, int32_t* iters_out, int B, int n, int m,
                   int dmax, int W, int k_stop, int max_iters, cudaStream_t stream) {
    const int flag_stride = (n + 15) / 16 * 16;
    const size_t smem = (size_t)kWarps * flag_stride;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            peel_kernel<VEC, kNB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int n_chunks = (W + 32 * VEC - 1) / (32 * VEC);
    const long long tasks = (long long)B * n_chunks;
    const unsigned blocks = (unsigned)((tasks + kWarps - 1) / kWarps);
    peel_kernel<VEC, kNB><<<blocks, kWarps * 32, smem, stream>>>(
        values, erased, vlist_idx, vlist_len, vlist_val, vlist_inv, out, erased_out, iters_out,
        B, n, m, dmax, W, k_stop, max_iters, flag_stride);
    return cudaGetLastError();
}

template <bool kNB>
cudaError_t launch_field(const int32_t* values, const uint8_t* erased,
                         const int32_t* vlist_idx, const int32_t* vlist_len,
                         const uint8_t* vlist_val, const uint8_t* vlist_inv, int32_t* out,
                         uint8_t* erased_out, int32_t* iters_out, int B, int n, int m,
                         int dmax, int W, int k_stop, int max_iters, cudaStream_t stream) {
    if (vec4_ok(W, {values, out}))
        return launch<4, kNB>(values, erased, vlist_idx, vlist_len, vlist_val, vlist_inv, out,
                              erased_out, iters_out, B, n, m, dmax, W, k_stop, max_iters,
                              stream);
    return launch<1, kNB>(values, erased, vlist_idx, vlist_len, vlist_val, vlist_inv, out,
                          erased_out, iters_out, B, n, m, dmax, W, k_stop, max_iters, stream);
}

}  // namespace

// nb = 0: GF(2), the coefficient tables are not read; nb = 1: GF(256).
extern "C" int ldpc_peel_launch(const int32_t* values, const uint8_t* erased,
                                const int32_t* vlist_idx, const int32_t* vlist_len,
                                const uint8_t* vlist_val, const uint8_t* vlist_inv,
                                int32_t* out, uint8_t* erased_out, int32_t* iters_out, int B,
                                int n, int m, int dmax, int W, int k_stop, int max_iters, int nb,
                                cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (nb)
        return (int)launch_field<true>(values, erased, vlist_idx, vlist_len, vlist_val,
                                       vlist_inv, out, erased_out, iters_out, B, n, m, dmax, W,
                                       k_stop, max_iters, stream);
    return (int)launch_field<false>(values, erased, vlist_idx, vlist_len, vlist_val, vlist_inv,
                                    out, erased_out, iters_out, B, n, m, dmax, W, k_stop,
                                    max_iters, stream);
}
