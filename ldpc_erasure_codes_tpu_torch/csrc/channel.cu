// Fused erasure channel: per64 erasures drawn on the device and the erased
// value slots zeroed in the same pass.
//
// Replaces the TPU kernel ldpc_erasure_codes_tpu/ops/pallas_channel.py::
// channel_apply_per64, the analog of the FPGA's data_in kernel
// (OpenCL/device/ldpc_erasure_decoder_top.cl:84-116): one random word per
// symbol, erased when its low six bits are below the numerator (PER =
// num / 64), and the erased slots zeroed. The TPU kernel seeds its hardware
// PRNG per (8 x 256) tile, so its bits depend on its grid and cannot be
// reproduced. Here the word is Philox-4x32-10 (Salmon et al., SC'11, the
// Random123 round function) keyed by (seed, 0) with the counter
// (symbol, frame, 0, 0), output word 0: the mask is a function of (seed,
// frame, symbol) alone, whatever the launch grid, and the plain PyTorch
// version (ops/channel.py) computes the same words.
//
// What bounds it on an H100: bytes. Each value word is read once and
// written once, plus one mask byte per symbol: 2 * B * n * W * 4 + B * n
// bytes, 8.56 GB at (2040,1530), B = 2048, W = 256 (2.56 ms at 3.35 TB/s);
// Philox is ~10 x 8 integer operations per symbol (~0.03 ms there).
//
// Design: a warp takes 32 consecutive symbols, each lane draws one symbol's
// word (so the mask store is one coalesced 32-byte write) and a ballot
// shares the 32 flags; then the warp copies the 32 symbols one after the
// other, its lanes on the words (16 bytes a lane where the width and the
// pointers allow, VEC = 4), writing zeros without reading for an erased
// symbol.

#include <cstdint>

#include <cuda_runtime.h>

#include "words.cuh"

namespace {

constexpr int kThreads = 256;

// Word 0 of Philox-4x32-10 of the counter (c0, c1, 0, 0) under key (k0, 0).
__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1, uint32_t k0) {
    uint32_t c2 = 0, c3 = 0, k1 = 0;
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
        c0 = hi1 ^ c1 ^ k0;
        c1 = lo1;
        c2 = hi0 ^ c3 ^ k1;
        c3 = lo0;
        k0 += 0x9E3779B9u;
        k1 += 0xBB67AE85u;
    }
    return c0;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
channel_kernel(const int32_t* __restrict__ values, int32_t* __restrict__ out,
               uint8_t* __restrict__ mask, int n, int W, long long total, uint32_t seed,
               uint32_t num) {
    using V = Words<VEC>;
    const int lane = threadIdx.x % 32;
    const long long warps = (long long)gridDim.x * (kThreads / 32);
    for (long long base = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32 * 32;
         base < total; base += warps * 32) {
        const long long sym = base + lane;
        bool erased = false;
        if (sym < total) {
            const uint32_t frame = (uint32_t)(sym / n);
            const uint32_t s = (uint32_t)(sym - (long long)frame * n);
            erased = (philox_word0(s, frame, seed) & 63u) < num;
            mask[sym] = erased;
        }
        const uint32_t flags = __ballot_sync(0xffffffffu, erased);
        const int count = (int)min(32LL, total - base);
        for (int t = 0; t < count; ++t) {
            const size_t off = (size_t)(base + t) * W;
            const bool zero = (flags >> t) & 1u;
            for (int w = lane * VEC; w < W; w += 32 * VEC) {
                const V v = zero ? V::zero() : V::load_ro(values + off + w);
                v.store(out + off + w);
            }
        }
    }
}

}  // namespace

// out (B, n, W) = values with erased slots zeroed; mask (B, n) uint8 0/1.
extern "C" int ldpc_channel_launch(const int32_t* values, int32_t* out, uint8_t* mask, int B,
                                   int n, int W, int seed, int num, cudaStream_t stream) {
    const long long total = (long long)B * n;
    if (total == 0) return (int)cudaSuccess;
    // A block covers 256 symbols per pass (a warp per 32); the grid strides.
    const long long need = (total + kThreads - 1) / kThreads;
    const int blocks = (int)(need < 132LL * 16 ? need : 132LL * 16);
    if (vec4_ok(W, {values, out}))
        channel_kernel<4><<<blocks, kThreads, 0, stream>>>(values, out, mask, n, W, total,
                                                          (uint32_t)seed, (uint32_t)num);
    else
        channel_kernel<1><<<blocks, kThreads, 0, stream>>>(values, out, mask, n, W, total,
                                                          (uint32_t)seed, (uint32_t)num);
    return (int)cudaGetLastError();
}
