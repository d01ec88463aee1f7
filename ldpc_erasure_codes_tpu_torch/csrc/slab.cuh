// Shared-memory slabs: a block's chunk of Wc words of every symbol row of
// one frame, filled by asynchronous copies (cp.async), all in flight at
// once, so the block waits for device memory once instead of once per
// row. The peel's value kernel (peel.cu), the list route of the dense
// GF(2) syndrome (f2mm.cu) and the encode (encode.cu) load their slabs
// with slab_load.
//
// Layout: a chunk of Wc = VEC * P words is P parts of VEC words; part p of
// row s sits at slab[s * P + p], so the P threads that share a row read
// neighbouring addresses.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "words.cuh"

// Bytes of shared memory a block may use on the H100.
constexpr int kMaxSmem = 232448;

__host__ __device__ inline int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// Asynchronous copy of one lane's words into shared memory (cp.async),
// with the hint that L2 fetch the whole 128-byte line: the other chunks of
// the symbol, which neighbouring blocks load at about the same time, then
// hit in L2 instead of each costing a device-memory access of its own.
template <int VEC>
__device__ __forceinline__ void copy_async(void* dst, const int32_t* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (VEC == 4)
        asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s), "l"(src)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4;\n" ::"r"(s), "l"(src)
                     : "memory");
}
__device__ __forceinline__ void copy_async_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of a table of ``nbytes`` bytes from device memory into
// shared memory, both 16-byte aligned: whole 16-byte pieces by cp.async
// (waited for with the slab), the tail byte by byte. Threads t of T.
__device__ __forceinline__ void stage_async(void* dst, const void* src, int nbytes, int t,
                                            int T) {
    const int n16 = nbytes / 16;
    for (int i = t; i < n16; i += T)
        copy_async<4>(static_cast<int4*>(dst) + i,
                      reinterpret_cast<const int32_t*>(static_cast<const int4*>(src) + i));
    for (int i = 16 * n16 + t; i < nbytes; i += T)
        static_cast<uint8_t*>(dst)[i] = __ldg(static_cast<const uint8_t*>(src) + i);
}

// Every row takes part (slab_load's default filter).
struct AllRows {
    __device__ bool operator()(int) const { return true; }
};

// Starts the copies of rows [0, rows) of one frame's chunk into the slab:
// ``in`` points at word w0 of the frame's row 0, rows W words apart.
// Parts past W, and rows that keep(s) refuses, are zeroed instead. Threads
// t of T share the work; the caller waits with copy_async_wait and a
// block barrier before it reads the slab.
template <int VEC, int P, class Keep = AllRows>
__device__ __forceinline__ void slab_load(Words<VEC>* slab, const int32_t* in, int rows, int W,
                                          int w0, int t, int T, Keep keep = Keep()) {
    for (int i = t; i < rows * P; i += T) {
        const int s = i / P, p = i % P;
        if (w0 + p * VEC < W && keep(s))
            copy_async<VEC>(slab + i, in + (size_t)s * W + p * VEC);
        else
            slab[i] = Words<VEC>::zero();
    }
}

// Writes rows [0, rows) of the slab out to ``o`` (word w0 of the frame's
// row 0), skipping parts past W.
template <int VEC, int P>
__device__ __forceinline__ void slab_store(const Words<VEC>* slab, int32_t* o, int rows, int W,
                                           int w0, int t, int T) {
#pragma unroll 4
    for (int i = t; i < rows * P; i += T) {
        const int s = i / P, p = i % P;
        if (w0 + p * VEC < W) slab[i].store(o + (size_t)s * W + p * VEC);
    }
}
