// Per-lane word vectors shared by the encode, peel and GF(2) product kernels.
//
// A lane owns VEC consecutive 32-bit words of every symbol of its frame
// (VEC = 4: one 16-byte access, so a warp moves 512 contiguous bytes of a
// symbol per instruction; VEC = 1 serves widths that are not a multiple of
// 4 words or buffers that are not 16-byte aligned). Neighbouring lanes own
// neighbouring words, so every access is coalesced.
#pragma once

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

template <int VEC>
struct Words;

template <>
struct Words<4> {
    int4 v;
    __device__ static Words zero() { return {make_int4(0, 0, 0, 0)}; }
    // Read-only path for inputs that no thread of the kernel writes.
    __device__ static Words load_ro(const int32_t* p) {
        return {__ldg(reinterpret_cast<const int4*>(p))};
    }
    __device__ static Words load(const int32_t* p) {
        return {*reinterpret_cast<const int4*>(p)};
    }
    __device__ void store(int32_t* p) const { *reinterpret_cast<int4*>(p) = v; }
    __device__ void operator^=(const Words& o) {
        v.x ^= o.v.x; v.y ^= o.v.y; v.z ^= o.v.z; v.w ^= o.v.w;
    }
    // The words of lane (this lane ^ o), all 32 lanes taking part.
    __device__ Words shfl_xor(int o) const {
        constexpr unsigned kAll = 0xffffffffu;
        return {make_int4(__shfl_xor_sync(kAll, v.x, o), __shfl_xor_sync(kAll, v.y, o),
                          __shfl_xor_sync(kAll, v.z, o), __shfl_xor_sync(kAll, v.w, o))};
    }
};

template <>
struct Words<1> {
    int32_t v;
    __device__ static Words zero() { return {0}; }
    __device__ static Words load_ro(const int32_t* p) { return {__ldg(p)}; }
    __device__ static Words load(const int32_t* p) { return {*p}; }
    __device__ void store(int32_t* p) const { *p = v; }
    __device__ void operator^=(const Words& o) { v ^= o.v; }
    __device__ Words shfl_xor(int o) const { return {__shfl_xor_sync(0xffffffffu, v, o)}; }
};

// True when every pointer is 16-byte aligned and W is a multiple of 4 words:
// the launchers then take the VEC = 4 kernels.
inline bool vec4_ok(int W, std::initializer_list<const void*> ptrs) {
    if (W % 4 != 0) return false;
    for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
    return true;
}
