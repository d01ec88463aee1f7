// GF(2^8) arithmetic on packed 32-bit words: four field elements per word,
// byte j in bits 8j..8j+7 (the little-endian view of a byte payload).
// Field polynomial x^8 + x^6 + x^5 + x^4 + 1 (0x171), the reference's.
//
// A product by a coefficient c is double-and-add over c's bits with the
// SWAR multiply-by-x below: about 6 integer operations per doubling, all
// four bytes at once. Where every lane of a warp multiplies by the same c
// (one coefficient per check, row or pivot; the lanes own words), the
// branches on c's bits are uniform and cost no divergence. The other
// choice, 256-entry log/exp tables in shared memory, takes per byte two
// gathers, an add and a zero test, and the four bytes of a word go apart:
// about as many instructions per word, plus bank conflicts on
// data-dependent addresses. The SWAR form needs no table and no staging.
#pragma once

#include <cstdint>

#include "words.cuh"

// Multiply each byte of v by x: a byte that overflows its top bit wraps
// modulo the polynomial's low byte 0x71.
__device__ __forceinline__ uint32_t gf_xtime4(uint32_t v) {
    const uint32_t hi = (v >> 7) & 0x01010101u;
    return ((v << 1) & 0xFEFEFEFEu) ^ (hi * 0x71u);
}

// Each byte of v times the field element c (0..255).
__device__ __forceinline__ uint32_t gf_mul4(uint32_t v, uint32_t c) {
    uint32_t acc = 0;
    while (c) {
        if (c & 1u) acc ^= v;
        c >>= 1;
        if (c) v = gf_xtime4(v);
    }
    return acc;
}

// Nibble products: the table that turns a product by any coefficient into
// two reads. For a packed word x0, row j (1..15) holds the XOR of x0 * x^t
// over the set bits t of j and row 16 + j the same with x0 * x^(4 + t);
// rows 0 and 16 hold zero (the caller writes them once). Then c * x0 =
// row (c & 15) ^ row (16 + (c >> 4)). Rows lie `stride` words apart from
// tb: csrc/gfmm.cu gives each thread a column (stride = its block width),
// csrc/elim.cu each pivot-row word 32 consecutive words (stride 1). Seven
// doublings and 22 XORs per word.
__device__ __forceinline__ void nibble_products(uint32_t* tb, uint32_t x0, int stride) {
    const uint32_t x1 = gf_xtime4(x0), x2 = gf_xtime4(x1), x3 = gf_xtime4(x2);
    const uint32_t x4 = gf_xtime4(x3), x5 = gf_xtime4(x4), x6 = gf_xtime4(x5);
    const uint32_t x7 = gf_xtime4(x6);
    uint32_t* lo = tb;
    uint32_t* hi = tb + 16 * stride;
    const uint32_t a3 = x0 ^ x1, b3 = x4 ^ x5;
    const uint32_t a[15] = {x0, x1, a3, x2, x2 ^ x0, x2 ^ x1, x2 ^ a3, x3, x3 ^ x0, x3 ^ x1,
                            x3 ^ a3, x3 ^ x2, x3 ^ x2 ^ x0, x3 ^ x2 ^ x1, x3 ^ x2 ^ a3};
    const uint32_t h[15] = {x4, x5, b3, x6, x6 ^ x4, x6 ^ x5, x6 ^ b3, x7, x7 ^ x4, x7 ^ x5,
                            x7 ^ b3, x7 ^ x6, x7 ^ x6 ^ x4, x7 ^ x6 ^ x5, x7 ^ x6 ^ b3};
#pragma unroll
    for (int k = 0; k < 15; ++k) {
        lo[(k + 1) * stride] = a[k];
        hi[(k + 1) * stride] = h[k];
    }
}

__device__ __forceinline__ uint32_t lookup(const uint8_t* tab, uint32_t off) {
    return *reinterpret_cast<const uint32_t*>(tab + off);
}

// c * x0 for the coefficient c given as the byte offsets u of its two
// nibble products in the table (low half: bits 0..15, high half: 16..31).
__device__ __forceinline__ uint32_t nibble_product(const uint8_t* tbytes, uint32_t u) {
    return lookup(tbytes, u & 0xFFFFu) ^ lookup(tbytes, u >> 16);
}

// The table offsets of coefficient c for rows `stride` words apart
// (ops/nbmm.py::matrix_tiles's offs); 128 * stride must stay below 65536.
__device__ __forceinline__ uint32_t nibble_offsets(uint32_t c, int stride) {
    const uint32_t row = 4u * (uint32_t)stride;
    return (c & 15u) * row | ((16u + (c >> 4)) * row) << 16;
}

template <int VEC>
__device__ __forceinline__ Words<VEC> gf_mul(Words<VEC> w, uint32_t c);

template <>
__device__ __forceinline__ Words<4> gf_mul<4>(Words<4> w, uint32_t c) {
    uint32_t x = w.v.x, y = w.v.y, z = w.v.z, t = w.v.w;
    uint32_t ax = 0, ay = 0, az = 0, at = 0;
    while (c) {
        if (c & 1u) {
            ax ^= x; ay ^= y; az ^= z; at ^= t;
        }
        c >>= 1;
        if (c) {
            x = gf_xtime4(x); y = gf_xtime4(y); z = gf_xtime4(z); t = gf_xtime4(t);
        }
    }
    return {make_int4((int)ax, (int)ay, (int)az, (int)at)};
}

template <>
__device__ __forceinline__ Words<1> gf_mul<1>(Words<1> w, uint32_t c) {
    return {(int32_t)gf_mul4((uint32_t)w.v, c)};
}

// Word-vector helpers for bit-sliced sums of products: a multiply by x of
// every byte, and a masked XOR (mk is 0 or all ones).
__device__ __forceinline__ Words<4> xtime(Words<4> w) {
    return {make_int4((int)gf_xtime4(w.v.x), (int)gf_xtime4(w.v.y), (int)gf_xtime4(w.v.z),
                      (int)gf_xtime4(w.v.w))};
}
__device__ __forceinline__ Words<1> xtime(Words<1> w) { return {(int32_t)gf_xtime4(w.v)}; }
__device__ __forceinline__ void xor_masked(Words<4>& a, const Words<4>& y, int mk) {
    a.v.x ^= y.v.x & mk; a.v.y ^= y.v.y & mk; a.v.z ^= y.v.z & mk; a.v.w ^= y.v.w & mk;
}
__device__ __forceinline__ void xor_masked(Words<1>& a, const Words<1>& y, int mk) {
    a.v ^= y.v & mk;
}

// sum_j c_j * y_j over GF(256), bit-sliced: the terms enter with one
// masked XOR per coefficient bit into eight partial sums S_t (the words
// whose coefficient has bit t), which Horner's rule folds at the end
// (7 multiplies by x). Threads whose terms have different coefficients
// then run the same instructions. Feed terms with add(), read with sum().
template <int VEC>
struct BitSlicedSum {
    Words<VEC> s[8];
    __device__ BitSlicedSum() {
#pragma unroll
        for (int q = 0; q < 8; ++q) s[q] = Words<VEC>::zero();
    }
    __device__ __forceinline__ void add(const Words<VEC>& y, uint32_t c) {
#pragma unroll
        for (int q = 0; q < 8; ++q) xor_masked(s[q], y, -(int)((c >> q) & 1u));
    }
    __device__ __forceinline__ Words<VEC> sum() const {
        Words<VEC> acc = s[7];
#pragma unroll
        for (int q = 6; q >= 0; --q) {
            acc = xtime(acc);
            acc ^= s[q];
        }
        return acc;
    }
};
