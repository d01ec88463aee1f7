// Swap-free Gauss-Jordan elimination over GF(2) of packed-bit [A | T] rows,
// one frame per block.
//
// Replaces the TPU kernel ldpc_erasure_codes_tpu/ops/pallas_elim.py::
// f2_eliminate, which holds a (C, m_pad, 128-frame) cube in VMEM with the
// batch on the 128 lanes and walks the pivot columns in a fori_loop.
//
// Function, per frame (rows r < m of C words; bit col of a row is bit
// col & 31 of word col >> 5), for col = 0 .. ub-1:
//   1. pivot p = the first row not yet used as a pivot whose bit col is set;
//   2. mark p used; pivrow[col] = p, or 0 when there is no pivot;
//   3. every other row with bit col set XORs in row p;
//   4. failed |= (no pivot) && col < nreal.
// ub = emax, or with a_words > 0 the batch's widest residual
// min(max(nreal), emax), read from a device scalar (*ncols). With
// a_words > 0 the words w < min(col >> 5, a_words) are skipped: they hold A
// columns already eliminated, zero in the pivot row of every frame that
// has not failed (pallas_elim.py:272-287). pivrow is 0 past ub.
//
// What bounds it on an H100: not the work (at the (2040,1530) GE bucket,
// 448 frames of 510 rows x 32 words, ~7e7 word XORs, a few microseconds at
// the INT32 rate) and not the bytes (the cube in and out once, 58 MB), but
// the chain of dependent steps per column: a pivot search over the rows,
// then the update of the rows that hold the column's bit.
//
// Design: the same function computed 32 columns (one word j, a "panel") at
// a time, the blocked order of ops/elim.py::f2_eliminate_panels_reference.
// A frame is one block of 8 warps; its cube sits in dynamic shared memory
// (rows at an odd stride where that fits, so a column of 32 rows hits 32
// banks) where it fits and in device memory where it does not ((4000,2000):
// 2000 rows of up to 95 words). Per panel j:
//   1. the block copies word j of every row to a panel array and ORs it
//      (__syncthreads_or): a panel that is zero in every row finds no pivot
//      and changes nothing, so it only sets failed where 32j < nreal (at
//      the bucket about half the panels below the batch's widest residual
//      are such);
//   2. warp 0 runs the panel's column steps in registers: lane l holds the
//      panel words of rows l, l + 32, ... (R = 8..64 of them, a template
//      parameter) and a combination word S_r per row, the panel's pivots
//      whose starting rows row r has absorbed. Per column: each lane's
//      first unused candidate from a bit mask over its rows,
//      __reduce_min_sync for the pivot, two shuffles for its word and S,
//      and every row that holds the bit takes row ^= pivot word and
//      S_r ^= S_p | 1 << i: no shared-memory round trip and no barrier;
//   3. the block stages the panel's pivot rows as they were before the panel
//      (words [c0, C), c0 = min(j, a_words) with the cuts, else 0: the words
//      the column order updates for each column of the panel), in groups of
//      G words where shared memory is short, and every row with S_r != 0
//      XORs in the staged rows of S_r (a warp per row, lanes on words).
// A live panel costs four block barriers where the column order took two
// per column and a 32-row walk per warp.
//
// GF(256) (gf256_elim_kernel) replaces pallas_elim.py::gf256_eliminate, the
// elimination of ge.py::ge_solve_wide_nb, a column at a time on byte
// columns (byte col & 3 of word col >> 2, four bytes per word), one frame
// per block of 16 warps (4 for cubes of at most 128 rows), the cube in
// shared memory (rows padded to an odd stride) or in device memory, chosen
// by size. Per column:
//   1. pivot p = the first unused row whose byte col is nonzero (the choice
//      of ge.py:589-594); warp w owns rows w, w + nwarps, ...: it keeps
//      their bytes in shared memory as the elimination factors, takes the
//      least candidate among them (__reduce_min_sync) and atomicMin's it
//      into a pivot slot (three, rotating, so that one barrier serves);
//   2. the block tables the nibble products of the pivot row as it stands,
//      words [c0, C) (gf256.cuh: 32 multiples per word, 33 words apart);
//   3. the normalisation is folded into the factors: with pinv the inverse
//      of the pivot byte (log and antilog tables in shared memory), the
//      pivot row becomes its table at pinv and every other row with factor
//      f != 0 takes row ^= table[f * pinv]: two table reads and an XOR per
//      word. Each lane folds one of its warp's rows' factors; the rows that
//      take an update are listed (ballot, popc) and updated four at a time,
//      lanes on words, their loads issued before their stores;
//   4. each warp then searches the next column over its own rows.
// Two block barriers per column: the pivot slot, the table. The a_words
// cuts and the device-scalar loop bound are the binary kernel's.
//
// What bounds it on an H100: not the bytes (the cube in and out once) and
// not the operations (one XOR per set factor bit: 0.017 ms at the
// RS(255,192) batch, 1024 cubes of 63 rows x 32 words), but the chain of
// dependent steps per column. The kernel it replaces multiplied by
// double-and-add (about 50 dependent instructions a word, after a
// normalise-then-update pair of barriers): 0.564 ms at the RS batch. The
// table makes a product two reads; what is left is the column's fixed
// chain (search, table build, two barriers): 0.089 ms of 0.152 at the RS
// batch by chip_smoke.py's split (the same cubes with an identity A block),
// 0.526 of 1.643 ms at the (2040,1530) escalation cube (31 frames of 510
// rows x 224 words, device memory), on NVIDIA H100 80GB HBM3, 700.00 W. A
// frame per warp (several per block, __syncwarp only, the pivot by two
// ballots) ran at 0.496 ms at the RS batch against 0.206 for a block of 4
// warps in a trial build: ~8 warps an SM cannot hide the chain.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "gf256.cuh"

namespace {

constexpr int kThreads = 512;  // the GF(256) kernel's block
constexpr unsigned kFull = 0xffffffffu;

// The GF(256) kernel's cube rows, padded to an odd stride in shared memory.
int row_stride(int C) { return C | 1; }

// The binary kernel: a block of 8 warps; warp 0 holds a frame's panel words
// in registers, R per lane (rows lane, lane + 32, ...), R = 8, 16, 32 or 64.
constexpr int kElimThreads = 256;
constexpr int kElimWarps = kElimThreads / 32;
constexpr int kMaxRows = 64 * 32;

// Shared memory of the binary kernel, in words, besides the union U: the
// panel's 32 pivot rows, the combination words, and the cube's rows at
// ``stride`` words when it lives there.
size_t elim_fixed_words(int m, int stride, bool in_smem) {
    return 32 + (size_t)m + (in_smem ? (size_t)m * stride : 0);
}

// U holds the panel words (m) while warp 0 loads them, then the staged
// pivot rows (32 x G words); G = C where that fits the device's opt-in
// limit, else the widest group that does. 0 when even G = 1 does not fit.
int staged_words(int m, int C, int stride, bool in_smem, size_t optin_bytes) {
    const size_t fixed = elim_fixed_words(m, stride, in_smem);
    const size_t room = optin_bytes / 4 > fixed ? optin_bytes / 4 - fixed : 0;
    if (room < (size_t)std::max(m, 32)) return 0;
    return (int)std::min<size_t>(C, room / 32);
}

struct ElimPlan {
    int stride = 0;  // of the cube's rows (C | 1 in shared memory where it fits)
    int G = 0;       // words per staged group; 0: does not fit
    size_t bytes = 0;
};

ElimPlan elim_plan(int m, int C, bool in_smem, size_t optin_bytes) {
    ElimPlan plan;
    for (const int stride : {in_smem ? (C | 1) : C, C}) {
        const int G = staged_words(m, C, stride, in_smem, optin_bytes);
        if (G > 0) {
            plan.stride = stride;
            plan.G = G;
            plan.bytes = 4 * (elim_fixed_words(m, stride, in_smem) + std::max(m, 32 * G));
            return plan;
        }
    }
    return plan;
}

template <int R>
using RowMask = typename std::conditional<(R > 32), unsigned long long, uint32_t>::type;

template <bool kSmem, int R>
__global__ void __launch_bounds__(kElimThreads)
elim_kernel(const uint32_t* __restrict__ in, uint32_t* out, const int32_t* __restrict__ nreal,
            const int32_t* __restrict__ ncols, int32_t* __restrict__ pivrow,
            int32_t* __restrict__ failed, int m, int C, int emax, int a_words, int stride,
            int G, bool vec4) {
    using Mask = RowMask<R>;
    extern __shared__ uint32_t smem[];
    const int b = blockIdx.x;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    int* piv = reinterpret_cast<int*>(smem);
    uint32_t* comb = smem + 32;
    uint32_t* u = comb + m;  // panel words, then staged pivot rows
    const uint32_t* src = in + (size_t)b * m * C;
    uint32_t* dst = out + (size_t)b * m * C;
    uint32_t* cube = kSmem ? u + max(m, 32 * G) : dst;
    // The frame in (16-byte pieces where the frame and its rows allow).
    if (vec4) {
#pragma unroll 4
        for (int i = threadIdx.x; i < m * C / 4; i += kElimThreads) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = (4 * i + q) / C;
                cube[(size_t)r * stride + (4 * i + q - r * C)] = w[q];
            }
        }
    } else {
        for (int i = threadIdx.x; i < m * C; i += kElimThreads) {
            const int r = i / C;
            cube[(size_t)r * stride + (i - r * C)] = src[i];
        }
    }
    __syncthreads();

    const int ub = a_words ? min(max(*ncols, 0), emax) : emax;
    const int nr = nreal[b];
    int fail = 0;  // thread 0's
    Mask used = 0;  // warp 0's: bit k of lane l is row l + 32k
    int32_t* prow_out = pivrow + (size_t)b * emax;
    for (int j = 0; 32 * j < ub; ++j) {
        const int ncol = min(32, ub - 32 * j);
        // 1. The panel words, and the zero-panel skip.
        uint32_t any = 0;
        for (int r = threadIdx.x; r < m; r += kElimThreads) {
            const uint32_t w = cube[(size_t)r * stride + j];
            u[r] = w;
            any |= w;
        }
        if (!__syncthreads_or(any != 0)) {
            if ((int)threadIdx.x < ncol) prow_out[32 * j + threadIdx.x] = 0;
            if (threadIdx.x == 0) fail |= 32 * j < nr;
            continue;
        }
        // 2. The column steps on word j, in warp 0's registers.
        if (warp == 0) {
            uint32_t pw[R], cw[R];
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const int r = 32 * k + lane;
                pw[k] = r < m ? u[r] : 0u;
                cw[k] = 0;
            }
            for (int i = 0; i < ncol; ++i) {
                Mask col = 0;
#pragma unroll
                for (int k = 0; k < R; ++k) col |= (Mask)((pw[k] >> i) & 1u) << k;
                const Mask cand = col & ~used;
                int first = 0;
                if (cand) first = R > 32 ? __ffsll((long long)cand) : __ffs((uint32_t)cand);
                const unsigned p = __reduce_min_sync(
                    kFull, cand ? (unsigned)(lane + 32 * (first - 1)) : 0xffffffffu);
                if (lane == 0) {
                    const bool has = p != 0xffffffffu;
                    prow_out[32 * j + i] = has ? (int)p : 0;
                    piv[i] = has ? (int)p : -1;
                    fail |= !has && 32 * j + i < nr;
                }
                if (p == 0xffffffffu) continue;
                const int kp = p >> 5;
                uint32_t sw = 0, sc = 0;
#pragma unroll
                for (int k = 0; k < R; ++k)
                    if (k == kp) {
                        sw = pw[k];
                        sc = cw[k];
                    }
                const uint32_t pv = __shfl_sync(kFull, sw, p & 31);
                const uint32_t ps = __shfl_sync(kFull, sc, p & 31) | (1u << i);
                const Mask self = lane == (int)(p & 31) ? (Mask)1 << kp : 0;
                used |= self;
                const Mask take = col & ~self;
#pragma unroll
                for (int k = 0; k < R; ++k)
                    if ((take >> k) & 1u) {
                        pw[k] ^= pv;
                        cw[k] ^= ps;
                    }
            }
#pragma unroll
            for (int k = 0; k < R; ++k)
                if (32 * k + lane < m) comb[32 * k + lane] = cw[k];
        }
        __syncthreads();
        // 3. The staged pivot rows into every row that absorbed them.
        const int c0 = a_words ? min(j, a_words) : 0;
        for (int g0 = c0; g0 < C; g0 += G) {
            const int gw = min(G, C - g0);
            for (int t = threadIdx.x; t < ncol * gw; t += kElimThreads) {
                const int i = t / gw;
                const int p = piv[i];
                if (p >= 0) u[i * G + (t - i * gw)] = cube[(size_t)p * stride + g0 + (t - i * gw)];
            }
            __syncthreads();
            for (int r = warp; r < m; r += kElimWarps) {
                const uint32_t s = comb[r];
                if (!s) continue;
                uint32_t* row = cube + (size_t)r * stride + g0;
                for (int w = lane; w < gw; w += 32) {
                    uint32_t acc = row[w];
                    for (uint32_t bits = s; bits; bits &= bits - 1)
                        acc ^= u[(__ffs(bits) - 1) * G + w];
                    row[w] = acc;
                }
            }
            __syncthreads();
        }
    }

    for (int col = ub + threadIdx.x; col < emax; col += kElimThreads) prow_out[col] = 0;
    if (threadIdx.x == 0) failed[b] = fail;
    if (kSmem && vec4) {
#pragma unroll 4
        for (int i = threadIdx.x; i < m * C / 4; i += kElimThreads) {
            uint32_t w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = (4 * i + q) / C;
                w[q] = cube[(size_t)r * stride + (4 * i + q - r * C)];
            }
            reinterpret_cast<uint4*>(dst)[i] = make_uint4(w[0], w[1], w[2], w[3]);
        }
    } else if (kSmem) {
        for (int i = threadIdx.x; i < m * C; i += kElimThreads) {
            const int r = i / C;
            dst[i] = cube[(size_t)r * stride + (i - r * C)];
        }
    }
}

size_t optin_bytes() {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
        return 0;
    return (size_t)optin;
}

template <bool kSmem, int R>
cudaError_t launch_rows(const uint32_t* in, uint32_t* out, const int32_t* nreal,
                        const int32_t* ncols, int32_t* pivrow, int32_t* failed, int B, int m,
                        int C, int emax, int a_words, const ElimPlan& plan,
                        cudaStream_t stream) {
    const auto kernel = elim_kernel<kSmem, R>;
    if (plan.bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.bytes);
        if (err != cudaSuccess) return err;
    }
    // 16-byte pieces where every frame starts on a 16-byte boundary.
    const bool vec4 = (size_t)m * C % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
    kernel<<<B, kElimThreads, plan.bytes, stream>>>(in, out, nreal, ncols, pivrow, failed, m,
                                                    C, emax, a_words, plan.stride, plan.G, vec4);
    return cudaGetLastError();
}

// Rows per lane of warp 0: the least of 8, 16, 32, 64 that holds m rows.
template <bool kSmem>
cudaError_t launch(const uint32_t* in, uint32_t* out, const int32_t* nreal,
                   const int32_t* ncols, int32_t* pivrow, int32_t* failed, int B, int m,
                   int C, int emax, int a_words, cudaStream_t stream) {
    const ElimPlan plan = elim_plan(m, C, kSmem, optin_bytes());
    if (plan.G < 1 || m > kMaxRows) return cudaErrorInvalidValue;
    const int chunks = (m + 31) / 32;
#define ELIM_ROWS(R) \
    launch_rows<kSmem, R>(in, out, nreal, ncols, pivrow, failed, B, m, C, emax, a_words, plan, \
                          stream)
    if (chunks <= 8) return ELIM_ROWS(8);
    if (chunks <= 16) return ELIM_ROWS(16);
    if (chunks <= 32) return ELIM_ROWS(32);
    return ELIM_ROWS(64);
#undef ELIM_ROWS
}

// The GF(256) kernel's nibble table: the 32 nibble products of each word
// of the pivot row (gf256.cuh), 32 consecutive words per cube word at a
// stride of 33, so that the lanes of a warp (consecutive words, the same
// table row) hit 32 banks when they build it and when they read it.
constexpr int kTabStride = 33;

// The GF(256) kernel's block: 4 warps for cubes of at most 128 rows (the RS
// point: 63 rows), so that more frames share an SM; 16 for the LDPC cubes.
int gf256_threads(int m) { return m <= 128 ? 128 : kThreads; }

// Shared memory of the GF(256) kernel, in words: a list of 32 (row,
// offsets) pairs per warp, the nibble table, the cube when it lives there,
// used bits, the column's bytes (one per row), three pivot slots (and one
// word of padding), and the log and doubled antilog tables (256 + 512
// bytes).
size_t gf256_smem_bytes(int m, int C, bool in_smem) {
    const size_t chunks = (m + 31) / 32;
    size_t words = chunks + (m + 3) / 4 + 4 + 192 + 64 * (size_t)(gf256_threads(m) / 32) +
                   (size_t)kTabStride * C;
    if (in_smem) words += (size_t)m * row_stride(C);
    return words * sizeof(uint32_t);
}

// Rows e[0..N) of the cube after the column, words [c0, C) of each (a lane
// per word): the pivot row p takes its table at pinv, every other row
// row ^ (f * pinv) * pivot row; e[i] = (row, its folded table offsets).
// The N rows' loads are issued before their stores.
template <int N>
__device__ __forceinline__ void update_rows(uint32_t* cube, int stride, const int2* e,
                                            const uint8_t* tab, int p, int c0, int C,
                                            int lane) {
    int2 rows[N];
#pragma unroll
    for (int i = 0; i < N; ++i) rows[i] = e[i];
    for (int w = c0 + lane; w < C; w += 32) {
        const uint8_t* tb = tab + 4 * kTabStride * w;
        uint32_t prod[N], old[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
            prod[i] = nibble_product(tb, (uint32_t)rows[i].y);
            old[i] = cube[(size_t)rows[i].x * stride + w];
        }
#pragma unroll
        for (int i = 0; i < N; ++i)
            cube[(size_t)rows[i].x * stride + w] = rows[i].x == p ? prod[i] : old[i] ^ prod[i];
    }
}

// One frame per block. Warp w owns rows w, w + nwarps, ...: it finds the
// pivot candidates among them and updates them. Per column two block
// barriers: A (the pivot slot complete) and B (the table built); each warp
// searches the next column over its own rows right after updating them.
template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
gf256_elim_kernel(const uint32_t* __restrict__ in, uint32_t* out,
                  const int32_t* __restrict__ nreal, const int32_t* __restrict__ ncols,
                  int32_t* __restrict__ pivrow, int32_t* __restrict__ failed,
                  const int32_t* __restrict__ log_tab, const uint8_t* __restrict__ exp_tab,
                  int m, int C, int emax, int a_words, int stride) {
    extern __shared__ uint32_t smem[];
    const int b = blockIdx.x;
    const int nthreads = blockDim.x;
    const int nwarps = nthreads / 32;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int chunks = (m + 31) / 32;
    int2* wlist = reinterpret_cast<int2*>(smem) + warp * 32;
    uint32_t* tab = smem + 64 * nwarps;
    const uint8_t* tbytes = reinterpret_cast<const uint8_t*>(tab);
    uint32_t* used = tab + kTabStride * C + (kSmem ? m * stride : 0);
    uint8_t* colv = reinterpret_cast<uint8_t*>(used + chunks);
    int* piv_slot = reinterpret_cast<int*>(used + chunks + (m + 3) / 4);
    uint8_t* s_log = reinterpret_cast<uint8_t*>(piv_slot + 4);
    uint8_t* s_exp = s_log + 256;
    const uint32_t* src = in + (size_t)b * m * C;
    uint32_t* dst = out + (size_t)b * m * C;
    uint32_t* cube;
    if (kSmem) {
        cube = tab + kTabStride * C;
        for (int i = threadIdx.x; i < m * C; i += nthreads) {
            const int r = i / C;
            cube[r * stride + (i - r * C)] = src[i];
        }
    } else {
        cube = dst;
        for (int i = threadIdx.x; i < m * C; i += nthreads) dst[i] = src[i];
    }
    for (int i = threadIdx.x; i < 256; i += nthreads) s_log[i] = (uint8_t)__ldg(log_tab + i);
    for (int i = threadIdx.x; i < 512; i += nthreads) s_exp[i] = __ldg(exp_tab + i);
    for (int w = threadIdx.x; w < C; w += nthreads)
        tab[kTabStride * w] = tab[kTabStride * w + 16] = 0;
    for (int j = threadIdx.x; j < chunks; j += nthreads) used[j] = 0;
    if (threadIdx.x < 3) piv_slot[threadIdx.x] = INT_MAX;
    __syncthreads();

    // This warp's rows' bytes of column c into colv, and the first of them
    // that is nonzero and not yet a pivot into slot c % 3.
    const auto search = [&](int c) {
        const int cw = c >> 2;
        const unsigned sh = 8u * (c & 3);
        int best = INT_MAX;
        for (int base = warp; base < m; base += 32 * nwarps) {
            const int r = base + lane * nwarps;
            uint32_t byte = 0;
            if (r < m) {
                byte = (cube[(size_t)r * stride + cw] >> sh) & 0xFFu;
                colv[r] = (uint8_t)byte;
            }
            const bool cand = byte != 0 && !((used[r >> 5] >> (r & 31)) & 1u);
            best = min(best, (int)__reduce_min_sync(kFull, cand ? (unsigned)r : INT_MAX));
        }
        if (lane == 0 && best != INT_MAX) atomicMin(&piv_slot[c % 3], best);
    };

    const int ub = a_words ? min(max(*ncols, 0), emax) : emax;
    const int nr = nreal[b];
    int fail = 0;
    if (ub > 0) search(0);
    for (int col = 0; col < ub; ++col) {
        __syncthreads();  // A
        const int p = piv_slot[col % 3];
        const bool has = p != INT_MAX;  // the same in every thread
        if (threadIdx.x == 0) {
            piv_slot[(col + 2) % 3] = INT_MAX;  // next written after the next barrier A
            pivrow[(size_t)b * emax + col] = has ? p : 0;
            if (has) used[p >> 5] |= 1u << (p & 31);
            fail |= (!has && col < nr);
        }
        if (has) {
            const int c0 = a_words ? min(col >> 2, a_words) : 0;
            const uint32_t* prow = cube + (size_t)p * stride;
            for (int w = c0 + threadIdx.x; w < C; w += nthreads)
                nibble_products(tab + kTabStride * w, prow[w], 1);
            const int lpinv = 255 - s_log[colv[p]];  // log of the pivot byte's inverse
            __syncthreads();  // B
            for (int base = warp; base < m; base += 32 * nwarps) {
                // Each lane folds one row's factor: f * pinv as table offsets
                // (the pivot row: pinv; 0 where f == 0); the rows that take
                // an update are listed, then updated four at a time.
                const int r = base + lane * nwarps;
                uint32_t u = 0;
                if (r == p) u = nibble_offsets(s_exp[lpinv], 1);
                else if (r < m && colv[r]) u = nibble_offsets(s_exp[s_log[colv[r]] + lpinv], 1);
                const uint32_t act = __ballot_sync(kFull, u != 0);
                if (u) wlist[__popc(act & ((1u << lane) - 1u))] = make_int2(r, (int)u);
                __syncwarp();
                const int cnt = __popc(act);
                int k = 0;
                for (; k + 4 <= cnt; k += 4)
                    update_rows<4>(cube, stride, wlist + k, tbytes, p, c0, C, lane);
                for (; k < cnt; ++k)
                    update_rows<1>(cube, stride, wlist + k, tbytes, p, c0, C, lane);
                __syncwarp();
            }
        }
        if (col + 1 < ub) search(col + 1);
    }
    __syncthreads();

    for (int col = ub + threadIdx.x; col < emax; col += nthreads)
        pivrow[(size_t)b * emax + col] = 0;
    if (threadIdx.x == 0) failed[b] = fail;
    if (kSmem) {
        for (int i = threadIdx.x; i < m * C; i += nthreads) {
            const int r = i / C;
            dst[i] = cube[r * stride + (i - r * C)];
        }
    }
}

template <bool kSmem>
cudaError_t gf256_launch(const uint32_t* in, uint32_t* out, const int32_t* nreal,
                         const int32_t* ncols, int32_t* pivrow, int32_t* failed,
                         const int32_t* log_tab, const uint8_t* exp_tab, int B, int m, int C,
                         int emax, int a_words, cudaStream_t stream) {
    const size_t smem = gf256_smem_bytes(m, C, kSmem);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            gf256_elim_kernel<kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int stride = kSmem ? row_stride(C) : C;
    gf256_elim_kernel<kSmem><<<B, gf256_threads(m), smem, stream>>>(
        in, out, nreal, ncols, pivrow, failed, log_tab, exp_tab, m, C, emax, a_words, stride);
    return cudaGetLastError();
}
}  // namespace

// 1 when a frame's GF(256) cube of m rows x C words fits in the shared
// memory that one block of the current device may opt in to, else 0.
extern "C" int ldpc_gf256_elim_fits_smem(int m, int C) {
    return gf256_smem_bytes(m, C, true) <= optin_bytes() ? 1 : 0;
}

extern "C" int ldpc_gf256_elim_launch(const uint32_t* in, uint32_t* out, const int32_t* nreal,
                                      const int32_t* ncols, int32_t* pivrow, int32_t* failed,
                                      const int32_t* log_tab, const uint8_t* exp_tab, int B,
                                      int m, int C, int emax, int a_words, int in_smem,
                                      cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (in_smem)
        return (int)gf256_launch<true>(in, out, nreal, ncols, pivrow, failed, log_tab, exp_tab,
                                       B, m, C, emax, a_words, stream);
    return (int)gf256_launch<false>(in, out, nreal, ncols, pivrow, failed, log_tab, exp_tab,
                                    B, m, C, emax, a_words, stream);
}
// 1 when a frame's cube of m rows x C words fits in the shared memory that
// one block of the current device may opt in to, else 0.
extern "C" int ldpc_elim_fits_smem(int m, int C) {
    return elim_plan(m, C, true, optin_bytes()).G > 0 ? 1 : 0;
}

extern "C" int ldpc_elim_launch(const uint32_t* in, uint32_t* out, const int32_t* nreal,
                                const int32_t* ncols, int32_t* pivrow, int32_t* failed,
                                int B, int m, int C, int emax, int a_words, int in_smem,
                                cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (in_smem)
        return (int)launch<true>(in, out, nreal, ncols, pivrow, failed, B, m, C, emax,
                                 a_words, stream);
    return (int)launch<false>(in, out, nreal, ncols, pivrow, failed, B, m, C, emax, a_words,
                              stream);
}
