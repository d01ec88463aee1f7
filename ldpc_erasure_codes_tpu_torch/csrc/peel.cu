// Peeling decode of LDPC erasure codes on packed 32-bit words, with the
// channel masking fused into the copy-in: a per-frame schedule kernel, then
// a value kernel that decodes each (frame, chunk of Wc words) out of a
// shared-memory slab. The schedule kernel sweeps in one of four visit
// orders; the value kernel is the same for all four.
//
// Replaces the TPU kernels of ldpc_erasure_codes_tpu/ops/pallas_peel.py::
// peel_decode_vmem: the constant-topology program _make_unrolled_kernel
// (with fence_gate), the runtime-topology _make_kernel "seq" body, and the
// research schedules _make_grouped_kernel (:1101), _make_counted_kernel
// (:586) and _make_jacobi_kernel (:377), in both of their gf_order modes.
// seq, unrolled, grouped and counted compute one function, the MATLAB
// sweep (utils/oracle.py::peel_decode): every sweep visits the checks in
// ROM order; a check whose neighbours hold
// exactly one erasure sets that symbol to the sum of its neighbours (erased
// slots hold zero) and clears its flag at once, so later checks of the same
// sweep see it. jacobi computes the Jacobi sweep of the XLA decoders
// (ops/peel_jacobi.py): every check tests its count on the sweep-start
// flags, every degree-1 check solves, and where several solve one symbol
// the highest-numbered check's value is kept. Binary: the XOR of the
// neighbours. GF(256) (four byte symbols per word): acc = sum_j coef_j * y_j
// and the symbol is inv_s * acc, inv_s the inverse of the erased slot's
// coefficient (pallas_peel.py:295-300, :1009-1036). Stopping is per frame
// (the TPU stops a whole 32-frame tile): a frame stops after the first
// sweep that leaves its first k_stop symbols known (iters = that sweep's
// number) or that changes nothing (iters = max_iters). Values, iteration
// counts and the first-k mask equal the TPU kernel's; with k_stop < n the
// parity-region residual may differ (its tile sweeps on for other frames).
//
// What bounds it on an H100: device-memory bytes. A frame is n symbols of
// W words (2 MB at n = 2040, W = 256), far more than one SM's 227 KB, so it
// cannot stay on chip the way a TPU tile stays in VMEM. The least traffic
// reads each known input word once and writes each output word once: at
// B = 2048, W = 256, PER .1406 that is 2.557 ms at 3.35 TB/s. The kernel
// this one replaced (a warp per (frame, 128-word chunk), values in device
// memory) read each resolved symbol's check neighbours back from device
// memory, mostly L2 misses: ~2.7x the minimum bytes, 6.977 ms (NVIDIA H100
// 80GB HBM3, 700 W).
//
// Design. The erasure flags evolve independently of the values, so the
// decode splits in two kernels on one stream:
//
// (a) peel_schedule_kernel runs the sequential mask sweep with a group of
//     G lanes per frame (G = 8, 16 or 32, the first that holds a check's
//     neighbours; 32 / G frames per warp), the Vlist staged in shared
//     memory as uint16. One ballot counts a check's erased neighbours. It
//     records each resolution (check c, slot position es within the check)
//     in sweep order, with a level: 1 + the largest level among the check's
//     other neighbours (known inputs are level 0). Resolutions of one level
//     write distinct symbols and read only symbols of lower levels, so they
//     are independent. At the end it sorts the list by level (a counting
//     sort, stable, so the order is canonical) and writes the erased flags,
//     the iteration count, the sorted list res[b, :] (c << 8 | es, -1 past
//     the end), the level count and lvl_off[b, l] = the resolutions of
//     level <= l, l = 0..n. The visit order is a template argument:
//     kSeq, check by check, one ballot per check for the warp's frames;
//     kGrouped, CodeArrays.check_groups (consecutive checks in pairwise
//     disjoint runs of up to 4): a member's resolution changes no other
//     member's count or neighbours, so the members are tested together on
//     the group-start counts (one ballot per group), G / 4 lanes per member
//     find its slot and level, and the members record in member order: the
//     list is seq's, bit for bit; kCounted, the live counts read G checks
//     at a time (a window), a ballot giving the first count-1 check at or
//     past the window's cursor, which resolves as in kSeq, then the window
//     read again past it: counts only fall, so the checks the ballot
//     passes over are those the sequential sweep skips, and the list is
//     seq's, bit for bit, for m / G window reads per sweep plus one per
//     resolution where kSeq makes m ballots; kJacobi, every check tested on
//     the sweep-start counts G at a time, the degree-1 checks' symbols claimed
//     by the highest-numbered check, the owners recorded in check order,
//     and only then the counts updated (shared-memory atomics). A Jacobi
//     resolution's level is its sweep (the check had two erased neighbours
//     a sweep earlier, one of which resolved then), and each symbol has one
//     owner, so one level writes distinct symbols.
// (b) peel_apply_kernel, a block of 1024 threads per (frame, chunk of Wc
//     words), copies the chunk of all n symbols into a shared-memory slab
//     with asynchronous copies (cp.async, all in flight at once; erased
//     slots are zeroed, never read), stages the Vlist, the frame's
//     resolutions and level offsets beside it, applies the resolutions
//     level by level (threads over (resolution, part of the chunk), a block
//     barrier between levels), and writes the slab out once. Every value
//     byte is read at most once and written once from device memory; the
//     neighbour sums read shared memory. Wc is the widest of 16, 12, 8, 4
//     words whose block fits (ops/peel.py::slab_words): longer runs of each
//     symbol row use device memory better than more blocks per SM did.
//
// Bit-exact with its sweep for any input, codewords or not: the schedule
// records the sweep's own (check, slot) pairs, and each resolution reads
// only symbols that were known when the sweep resolved it (a Jacobi
// target holds zero until its one owner writes it). GF(256)
// sums run bit-sliced: per neighbour, eight masked XORs into the partial
// sums S_t of the words whose coefficient has bit t, then Horner's rule
// over t (7 multiplies by x), so threads working on checks with different
// coefficients do not diverge.
//
// Measured by chip_smoke.py on NVIDIA H100 80GB HBM3, 700 W, at B = 2048,
// W = 256, PER .1406 against the 2.557 ms byte bound: seq 4.849 ms (its
// schedule kernel 0.517), grouped 4.739 (0.431), counted 4.676 (0.347),
// jacobi 4.376 (0.302); the per-warp kernels the last three replaced took
// 7.987, 6.038 and 7.170. GF(256) seq at B = 512, 1 KB symbols 2.498 ms
// against 0.639 (PERF.md section 6, rows 1-5).

#include <cstdint>

#include <cuda_runtime.h>

#include "gf256.cuh"
#include "slab.cuh"
#include "words.cuh"

namespace {

constexpr int kSmemPerSm = 233472;   // bytes of shared memory on an SM
constexpr int kApplyThreads = 1024;
constexpr uint16_t kErased = 0xFFFF;
// Jacobi schedule, within a sweep: a symbol whose owner is chosen, and the
// count of a degree-1 check (| its erased slot).
constexpr uint16_t kClaimed = 0xFFFE;
constexpr uint16_t kDegreeOne = 0x8000;

// The visit order of the schedule kernel's sweep.
enum Order { kSeq = 0, kGrouped = 1, kJacobi = 2, kCounted = 3 };

// The Vlist staged in shared memory as uint16: m * dmax indices, m degrees.
__host__ __device__ inline int vlist_bytes(int m, int dmax) {
    return round16(2 * m * dmax) + round16(2 * m);
}
// The Clist staged likewise: nc * cmax check indices, nc degrees (nc: the
// code's columns, which may be fewer than a frame's n symbols).
__host__ __device__ inline int clist_bytes(int n, int cmax) {
    return round16(2 * n * cmax) + round16(2 * n);
}
// One schedule frame's shared memory: levels (uint16, kErased = erased),
// one uint16 per level for the sort, and each check's count of erased
// neighbours.
__host__ __device__ inline int sched_frame_bytes(int n, int m) {
    return round16(2 * n) + round16(2 * (n + 2)) + round16(2 * m);
}
// The value kernel's shared memory: the slab (n symbols x Wc words), the
// staged Vlist (and, GF(256), its coefficients and inverses), the frame's
// resolutions and level offsets.
__host__ __device__ inline int apply_bytes(int n, int m, int dmax, int wc, bool nb) {
    return 4 * n * wc + vlist_bytes(m, dmax) + (nb ? 2 * round16(m * dmax) : 0) +
           round16(4 * n) + round16(4 * (n + 1));
}

// Lanes per frame in the schedule kernel: the smallest power of two that
// holds a check's neighbours (32 for dmax > 16), so a warp sweeps 32 / G
// frames at once.
__host__ __device__ inline int sched_lanes(int dmax) {
    return dmax <= 8 ? 8 : dmax <= 16 ? 16 : 32;
}

// Warps per schedule block: the most resident warps per SM.
int sched_warps(int n, int m, int dmax, int nc, int cmax) {
    const int per_warp = 32 / sched_lanes(dmax) * sched_frame_bytes(n, m);
    int best = 0, best_resident = 0;
    for (int w = 1; w <= 16; ++w) {
        const int bytes = vlist_bytes(m, dmax) + clist_bytes(nc, cmax) + w * per_warp;
        if (bytes > kMaxSmem) break;
        const int blocks = kSmemPerSm / (bytes + 1024);
        const int resident = blocks * w < 64 ? blocks * w : 64;
        if (resident > best_resident) best = w, best_resident = resident;
    }
    return best;
}

// Copies an index list ((rows, width) int32, as the Vlist or the Clist) and
// its row lengths into shared memory as uint16 (threads t of T).
__device__ void stage_list(uint16_t* vl, uint16_t* vlen, const int32_t* vlist_idx,
                            const int32_t* vlist_len, int m, int dmax, int t, int T) {
    for (int i = t; i < m * dmax; i += T) vl[i] = (uint16_t)__ldg(vlist_idx + i);
    for (int i = t; i < m; i += T) vlen[i] = (uint16_t)__ldg(vlist_len + i);
}

// Sum and maximum over the G lanes of a lane group (G a power of two).
__device__ __forceinline__ int group_sum(int v, int G) {
    for (int o = G / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}
__device__ __forceinline__ unsigned group_max(unsigned v, int G) {
    for (int o = G / 2; o > 0; o /= 2) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// One less erased neighbour for check c, by an atomic on the 32-bit word
// that holds its uint16 count (counts never fall below 0, so the other half
// is left alone): lanes resolving different symbols may share a check.
__device__ __forceinline__ void count_down(uint16_t* cnt_of, int c) {
    atomicSub(reinterpret_cast<unsigned*>(cnt_of) + c / 2, 1u << (16 * (c & 1)));
}

// A group of G lanes per frame, 32 / G frames per warp. Every loop that
// holds a warp-wide exchange runs to the same count in all lanes; a frame
// whose sweep has ended (or past B) takes part without effect. kOrder is
// the visit order of a sweep (kSeq, kGrouped, kJacobi, kCounted); the
// staging, the counts, the stop rule and the sort are the same for all four.
template <int kOrder>
__global__ void peel_schedule_kernel(const uint8_t* __restrict__ erased,
                                     const int32_t* __restrict__ vlist_idx,
                                     const int32_t* __restrict__ vlist_len,
                                     const int32_t* __restrict__ clist_idx,
                                     const int32_t* __restrict__ clist_len,
                                     const int4* __restrict__ groups, int ngroups,
                                     int32_t* __restrict__ seq_all, int32_t* __restrict__ res,
                                     int32_t* __restrict__ lvl_off,
                                     int32_t* __restrict__ nlev_out,
                                     uint8_t* __restrict__ erased_out,
                                     int32_t* __restrict__ iters_out, int B, int n, int m,
                                     int dmax, int nc, int cmax, int k_stop, int max_iters) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint16_t* vl = reinterpret_cast<uint16_t*>(smem);
    uint16_t* vlen = reinterpret_cast<uint16_t*>(smem + round16(2 * m * dmax));
    uint16_t* cl = reinterpret_cast<uint16_t*>(smem + vlist_bytes(m, dmax));
    uint16_t* clen = cl + round16(2 * nc * cmax) / 2;
    stage_list(vl, vlen, vlist_idx, vlist_len, m, dmax, threadIdx.x, blockDim.x);
    stage_list(cl, clen, clist_idx, clist_len, nc, cmax, threadIdx.x, blockDim.x);
    __syncthreads();
    const unsigned full = 0xffffffffu;
    const int G = sched_lanes(dmax);
    const int fpw = 32 / G;
    const int lane = threadIdx.x % 32;
    const int g = lane / G, gl = lane % G;
    const unsigned gmask = (G == 32 ? full : (1u << G) - 1) << (g * G);
    const unsigned lt = (1u << lane) - 1;
    const int slot = (threadIdx.x / 32) * fpw + g;  // frame slot in the block
    const int b0 = (blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * fpw;
    if (b0 >= B) return;  // whole warp: no block barrier follows
    const int b = b0 + g;
    const bool live = b < B;
    uint16_t* lev = reinterpret_cast<uint16_t*>(smem + vlist_bytes(m, dmax) +
                                                clist_bytes(nc, cmax) +
                                                (size_t)slot * sched_frame_bytes(n, m));
    uint16_t* cur = lev + round16(2 * n) / 2;
    uint16_t* cnt_of = cur + round16(2 * (n + 2)) / 2;
    int32_t* seq = seq_all + (size_t)(live ? b : 0) * n;

    int left = 0;  // erased symbols among the first k_stop
    for (int i = gl; i < n; i += G) {
        const bool e = live && erased[(size_t)b * n + i] != 0;
        lev[i] = e ? kErased : 0;
        left += (e && i < k_stop);
    }
    left = group_sum(left, G);
    __syncwarp();
    // Each check's erased neighbours, kept current as symbols resolve (the
    // count is what the sweep would recount at every visit).
    for (int c = gl; c < m; c += G) {
        int k = 0;
        for (int j = 0; j < vlen[c]; ++j) k += lev[vl[c * dmax + j]] == kErased;
        cnt_of[c] = (uint16_t)k;
    }
    __syncwarp();

    int nres = 0, iters = max_iters;
    unsigned maxlev = 0;  // this lane's; a group maximum after the sweeps
    bool done = !live;
    // The seq and counted orders' resolution, by every lane of the warp: a
    // group whose `solve` is set resolves check c of its frame (its one
    // erased neighbour, at slot es, one lane of G per neighbour; the level
    // is 1 + the largest level among the known ones), records c << 8 | es
    // and lowers the counts of the solved symbol's checks (the Clist row:
    // distinct checks, so no two lanes meet). The groups may solve
    // different checks; every lane runs the warp's longest scan.
    const auto resolve = [&](bool solve, int c, int& solved_k) {
        const uint16_t* nb = vl + c * dmax;
        const int d = solve ? vlen[c] : 0;
        const int dw = (int)__reduce_max_sync(full, (unsigned)d);
        int es = 0;
        bool found = false;
        unsigned mx = 0;  // this lane's largest known-neighbour level
        for (int j0 = 0; j0 < dw; j0 += G) {
            const int j = j0 + gl;
            bool er = false;
            if (j < d) {
                const unsigned l = lev[nb[j]];
                er = l == kErased;
                if (!er) mx = max(mx, l);
            }
            const unsigned bal = __ballot_sync(full, er) & gmask;
            if (bal != 0 && !found) es = j0 + __ffs(bal) - 1 - g * G, found = true;
        }
        const unsigned lv = group_max(mx, G) + 1;
        if (solve) {
            const int e = nb[es];
            if (gl == 0) {
                lev[e] = (uint16_t)lv;
                seq[nres] = c << 8 | es;
                solved_k += e < k_stop;
            }
            for (int q = gl; q < clen[e]; q += G) --cnt_of[cl[e * cmax + q]];
            ++nres;
            maxlev = max(maxlev, lv);
        }
        __syncwarp();
    };
    for (int it = 0; it < max_iters; ++it) {
        const int nres0 = nres;
        int solved_k = 0;  // this lane's resolutions among the first k_stop
        if constexpr (kOrder == kSeq) {
            // Check by check; one ballot tells whether any frame of the warp
            // solves check c.
            for (int c = 0; c < m; ++c) {
                const bool solve = !done && cnt_of[c] == 1;  // the same in the group's lanes
                if (__ballot_sync(full, solve) == 0) continue;
                resolve(solve, c, solved_k);
            }
        } else if constexpr (kOrder == kGrouped) {
            // Group by group (check_groups: consecutive checks, pairwise
            // disjoint, pad = m). A member's resolution changes no other
            // member's count or neighbours, so testing the members together
            // on the group-start counts is the sequential sweep: one ballot
            // per group, then G / 4 lanes per member find its erased slot
            // and level, and the members record in member order.
            const int S = G / 4;
            const int q = gl / S, s = gl % S;
            int4 next = ngroups > 0 ? __ldg(groups) : int4{};
            for (int gi = 0; gi < ngroups; ++gi) {
                const int4 mem = next;  // one broadcast load, a group ahead
                if (gi + 1 < ngroups) next = __ldg(groups + gi + 1);
                unsigned fire = 0;  // bit u: member u solves (the same in the group's lanes)
                if (!done) {
                    fire = (mem.x < m && cnt_of[mem.x] == 1) |
                           (mem.y < m && cnt_of[mem.y] == 1) << 1 |
                           (mem.z < m && cnt_of[mem.z] == 1) << 2 |
                           (mem.w < m && cnt_of[mem.w] == 1) << 3;
                }
                if (__ballot_sync(full, fire != 0) == 0) continue;
                const bool mine = fire >> q & 1;
                const int c = q == 0 ? mem.x : q == 1 ? mem.y : q == 2 ? mem.z : mem.w;
                int es = -1;
                unsigned mx = 0;
                if (mine) {
                    const uint16_t* nb = vl + c * dmax;
                    const int d = vlen[c];
                    for (int j = s; j < d; j += S) {
                        const unsigned l = lev[nb[j]];
                        if (l == kErased) es = j;
                        else mx = max(mx, l);
                    }
                }
                for (int o = S / 2; o > 0; o /= 2) {  // over the member's S lanes
                    es = max(es, __shfl_xor_sync(full, es, o));
                    mx = max(mx, __shfl_xor_sync(full, mx, o));
                }
                if (mine) {
                    const int e = vl[c * dmax + es];
                    const unsigned lv = mx + 1;
                    if (s == 0) {
                        lev[e] = (uint16_t)lv;
                        seq[nres + __popc(fire & ((1u << q) - 1))] = c << 8 | es;
                        solved_k += e < k_stop;
                    }
                    for (int i = s; i < clen[e]; i += S) count_down(cnt_of, cl[e * cmax + i]);
                    maxlev = max(maxlev, lv);
                }
                nres += __popc(fire);
                __syncwarp();
            }
        } else if constexpr (kOrder == kCounted) {
            // Windows of G consecutive checks: the frame's G lanes read the
            // live counts of the window's checks in one step, and a ballot
            // gives the first check at or past the frame's cursor whose
            // count is 1. It resolves as in the seq order, and the window is
            // read again past it: the resolution may have lowered a later
            // check of the window to 1. Counts only fall, so a check the
            // ballot passes over is one the sequential sweep skips too, and
            // the list is seq's, bit for bit. The warp's frames share the
            // window loop; a frame without a hit takes part without effect
            // (its counts cannot change, so it has none until the next
            // window).
            for (int c0 = 0; c0 < m; c0 += G) {
                int next = c0;  // this frame's cursor in the window
                while (true) {
                    const int cc = c0 + gl;
                    const bool hit = !done && cc >= next && cc < m && cnt_of[cc] == 1;
                    const unsigned hits = __ballot_sync(full, hit);
                    if (hits == 0) break;
                    const unsigned mine = hits & gmask;
                    const bool solve = mine != 0;
                    const int c = solve ? c0 + __ffs(mine) - 1 - g * G : 0;
                    resolve(solve, c, solved_k);
                    if (solve) next = c + 1;
                }
            }
        } else {
            // Jacobi: every check tests its count at the start of the sweep
            // and every degree-1 check solves its erased symbol from
            // neighbours known then, so the sweep's resolutions are level
            // it + 1. Where several checks solve one symbol, the highest
            // numbered owns it (the Jacobi decoders keep its value).
            // (1) Claims, highest window first: a degree-1 check marks its
            //     count kDegreeOne | es; the highest lane of a window that
            //     names a symbol claims it unless a higher window did
            //     (kClaimed, owner in cur[]).
            for (int c0 = (m - 1) / G * G; c0 >= 0; c0 -= G) {
                const int c = c0 + gl;
                const bool deg1 = !done && c < m && cnt_of[c] == 1;
                if (__ballot_sync(full, deg1) == 0) continue;
                int es = 0, e = 0;
                if (deg1) {
                    const uint16_t* nb = vl + c * dmax;
                    while (lev[nb[es]] < kClaimed) ++es;  // its one erased neighbour
                    e = nb[es];
                }
                const unsigned key = (deg1 ? (unsigned)e : 1u << 16) | (unsigned)g << 17;
                const unsigned peers = __match_any_sync(full, key);
                if (deg1) {
                    cnt_of[c] = (uint16_t)(kDegreeOne | es);
                    if ((peers >> lane) == 1 && lev[e] == kErased) {
                        lev[e] = kClaimed;
                        cur[e] = (uint16_t)c;
                    }
                }
                __syncwarp();
            }
            // (2) Owners record in check order, at level it + 1; every
            //     degree-1 count goes back to 1.
            const unsigned lv = it + 1;
            for (int c0 = 0; c0 < m; c0 += G) {
                const int c = c0 + gl;
                const unsigned k = c < m ? cnt_of[c] : 0;
                const bool marked = (k & kDegreeOne) != 0;
                if (__ballot_sync(full, marked) == 0) continue;
                bool own = false;
                int es = 0, e = 0;
                if (marked) {
                    es = k & 255;
                    e = vl[c * dmax + es];
                    own = cur[e] == c;
                    cnt_of[c] = 1;
                }
                const unsigned bal = __ballot_sync(full, own) & gmask;
                if (own) {
                    seq[nres + __popc(bal & lt)] = c << 8 | es;
                    lev[e] = (uint16_t)lv;
                    solved_k += e < k_stop;
                }
                nres += __popc(bal);
            }
            __syncwarp();
            // (3) Only now the counts: each resolved symbol's checks.
            for (int r = nres0 + gl; r < nres; r += G) {
                const int t = seq[r];
                const int e = vl[(t >> 8) * dmax + (t & 255)];
                for (int i = 0; i < clen[e]; ++i) count_down(cnt_of, cl[e * cmax + i]);
            }
            if (nres > nres0) maxlev = lv;
            __syncwarp();
        }
        left -= group_sum(solved_k, G);
        if (!done && left == 0) {
            iters = it + 1;
            done = true;
        }
        if (nres == nres0) done = true;
        if (__all_sync(full, done)) break;
    }
    maxlev = group_max(maxlev, G);

    if (live)
        for (int i = gl; i < n; i += G) erased_out[(size_t)b * n + i] = lev[i] == kErased;
    // Counting sort of the resolutions by level, stable in sweep order: the
    // counts as uint16 pairs in 32-bit words (atomics), then the first slot
    // of each level.
    unsigned* pairs = reinterpret_cast<unsigned*>(cur);
    for (int l = gl; l <= (int)maxlev / 2; l += G) pairs[l] = 0;
    __syncwarp();
    const int nres_max = __reduce_max_sync(full, nres);
    for (int r = gl; r < nres; r += G) {
        const int t = seq[r];
        const unsigned l = lev[vl[(t >> 8) * dmax + (t & 255)]];
        atomicAdd(pairs + l / 2, 1u << (16 * (l & 1)));
    }
    __syncwarp();
    int carry = 0;  // resolutions of level <= l, over l = 0..n
    for (int l0 = 0; l0 <= n; l0 += G) {
        const int l = l0 + gl;
        const int v = (l >= 1 && l <= (int)maxlev) ? cur[l] : 0;
        int incl = v;
        for (int o = 1; o < G; o <<= 1) {
            const int u = __shfl_up_sync(full, incl, o, G);
            if (gl >= o) incl += u;
        }
        incl += carry;
        if (live && l <= n) lvl_off[(size_t)b * (n + 1) + l] = incl;
        if (l >= 1 && l <= (int)maxlev) cur[l] = (uint16_t)(incl - v);
        carry = __shfl_sync(full, incl, G - 1, G);
    }
    __syncwarp();
    for (int r0 = 0; r0 < nres_max; r0 += G) {
        const int r = r0 + gl;
        const bool act = r < nres;
        const int t = act ? seq[r] : 0;
        const unsigned key = act ? lev[vl[(t >> 8) * dmax + (t & 255)]] : 0xFFFFu;
        const unsigned peers = __match_any_sync(full, key | (unsigned)g << 17);
        const int pos = act ? cur[key] + __popc(peers & lt) : 0;
        __syncwarp();
        if (act && (peers & lt) == 0) cur[key] = (uint16_t)(cur[key] + __popc(peers));
        if (act) res[(size_t)b * n + pos] = t;
        __syncwarp();
    }
    if (!live) return;
    for (int r = nres + gl; r < n; r += G) res[(size_t)b * n + r] = -1;
    if (gl == 0) {
        nlev_out[b] = (int)maxlev;
        iters_out[b] = iters;
    }
}

// A block per (frame, chunk of VEC * P words); the slab holds the chunk of
// all n symbols, part p of symbol s at s * P + p. The slab's loads are
// asynchronous copies (cp.async), all in flight at once; the Vlist, the
// resolutions and the level offsets are staged beside it meanwhile, so the
// resolutions read shared memory only.
template <int VEC, int P, bool kNB>
__global__ void __launch_bounds__(kApplyThreads)
peel_apply_kernel(const int32_t* __restrict__ values, const uint8_t* __restrict__ erased,
                  const int32_t* __restrict__ res, const int32_t* __restrict__ lvl_off,
                  const int32_t* __restrict__ nlev, const int32_t* __restrict__ vlist_idx,
                  const int32_t* __restrict__ vlist_len, const uint8_t* __restrict__ vlist_val,
                  const uint8_t* __restrict__ vlist_inv, int32_t* __restrict__ out, int n,
                  int m, int dmax, int W, int n_chunks) {
    using V = Words<VEC>;
    extern __shared__ __align__(16) uint8_t smem_raw[];
    V* slab = reinterpret_cast<V*>(smem_raw);
    uint8_t* p8 = smem_raw + (size_t)4 * n * VEC * P;
    uint16_t* vl = reinterpret_cast<uint16_t*>(p8);
    uint16_t* vlen = reinterpret_cast<uint16_t*>(p8 + round16(2 * m * dmax));
    p8 += vlist_bytes(m, dmax);
    uint8_t* cval = p8;
    uint8_t* cinv = p8 + round16(m * dmax);
    if (kNB) p8 += 2 * round16(m * dmax);
    int32_t* rl = reinterpret_cast<int32_t*>(p8);
    int32_t* off = reinterpret_cast<int32_t*>(p8 + round16(4 * n));

    const int b = blockIdx.x / n_chunks;
    const int w0 = (blockIdx.x % n_chunks) * VEC * P;
    const int32_t* in = values + (size_t)b * n * W + w0;
    int32_t* o = out + (size_t)b * n * W + w0;
    const uint8_t* er = erased + (size_t)b * n;

    slab_load<VEC, P>(slab, in, n, W, w0, threadIdx.x, kApplyThreads,
                      [er](int s) { return !er[s]; });
    const int levels = __ldg(nlev + b);
    const int32_t* offg = lvl_off + (size_t)b * (n + 1);
    const int nres = __ldg(offg + n);
    stage_list(vl, vlen, vlist_idx, vlist_len, m, dmax, threadIdx.x, kApplyThreads);
    if (kNB) {
        for (int i = threadIdx.x; i < m * dmax; i += kApplyThreads) {
            cval[i] = __ldg(vlist_val + i);
            cinv[i] = __ldg(vlist_inv + i);
        }
    }
    for (int i = threadIdx.x; i < nres; i += kApplyThreads) rl[i] = __ldg(res + (size_t)b * n + i);
    for (int i = threadIdx.x; i <= levels; i += kApplyThreads) off[i] = __ldg(offg + i);
    copy_async_wait();
    __syncthreads();

    for (int l = 1; l <= levels; ++l) {
        const int start = off[l - 1], end = off[l];
        for (int i = threadIdx.x; i < (end - start) * P; i += kApplyThreads) {
            const int t = rl[start + i / P];
            const int p = i % P;
            const int c = t >> 8, es = t & 255;
            const uint16_t* nb = vl + c * dmax;
            const int d = vlen[c];
            V acc = V::zero();
            if (kNB) {
                BitSlicedSum<VEC> sum;
                const uint8_t* cf = cval + c * dmax;
                for (int j0 = 0; j0 < d; j0 += 4) {
                    int ix[4];
                    uint32_t cj[4];
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        const bool in = j0 + u < d;
                        ix[u] = in ? nb[j0 + u] : 0;
                        cj[u] = in ? cf[j0 + u] : 0u;  // a zero coefficient adds nothing
                    }
#pragma unroll
                    for (int u = 0; u < 4; ++u) sum.add(slab[ix[u] * P + p], cj[u]);
                }
                acc = gf_mul<VEC>(sum.sum(), cinv[c * dmax + es]);
            } else {
                // Neighbour indices eight at a time, so their reads and the
                // slab reads they address overlap.
                for (int j0 = 0; j0 < d; j0 += 8) {
                    int ix[8];
#pragma unroll
                    for (int u = 0; u < 8; ++u) ix[u] = j0 + u < d ? nb[j0 + u] : -1;
#pragma unroll
                    for (int u = 0; u < 8; ++u)
                        if (ix[u] >= 0) acc ^= slab[ix[u] * P + p];
                }
            }
            slab[nb[es] * P + p] = acc;
        }
        __syncthreads();
    }

    slab_store<VEC, P>(slab, o, n, W, w0, threadIdx.x, kApplyThreads);
}

template <int VEC, int P, bool kNB>
cudaError_t launch_apply(const int32_t* values, const uint8_t* erased, const int32_t* res,
                         const int32_t* lvl_off, const int32_t* nlev, const int32_t* vlist_idx,
                         const int32_t* vlist_len, const uint8_t* vlist_val,
                         const uint8_t* vlist_inv, int32_t* out, int B, int n, int m, int dmax,
                         int W, cudaStream_t stream) {
    const size_t smem = apply_bytes(n, m, dmax, VEC * P, kNB);
    const auto kernel = peel_apply_kernel<VEC, P, kNB>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int n_chunks = (W + VEC * P - 1) / (VEC * P);
    kernel<<<(unsigned)((long long)B * n_chunks), kApplyThreads, smem, stream>>>(
        values, erased, res, lvl_off, nlev, vlist_idx, vlist_len, vlist_val, vlist_inv, out, n,
        m, dmax, W, n_chunks);
    return cudaGetLastError();
}

template <bool kNB>
cudaError_t apply_field(const int32_t* values, const uint8_t* erased, const int32_t* res,
                        const int32_t* lvl_off, const int32_t* nlev, const int32_t* vlist_idx,
                        const int32_t* vlist_len, const uint8_t* vlist_val,
                        const uint8_t* vlist_inv, int32_t* out, int B, int n, int m, int dmax,
                        int W, int wc, cudaStream_t stream) {
#define PEEL_APPLY(VEC, P)                                                                  \
    return launch_apply<VEC, P, kNB>(values, erased, res, lvl_off, nlev, vlist_idx,         \
                                     vlist_len, vlist_val, vlist_inv, out, B, n, m, dmax, W, \
                                     stream)
    if (vec4_ok(W, {values, out})) {
        switch (wc) {
            case 4: PEEL_APPLY(4, 1);
            case 8: PEEL_APPLY(4, 2);
            case 12: PEEL_APPLY(4, 3);
            case 16: PEEL_APPLY(4, 4);
        }
    } else {
        switch (wc) {
            case 4: PEEL_APPLY(1, 4);
            case 8: PEEL_APPLY(1, 8);
            case 12: PEEL_APPLY(1, 12);
            case 16: PEEL_APPLY(1, 16);
        }
    }
#undef PEEL_APPLY
    return cudaErrorInvalidValue;
}

template <int kOrder>
cudaError_t launch_schedule(const uint8_t* erased, const int32_t* vlist_idx,
                            const int32_t* vlist_len, const int32_t* clist_idx,
                            const int32_t* clist_len, const int32_t* groups, int ngroups,
                            int32_t* seq, int32_t* res, int32_t* lvl_off, int32_t* nlev,
                            uint8_t* erased_out, int32_t* iters_out, int B, int n, int m,
                            int dmax, int nc, int cmax, int k_stop, int max_iters,
                            cudaStream_t stream) {
    const int warps = sched_warps(n, m, dmax, nc, cmax);
    const int frames = warps * (32 / sched_lanes(dmax));  // per block
    const size_t smem = (size_t)vlist_bytes(m, dmax) + clist_bytes(nc, cmax) +
                        (size_t)frames * sched_frame_bytes(n, m);
    const auto kernel = peel_schedule_kernel<kOrder>;
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const unsigned blocks = (unsigned)((B + frames - 1) / frames);
    kernel<<<blocks, warps * 32, smem, stream>>>(
        erased, vlist_idx, vlist_len, clist_idx, clist_len,
        reinterpret_cast<const int4*>(groups), ngroups, seq, res, lvl_off, nlev, erased_out,
        iters_out, B, n, m, dmax, nc, cmax, k_stop, max_iters);
    return cudaGetLastError();
}

}  // namespace

// The schedule of B frames in visit order `order` (0 sequential, 1 the
// check groups (ngroups, 4), pad = m, a 16-byte aligned table read by that
// order only, 2 Jacobi, 3 counted): res (B, n), lvl_off (B, n + 1), nlev (B,),
// erased_out (B, n), iters (B,); seq (B, n) is scratch. The Clist has nc
// rows. dmax <= 256, n < 65534, m < 65535, and the Vlist and Clist (as
// uint16) with one warp's frames must fit in a block's shared memory.
extern "C" int ldpc_peel_schedule_launch(int order, const uint8_t* erased,
                                         const int32_t* vlist_idx, const int32_t* vlist_len,
                                         const int32_t* clist_idx, const int32_t* clist_len,
                                         const int32_t* groups, int ngroups, int32_t* seq,
                                         int32_t* res, int32_t* lvl_off, int32_t* nlev,
                                         uint8_t* erased_out, int32_t* iters_out, int B, int n,
                                         int m, int dmax, int nc, int cmax, int k_stop,
                                         int max_iters, cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (dmax > 256 || n >= kClaimed || m >= kErased || sched_warps(n, m, dmax, nc, cmax) == 0)
        return (int)cudaErrorInvalidValue;
#define PEEL_SCHEDULE(ORDER)                                                                 \
    return (int)launch_schedule<ORDER>(erased, vlist_idx, vlist_len, clist_idx, clist_len,  \
                                       groups, ngroups, seq, res, lvl_off, nlev, erased_out, \
                                       iters_out, B, n, m, dmax, nc, cmax, k_stop, max_iters,\
                                       stream)
    switch (order) {
        case kSeq: PEEL_SCHEDULE(kSeq);
        case kGrouped: PEEL_SCHEDULE(kGrouped);
        case kJacobi: PEEL_SCHEDULE(kJacobi);
        case kCounted: PEEL_SCHEDULE(kCounted);
    }
#undef PEEL_SCHEDULE
    return (int)cudaErrorInvalidValue;
}

// The decode of B frames: the schedule kernel in visit order `order`, then
// the value kernel with Wc = wc words (4, 8, 12 or 16) per block, on one
// stream. res, lvl_off and nlev receive the schedule; seq is scratch. nb =
// 0: GF(2), the coefficient tables are not read; nb = 1: GF(256).
extern "C" int ldpc_peel_launch(int order, const int32_t* values, const uint8_t* erased,
                                const int32_t* vlist_idx, const int32_t* vlist_len,
                                const uint8_t* vlist_val, const uint8_t* vlist_inv,
                                const int32_t* clist_idx, const int32_t* clist_len,
                                const int32_t* groups, int ngroups, int32_t* out,
                                uint8_t* erased_out, int32_t* iters_out, int32_t* seq,
                                int32_t* res, int32_t* lvl_off, int32_t* nlev, int B, int n,
                                int m, int dmax, int nc, int cmax, int W, int k_stop,
                                int max_iters, int wc, int nb, cudaStream_t stream) {
    if (B == 0) return (int)cudaSuccess;
    if (apply_bytes(n, m, dmax, wc, nb != 0) > kMaxSmem) return (int)cudaErrorInvalidValue;
    const int rc = ldpc_peel_schedule_launch(order, erased, vlist_idx, vlist_len, clist_idx,
                                             clist_len, groups, ngroups, seq, res, lvl_off, nlev,
                                             erased_out, iters_out, B, n, m, dmax, nc, cmax,
                                             k_stop, max_iters, stream);
    if (rc != (int)cudaSuccess) return rc;
    if (nb)
        return (int)apply_field<true>(values, erased, res, lvl_off, nlev, vlist_idx, vlist_len,
                                      vlist_val, vlist_inv, out, B, n, m, dmax, W, wc, stream);
    return (int)apply_field<false>(values, erased, res, lvl_off, nlev, vlist_idx, vlist_len,
                                   vlist_val, vlist_inv, out, B, n, m, dmax, W, wc, stream);
}
