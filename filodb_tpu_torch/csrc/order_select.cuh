// Exact order statistics of one segment of keys by one block, on Hopper
// (sm_90a): the device-side select of order_stats.cu's two kernels
// (filodb_topk_steps and filodb_segment_quantile).
//
// key_of maps a float to a uint32 whose unsigned order is the float's
// total order (-inf < ... < -0 < +0 < ... < +inf), the order XLA's top_k
// ranks by; value_of inverts it. An absent value (NaN) is given ABSENT,
// above every float's key, by the caller.
//
// select() finds the rank-th smallest of n keys, read through a functor
// (a contiguous column, or a column gathered through a member list), by a
// radix select over four 8-bit digits, most significant first. Each pass
// builds a 256-bin histogram in shared memory of the keys whose digits so
// far match the chosen ones, and one warp picks the bin that holds the
// rank (each lane owns 8 bins; a warp scan of their sums). A thread keeps
// UNROLL keys in flight per round, and the histogram increments are
// warp-aggregated (__match_any_sync: one shared atomic per distinct digit
// in a warp), since the values of one series family share a magnitude and
// crowd one bin of the first pass. It is exact for any n and rank: the
// result is the key itself, with how many keys lie below it and how many
// equal it.
//
// The least work is one read of the n keys; the select reads them four
// times (the callers once or twice more).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace order_select {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t ABSENT = 0xffffffffu;  // the key of an absent value: above +inf's
constexpr int UNROLL = 4;                 // keys a thread has in flight per round
constexpr int MAX_WARPS = 32;

__device__ __forceinline__ uint32_t key_of(float x) {
    const uint32_t u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// shared memory of one select
struct Scratch {
    unsigned hist[256];
    int absent;                // keys equal to ABSENT, counted in the first pass
    int digit, below, equal;   // the picking warp's result, broadcast
};

struct Selection {
    uint32_t key;  // the rank-th smallest key
    int below;     // keys smaller than it
    int equal;     // keys equal to it
    int absent;    // keys equal to ABSENT
};

// The rank-th smallest (0-based) of the keys key(i), i in [0, n), where
// rank = rank_of(absent) is computed after the first pass from the count
// of ABSENT keys (a quantile's rank depends on how many values are
// present). rank_of must return 0 <= rank < n. Every thread of the block
// calls select with the same arguments (it synchronises); blockDim.x is a
// multiple of 32, at most 1024.
template <typename Key, typename Rank>
__device__ Selection select(int n, Key key, Rank rank_of, Scratch& sh) {
    const int lane = threadIdx.x & 31;
    uint32_t prefix = 0, mask = 0;
    int below = 0, equal = 0, rank = 0;
    if (threadIdx.x == 0) sh.absent = 0;
    for (int shift = 24; shift >= 0; shift -= 8) {
        for (int i = threadIdx.x; i < 256; i += blockDim.x) sh.hist[i] = 0;
        __syncthreads();
        for (int base = 0; base < n; base += UNROLL * blockDim.x) {
            uint32_t k[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int i = base + u * blockDim.x + threadIdx.x;
                k[u] = i < n ? key(i) : 0u;
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const bool live = base + u * blockDim.x + threadIdx.x < n;
                const int digit =
                    live && (k[u] & mask) == prefix ? (int)((k[u] >> shift) & 255u) : 256;
                const unsigned peers = __match_any_sync(FULL, digit);
                if (digit < 256 && lane == __ffs(peers) - 1)
                    atomicAdd(&sh.hist[digit], (unsigned)__popc(peers));
                if (shift == 24) {
                    const unsigned gone = __ballot_sync(FULL, live && k[u] == ABSENT);
                    if (lane == 0 && gone) atomicAdd(&sh.absent, __popc(gone));
                }
            }
        }
        __syncthreads();
        if (shift == 24) rank = rank_of(sh.absent);
        if (threadIdx.x < 32) {  // lane l owns bins 8l .. 8l + 7
            unsigned c[8], sum = 0;
#pragma unroll
            for (int d = 0; d < 8; ++d) {
                c[d] = sh.hist[8 * lane + d];
                sum += c[d];
            }
            unsigned incl = sum;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned y = __shfl_up_sync(FULL, incl, o);
                if (lane >= o) incl += y;
            }
            const unsigned r = (unsigned)(rank - below);
            unsigned run = incl - sum;
            if (run <= r && r < incl) {
#pragma unroll
                for (int d = 0; d < 8; ++d) {
                    if (r < run + c[d]) {
                        sh.digit = 8 * lane + d;
                        sh.below = below + (int)run;
                        sh.equal = (int)c[d];
                        break;
                    }
                    run += c[d];
                }
            }
        }
        __syncthreads();
        prefix |= (uint32_t)sh.digit << shift;
        mask |= 255u << shift;
        below = sh.below;
        equal = sh.equal;
    }
    return {prefix, below, equal, sh.absent};
}

// The smallest key above `floor` of the keys key(i), i in [0, n) (ABSENT
// when there is none), by every thread of the block; `slot` is a shared
// word the call may overwrite.
template <typename Key>
__device__ uint32_t next_above(int n, Key key, uint32_t floor, unsigned* slot) {
    if (threadIdx.x == 0) *slot = ABSENT;
    __syncthreads();
    uint32_t m = ABSENT;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const uint32_t k = key(i);
        if (k > floor && k < m) m = k;
    }
    m = __reduce_min_sync(FULL, m);
    if ((threadIdx.x & 31) == 0) atomicMin(slot, m);
    __syncthreads();
    return *slot;
}

}  // namespace order_select
