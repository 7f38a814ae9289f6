// Exact order statistics of one segment of keys, split across the blocks
// of a thread block cluster, on Hopper (sm_90a): the device-side select of
// order_stats.cu's two kernels (filodb_topk_steps and
// filodb_segment_quantile).
//
// key_of maps a float to a uint32 whose unsigned order is the float's
// total order (-inf < ... < -0 < +0 < ... < +inf), the order XLA's top_k
// ranks by; value_of inverts it. An absent value (NaN) is given ABSENT,
// above every float's key, by the caller.
//
// A segment of n keys is cut into C consecutive slices, one per block of a
// cluster of C blocks (C = 1: a block alone). stage() reads a block's slice
// from device memory once, UNROLL keys in flight per thread: into shared
// memory on the staged route, where the plan gave the block room for it;
// on the streaming route (segments past the cluster's shared memory) every
// later pass reads device memory again. Passes over staged keys read them
// four at a time (each_key). select() finds the rank-th smallest key of
// the whole segment by a radix select over four 8-bit digits, most
// significant first. In each pass every block counts a 256-bin histogram
// of its keys whose digits so far match the chosen ones (stage() counts
// the first pass as it reads); after one cluster barrier every block sums
// the C histograms through distributed shared memory and picks the same
// digit. The histograms are double-buffered, so a pass needs one cluster
// barrier. Each key is one shared atomic: the values of one series family
// share a magnitude and crowd one bin of the first passes, but counting
// runs of equal digits in registers instead measured slower on topk.
// The result is the key itself, with how many keys of the segment lie
// below it and equal it, and how many of those lie in the slices of lower
// rank (topk's compaction takes ties in index order across the cluster).
//
// A block's last read of another's shared memory must come before that
// block exits: after its last remote read a caller arrives at a cluster
// barrier (cluster_arrive) and waits there (cluster_wait) before it exits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace order_select {

namespace cg = cooperative_groups;

constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t ABSENT = 0xffffffffu;  // the key of an absent value: above +inf's
constexpr int BINS = 256;
constexpr int UNROLL = 8;   // keys a thread has in flight per round of a pass over device memory
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_WARPS = 32;

__device__ __forceinline__ uint32_t key_of(float x) {
    const uint32_t u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// shared memory of one block's part in a select
struct Scratch {
    unsigned long long staged;  // the mbarrier of a bulk copy into the block's slice
    unsigned hist[2][BINS];  // this block's histogram of pass p in hist[p & 1] (read by the cluster)
    unsigned total[BINS];    // the cluster's histogram of the pass
    unsigned before[BINS];   // the histograms of the blocks of lower rank, summed
    int absent;              // this block's ABSENT keys (read by the cluster)
    int absent_total;        // the segment's
    unsigned minimum;        // next_above: this block's least key above the floor (read by the cluster)
    int digit, below, equal, equal_before, below_before;  // the pass's choice, broadcast
    int taken[2];            // compaction counters (topk)
    int warp_sum[MAX_WARPS];
};

struct Selection {
    uint32_t key;      // the rank-th smallest key of the segment
    int below;         // keys of the segment smaller than it
    int equal;         // keys of the segment equal to it
    int below_before;  // of those below, the ones in the slices of lower rank
    int equal_before;  // of those equal, the ones in the slices of lower rank
    int equal_own;     // of those equal, this block's
};

// A block's slice of a segment: m keys, staged in shared memory (STAGED:
// keys, 16-byte aligned) or read through src from device memory.
template <bool STAGED, typename Src>
struct Slice {
    int m;
    Src src;
    uint32_t* keys;
    __device__ __forceinline__ uint32_t operator()(int i) const {
        return STAGED ? keys[i] : src(i);
    }
};

// f(key) for each key of the block's slice, by the threads in turn: staged
// keys four at a time, streamed ones UNROLL in flight; f must not
// synchronise (the threads leave the loop at different times)
template <bool STAGED, typename Src, typename F>
__device__ __forceinline__ void each_key(const Slice<STAGED, Src>& s, F f) {
    if (STAGED) {
        const uint4* k4 = reinterpret_cast<const uint4*>(s.keys);
        for (int v = threadIdx.x; v < s.m >> 2; v += blockDim.x) {
            const uint4 q = k4[v];
            f(q.x);
            f(q.y);
            f(q.z);
            f(q.w);
        }
        for (int i = (s.m & ~3) + (int)threadIdx.x; i < s.m; i += blockDim.x) f(s.keys[i]);
        return;
    }
    for (int base = 0; base < s.m; base += UNROLL * (int)blockDim.x) {
        uint32_t k[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int i = base + u * (int)blockDim.x + (int)threadIdx.x;
            k[u] = i < s.m ? s.src(i) : 0u;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            if (base + u * (int)blockDim.x + (int)threadIdx.x < s.m) f(k[u]);
    }
}

// Clears the block's scratch before stage(); the block synchronises after.
__device__ __forceinline__ void reset(Scratch& sh) {
    for (int i = threadIdx.x; i < BINS; i += blockDim.x) sh.hist[0][i] = 0;
    if (threadIdx.x == 0) {
        sh.absent = 0;
        sh.minimum = ABSENT;
        sh.taken[0] = sh.taken[1] = 0;
    }
}

// Reads the block's keys s.src(i), i in [0, s.m), once: into s.keys
// (shared memory) when STAGED; counts their top digits into hist[0] (the
// first pass) and the ABSENT ones into sh.absent. Every thread of the block
// calls it, after reset() and a block barrier.
template <bool STAGED, typename Src>
__device__ void stage(const Slice<STAGED, Src>& s, Scratch& sh) {
    int absent = 0;
    for (int base = 0; base < s.m; base += UNROLL * (int)blockDim.x) {
        uint32_t k[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int i = base + u * (int)blockDim.x + (int)threadIdx.x;
            k[u] = i < s.m ? s.src(i) : 0u;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int i = base + u * (int)blockDim.x + (int)threadIdx.x;
            if (i < s.m) {
                if (STAGED) s.keys[i] = k[u];
                atomicAdd(&sh.hist[0][k[u] >> 24], 1u);
                absent += k[u] == ABSENT;
            }
        }
    }
    absent = __reduce_add_sync(FULL, absent);
    if ((threadIdx.x & 31) == 0 && absent) atomicAdd(&sh.absent, absent);
}

// one later pass: the digit at `shift` of the keys matching prefix under mask
template <bool STAGED, typename Src>
__device__ void count_pass(const Slice<STAGED, Src>& s, uint32_t prefix, uint32_t mask,
                           int shift, unsigned* hist) {
    each_key(s, [&](uint32_t k) {
        if ((k & mask) == prefix) atomicAdd(hist + ((k >> shift) & 255u), 1u);
    });
}

// The rank-th smallest (0-based) key of the segment whose slices the
// cluster's blocks hold, this block's slice s, after stage(). rank =
// rank_of(absent) is computed after the first pass from the segment's
// count of ABSENT keys (a quantile's rank depends on how many values are
// present); it must lie in [0, n). Every thread of every block of the
// cluster calls select; blockDim.x is a multiple of 32.
template <bool STAGED, typename Src, typename Rank>
__device__ Selection select(const Slice<STAGED, Src>& s, Rank rank_of, Scratch& sh) {
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned me = cluster.block_rank(), C = cluster.num_blocks();
    const int lane = threadIdx.x & 31;
    uint32_t prefix = 0, mask = 0;
    int below = 0, below_before = 0, rank = 0;
    for (int pass = 0; pass < 4; ++pass) {
        const int shift = 24 - 8 * pass;
        unsigned* hist = sh.hist[pass & 1];
        if (pass > 0) {
            // hist[pass & 1] was last read by the cluster in pass - 2, before
            // every block reached pass - 1's barrier
            for (int i = threadIdx.x; i < BINS; i += blockDim.x) hist[i] = 0;
            __syncthreads();
            count_pass(s, prefix, mask, shift, hist);
        }
        cluster.sync();  // every block's histogram of this pass is complete
        for (int t = threadIdx.x; t < BINS; t += blockDim.x) {
            unsigned tot = 0, bef = 0;
#pragma unroll
            for (int c = 0; c < MAX_CLUSTER; ++c) {
                if (c < (int)C) {
                    const unsigned h = *cluster.map_shared_rank(hist + t, c);
                    tot += h;
                    bef += c < (int)me ? h : 0u;
                }
            }
            sh.total[t] = tot;
            sh.before[t] = bef;
        }
        if (pass == 0 && threadIdx.x == 0) {
            int a = 0;
            for (unsigned c = 0; c < C; ++c) a += *cluster.map_shared_rank(&sh.absent, c);
            sh.absent_total = a;
        }
        __syncthreads();
        if (pass == 0) rank = rank_of(sh.absent_total);
        if (threadIdx.x < 32) {  // lane l owns bins 8l .. 8l + 7
            unsigned c[8], b[8], sum = 0;
#pragma unroll
            for (int d = 0; d < 8; ++d) {
                c[d] = sh.total[8 * lane + d];
                b[d] = sh.before[8 * lane + d];
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
            int pick = -1;
            if (run <= r && r < incl) {
#pragma unroll
                for (int d = 0; d < 8; ++d) {
                    if (pick < 0 && r < run + c[d]) pick = d;
                    else if (pick < 0) run += c[d];
                }
            }
            const unsigned owner = __ballot_sync(FULL, pick >= 0);
            const int src = owner ? __ffs(owner) - 1 : 0;
            const int digit = __shfl_sync(FULL, 8 * lane + (pick < 0 ? 0 : pick), src);
            unsigned bb = 0;  // the lower ranks' keys in bins below the digit
#pragma unroll
            for (int d = 0; d < 8; ++d) bb += 8 * lane + d < digit ? b[d] : 0u;
            bb = __reduce_add_sync(FULL, bb);
            if (lane == src) {
                sh.digit = digit;
                sh.below = below + (int)run;
                sh.equal = pick < 0 ? 0 : (int)c[pick];
                sh.equal_before = pick < 0 ? 0 : (int)b[pick];
            }
            if (lane == 0) sh.below_before = (int)bb;
        }
        __syncthreads();
        prefix |= (uint32_t)sh.digit << shift;
        mask |= 255u << shift;
        below = sh.below;
        below_before += sh.below_before;
    }
    // the last pass counted into hist[1]; no block writes it again
    return {prefix, below, sh.equal, below_before, sh.equal_before, (int)sh.hist[1][sh.digit]};
}

// The smallest key above `floor` of the segment (ABSENT when there is
// none): every thread of every block of the cluster calls it (one cluster
// barrier).
template <bool STAGED, typename Src>
__device__ uint32_t next_above(const Slice<STAGED, Src>& s, uint32_t floor, Scratch& sh) {
    cg::cluster_group cluster = cg::this_cluster();
    uint32_t least = ABSENT;
    each_key(s, [&](uint32_t k) {
        if (k > floor && k < least) least = k;
    });
    least = __reduce_min_sync(FULL, least);
    if ((threadIdx.x & 31) == 0) atomicMin(&sh.minimum, least);
    cluster.sync();
    for (unsigned c = 0; c < cluster.num_blocks(); ++c)
        least = min(least, *cluster.map_shared_rank(&sh.minimum, c));
    return least;
}

}  // namespace order_select
