// The fused epilogues' order statistics across series, on Hopper (sm_90a):
// two kernels over the step-major [J, S] per-series grid that a rung's
// store mode writes (group_acc.cuh Store).
//
// 1. topk_steps_kernel (entry filodb_topk_steps) replaces the ("topk", k,
//    bottom) arm of filodb_tpu/ops/aggregations.py _apply_epilogue, the
//    lax.top_k over [J, S] that topk_mask (:1904) also runs: per step, the
//    k best series (the largest for topk, the smallest for bottomk), a NaN
//    ranking last of all (as -inf for topk, +inf for bottomk), ties to the
//    lower series index, as lax.top_k breaks them, in XLA's total order
//    (-0 below +0). Out: [k, J] values (NaN where the winner's value is not
//    finite, as the JAX arm returns it) and [k, J] int32 series indices.
// 2. segment_quantile_kernel (entry filodb_segment_quantile) replaces
//    segment_quantile (aggregations.py:1923): per (group, step), count the
//    members' non-NaN values, rank = clip(q, 0, 1) * max(count - 1, 0) in
//    f32, and interpolate v_lo + (v_hi - v_lo) * frac between the
//    floor(rank)-th and ceil(rank)-th smallest, NaN sorting as +inf (so a
//    real +inf sorts with the absent values) and NaN where count is 0.
//    -0 sorts below +0 here, where JAX's argsort ties them; the result is
//    the same, since the interpolation of two zeros is +0 whatever their
//    signs. A group of one member is interpolated too (a lone +inf gives
//    inf + (inf - inf) * 0 = NaN, as the JAX formula does).
//    Members come as `perm` (the real series ordered by group) and
//    `starts` ([G+1]), so a group's members are perm[starts[g] ..
//    starts[g+1]).
// 3. segment_topk_kernel (entry filodb_segment_topk) replaces topk_mask
//    (aggregations.py:1904) as the JAX package's AggregatePresentExec
//    (query/exec/plans.py:2440) calls it once per group: per (group,
//    step), the min(k, size) best members keep their values (ties to the
//    lower series index), the rest and any kept non-finite value are NaN;
//    with the (group, step)'s threshold, the k-th best value, which the
//    tree's per-shard candidate filter reads (TopkCandidateFilter,
//    transformers.py:484). Where a block can stage a step's whole column
//    (at most STEP_KEYS series: a shard leaf's) and k <= STEP_MAX_K,
//    segment_topk_step_kernel selects every group of a step in one block
//    from the column staged once (3b below); else large groups take a
//    cluster per step and the same select as the quantile's, small groups
//    a thread per (group, step), each member ranked by counting.
//
// Bound: device-memory bytes, one read of the real series' values at the
// real steps (and of perm) and the outputs written once; a few integer
// operations per key and pass.
//
// Design. A segment (a step's column of real series for topk; one group's
// members at one step for a quantile) is read from device memory once, by
// a thread block cluster of C blocks (ops/order_stats.order_plan: C grows
// in powers of two up to 8 until a block's slice is at most 16,384 keys),
// each block staging its slice of keys in shared memory: a topk column, or
// a group whose members are consecutive series (a global quantile), by one
// bulk copy of the TMA engine; other groups key by key through perm. The
// radix select of order_select.cuh then runs every pass on chip and merges
// the blocks' histograms through distributed shared memory, one cluster
// barrier a pass. A slice the block's dynamic shared memory cannot hold (a segment
// past the cluster's) is read from device memory in every pass instead,
// in the same kernel, so it stays exact for any n. Blocks of one segment
// sit on neighbouring SMs and the J x C blocks of a topk fill every SM
// where one block per step left some idle.
// topk then compacts in one pass over the staged keys: a key better than
// the threshold takes a slot from a shared counter at an offset the select
// gives (the slots of a step hold its winners in no fixed order); of the
// keys equal to it, the cluster takes the first take_eq in index order:
// a block whose equal keys all fall before take_eq takes them from a
// counter too, and only the block where take_eq falls ranks its own in
// index order (a chunk per thread, one block scan), stopping there.
// The quantile selects the floor rank; the ceil rank is the same key unless
// the run of equal keys ends there, else the smallest key above it (one
// cluster min-reduction).
// Groups of at most SMALL members (quantile by (instance): 100k groups of
// one) take a thread per (group, step) instead, a block TILE_GROUPS groups
// at every step, TILE_STEPS steps at a time: lanes on neighbouring groups
// of one step read, the results pass through a shared-memory transpose, and
// lanes on neighbouring steps of one group write, so the [G, J] stores
// coalesce; the member lists are read once per block; 32-bit index
// arithmetic; the rank loop stops at the group's size, and groups of one
// member take four steps' reads in flight.
//
// The build passes -fmad=false, so the interpolation rounds its multiply
// and its add separately, as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "order_select.cuh"

namespace {

using order_select::ABSENT;
using order_select::FULL;
using order_select::key_of;
using order_select::value_of;
namespace cg = cooperative_groups;

constexpr int SMALL = 16;  // groups of at most SMALL members: one thread each
constexpr int MAX_THREADS = 1024;
constexpr int MAX_SLICE = 49152;  // keys a block stages: 192 KB of dynamic shared memory
constexpr int TILE_GROUPS = 32;   // the thread path: groups a block owns (one a lane) ...
constexpr int TILE_STEPS = 32;    // ... walked over the steps this many at a time

// keys per block of a segment of n keys in clusters of `cluster` blocks:
// whole 16-byte groups, so that each slice of an aligned column is aligned
__host__ __device__ __forceinline__ int64_t slice_of(int64_t n, int cluster) {
    return ((n + cluster - 1) / cluster + 3) & ~(int64_t)3;
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// the topk key: ascending = better; a NaN ranks last, as -inf does
__device__ __forceinline__ uint32_t topk_key(float v, int bottom) {
    const float x = isnan(v) ? -inf_f() : (bottom ? -v : v);
    return ~key_of(x);
}

// Stages a slice whose m values lie contiguous at src (16-byte aligned) as
// keys to_key(value) in shared memory: one bulk copy of its whole 16-byte
// groups by the TMA engine (completion counted on an mbarrier), the rest
// read by the threads meanwhile, then one pass that turns the copied values
// into keys in place, counting their first digits and the ABSENT ones (what
// order_select::stage does for a slice read key by key). Every thread of
// the block calls it, after reset() and a block barrier.
template <typename ToKey>
__device__ void stage_run(const float* __restrict__ src, int m, ToKey to_key, uint32_t* keys,
                          order_select::Scratch& sh) {
    const int bulk = m & ~3;
    const unsigned bar = (unsigned)__cvta_generic_to_shared(&sh.staged);
    if (bulk > 0 && threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                     "r"(bulk * 4)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"((unsigned)__cvta_generic_to_shared(keys)),
            "l"(src), "r"(bulk * 4), "r"(bar)
            : "memory");
    }
    int absent = 0;
    auto count = [&](uint32_t k) {
        atomicAdd(&sh.hist[0][k >> 24], 1u);
        absent += k == ABSENT;
    };
    for (int i = bulk + threadIdx.x; i < m; i += blockDim.x) {
        const uint32_t k = to_key(__ldg(src + i));
        keys[i] = k;
        count(k);
    }
    if (bulk > 0) {
        __syncthreads();  // the barrier is initialised before anyone waits on it
        unsigned done = 0;
        while (!done) {
            asm volatile(
                "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                " selp.u32 %0, 1, 0, p;\n}\n"
                : "=r"(done)
                : "r"(bar), "r"(0u)
                : "memory");
        }
        uint4* k4 = reinterpret_cast<uint4*>(keys);
        for (int v = threadIdx.x; v < bulk >> 2; v += blockDim.x) {
            uint4 q = k4[v];
            q.x = to_key(__uint_as_float(q.x));
            q.y = to_key(__uint_as_float(q.y));
            q.z = to_key(__uint_as_float(q.z));
            q.w = to_key(__uint_as_float(q.w));
            k4[v] = q;
            count(q.x);
            count(q.y);
            count(q.z);
            count(q.w);
        }
    }
    absent = __reduce_add_sync(FULL, absent);
    if ((threadIdx.x & 31) == 0 && absent) atomicAdd(&sh.absent, absent);
}

// the value a winner's topk key stands for (NaN where it is not finite)
__device__ __forceinline__ float topk_value(uint32_t k, int bottom) {
    const float x = value_of(~k);
    const float v = bottom ? -x : x;
    return isfinite(v) ? v : nan_f();
}

// One step's column of the n real series (col), this block's slice of it
// [i0, i0 + m): select the kr-th best key over the cluster, then write the
// winners of the slice into their slots of vals/idx (column j of [k, J]).
template <bool STAGED>
__device__ void topk_column(const float* __restrict__ col, int n, int slice, int k, int bottom,
                            int j, int J, float* __restrict__ vals, int* __restrict__ idx,
                            order_select::Scratch& sh, uint32_t* keys) {
    const int me = (int)cg::this_cluster().block_rank();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int i0 = min(n, me * slice), m = min(n, i0 + slice) - i0;
    // slots past the n real series take the padded rows n, n + 1, ... in
    // order: NaN rows, which rank below every real one and tie by index
    const int kr = min(k, n);
    if (me == 0) {
        for (int s = kr + threadIdx.x; s < k; s += blockDim.x) {
            vals[(size_t)s * J + j] = nan_f();
            idx[(size_t)s * J + j] = s;
        }
    }
    if (kr == 0) return;  // the same in every block of the cluster
    order_select::reset(sh);
    __syncthreads();
    auto src = [&](int i) { return topk_key(__ldg(col + i0 + i), bottom); };
    const order_select::Slice<STAGED, decltype(src)> s{m, src, keys};
    if (STAGED && ((uintptr_t)(col + i0) & 15) == 0)
        stage_run(col + i0, m, [&](float v) { return topk_key(v, bottom); }, keys, sh);
    else
        order_select::stage(s, sh);
    const order_select::Selection sel = order_select::select(s, [&](int) { return kr - 1; }, sh);
    order_select::cluster_arrive();  // this block reads no other's shared memory again
    const int take_eq = kr - sel.below;           // equal keys to take, the first in index order
    const int room = take_eq - sel.equal_before;  // of them, this block's first `room`
    const bool all_eq = room >= sel.equal_own;
    auto put = [&](int slot, uint32_t kv, int i) {
        vals[(size_t)slot * J + j] = topk_value(kv, bottom);
        idx[(size_t)slot * J + j] = i0 + i;
    };
    // keys better than the threshold, and the equal ones where this block
    // takes them all: a slot each from the block's counters, VEC keys a
    // thread (staged keys as one 16-byte read), one atomic per warp
    constexpr int VEC = STAGED ? 4 : 1;
    for (int base = 0; base < m; base += VEC * (int)blockDim.x) {
        const int i0v = base + VEC * (int)threadIdx.x;
        uint32_t kv[VEC];
        if constexpr (STAGED) {
            if (i0v + 3 < m) {
                const uint4 q = *reinterpret_cast<const uint4*>(keys + i0v);
                kv[0] = q.x;
                kv[1] = q.y;
                kv[2] = q.z;
                kv[3] = q.w;
            } else {
#pragma unroll
                for (int u = 0; u < VEC; ++u) kv[u] = i0v + u < m ? keys[i0v + u] : ABSENT;
            }
        } else {
            kv[0] = i0v < m ? src(i0v) : ABSENT;
        }
        int n_lt = 0, n_eq = 0;
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
            const bool live = i0v + u < m;
            n_lt += live && kv[u] < sel.key;
            n_eq += all_eq && live && kv[u] == sel.key;
        }
        if (!__any_sync(FULL, n_lt + n_eq)) continue;
        int x_lt = n_lt, x_eq = n_eq;  // inclusive warp scans
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int a = __shfl_up_sync(FULL, x_lt, o), b = __shfl_up_sync(FULL, x_eq, o);
            if (lane >= o) {
                x_lt += a;
                x_eq += b;
            }
        }
        int at_lt = 0, at_eq = 0;
        if (lane == 31) {
            if (x_lt) at_lt = atomicAdd(&sh.taken[0], x_lt);
            if (x_eq) at_eq = atomicAdd(&sh.taken[1], x_eq);
        }
        int s_lt = sel.below_before + __shfl_sync(FULL, at_lt, 31) + x_lt - n_lt;
        int s_eq = sel.below + sel.equal_before + __shfl_sync(FULL, at_eq, 31) + x_eq - n_eq;
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
            if (i0v + u >= m) continue;
            if (kv[u] < sel.key) put(s_lt++, kv[u], i0v + u);
            else if (all_eq && kv[u] == sel.key) put(s_eq++, kv[u], i0v + u);
        }
    }
    if (!all_eq && room > 0) {  // take_eq falls in this block: its equal keys in index order
        const int chunk = (m + (int)blockDim.x - 1) / (int)blockDim.x;
        const int lo = min(m, (int)threadIdx.x * chunk), hi = min(m, lo + chunk);
        int mine = 0;
        for (int i = lo; i < hi; ++i) mine += s(i) == sel.key;
        int incl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += y;
        }
        if (lane == 31) sh.warp_sum[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            const int nwarps = blockDim.x >> 5;
            const int w = lane < nwarps ? sh.warp_sum[lane] : 0;
            int wincl = w;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(FULL, wincl, o);
                if (lane >= o) wincl += y;
            }
            if (lane < nwarps) sh.warp_sum[lane] = wincl - w;
        }
        __syncthreads();
        int r = sh.warp_sum[warp] + incl - mine;  // this block's equal keys before lo
        for (int i = lo; i < hi && r < room; ++i) {
            const uint32_t kv = s(i);
            if (kv == sel.key) put(sel.below + sel.equal_before + r++, kv, i);
        }
    }
    order_select::cluster_wait();  // no block of the cluster reads this one's shared memory now
}

__global__ void __launch_bounds__(MAX_THREADS)
    topk_steps_kernel(const float* __restrict__ grid, int ld, int n, int slice, int cap, int k,
                      int bottom, float* __restrict__ vals, int* __restrict__ idx) {
    extern __shared__ __align__(16) uint32_t keys[];
    __shared__ order_select::Scratch sh;
    const int C = (int)cg::this_cluster().num_blocks();
    const int j = blockIdx.x / C, J = gridDim.x / C;
    const float* col = grid + (size_t)j * ld;
    if (slice <= cap)
        topk_column<true>(col, n, slice, k, bottom, j, J, vals, idx, sh, keys);
    else
        topk_column<false>(col, n, slice, k, bottom, j, J, vals, idx, sh, keys);
}

// rank = clip(q, 0, 1) * max(count - 1, 0) in f32 and its floor and ceil
// (0 for a NaN rank, whose interpolation is NaN anyway)
struct Rank {
    float rank;
    int lo, hi;
};

__device__ __forceinline__ Rank rank_for(float q, int count) {
    const float qc = q < 0.0f ? 0.0f : (q > 1.0f ? 1.0f : q);  // a NaN q stays NaN
    const float rank = qc * fmaxf((float)count - 1.0f, 0.0f);
    if (isnan(rank)) return {rank, 0, 0};
    return {rank, (int)floorf(rank), (int)ceilf(rank)};
}

__device__ __forceinline__ float interpolate(int count, const Rank& r, uint32_t k_lo,
                                             uint32_t k_hi) {
    if (count <= 0) return nan_f();
    const float v_lo = value_of(k_lo), v_hi = value_of(k_hi);
    const float frac = r.rank - floorf(r.rank);
    return v_lo + (v_hi - v_lo) * frac;
}

// the quantile key: ascending; a NaN is ABSENT, above +inf
__device__ __forceinline__ uint32_t quantile_key(float v) {
    return isnan(v) ? ABSENT : key_of(v);
}

// One large group's n members at one step (col, mem), this block's slice
// of them: the quantile over the cluster, written by rank 0 to *out.
template <bool STAGED>
__device__ void quantile_segment(const float* __restrict__ col, const int* __restrict__ mem,
                                 int n, int slice, float q, float* __restrict__ out,
                                 order_select::Scratch& sh, uint32_t* keys) {
    const int me = (int)cg::this_cluster().block_rank();
    const int i0 = min(n, me * slice), m = min(n, i0 + slice) - i0;
    order_select::reset(sh);
    __syncthreads();
    auto src = [&](int i) { return quantile_key(__ldg(col + __ldg(mem + i0 + i))); };
    const order_select::Slice<STAGED, decltype(src)> s{m, src, keys};
    // members that are a run of consecutive series (perm ascends within a
    // group, so its ends tell) are staged by one bulk copy
    const int first = m > 0 ? __ldg(mem + i0) : 0;
    if (STAGED && m > 0 && __ldg(mem + i0 + m - 1) - first == m - 1 &&
        ((uintptr_t)(col + first) & 15) == 0)
        stage_run(col + first, m, quantile_key, keys, sh);
    else
        order_select::stage(s, sh);
    int count = 0;
    Rank r{};
    const order_select::Selection sel = order_select::select(
        s,
        [&](int absent) {
            count = n - absent;
            r = rank_for(q, count);
            return r.lo;
        },
        sh);
    uint32_t k_hi = sel.key;
    if (r.hi > r.lo && r.hi >= sel.below + sel.equal)  // the run of equal keys ends at lo
        k_hi = order_select::next_above(s, sel.key, sh);
    order_select::cluster_arrive();
    if (me == 0 && threadIdx.x == 0) *out = interpolate(count, r, sel.key, k_hi);
    order_select::cluster_wait();
}

// the quantile of one small group (n <= SMALL members at p[0 .. n)) at one
// step: each member's position in the sorted order is the count of keys
// below it and of equal keys before it
__device__ __forceinline__ float small_quantile(const float* __restrict__ col, const int (&p)[SMALL],
                                                int n, float q) {
    uint32_t k[SMALL];
    int count = 0;
#pragma unroll
    for (int i = 0; i < SMALL; ++i) {
        if (i >= n) break;
        k[i] = quantile_key(__ldg(col + p[i]));
        count += k[i] != ABSENT;
    }
    const Rank r = rank_for(q, count);
    uint32_t k_lo = ABSENT, k_hi = ABSENT;
#pragma unroll
    for (int i = 0; i < SMALL; ++i) {
        if (i >= n) break;
        int pos = 0;
#pragma unroll
        for (int m = 0; m < SMALL; ++m) {
            if (m >= n) break;
            pos += k[m] < k[i] || (k[m] == k[i] && m < i);
        }
        if (pos == r.lo) k_lo = k[i];
        if (pos == r.hi) k_hi = k[i];
    }
    return interpolate(count, r, k_lo, k_hi);
}

// the quantile of a group of at most one member, whose value (if any) is x:
// small_quantile's arithmetic for n <= 1
__device__ __forceinline__ float single_quantile(float x, int n, float q) {
    const uint32_t k = n ? quantile_key(x) : ABSENT;
    const int count = k != ABSENT;
    return interpolate(count, rank_for(q, count), k, k);
}

// Block gt of the thread path: small groups gt * TILE_GROUPS .. (a lane
// each) at every step, TILE_STEPS steps at a time: each warp takes steps of
// the tile (lanes read neighbouring groups of one step), the results pass
// through the shared tile, and lanes on neighbouring steps of one group
// write them. A warp whose groups have at most one member each reads four
// steps before it computes any.
__device__ void quantile_groups(int gt, const float* __restrict__ grid, int S, int J,
                                const int* __restrict__ perm, const int* __restrict__ starts,
                                const int* __restrict__ small, int n_small, float q,
                                float* __restrict__ out, float (*tile)[TILE_STEPS + 1]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int gi = gt * TILE_GROUPS + lane;
    int st = 0, n = 0;
    if (gi < n_small) {
        const int g = __ldg(small + gi);
        st = __ldg(starts + g);
        n = __ldg(starts + g + 1) - st;
    }
    int p[SMALL];
#pragma unroll
    for (int i = 0; i < SMALL; ++i) {
        if (i >= n) break;
        p[i] = __ldg(perm + st + i);
    }
    const bool singles = __all_sync(FULL, n <= 1);
    for (int j0 = 0; j0 < J; j0 += TILE_STEPS) {
        if (singles) {
            for (int jl0 = warp; jl0 < TILE_STEPS; jl0 += 4 * nwarps) {
                float x[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int jl = jl0 + u * nwarps;
                    x[u] = n && jl < TILE_STEPS && j0 + jl < J
                               ? __ldg(grid + (size_t)(j0 + jl) * S + p[0]) : 0.0f;
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int jl = jl0 + u * nwarps;
                    if (jl < TILE_STEPS) tile[lane][jl] = single_quantile(x[u], n, q);
                }
            }
        } else {
            for (int jl = warp; jl < TILE_STEPS; jl += nwarps)
                tile[lane][jl] = j0 + jl < J
                                     ? small_quantile(grid + (size_t)(j0 + jl) * S, p, n, q)
                                     : nan_f();
        }
        __syncthreads();
        for (int e = threadIdx.x; e < TILE_GROUPS * TILE_STEPS; e += blockDim.x) {
            const int r = e / TILE_STEPS, c = e % TILE_STEPS;
            const int g_i = gt * TILE_GROUPS + r;
            if (g_i < n_small && j0 + c < J)
                out[(size_t)__ldg(small + g_i) * J + j0 + c] = tile[r][c];
        }
        __syncthreads();  // before the next steps overwrite the tile
    }
}

__global__ void __launch_bounds__(MAX_THREADS)
    segment_quantile_kernel(const float* __restrict__ grid, int S, int J,
                            const int* __restrict__ perm, const int* __restrict__ starts,
                            const int* __restrict__ large, int n_large,
                            const int* __restrict__ small, int n_small, float q, int cap,
                            float* __restrict__ out) {
    extern __shared__ __align__(16) uint32_t keys[];
    __shared__ union {
        order_select::Scratch sel;
        float tile[TILE_GROUPS][TILE_STEPS + 1];
    } sh;
    const int C = (int)cg::this_cluster().num_blocks();
    const int large_blocks = n_large * J * C;
    if ((int)blockIdx.x < large_blocks) {  // one large group at one step, by a cluster
        const int seg = blockIdx.x / C;
        const int gl = seg % n_large, j = seg / n_large;
        const int g = __ldg(large + gl);
        const int st = __ldg(starts + g), n = __ldg(starts + g + 1) - st;
        const int slice = (int)slice_of(n, C);
        const float* col = grid + (size_t)j * S;
        float* o = out + (size_t)g * J + j;
        if (slice <= cap)
            quantile_segment<true>(col, perm + st, n, slice, q, o, sh.sel, keys);
        else
            quantile_segment<false>(col, perm + st, n, slice, q, o, sh.sel, keys);
        return;
    }
    const int gt = blockIdx.x - large_blocks;
    if (gt < (n_small + TILE_GROUPS - 1) / TILE_GROUPS)
        quantile_groups(gt, grid, S, J, perm, starts, small, n_small, q, out, sh.tile);
}

// -- 3. the grouped top-k ------------------------------------------------------

// the k-th best key as a value in the caller's terms (topk: the value, a
// NaN as -inf; bottomk: the value, a NaN as +inf): the threshold a
// candidate filter compares with
__device__ __forceinline__ float topk_threshold(uint32_t k, int bottom) {
    const float x = value_of(~k);
    return bottom ? -x : x;
}

// One large group's n members at one step (col, mem), this block's slice
// of them: select the kr-th best key over the cluster (kr = min(k, n)),
// then write every member of the slice to out_col at its series index:
// its value where it is kept and finite, else NaN. Kept are the keys
// better than the threshold and, of those equal to it, the first take_eq
// in series order (perm ascends within a group). Rank 0 writes the
// threshold to *thr.
template <bool STAGED>
__device__ void topk_segment(const float* __restrict__ col, const int* __restrict__ mem, int n,
                             int slice, int k, int bottom, float* __restrict__ out_col,
                             float* __restrict__ thr, order_select::Scratch& sh, uint32_t* keys) {
    const int me = (int)cg::this_cluster().block_rank();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int i0 = min(n, me * slice), m = min(n, i0 + slice) - i0;
    const int kr = min(k, n);
    order_select::reset(sh);
    __syncthreads();
    auto src = [&](int i) { return topk_key(__ldg(col + __ldg(mem + i0 + i)), bottom); };
    const order_select::Slice<STAGED, decltype(src)> s{m, src, keys};
    const int first = m > 0 ? __ldg(mem + i0) : 0;
    const bool run = m > 0 && __ldg(mem + i0 + m - 1) - first == m - 1;  // consecutive series
    if (STAGED && run && ((uintptr_t)(col + first) & 15) == 0)
        stage_run(col + first, m, [&](float v) { return topk_key(v, bottom); }, keys, sh);
    else
        order_select::stage(s, sh);
    const order_select::Selection sel = order_select::select(s, [&](int) { return kr - 1; }, sh);
    order_select::cluster_arrive();  // this block reads no other's shared memory again
    const int take_eq = kr - sel.below;           // equal keys kept, the first in series order
    const int room = take_eq - sel.equal_before;  // of them, this block's first `room`
    const bool all_eq = sel.equal_own <= room;
    const bool ordered = !all_eq && room > 0;  // take_eq falls inside this block's equal keys
    auto put = [&](int i, uint32_t kv, bool keep) {
        out_col[__ldg(mem + i0 + i)] = keep ? topk_value(kv, bottom) : nan_f();
    };
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const uint32_t kv = s(i);
        if (kv != sel.key) put(i, kv, kv < sel.key);
        else if (!ordered) put(i, kv, all_eq);
    }
    if (ordered) {  // this block's equal keys in series order: a chunk per thread, one scan
        const int chunk = (m + (int)blockDim.x - 1) / (int)blockDim.x;
        const int lo = min(m, (int)threadIdx.x * chunk), hi = min(m, lo + chunk);
        int mine = 0;
        for (int i = lo; i < hi; ++i) mine += s(i) == sel.key;
        int incl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += y;
        }
        if (lane == 31) sh.warp_sum[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            const int nwarps = blockDim.x >> 5;
            const int w = lane < nwarps ? sh.warp_sum[lane] : 0;
            int wincl = w;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(FULL, wincl, o);
                if (lane >= o) wincl += y;
            }
            if (lane < nwarps) sh.warp_sum[lane] = wincl - w;
        }
        __syncthreads();
        int r = sh.warp_sum[warp] + incl - mine;  // this block's equal keys before lo
        for (int i = lo; i < hi; ++i) {
            const uint32_t kv = s(i);
            if (kv == sel.key) put(i, kv, r++ < room);
        }
    }
    if (me == 0 && threadIdx.x == 0) *thr = topk_threshold(sel.key, bottom);
    order_select::cluster_wait();  // no block of the cluster reads this one's shared memory now
}

// One small group (n <= SMALL members at p[0 .. n)) at one step: each
// member's rank is the count of better keys and of equal keys before it;
// the first kr ranks are kept.
__device__ __forceinline__ void topk_small(const float* __restrict__ col, const int* __restrict__ p,
                                           int n, int k, int bottom, float* __restrict__ out_col,
                                           float* __restrict__ thr) {
    uint32_t key[SMALL];
    int idx[SMALL];
#pragma unroll
    for (int i = 0; i < SMALL; ++i) {
        if (i >= n) break;
        idx[i] = __ldg(p + i);
        key[i] = topk_key(__ldg(col + idx[i]), bottom);
    }
    const int kr = min(k, n);
    if (kr == 0) *thr = nan_f();
#pragma unroll
    for (int i = 0; i < SMALL; ++i) {
        if (i >= n) break;
        int pos = 0;
#pragma unroll
        for (int m = 0; m < SMALL; ++m) {
            if (m >= n) break;
            pos += key[m] < key[i] || (key[m] == key[i] && m < i);
        }
        out_col[idx[i]] = pos < kr ? topk_value(key[i], bottom) : nan_f();
        if (pos == kr - 1) *thr = topk_threshold(key[i], bottom);
    }
}

__global__ void __launch_bounds__(MAX_THREADS)
    segment_topk_kernel(const float* __restrict__ grid, int ld, int J,
                        const int* __restrict__ perm, const int* __restrict__ starts,
                        const int* __restrict__ large, int n_large,
                        const int* __restrict__ small, int n_small, int k, int bottom, int cap,
                        float* __restrict__ out, int ld_out, float* __restrict__ thr) {
    extern __shared__ __align__(16) uint32_t keys[];
    __shared__ order_select::Scratch sh;
    const int C = (int)cg::this_cluster().num_blocks();
    const int large_blocks = n_large * J * C;
    if ((int)blockIdx.x < large_blocks) {  // one large group at one step, by a cluster
        const int seg = blockIdx.x / C;
        const int gl = seg % n_large, j = seg / n_large;
        const int g = __ldg(large + gl);
        const int st = __ldg(starts + g), n = __ldg(starts + g + 1) - st;
        const int slice = (int)slice_of(n, C);
        const float* col = grid + (size_t)j * ld;
        float* o = out + (size_t)j * ld_out;
        float* t = thr + (size_t)g * J + j;
        if (slice <= cap)
            topk_segment<true>(col, perm + st, n, slice, k, bottom, o, t, sh, keys);
        else
            topk_segment<false>(col, perm + st, n, slice, k, bottom, o, t, sh, keys);
        return;
    }
    // a thread per (small group, step), neighbouring threads on neighbouring
    // groups of one step
    const int64_t e = (int64_t)(blockIdx.x - large_blocks) * blockDim.x + threadIdx.x;
    if (e >= (int64_t)n_small * J) return;
    const int gi = (int)(e % n_small), j = (int)(e / n_small);
    const int g = __ldg(small + gi);
    const int st = __ldg(starts + g), n = __ldg(starts + g + 1) - st;
    topk_small(grid + (size_t)j * ld, perm + st, n, k, bottom, out + (size_t)j * ld_out,
               thr + (size_t)g * J + j);
}

// -- 3b. the grouped top-k, one block a step --------------------------------------
//
// Every group of one step in one block, for k <= STEP_MAX_K (the
// dashboards' top few per zone; past it the per-group route measured
// faster): the step's column of n keys and perm are read once,
// coalesced, into shared memory (16-byte loads, twelve in flight a thread),
// and the keys gathered there into group order, so that each group's keys
// are one run in shared memory (perm ascends within a group: a run's
// order is series order). A group of at most SMALL members takes a thread
// (ranked by counting); a larger one a warp: all kept where it has at most
// k members, else each lane keeps its KMAX best (key, position) pairs of a
// strided share of the run sorted in registers (KMAX: k rounded up to a
// power of two) and the warp pops the best head k times (a shuffle
// reduction each). Ordering by (key, position) keeps the first take_eq of
// the keys equal to the threshold in series order, as topk_segment does.
// Kept members set a bit of a shared bitmap by series index; the block
// then writes the whole column, coalesced. Bound: the column read and
// written once (perm is read by every step's block, from L2).

constexpr int STEP_THREADS = 256;  // threads of a step's block at most (registers: KMAX pairs)
constexpr int STEP_KEYS = 24576;   // a column the step route stages at most (two copies)
constexpr int STEP_MAX_K = 16;     // the largest k the step route takes (a lane's list in registers)
constexpr int STEP_UNROLL = 4;     // keys a lane of a warp's select reads before it ranks any
constexpr int STAGE_UNROLL = 12;   // 16-byte loads of the column (and of perm) a thread has in flight

__host__ __device__ __forceinline__ int64_t round4(int64_t x) { return (x + 3) & ~(int64_t)3; }

// dynamic shared memory of the step route over n keys: the column's keys,
// the same in group order and the kept bitmap, each in whole 16-byte
// groups
__host__ __device__ __forceinline__ int64_t step_bytes(int64_t n) {
    return 4 * (2 * round4(n) + round4((n + 31) / 32));
}

// Stages the step's column of m values at src as topk keys in shared
// memory, and perm (m member indices, group by group) beside them, by
// 16-byte loads where both are 16-byte aligned (STAGE_UNROLL of each in
// flight a thread), the rest one by one; then replaces each entry of the
// copied perm by its member's key (a thread reads and writes its own
// entries). Every thread of the block calls it.
__device__ void stage_column(const float* __restrict__ src, const int* __restrict__ perm, int m,
                             int bottom, uint32_t* keys, uint32_t* sorted) {
    const bool vec = (((uintptr_t)src | (uintptr_t)perm) & 15) == 0;
    const int nv = vec ? m >> 2 : 0;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const int4* perm4 = reinterpret_cast<const int4*>(perm);
    for (int v0 = threadIdx.x; v0 < nv; v0 += STAGE_UNROLL * blockDim.x) {
        float4 x[STAGE_UNROLL];
        int4 p[STAGE_UNROLL];
#pragma unroll
        for (int u = 0; u < STAGE_UNROLL; ++u) {
            const int v = v0 + u * blockDim.x;
            if (v < nv) {
                x[u] = __ldg(src4 + v);
                p[u] = __ldg(perm4 + v);
            }
        }
#pragma unroll
        for (int u = 0; u < STAGE_UNROLL; ++u) {
            const int v = v0 + u * blockDim.x;
            if (v >= nv) continue;
            reinterpret_cast<uint4*>(keys)[v] =
                make_uint4(topk_key(x[u].x, bottom), topk_key(x[u].y, bottom),
                           topk_key(x[u].z, bottom), topk_key(x[u].w, bottom));
            reinterpret_cast<int4*>(sorted)[v] = p[u];
        }
    }
    for (int i = 4 * nv + threadIdx.x; i < m; i += blockDim.x) {
        keys[i] = topk_key(__ldg(src + i), bottom);
        sorted[i] = (uint32_t)__ldg(perm + i);
    }
    __syncthreads();  // every key is in place
    for (int i = threadIdx.x; i < m; i += blockDim.x) sorted[i] = keys[sorted[i]];
}

__device__ __forceinline__ void mark_kept(uint32_t* kept, int i) {
    atomicOr(kept + (i >> 5), 1u << (i & 31));
}

// (key, position in the group's run) as one ascending order: better keys
// first, ties to the earlier series
__device__ __forceinline__ unsigned long long ranked(uint32_t key, int i) {
    return ((unsigned long long)key << 32) | (uint32_t)i;
}

// A small group (n <= SMALL keys at run[0 .. n), members p[0 .. n)) by one
// thread: each member's rank is the count of better keys and of equal keys
// before it.
__device__ __forceinline__ void step_small(const uint32_t* run, const int* __restrict__ p, int n,
                                           int k, int bottom, uint32_t* kept, float* thr) {
    uint32_t key[SMALL];
#pragma unroll
    for (int i = 0; i < SMALL; ++i) {
        if (i >= n) break;
        key[i] = run[i];
    }
    const int kr = min(k, n);
    if (kr == 0) *thr = nan_f();
#pragma unroll
    for (int i = 0; i < SMALL; ++i) {
        if (i >= n) break;
        int pos = 0;
#pragma unroll
        for (int m = 0; m < SMALL; ++m) {
            if (m >= n) break;
            pos += key[m] < key[i] || (key[m] == key[i] && m < i);
        }
        if (pos < kr) mark_kept(kept, __ldg(p + i));
        if (pos == kr - 1) *thr = topk_threshold(key[i], bottom);
    }
}

// A group of n > SMALL keys at run[0 .. n) (members p[0 .. n)) by one
// warp (k <= KMAX): all kept where n <= k, else the warp's merge of its
// lanes' sorted lists. From KMAX = 8 on, a key is also dropped at once
// when it is no better than tau, the least of the lanes' KMAX-th best
// pairs (with KMAX >= k, each of those bounds the warp's k-th best),
// refreshed after every round of reads. The winners' positions wait in
// `win` (the warp's 32 ints of shared memory) and are marked together.
template <int KMAX>
__device__ void step_warp(const uint32_t* run, const int* __restrict__ p, int n, int k,
                          int bottom, uint32_t* kept, float* thr, int* win) {
    const int lane = threadIdx.x & 31;
    if (n <= k) {  // every member kept; the threshold is the worst key
        uint32_t worst = 0;
        for (int i = lane; i < n; i += 32) {
            mark_kept(kept, __ldg(p + i));
            worst = max(worst, run[i]);
        }
        worst = __reduce_max_sync(FULL, worst);
        if (lane == 0) *thr = topk_threshold(worst, bottom);
        return;
    }
    unsigned long long best[KMAX];  // this lane's KMAX best, ascending
#pragma unroll
    for (int t = 0; t < KMAX; ++t) best[t] = ~0ull;
    unsigned long long tau = ~0ull;
    for (int base = 0; base < n; base += 32 * STEP_UNROLL) {  // every lane each round: tau's shuffles
        const int i0 = base + lane;
        uint32_t key[STEP_UNROLL];
#pragma unroll
        for (int u = 0; u < STEP_UNROLL; ++u) key[u] = i0 + 32 * u < n ? run[i0 + 32 * u] : 0u;
#pragma unroll
        for (int u = 0; u < STEP_UNROLL; ++u) {
            const int i = i0 + 32 * u;
            unsigned long long x = ranked(key[u], i);
            if (i >= n || x >= best[KMAX - 1] || x >= tau) continue;
#pragma unroll
            for (int t = 0; t < KMAX; ++t) {  // insert: x bubbles to its place
                const unsigned long long lo = x < best[t] ? x : best[t];
                x = x < best[t] ? best[t] : x;
                best[t] = lo;
            }
        }
        if (KMAX >= 8) {
            tau = best[KMAX - 1];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                const unsigned long long y = __shfl_xor_sync(FULL, tau, o);
                tau = y < tau ? y : tau;
            }
        }
    }
    unsigned long long last = 0;
    for (int r = 0; r < k; ++r) {  // the warp's r-th best: the least head
        unsigned long long m = best[0];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const unsigned long long y = __shfl_xor_sync(FULL, m, o);
            m = y < m ? y : m;
        }
        if (best[0] == m) {  // this lane's head (positions differ: one lane)
            win[r] = (int)(uint32_t)m;
#pragma unroll
            for (int t = 0; t + 1 < KMAX; ++t) best[t] = best[t + 1];
            best[KMAX - 1] = ~0ull;
        }
        last = m;
    }
    __syncwarp();
    if (lane < k) mark_kept(kept, __ldg(p + win[lane]));
    if (lane == 0) *thr = topk_threshold((uint32_t)(last >> 32), bottom);
    __syncwarp();  // `win` is read before the warp's next group rewrites it
}

template <int KMAX>
__global__ void __launch_bounds__(STEP_THREADS)
    segment_topk_step_kernel(const float* __restrict__ grid, int ld, int n,
                             const int* __restrict__ perm, const int* __restrict__ starts,
                             const int* __restrict__ large, int n_large,
                             const int* __restrict__ small, int n_small, int k, int bottom,
                             float* __restrict__ out, int ld_out, float* __restrict__ thr) {
    extern __shared__ __align__(16) uint32_t keys[];
    __shared__ int win[STEP_THREADS / 32][32];  // each warp's winners' positions
    const int j = blockIdx.x, J = gridDim.x;
    uint32_t* sorted = keys + round4(n);  // the keys in group order
    uint32_t* kept = sorted + round4(n);
    for (int w = threadIdx.x; w < (n + 31) / 32; w += blockDim.x) kept[w] = 0;
    stage_column(grid + (size_t)j * ld, perm, n, bottom, keys, sorted);
    __syncthreads();
    auto group = [&](const int* list, int i, int& st, int& size) {
        const int g = __ldg(list + i);
        st = __ldg(starts + g);
        size = __ldg(starts + g + 1) - st;
        return g;
    };
    for (int i = threadIdx.x; i < n_small; i += blockDim.x) {
        int st, size;
        const int g = group(small, i, st, size);
        step_small(sorted + st, perm + st, size, k, bottom, kept, thr + (size_t)g * J + j);
    }
    for (int i = threadIdx.x >> 5; i < n_large; i += blockDim.x >> 5) {
        int st, size;
        const int g = group(large, i, st, size);
        step_warp<KMAX>(sorted + st, perm + st, size, k, bottom, kept, thr + (size_t)g * J + j,
                        win[threadIdx.x >> 5]);
    }
    __syncthreads();  // every kept bit is set
    float* o = out + (size_t)j * ld_out;
    auto value = [&](int i) {
        return (kept[i >> 5] >> (i & 31)) & 1u ? topk_value(keys[i], bottom) : nan_f();
    };
    const int nv = ((uintptr_t)o & 15) == 0 ? n >> 2 : 0;
    for (int v = threadIdx.x; v < nv; v += blockDim.x)
        reinterpret_cast<float4*>(o)[v] =
            make_float4(value(4 * v), value(4 * v + 1), value(4 * v + 2), value(4 * v + 3));
    for (int i = 4 * nv + threadIdx.x; i < n; i += blockDim.x) o[i] = value(i);
}

bool bad_threads(int threads) {
    return threads < 32 || threads > MAX_THREADS || threads % 32 != 0;
}

// dynamic shared memory of a launch whose largest segment has n keys, in
// clusters of `cluster` blocks: the largest slice's keys when a block can
// stage them, else none (the streaming route)
int64_t slice_bytes(int64_t n, int cluster) {
    const int64_t slice = slice_of(n, cluster);
    return slice <= MAX_SLICE ? slice * 4 : 0;
}

// Launches kernel on `stream` in clusters of `cluster` blocks with `smem`
// bytes of dynamic shared memory (the kernel is allowed that much, and at
// least MAX_SLICE keys', on the current device first).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int64_t blocks, int threads, int cluster, int smem,
           void* stream, Args... args) {
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem > MAX_SLICE * 4 ? smem : MAX_SLICE * 4);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes: global topk (bottom = 0) or bottomk (bottom =
// 1) of each of the J steps of the grid (step j's column at grid + j * ld)
// -> vals [k, J] f32 and idx [k, J] int32, 1 <= k <= ld. Only the first
// n <= ld series of a column are read: the rest are the padded rows, NaN,
// which fill the slots past n. Each step takes a cluster of `cluster`
// blocks (1-8) of `threads`, each block a slice of ceil(n / cluster) keys,
// staged in `smem_bytes` of dynamic shared memory (which must equal the
// slice's bytes, or 0 past MAX_SLICE keys: the streaming route). The slots
// of a step hold its winners in no fixed order (those better than the
// k-th first). Launches on `stream` and returns a cudaError_t (0 on
// success); it does not synchronise.
extern "C" int filodb_topk_steps(const void* grid, int ld, int n, int J, int k, int bottom,
                                 int cluster, int threads, int smem_bytes, void* vals, void* idx,
                                 void* stream) {
    if (J <= 0) return 0;
    if (ld <= 0 || n < 0 || n > ld || k < 1 || k > ld || bad_threads(threads) || cluster < 1 ||
        cluster > order_select::MAX_CLUSTER || smem_bytes != slice_bytes(n, cluster))
        return (int)cudaErrorInvalidValue;
    const int slice = (int)slice_of(n, cluster);
    return launch(topk_steps_kernel, (int64_t)J * cluster, threads, cluster, smem_bytes, stream,
                  (const float*)grid, ld, n, slice, smem_bytes / 4, k, (int)(bottom != 0), (float*)vals,
                  (int*)idx);
}

// Plain C entry for ctypes: quantile q of each group's members at each step
// of the [J, S] grid -> out [G, J] f32. Members: perm [N] int32 (the real
// series ordered by group, ascending within a group: a slice whose ends
// differ by its length less one is a run of consecutive series), starts
// [G+1] int32; `large` lists the n_large groups of more than SMALL members
// (none larger than large_max; a cluster of `cluster` blocks of `threads`
// each per step, each block a slice of the group's members staged in
// `smem_bytes` of dynamic shared memory, which must equal the largest
// slice's bytes, or 0 past MAX_SLICE keys: the streaming route), `small`
// the n_small others (a thread each per step, 32 groups a block; none
// larger than small_max, checked against SMALL). Every group is in one
// list. Launches on `stream` and returns a cudaError_t (0 on success); it
// does not synchronise.
extern "C" int filodb_segment_quantile(const void* grid, int S, int J, const void* perm,
                                       const void* starts, const void* large, int n_large,
                                       int large_max, const void* small, int n_small,
                                       int small_max, float q, int cluster, int threads,
                                       int smem_bytes, void* out, void* stream) {
    if (J <= 0 || n_large + n_small <= 0) return 0;
    if (S <= 0 || n_large < 0 || n_small < 0 || small_max > SMALL || bad_threads(threads) ||
        cluster < 1 || cluster > order_select::MAX_CLUSTER ||
        (n_large > 0 && large_max <= SMALL) ||
        smem_bytes != (n_large > 0 ? slice_bytes(large_max, cluster) : 0))
        return (int)cudaErrorInvalidValue;
    const int64_t large_blocks = (int64_t)n_large * J * cluster;
    const int64_t tiles = ((int64_t)n_small + TILE_GROUPS - 1) / TILE_GROUPS;
    if (large_blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    return launch(segment_quantile_kernel,
                  large_blocks + (tiles + cluster - 1) / cluster * cluster, threads, cluster,
                  smem_bytes, stream, (const float*)grid, S, J, (const int*)perm,
                  (const int*)starts, (const int*)large, n_large, (const int*)small, n_small, q,
                  smem_bytes / 4, (float*)out);
}

// Plain C entry for ctypes: topk (bottom = 0) or bottomk (bottom = 1) of
// each group's members at each of the J steps of the grid (step j's column
// at grid + j * ld, its first n series the members) -> out, step j's
// column at out + j * ld_out: every member's value where it is among its
// group's min(k, size) best at the step (a NaN ranking last, ties to the
// lower series index, -0 below +0) and finite, else NaN; and thr [G, J]
// f32, the min(k, size)-th best value of each (group, step) (a NaN as -inf
// for topk, +inf for bottomk). Members: perm [n] int32 (the series ordered
// by group, ascending within a group), starts [G+1] int32; `large` lists
// the n_large groups of more than SMALL members (none larger than
// large_max), `small` the n_small others (none larger than small_max).
// by_step: a block of `threads` per step selects every group of it from
// the column staged in `smem_bytes` of dynamic shared memory (which must
// be step_bytes(n); cluster 1; n <= STEP_KEYS; k <= STEP_MAX_K). Else a
// large group takes a cluster of `cluster` blocks per step (shared bytes
// as for filodb_segment_quantile) and a small one a thread per step;
// columns of out at no member's index are not written. Launches on
// `stream` and returns a cudaError_t (0 on success); it does not
// synchronise.
extern "C" int filodb_segment_topk(const void* grid, int ld, int n, int J, const void* perm,
                                   const void* starts, const void* large, int n_large,
                                   int large_max, const void* small, int n_small, int small_max,
                                   int k, int bottom, int by_step, int cluster, int threads,
                                   int smem_bytes, void* out, int ld_out, void* thr,
                                   void* stream) {
    if (J <= 0 || n_large + n_small <= 0) return 0;
    if (ld <= 0 || ld_out <= 0 || k < 1 || n_large < 0 || n_small < 0 || small_max > SMALL ||
        bad_threads(threads) || cluster < 1 || cluster > order_select::MAX_CLUSTER ||
        (n_large > 0 && large_max <= SMALL))
        return (int)cudaErrorInvalidValue;
    if (by_step) {
        if (n < 0 || n > STEP_KEYS || ld < n || ld_out < n || cluster != 1 || k > STEP_MAX_K ||
            threads > STEP_THREADS || smem_bytes != step_bytes(n))
            return (int)cudaErrorInvalidValue;
        auto kern = k <= 1   ? segment_topk_step_kernel<1>
                    : k <= 2 ? segment_topk_step_kernel<2>
                    : k <= 4 ? segment_topk_step_kernel<4>
                    : k <= 8 ? segment_topk_step_kernel<8>
                             : segment_topk_step_kernel<16>;
        return launch(kern, J, threads, 1, smem_bytes, stream, (const float*)grid, ld, n,
                      (const int*)perm, (const int*)starts, (const int*)large, n_large,
                      (const int*)small, n_small, k, (int)(bottom != 0), (float*)out, ld_out,
                      (float*)thr);
    }
    if (smem_bytes != (n_large > 0 ? slice_bytes(large_max, cluster) : 0))
        return (int)cudaErrorInvalidValue;
    const int64_t large_blocks = (int64_t)n_large * J * cluster;
    const int64_t tiles = ((int64_t)n_small * J + threads - 1) / threads;
    if (large_blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    return launch(segment_topk_kernel, large_blocks + (tiles + cluster - 1) / cluster * cluster,
                  threads, cluster, smem_bytes, stream, (const float*)grid, ld, J,
                  (const int*)perm, (const int*)starts, (const int*)large, n_large,
                  (const int*)small, n_small, k, (int)(bottom != 0), smem_bytes / 4, (float*)out,
                  ld_out, (float*)thr);
}
