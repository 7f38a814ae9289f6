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
//    signs.
//    Members come as `perm` (the real series ordered by group) and
//    `starts` ([G+1]), so a group's members are perm[starts[g] ..
//    starts[g+1]).
//
// Design. One block per (segment, step) of the query's real steps (the
// caller passes J without the padded steps): for topk the segment is the
// real series of the column (the padded rows, NaN, are not read), for a
// quantile one group's members. The block runs the exact radix select of
// order_select.cuh on order-preserving uint32 keys over its contiguous
// column, gathered through perm for groups. topk then
// compacts, in one more pass, the keys better than the threshold key and,
// in index order, as many keys equal to it as are missing: a block scan
// (warp ballots, then the warps' totals), which gives lax.top_k's tie rule
// for any k <= S. The quantile selects the floor rank; the ceil rank is the
// same key unless the run of equal keys ends there, else the smallest key
// above it (one block min-reduction). Groups of at most SMALL members take
// one thread each instead of a block (`small`; the rest are `large`), so
// that 100k groups of one series (quantile by (instance)) do not pay a
// block's four histogram passes per (group, step): the thread ranks its
// few keys by counting.
//
// Bound: device-memory bytes, one read of the real series' values at the
// real steps (and of perm) and the outputs written once; a few integer
// operations per key and pass. The select reads a segment four times and topk a fifth (the
// compaction); a column of 100,000 series is 400 KB, so those passes
// stream from L2 or device memory, not shared memory (PERF.md).
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

constexpr int SMALL = 16;  // groups of at most SMALL members: one thread each
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// the topk key: ascending = better; a NaN ranks last, as -inf does
__device__ __forceinline__ uint32_t topk_key(float v, int bottom) {
    const float x = isnan(v) ? -inf_f() : (bottom ? -v : v);
    return ~key_of(x);
}

__global__ void __launch_bounds__(MAX_THREADS)
    topk_steps_kernel(const float* __restrict__ grid, int ld, int n, int k, int bottom,
                      float* __restrict__ vals, int* __restrict__ idx) {
    __shared__ order_select::Scratch sel_sh;
    __shared__ int warp_lt[order_select::MAX_WARPS], warp_eq[order_select::MAX_WARPS];
    const int j = blockIdx.x, J = gridDim.x;
    const float* col = grid + (int64_t)j * ld;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    // slots past the n real series take the padded rows n, n + 1, ... in
    // order: NaN rows, which rank below every real one and tie by index
    const int kr = k < n ? k : n;
    for (int s = kr + threadIdx.x; s < k; s += blockDim.x) {
        vals[(int64_t)s * J + j] = nan_f();
        idx[(int64_t)s * J + j] = s;
    }
    if (kr == 0) return;
    auto key = [&](int i) { return topk_key(__ldg(col + i), bottom); };
    const order_select::Selection sel =
        order_select::select(n, key, [&](int) { return kr - 1; }, sel_sh);
    const int take_eq = kr - sel.below;  // keys equal to the threshold to take, in index order
    int base_lt = 0, base_eq = 0;         // taken so far (the same in every thread)
    for (int i0 = 0; i0 < n; i0 += blockDim.x) {
        const int i = i0 + threadIdx.x;
        const float v = i < n ? __ldg(col + i) : 0.0f;
        const uint32_t kv = i < n ? topk_key(v, bottom) : ABSENT;
        const bool lt = i < n && kv < sel.key, eq = i < n && kv == sel.key;
        const unsigned b_lt = __ballot_sync(FULL, lt), b_eq = __ballot_sync(FULL, eq);
        if (lane == 0) {
            warp_lt[warp] = __popc(b_lt);
            warp_eq[warp] = __popc(b_eq);
        }
        __syncthreads();
        int off_lt = 0, off_eq = 0, tot_lt = 0, tot_eq = 0;
        for (int w = 0; w < nwarps; ++w) {
            const int a = warp_lt[w], b = warp_eq[w];
            off_lt += w < warp ? a : 0;
            off_eq += w < warp ? b : 0;
            tot_lt += a;
            tot_eq += b;
        }
        const unsigned before = (1u << lane) - 1u;
        int slot = -1;
        if (lt) slot = base_lt + off_lt + __popc(b_lt & before);
        if (eq) {
            const int r = base_eq + off_eq + __popc(b_eq & before);
            if (r < take_eq) slot = sel.below + r;
        }
        if (slot >= 0) {
            vals[(int64_t)slot * J + j] = isfinite(v) ? v : nan_f();
            idx[(int64_t)slot * J + j] = i;
        }
        base_lt += tot_lt;
        base_eq += tot_eq;
        __syncthreads();  // before the warps' totals are rewritten
        if (base_lt >= sel.below && base_eq >= take_eq) break;
    }
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

__global__ void __launch_bounds__(MAX_THREADS)
    segment_quantile_kernel(const float* __restrict__ grid, int S, int J,
                            const int* __restrict__ perm, const int* __restrict__ starts,
                            const int* __restrict__ large, int n_large,
                            const int* __restrict__ small, int n_small, float q,
                            float* __restrict__ out) {
    __shared__ order_select::Scratch sel_sh;
    __shared__ unsigned next_sh;
    const int64_t b = blockIdx.x;
    const int64_t block_items = (int64_t)n_large * J;
    if (b < block_items) {  // one large group at one step, by the whole block
        const int g = __ldg(large + b % n_large);
        const int j = (int)(b / n_large);
        const int st = __ldg(starts + g), n = __ldg(starts + g + 1) - st;
        const float* col = grid + (int64_t)j * S;
        const int* mem = perm + st;
        auto key = [&](int i) { return quantile_key(__ldg(col + __ldg(mem + i))); };
        int count = 0;
        Rank r{};
        const order_select::Selection sel = order_select::select(
            n, key,
            [&](int absent) {
                count = n - absent;
                r = rank_for(q, count);
                return r.lo;
            },
            sel_sh);
        uint32_t k_hi = sel.key;
        if (r.hi > r.lo && r.hi >= sel.below + sel.equal)  // the run of equal keys ends at lo
            k_hi = order_select::next_above(n, key, sel.key, &next_sh);
        if (threadIdx.x == 0) out[(int64_t)g * J + j] = interpolate(count, r, sel.key, k_hi);
        return;
    }
    // groups of at most SMALL members: one thread per (group, step)
    const int64_t t = (b - block_items) * blockDim.x + threadIdx.x;
    if (t >= (int64_t)n_small * J) return;
    const int g = __ldg(small + t % n_small);
    const int j = (int)(t / n_small);
    const int st = __ldg(starts + g), n = __ldg(starts + g + 1) - st;
    const float* col = grid + (int64_t)j * S;
    uint32_t k[SMALL];
    int count = 0;
#pragma unroll
    for (int i = 0; i < SMALL; ++i) {
        k[i] = i < n ? quantile_key(__ldg(col + __ldg(perm + st + i))) : ABSENT;
        count += i < n && k[i] != ABSENT;
    }
    const Rank r = rank_for(q, count);
    uint32_t k_lo = ABSENT, k_hi = ABSENT;
    // member i's position in the sorted order: the keys below it, and the
    // equal keys before it
#pragma unroll
    for (int i = 0; i < SMALL; ++i) {
        int pos = 0;
#pragma unroll
        for (int m = 0; m < SMALL; ++m) pos += m < n && (k[m] < k[i] || (k[m] == k[i] && m < i));
        if (i < n && pos == r.lo) k_lo = k[i];
        if (i < n && pos == r.hi) k_hi = k[i];
    }
    out[(int64_t)g * J + j] = interpolate(count, r, k_lo, k_hi);
}

bool bad_threads(int threads) {
    return threads < 32 || threads > MAX_THREADS || threads % 32 != 0;
}

}  // namespace

// Plain C entry for ctypes: global topk (bottom = 0) or bottomk (bottom =
// 1) of each of the J steps of the grid (step j's column at grid + j * ld)
// -> vals [k, J] f32 and idx [k, J] int32, 1 <= k <= ld, one block of
// `threads` per step. Only the first n <= ld series of a column are read:
// the rest are the padded rows, NaN, which fill the slots past n. The
// slots of a step hold its winners in no fixed order (those better than
// the k-th first). Launches on `stream` and returns a cudaError_t (0 on
// success); it does not synchronise.
extern "C" int filodb_topk_steps(const void* grid, int ld, int n, int J, int k, int bottom,
                                 int threads, void* vals, void* idx, void* stream) {
    if (J <= 0) return 0;
    if (ld <= 0 || n < 0 || n > ld || k < 1 || k > ld || bad_threads(threads))
        return (int)cudaErrorInvalidValue;
    topk_steps_kernel<<<J, threads, 0, (cudaStream_t)stream>>>(
        (const float*)grid, ld, n, k, bottom != 0, (float*)vals, (int*)idx);
    return (int)cudaGetLastError();
}

// Plain C entry for ctypes: quantile q of each group's members at each
// step of the [J, S] grid -> out [G, J] f32. Members: perm [N] int32 (the
// real series ordered by group), starts [G+1] int32; `large` lists the
// n_large groups of more than SMALL members (a block of `threads` each per
// step), `small` the n_small others (a thread each per step; none larger
// than small_max, checked against SMALL). Every group is in one list.
// Launches on `stream` and returns a cudaError_t (0 on success); it does
// not synchronise.
extern "C" int filodb_segment_quantile(const void* grid, int S, int J, const void* perm,
                                       const void* starts, const void* large, int n_large,
                                       const void* small, int n_small, int small_max, float q,
                                       int threads, void* out, void* stream) {
    if (J <= 0 || n_large + n_small <= 0) return 0;
    if (S <= 0 || n_large < 0 || n_small < 0 || small_max > SMALL || bad_threads(threads))
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = (int64_t)n_large * J + ((int64_t)n_small * J + threads - 1) / threads;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    segment_quantile_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)grid, S, J, (const int*)perm, (const int*)starts, (const int*)large,
        n_large, (const int*)small, n_small, q, (float*)out);
    return (int)cudaGetLastError();
}
