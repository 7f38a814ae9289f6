// Group partials of the port's fused range kernels (window_stats.cu's
// filodb_window_range_aggregate and regular_range.cu), on Hopper (sm_90a).
//
// A kernel computes one range-function value v per (series row s, step j)
// and reduces it straight into [G, J] group accumulators: acc (the sum,
// min or max of the values) and cnt (how many there were). A NaN value
// means absence and is skipped; a row whose group id lies outside [0, G)
// (the trash group G of padded rows; jax.ops.segment_sum drops other ids
// too) is skipped before any work.
//
// Two variants, chosen by the wrapper from G and J alone
// (ops/group_acc.tile_plan):
// - shared: a [G, J] acc/cnt pair in the block's dynamic shared memory,
//   updated with shared-memory atomics and flushed to the global arrays
//   once per persistent block (shared_flush). For grouped queries whose
//   groups interleave row by row (sum by (zone)), no global atomic is
//   issued per row.
// - global: every value goes to the global [G+1, ld] arrays with global
//   atomics. For G too large for shared memory, up to one group per
//   series, where groups are many and each address sees few updates.
// Both go through Sink::add, so the two variants differ only in where the
// accumulators live.
//
// min/max use ordered-int atomics: a float with its sign bit clear orders
// as a signed int, one with it set orders reversed as an unsigned int.
// They work on shared and global addresses alike.
//
// A third mode, the store (code ACC_STORE), serves the fused epilogues
// (topk/bottomk/quantile): an order statistic across series needs every
// series' value, so each (row s, step j) value is written once, NaN
// included, to a step-major [J_pad, S_pad] grid at j * S_pad + s, and a
// row of the trash group is written as NaN (the JAX package's n_real
// mask). No atomics, no cnt array and no shared partials: Store::put is
// one plain 4-byte store. A step's column across series is then contiguous
// for the order-statistics kernels (order_stats.cu); the rungs' stores
// scatter instead (neighbouring lanes take neighbouring steps of a row).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace group_acc {

// group accumulators (ops/group_acc.py ACC_CODES)
enum Acc { ACC_ADD = 0, ACC_MIN, ACC_MAX, ACC_STORE };

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }
// minimum that propagates NaN, as torch.minimum / jnp.minimum
__device__ __forceinline__ float nan_min(float a, float b) {
    return (isnan(a) || isnan(b)) ? nan_f() : fminf(a, b);
}

// accumulator identity: 0, +inf (min) or -inf (max)
__device__ __forceinline__ float identity(int acc_op) {
    return acc_op == ACC_MIN ? inf_f() : (acc_op == ACC_MAX ? -inf_f() : 0.0f);
}

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
    if (__float_as_int(v) >= 0) atomicMin((int*)addr, __float_as_int(v));
    else atomicMax((unsigned int*)addr, __float_as_uint(v));
}
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
    if (__float_as_int(v) >= 0) atomicMax((int*)addr, __float_as_int(v));
    else atomicMin((unsigned int*)addr, __float_as_uint(v));
}

// fold `n` members with accumulated value `v` into acc/cnt at one address
__device__ __forceinline__ void fold(float* acc, float* cnt, int acc_op, float v, float n) {
    atomicAdd(cnt, n);
    if (acc_op == ACC_ADD) atomicAdd(acc, v);
    else if (acc_op == ACC_MIN) atomic_min_f32(acc, v);
    else atomic_max_f32(acc, v);
}

// Where a kernel's values go: shared [G, J] partials (ld = J) or the
// global [G+1, ld] arrays.
struct Sink {
    float* acc;
    float* cnt;
    int ld;
    int acc_op;

    __device__ __forceinline__ void add(int64_t g, int j, float v) const {
        const int64_t i = g * ld + j;
        fold(acc + i, cnt + i, acc_op, v, 1.0f);
    }
};

// The store mode's grid: value v of (row s, step j) at out[j * ld + s],
// ld = S_pad (the rows of the launch).
struct Store {
    float* out;
    int64_t ld;

    __device__ __forceinline__ void put(int64_t s, int j, float v) const {
        out[(int64_t)j * ld + s] = v;
    }
};

// Set the shared partials to the identity (every thread of the block takes
// part; the caller synchronises before the first add).
__device__ __forceinline__ void shared_init(float* acc_s, float* cnt_s, int n, int acc_op) {
    const float init = identity(acc_op);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        acc_s[i] = init;
        cnt_s[i] = 0.0f;
    }
}

// Fold the block's shared [G, J] partials into the global [G+1, ld]
// arrays: one atomic pair per (group, step) that received a value. The
// caller synchronises after the last add.
__device__ __forceinline__ void shared_flush(const float* acc_s, const float* cnt_s, int G,
                                             int J, float* acc, float* cnt, int ld,
                                             int acc_op) {
    for (int i = threadIdx.x; i < G * J; i += blockDim.x) {
        const float n = cnt_s[i];
        if (n > 0.0f) {
            const int g = i / J;
            const int64_t o = (int64_t)g * ld + (i - g * J);
            fold(acc + o, cnt + o, acc_op, acc_s[i], n);
        }
    }
}

}  // namespace group_acc


// Lane mode of the fused kernels (cross-query batching, B12): one launch
// serves L queries over one superblock. Each of U unique windows is
// blockIdx.y of the launch; a block computes its rows' value of window u
// once and folds it into every lane l with u_of_lane[l] == u, at that
// lane's group gids[l, s]. Each lane has its own [G+1, ld] accumulators in
// the global [L, G+1, ld] arrays, and while 2 * lanes(u) * G * width
// floats fit the wrapper's budget (ops/group_acc.tile_plan counts the
// lanes), its own [G, width] partials in shared memory, flushed once per
// block; past it every value goes to the global arrays with atomics.
namespace lanes {

constexpr int MAX_LANES = 64;  // lanes a launch takes (ops/group_acc.MAX_LANES)

struct Table {
    const int32_t* gids;       // [L, S] lane group ids; outside [0, G): not in the lane
    const int32_t* u_of_lane;  // [L] the unique window of each lane
    int L;
    int64_t S;                 // a gids row's length
    int G;
    int64_t lane_words;        // one lane's [G+1, ld] accumulators
    int ld;
    int acc_op;
    float* acc;                // [L, G+1, ld]
    float* cnt;
};

// The lanes of window u into lane_s and their count into *n (thread 0);
// the caller synchronises before reading them.
__device__ __forceinline__ void collect(const Table& t, int u, int* lane_s, int* n) {
    if (threadIdx.x == 0) {
        int k = 0;
        for (int l = 0; l < t.L; ++l)
            if (__ldg(t.u_of_lane + l) == u) lane_s[k++] = l;
        *n = k;
    }
}

// whether row s belongs to a group of any of the block's nl lanes
__device__ __forceinline__ bool wants(const Table& t, const int* lane_s, int nl, int64_t s) {
    for (int k = 0; k < nl; ++k) {
        const int g = __ldg(t.gids + (int64_t)lane_s[k] * t.S + s);
        if (g >= 0 && g < t.G) return true;
    }
    return false;
}

// the block's lanes' shared [G, width] acc/cnt pairs at the identity:
// lane k's acc at part_s + 2 k G width, its cnt G width after it
__device__ __forceinline__ void init(float* part_s, int nl, int G, int width, int acc_op) {
    const int64_t n = (int64_t)G * width;
    for (int k = 0; k < nl; ++k)
        group_acc::shared_init(part_s + 2 * k * n, part_s + (2 * k + 1) * n, (int)n, acc_op);
}

// fold value v of row s at column c into every lane of the block
template <bool SHARED>
__device__ __forceinline__ void add(const Table& t, const int* lane_s, int nl, float* part_s,
                                    int width, int64_t s, int c, float v) {
    const int64_t n = (int64_t)t.G * width;
    for (int k = 0; k < nl; ++k) {
        const int l = lane_s[k];
        const int g = __ldg(t.gids + (int64_t)l * t.S + s);
        if (g < 0 || g >= t.G) continue;
        if (SHARED) {
            const int64_t i = 2 * k * n + (int64_t)g * width + c;
            group_acc::fold(part_s + i, part_s + i + n, t.acc_op, v, 1.0f);
        } else {
            const int64_t i = l * t.lane_words + (int64_t)g * t.ld + c;
            group_acc::fold(t.acc + i, t.cnt + i, t.acc_op, v, 1.0f);
        }
    }
}

// fold the block's shared partials into each lane's global arrays from
// column col0 (the caller synchronises after the last add)
__device__ __forceinline__ void flush(const Table& t, const int* lane_s, int nl,
                                      const float* part_s, int width, int64_t col0) {
    const int64_t n = (int64_t)t.G * width;
    for (int k = 0; k < nl; ++k) {
        const int64_t o = lane_s[k] * t.lane_words + col0;
        group_acc::shared_flush(part_s + 2 * k * n, part_s + (2 * k + 1) * n, t.G, width, t.acc + o,
                     t.cnt + o, t.ld, t.acc_op);
    }
}

}  // namespace lanes
