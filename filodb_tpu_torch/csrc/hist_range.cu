// Native-histogram range functions fused with the per-bucket group sum
// and, in the same launch, the histogram_quantile epilogue, on Hopper
// (sm_90a).
//
// hist_range_kernel (entry filodb_hist_range_aggregate) replaces the XLA
// programs that filodb_tpu/ops/hist_kernels.py runs behind one jit: the
// per-bucket range function -- hist_range_kernel (:29, window bounds
// searched per series) or _hist_range_shared (:157, the [J] bounds of a
// shared regular grid) -- _segment_aggregate_jit "sum" over the flattened
// [S, J*B] grid, and, with a quantile, histogram_quantile (:86), as
// _fused_hist_jit (:351) and _fused_hist_shared_jit (:329) compose them.
// For every (row s, step j < J, bucket b) it computes rate / increase /
// delta (Prometheus extrapolation, no zero cap), sum_over_time (and rate /
// increase of a delta column) as the window sum, or last, and reduces it
// straight into [G, J*B] group accumulators acc (the sum) and cnt (valid
// members); no [S, J, B] plane reaches device memory. With a quantile, the
// block that finishes a slice's partials last interpolates them into out
// [G, J]. A second entry, filodb_hist_quantile_gather, is the standalone
// quantile (hist_kernels.py:86) over classic le-labelled bucket series: it
// gathers each group's cumulative counts from the rows of a finished
// by-(le, ...) aggregate and applies the same rule (quantile_of). Its work
// is a few KB at the main path's shapes, so its launch, not its bytes,
// bounds it.
//
// Design. A persistent grid of blocks (gridDim.x of them per slice) walks
// tiles of R rows (row_tiles.cuh); the plan sizes a block to its slice's
// column vectors (below), so that no warp idles through a second, partial
// pass over the columns. Slice blockIdx.y owns whole
// steps [j0, j0 + steps) -- all their B buckets -- so a row's ts, lens and
// gid are read once per slice, and mostly there is one slice. Each tile:
// 1. Bounds. Per-series: the tile's ts rows were copied into shared memory
//    by cp.async while the previous tile was computed (double-buffered,
//    only each row's samples); each (row, step) pair's window [lo, hi) and
//    extrapolation factor are searched once in shared memory
//    (window_search.cuh) into a [R, steps] table that the step's B bucket
//    lanes read. Shared bounds: the [steps] table is filled once per block.
//    Jitter (B1, filodb_tpu/ops/hist_kernels.py:207 _hist_range_jitter, as
//    _fused_hist_jitter_jit :283 composes it, entry
//    filodb_hist_range_jitter): a near-regular grid's window is its step's
//    certain range [clo, chi) of the shared step table
//    (ops/mxu_jitter.JitterWindowMatrices.steps, jitter_steps.cuh) and at
//    most one edge slot each side (klo = clo - 1, khi = chi), in it for a
//    row when the row's deviation ts - nominal at the slot passes the
//    edge's bound. So each (row, step) pair reads the step's row of the
//    table and two of the row's timestamps in place (four for the rate
//    family: the first and last sample's), and its [lo, hi) window and
//    extrapolation factor go to the same [R, steps] table: no search, no
//    staged ts rows and no [S, T] deviation plane. The factor takes the
//    boundary times relative to the window's start in f32, in the JAX
//    order.
// 2. Fetch. A thread owns fixed column vectors of the slice -- V
//    contiguous buckets of one step, fetched whole as float4 (V = 4) or
//    float2 where B allows -- and walks the tile's rows, two at a time
//    with every load issued before any is used, keeping V run sums while
//    consecutive rows share a group. A run is added to the block's shared
//    [G, steps*B] partials (no atomic: each column has one owner thread)
//    or, when those do not fit, to the global arrays with atomics.
// Shared partials are flushed once per block. Then every block issues
// __threadfence() and one atomicAdd on its slice's arrival counter; the
// last to arrive reads the finished partials through L2 (__ldcg) and
// interpolates the slice's [G, steps] quantiles, one thread per (group,
// step), and sets the counter back to 0 for the next launch into the same
// buffers. The wrapper carves the counters from the accumulators' zeroed
// allocation, so no launch is spent on them.
//
// Bound: device-memory bytes. For rate, increase and delta, each real
// row's buckets at the distinct first and last samples of the query's
// windows (bench.py's 100k-series store: 222 samples x 12 buckets x 4
// bytes per row, 1,065,600,000 bytes, 0.32 ms at 3.35 TB/s), each row's
// timestamps for per-series bounds, gids and the outputs. A 48-byte
// sample spans two 32-byte sectors, so the data format's own floor (the
// sectors the sampled positions touch) lies above that.
//
// Semantics kept from the JAX package: f32 extrapolation with the 1.1 x
// average-duration rule and no zero cap; NaN where a window holds fewer
// than two samples (rate family) or none; window sums taken in index order
// inside the window (the JAX package takes a difference of f32 prefix
// sums, which rounds differently: the tests hold the two at rtol 2e-4);
// padded rows (group G) skipped; a NaN value is absence. The build passes
// -fmad=false so that each f32 multiply and add rounds separately, as in
// the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_acc.cuh"
#include "jitter_steps.cuh"
#include "row_tiles.cuh"
#include "window_search.cuh"

namespace {

using window_search::count_le;
using window_search::lower_edge;
using window_search::wrap_add;
using window_search::wrap_mul;

constexpr int UNROLL = 2;         // rows whose loads a thread issues before using any
constexpr int MAX_THREADS = 384;  // threads per block (the plan sizes it to the slice)
// blocks per SM the register budget is cut for (64 K registers / (384 x 3)
// leave 56 a thread): on an H100, three blocks with two rows' loads in
// flight per thread ran faster than two with four (tile_sweep.py --hist)
constexpr int MIN_BLOCKS = 3;

// range functions (ops/hist_kernels.py HIST_FUNC_CODES)
enum HFunc { H_RATE = 0, H_INCREASE, H_DELTA, H_SUM_OVER_TIME, H_LAST };

struct HistArgs {
    const int32_t* ts;       // [S, T] (per-series bounds)
    const float* vals;       // [S, T, B]
    const int32_t* lens;     // [S] (per-series bounds)
    const long long* gids;   // [S]
    const int32_t* lo;       // [J] shared bounds: window [lo, hi) of each step
    const int32_t* hi;
    const int32_t* t_first;  // [J] shared bounds: the window's first/last timestamps
    const int32_t* t_last;
    const float* les;        // [B] bucket bounds (quantile)
    int S, T, B, J, ld, G;
    int32_t start, step, window;
    int func, is_delta;
    int R;      // rows per tile
    int steps;  // steps per slice
    int quantile;
    float q;
    int ld_out;
    float* out;               // [G, ld_out] quantiles (quantile)
    unsigned int* arrivals;   // [slices] arrival counters, zero (quantile)
    float* acc;
    float* cnt;
    float* series;   // [J, B, ld_series] per-series values (store mode)
    int64_t ld_series;
    const jitter_steps::StepRow* jsteps;  // [J] the jitter mode's step table
};

__host__ __device__ __forceinline__ int64_t round4(int64_t x) { return (x + 3) & ~(int64_t)3; }

// Words of dynamic shared memory (ops/hist_kernels.hist_plan mirrors it):
// the [G, steps*B] acc/cnt partials (shared), R gids, the lo/hi/factor
// table ([steps] shared bounds, [R, steps] per series) and both ts tile
// buffers (staged).
__host__ __device__ __forceinline__ int64_t smem_words(int G, int B, int steps, int R, int T,
                                                       bool shared_bounds, bool shared,
                                                       bool staged) {
    const int64_t part = shared ? round4((int64_t)2 * G * steps * B) : 0;
    const int64_t nb = (int64_t)(shared_bounds ? 1 : R) * steps;
    return part + round4(R) + round4(3 * nb) + (staged ? (int64_t)2 * R * T : 0);
}

// hist_kernels.py:59-77 / :185-200: Prometheus' extrapolation factor of a
// window of cnt samples whose first and last timestamps are tf and tl
__device__ __forceinline__ float extrap_factor(int cnt_i, int32_t tf_i, int32_t tl_i,
                                               int32_t t_j, int32_t window) {
    const float cnt = (float)cnt_i;
    const float tf = (float)tf_i * 1e-3f;
    const float tl = (float)tl_i * 1e-3f;
    const float sampled = tl - tf;
    const float range_start = (float)wrap_add(t_j, -window) * 1e-3f;
    const float range_end = (float)t_j * 1e-3f;
    float dur_start = tf - range_start;
    float dur_end = range_end - tl;
    const float avg_dur = sampled / fmaxf(cnt - 1.0f, 1.0f);
    const float thresh = avg_dur * 1.1f;
    dur_start = dur_start >= thresh ? avg_dur / 2.0f : dur_start;
    dur_end = dur_end >= thresh ? avg_dur / 2.0f : dur_end;
    return (sampled + dur_start + dur_end) / fmaxf(sampled, 1e-30f);
}

// V contiguous floats at p (16-byte aligned for V = 4, 8-byte for V = 2)
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
    if constexpr (V == 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else if constexpr (V == 2) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(p));
        x[0] = v.x; x[1] = v.y;
    } else {
        x[0] = __ldg(p);
    }
}

// The range function of buckets b0 .. b0+V-1 of one row over the window
// [lo, hi); `row` points at bucket b0 of the row's first sample.
template <int V>
__device__ __forceinline__ void window_values(const HistArgs& a, const float* row, int lo, int hi,
                                              float factor, bool win_sum, float w_s,
                                              float (&v)[V]) {
    const float NaN = group_acc::nan_f();
    const int64_t B = a.B;
    if (a.func == H_LAST) {
        if (hi > lo) load_vec<V>(row + (hi - 1) * B, v);
        else
            for (int i = 0; i < V; ++i) v[i] = NaN;
    } else if (win_sum) {
        float sm[V];
        for (int i = 0; i < V; ++i) sm[i] = 0.0f;
        for (int k = lo; k < hi; ++k) {
            float x[V];
            load_vec<V>(row + k * B, x);
            for (int i = 0; i < V; ++i) sm[i] += x[i];
        }
        for (int i = 0; i < V; ++i) {
            const float s = a.func == H_RATE ? sm[i] / w_s : sm[i];
            v[i] = hi > lo ? s : NaN;
        }
    } else if (hi - lo >= 2) {
        float first[V], last[V];
        load_vec<V>(row + lo * B, first);
        load_vec<V>(row + (hi - 1) * B, last);
        for (int i = 0; i < V; ++i) {
            const float r = (last[i] - first[i]) * factor;
            v[i] = a.func == H_RATE ? r / w_s : r;
        }
    } else {
        for (int i = 0; i < V; ++i) v[i] = NaN;
    }
}

// The jitter mode's window [lo, hi) of row s at step j and, for the rate
// family, its extrapolation factor (_hist_range_jitter's in_lo / in_hi,
// tf_rel / tl_rel and factor, f32 in the JAX order): each edge slot is in
// the window when the row's deviation there passes the slot's bound.
__device__ __forceinline__ void jitter_bounds(const HistArgs& a, int64_t s, int j, bool extrap,
                                              int& lo, int& hi, float& f) {
    using namespace jitter_steps;
    const StepRow& r = a.jsteps[j];
    const int32_t* rt = a.ts + s * a.T;
    const int flags = __ldg(&r.flags);
    auto dev = [&](const int* i, const int* nom) {
        return (float)((long long)__ldg(rt + __ldg(i)) - (long long)__ldg(nom));
    };
    const bool c0 = flags & C0POS;
    const float dKlo = dev(&r.iKlo, &r.nKlo), dKhi = dev(&r.iKhi, &r.nKhi);
    const bool in_lo = (flags & HAS_KLO) && dKlo > __ldg(&r.blo_rel);
    const bool in_hi = (flags & HAS_KHI) && dKhi <= __ldg(&r.ehi_rel);
    lo = in_lo ? __ldg(&r.iKlo) : __ldg(&r.clo);
    hi = in_hi ? __ldg(&r.iKhi) + 1 : __ldg(&r.chi);
    f = 0.0f;
    const float cnt = __ldg(&r.count0) + (float)in_lo + (float)in_hi;
    if (!extrap || cnt < 2.0f) return;
    const float klo_t = __ldg(&r.Klo_rel) + dKlo, khi_t = __ldg(&r.Khi_rel) + dKhi;
    const float tf_rel = in_lo ? klo_t : (c0 ? __ldg(&r.F0_rel) + dev(&r.iF0, &r.nF0) : khi_t);
    const float tl_rel = in_hi ? khi_t : (c0 ? __ldg(&r.L0_rel) + dev(&r.iL0, &r.nL0) : klo_t);
    const float sampled = (tl_rel - tf_rel) * 1e-3f;
    const float dur_start = tf_rel * 1e-3f;
    const float dur_end = ((float)a.window - tl_rel) * 1e-3f;
    const float avg_dur = sampled / fmaxf(cnt - 1.0f, 1.0f);
    const float thresh = avg_dur * 1.1f;
    const float ds = dur_start >= thresh ? avg_dur / 2.0f : dur_start;
    const float de = dur_end >= thresh ? avg_dur / 2.0f : dur_end;
    f = (sampled + ds + de) / fmaxf(sampled, 1e-30f);
}

// Prometheus histogram_quantile over B cumulative bucket counts bucket(i)
// (NaN: no count) with bounds les [B] -- the one copy of the rule, which
// the range launch folds in (quantile_at), the standalone entry runs over
// gathered rows (hist_quantile_gather_kernel) and the instant kernel over
// each (row, step) of a grid (hist_instant_kernel, with `even`:
// histogram_max_quantile_even's count + 1 positions).
template <typename F>
__device__ __forceinline__ float quantile_of(F bucket, const float* les, int B, float q,
                                             bool even = false) {
    const float NaN = group_acc::nan_f();
    const float INF = group_acc::inf_f();
    const float total = bucket(B - 1);
    const bool ok = total > 0.0f && isfinite(total);
    const float rank = fminf(fmaxf(q, 0.0f), 1.0f) * total;
    // k: the first bucket whose count reaches the rank (else the last); the
    // scan does not stop there, so its loads do not wait on each other
    int k = -1;
    float c_hi = total, c_lo = 0.0f, prev = 0.0f;
    for (int i = 0; i < B; ++i) {
        const float c = bucket(i);
        if (k < 0 && c >= rank) {
            k = i;
            c_hi = c;
            c_lo = prev;
        }
        prev = c;
    }
    if (k < 0) {
        k = B - 1;
        c_lo = B > 1 ? bucket(B - 2) : 0.0f;
    }
    const float le_hi = __ldg(les + k);
    const float le_lo = k > 0 ? __ldg(les + k - 1) : (__ldg(les) > 0.0f ? 0.0f : -INF);
    const float highest_finite = B >= 2 ? __ldg(les + B - 2) : __ldg(les);
    // even: the samples spread over count + 1 positions (hist_kernels.py:111)
    const float denom = even ? (c_hi - c_lo) + 1.0f : c_hi - c_lo;
    const float frac = (rank - c_lo) / (isnan(denom) ? denom : fmaxf(denom, 1e-30f));
    float val = le_lo + (le_hi - le_lo) * frac;
    if (k == B - 1) val = highest_finite;  // the +Inf bucket: the highest finite bound
    if (isinf(le_lo) && le_lo < 0.0f) val = le_hi;  // les[0] <= 0
    float res = ok ? val : NaN;
    if (q < 0.0f) res = -INF;
    if (q > 1.0f) res = INF;
    return res;
}

// jnp.clip(x, 0, 1) and jnp.maximum(x, floor): a NaN passes through
__device__ __forceinline__ float clip01(float x) { return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x); }
__device__ __forceinline__ float max_or_nan(float x, float floor) {
    return isnan(x) || x > floor ? x : floor;
}

// promql histogram_fraction(lower, upper, .) over B cumulative bucket
// counts bucket(i) with bounds les [B] (les[B-1] = +inf), line for line
// filodb_tpu/ops/hist_kernels.py:124: the share of the observations in
// [lower, upper], each bound's cumulative count interpolated linearly in
// its bucket (cum_at); NaN where the total is not positive.
template <typename F>
__device__ __forceinline__ float fraction_of(F bucket, const float* les, int B, float lower,
                                             float upper) {
    const float INF = group_acc::inf_f();
    auto cum_at = [&](float x) {
        int xb = 0;  // searchsorted(les, x), side left: the bounds below x
        for (int i = 0; i < B; ++i) xb += __ldg(les + i) < x;
        xb = min(xb, B - 1);
        const float c_hi = bucket(xb);
        const float c_lo = xb > 0 ? bucket(xb - 1) : 0.0f;
        const float le_hi = __ldg(les + xb);
        const float le_lo = xb > 0 ? __ldg(les + xb - 1) : (__ldg(les) > 0.0f ? 0.0f : -INF);
        const float width = le_hi - le_lo;
        const float w = isfinite(width) ? (x - le_lo) / max_or_nan(width, 1e-30f) : 1.0f;
        return c_lo + (c_hi - c_lo) * clip01(w);
    };
    const float total = bucket(B - 1);
    const float frac = (cum_at(upper) - cum_at(lower)) / max_or_nan(total, 1e-30f);
    return total > 0.0f ? clip01(frac) : group_acc::nan_f();
}

// Prometheus histogram_quantile of one (group, step)'s finished partials:
// `ar` / `cr` are its B bucket sums and member counts, read through L2
// (they were written by other blocks' atomics in this launch).
__device__ __forceinline__ float quantile_at(const float* ar, const float* cr, const float* les,
                                             int B, float q) {
    // the finished group sum of bucket i: NaN where no member had a value
    return quantile_of(
        [&](int i) { return __ldcg(cr + i) > 0.0f ? __ldcg(ar + i) : group_acc::nan_f(); }, les,
        B, q);
}

// The standalone quantile (B7, filodb_tpu/ops/hist_kernels.py:86
// histogram_quantile) over classic bucket series: group g's B cumulative
// counts are the rows table[g, 0..B) of the finished [*, ld] partials
// `part` (the by-(le, ...) aggregate, NaN where a group had no member; a
// row index < 0 reads NaN); quantile_of of them goes to out[rows[g], j].
//
// One thread per (group g, step j < J). The threads of a warp take
// consecutive steps of one group, so each bucket's read is one coalesced
// row segment; each of quantile_of's B + 1 bucket reads is a pair whose
// count read waits on its table read (table[g, b], then part[r * ld + j]).
// On an H100 a design that staged the rows in shared memory and issued
// every count read before use ran 10-12 % faster at 1-512 groups of 12
// buckets x 111 steps, where either launch takes ~0.003 ms on the device,
// and 1.2-1.4 x slower from 1,000 groups (tile_sweep.py --classic-gather
// builds it from GATHER_PATCHES), so this one stays.
__global__ void hist_quantile_gather_kernel(const float* part, int ld, const int32_t* table,
                                            const int32_t* rows, const float* les, int G, int B,
                                            int J, float q, float* out, int ld_out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (int64_t)G * J) return;
    const int g = (int)(i / J), j = (int)(i - (int64_t)g * J);
    const int32_t* tg = table + (int64_t)g * B;
    auto bucket = [&](int b) {
        const int32_t r = __ldg(tg + b);
        return r >= 0 ? __ldg(part + (int64_t)r * ld + j) : group_acc::nan_f();
    };
    out[(int64_t)__ldg(rows + g) * ld_out + j] = quantile_of(bucket, les, B, q);
}

// An empty kernel: the card's floor for a launch through ctypes, timed
// beside the gather over its blocks (filodb_empty_launch).
__global__ void empty_kernel() {}

constexpr int GATHER_THREADS = 256;

// The gather's blocks over G groups x J steps, or -1 past a grid's limit.
int64_t gather_blocks(int G, int J) {
    const int64_t blocks = ((int64_t)G * J + GATHER_THREADS - 1) / GATHER_THREADS;
    return blocks > 0x7fffffff ? -1 : blocks;
}

// The instant histogram functions (filodb_tpu/ops/hist_kernels.py:86
// histogram_quantile, with `even`, and :124 histogram_fraction) over the
// grids of one plan node, in one launch: up to MAX_GRIDS [S_g, J, B_g]
// grids of per-series bucket values, each read through its own strides (in
// floats: ss per row, sj per step, sb per bucket) with its own bounds
// les_g [B_g], their rows numbered one after the other (grid g's from
// row0[g]). One thread per (row r, step j) reads its B_g buckets and
// writes one f32 to the step-major out[j * ld_out + r]. The threads of a
// warp take consecutive rows of one step, so each bucket's read is one
// coalesced segment where a grid's rows are contiguous (ss = 1: the store
// mode's [J, B, S] grid).
enum HOp { HOP_QUANTILE = 0, HOP_QUANTILE_EVEN, HOP_FRACTION };
constexpr int MAX_GRIDS = 32;  // grids a launch takes (ops/hist_kernels.py MAX_GRIDS)

struct InstantArgs {
    const float* h[MAX_GRIDS];
    const float* les[MAX_GRIDS];
    int64_t ss[MAX_GRIDS], sj[MAX_GRIDS], sb[MAX_GRIDS];
    int64_t row0[MAX_GRIDS + 1];  // grid g's rows are [row0[g], row0[g + 1])
    int B[MAX_GRIDS];
    int n_grids, J, op;
    float q, lower, upper;
    float* out;
    int64_t ld_out;
};

__global__ void hist_instant_kernel(const __grid_constant__ InstantArgs a) {
    const int64_t rows = a.row0[a.n_grids];
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rows * a.J) return;
    const int j = (int)(i / rows);
    const int64_t r = i - (int64_t)j * rows;
    int g = 0;
    while (r >= a.row0[g + 1]) ++g;
    const float* p = a.h[g] + (r - a.row0[g]) * a.ss[g] + j * a.sj[g];
    const int64_t sb = a.sb[g];
    auto bucket = [&](int b) { return __ldg(p + b * sb); };
    a.out[(int64_t)j * a.ld_out + r] =
        a.op == HOP_FRACTION ? fraction_of(bucket, a.les[g], a.B[g], a.lower, a.upper)
                             : quantile_of(bucket, a.les[g], a.B[g], a.q, a.op == HOP_QUANTILE_EVEN);
}

// The store mode's values of one tile: the range function of every (row r
// < rows, step j0 + jl, bucket) to the step-major series[(j * B + b) *
// ld_series + s0 + r]; each value is written once (no atomic, no group
// partials). A thread takes (column vector, row) items with the rows
// fastest, so the lanes of a warp store runs of consecutive rows of one
// (step, bucket) plane; UNROLL items' loads are issued before any is
// stored. A padded row (group < 0) is NaN. The row bound is checked again
// at the store: nvcc 12.8 miscompiled a store variant's tile bound once
// (ROADMAP C, "Closed").
template <int V, bool SHARED_BOUNDS>
__device__ __forceinline__ void store_tile(const HistArgs& a, const float* tile_vals, int64_t s0,
                                           int rows, int j0, int cv_n, int nvec,
                                           const int* gid_s, const int* lo_s, const int* hi_s,
                                           const float* fac_s, bool win_sum, float w_s) {
    const int B = a.B;
    const int items = cv_n * rows;
    for (int it0 = threadIdx.x; it0 < items; it0 += UNROLL * blockDim.x) {
        float v[UNROLL][V];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int it = it0 + u * blockDim.x;
            if (it >= items) continue;
            const int cv = it / rows, r = it - cv * rows;
            const int jl = cv / nvec, b0 = (cv - jl * nvec) * V;
            if (gid_s[r] < 0) {
                for (int i = 0; i < V; ++i) v[u][i] = group_acc::nan_f();
                continue;
            }
            const int k = SHARED_BOUNDS ? jl : r * a.steps + jl;
            window_values<V>(a, tile_vals + (int64_t)r * a.T * B + b0, lo_s[k], hi_s[k],
                             fac_s[k], win_sum, w_s, v[u]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int it = it0 + u * blockDim.x;
            if (it >= items) continue;
            const int cv = it / rows, r = it - cv * rows;
            const int64_t s = s0 + r;
            if (s >= a.S) continue;
            const int jl = cv / nvec, b0 = (cv - jl * nvec) * V;
            float* o = a.series + ((int64_t)(j0 + jl) * B + b0) * a.ld_series + s;
            for (int i = 0; i < V; ++i) o[(int64_t)i * a.ld_series] = v[u][i];
        }
    }
}

// STORE: the store mode (store_tile) instead of the group sums; no
// partials, no quantile.
// JITTER: the jitter mode's bounds (SHARED_BOUNDS and STAGED false).
template <bool SHARED_BOUNDS, bool SHARED, bool STAGED, int V, bool STORE = false,
          bool JITTER = false>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS) hist_range_kernel(const HistArgs a) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int last_s;
    const int B = a.B;
    const int j0 = blockIdx.y * a.steps;
    const int ns = min(a.steps, a.J - j0);  // this slice's steps
    const int width = a.steps * B;          // a row of the shared partials
    const int nvec = B / V;
    const int cv_n = ns * nvec;             // the slice's column vectors
    const int64_t part = SHARED ? round4((int64_t)2 * a.G * width) : 0;
    float* acc_s = smem;
    float* cnt_s = smem + (int64_t)a.G * width;
    int* gid_s = reinterpret_cast<int*>(smem + part);
    const int nb = (SHARED_BOUNDS ? 1 : a.R) * a.steps;
    int* lo_s = gid_s + round4(a.R);
    int* hi_s = lo_s + nb;
    float* fac_s = reinterpret_cast<float*>(hi_s + nb);
    float* stage = reinterpret_cast<float*>(lo_s) + round4(3 * nb);
    const float w_s = (float)a.window * 1e-3f;
    const bool win_sum =
        a.func == H_SUM_OVER_TIME || (a.is_delta && (a.func == H_RATE || a.func == H_INCREASE));
    const bool extrap = !win_sum && a.func != H_LAST;
    auto t_of = [&](int j) { return wrap_add(a.start, wrap_mul(j, a.step)); };
    // a row's group, -1 for the trash group G (padding) or no group
    auto gid_of = [&](int64_t s) {
        const long long g = __ldg(a.gids + s);
        return (g < 0 || g >= a.G) ? -1 : (int)g;
    };
    auto len_of = [&](int64_t s) { return min(max(__ldg(a.lens + s), 0), a.T); };

    if (SHARED) group_acc::shared_init(acc_s, cnt_s, a.G * width, group_acc::ACC_ADD);
    if (SHARED_BOUNDS) {  // the same window in every row
        for (int jl = threadIdx.x; jl < ns; jl += blockDim.x) {
            const int j = j0 + jl;
            const int lo = __ldg(a.lo + j), hi = __ldg(a.hi + j);
            lo_s[jl] = lo;
            hi_s[jl] = hi;
            fac_s[jl] = extrap && hi - lo >= 2
                            ? extrap_factor(hi - lo, __ldg(a.t_first + j), __ldg(a.t_last + j),
                                            t_of(j), a.window)
                            : 0.0f;
        }
    }
    __syncthreads();

    // add a run of n[i] values summing to run[i] to group g's columns
    // col .. col+V-1 of the slice
    auto fold = [&](int g, int col, const float (&run)[V], const float (&n)[V]) {
        for (int i = 0; i < V; ++i) {
            if (n[i] <= 0.0f) continue;
            if (SHARED) {  // this thread owns the column: no atomic
                acc_s[(int64_t)g * width + col + i] += run[i];
                cnt_s[(int64_t)g * width + col + i] += n[i];
            } else {
                const int64_t o = (int64_t)g * a.ld + (int64_t)j0 * B + col + i;
                atomicAdd(a.acc + o, run[i]);
                atomicAdd(a.cnt + o, n[i]);
            }
        }
    };

    row_tiles::for_each_tile<STAGED>(
        a.S, a.R,
        [&](int tile, int b) {  // the tile's ts rows: each real row's samples only
            const int64_t s0 = (int64_t)tile * a.R;
            const int rows = a.S - s0 < a.R ? (int)(a.S - s0) : a.R;
            row_tiles::issue_tile(a.ts, nullptr, nullptr, 1, s0, rows, a.R, a.T,
                                  stage + (int64_t)b * a.R * a.T, [&](int r) {
                                      return gid_of(s0 + r) < 0 ? 0 : (len_of(s0 + r) + 3) / 4;
                                  });
        },
        [&](int tile, int b) {
            const int64_t s0 = (int64_t)tile * a.R;
            const int rows = a.S - s0 < a.R ? (int)(a.S - s0) : a.R;
            for (int r = threadIdx.x; r < rows; r += blockDim.x) gid_s[r] = gid_of(s0 + r);
            if (!SHARED_BOUNDS) {  // one search per (row, step), for all B buckets
                const int32_t* buf =
                    reinterpret_cast<const int32_t*>(stage + (int64_t)b * a.R * a.T);
                row_tiles::for_each_pair(rows, ns, [&](int r, int jl) {
                    const int64_t s = s0 + r;
                    int lo = 0, hi = 0;
                    float f = 0.0f;
                    if (JITTER) {
                        if (gid_of(s) >= 0) jitter_bounds(a, s, j0 + jl, extrap, lo, hi, f);
                    } else if (gid_of(s) >= 0) {
                        const int32_t* rt = STAGED ? buf + (int64_t)r * a.T : a.ts + s * a.T;
                        const int32_t t_j = t_of(j0 + jl);
                        hi = count_le<!STAGED>(rt, len_of(s), t_j);
                        lo = lower_edge(rt, hi, wrap_add(t_j, -a.window));
                        if (extrap && hi - lo >= 2)
                            f = extrap_factor(hi - lo, rt[lo], rt[hi - 1], t_j, a.window);
                    }
                    lo_s[r * a.steps + jl] = lo;
                    hi_s[r * a.steps + jl] = hi;
                    fac_s[r * a.steps + jl] = f;
                });
            }
            __syncthreads();
            const float* tile_vals = a.vals + s0 * a.T * B;
            if constexpr (STORE) {
                store_tile<V, SHARED_BOUNDS>(a, tile_vals, s0, rows, j0, cv_n, nvec, gid_s, lo_s,
                                             hi_s, fac_s, win_sum, w_s);
                __syncthreads();  // before the next tile rewrites the gids and bounds
                return;
            }
            for (int cv = threadIdx.x; cv < cv_n; cv += blockDim.x) {
                const int jl = cv / nvec;
                const int b0 = (cv - jl * nvec) * V;
                const int col = jl * B + b0;
                float run[V] = {}, n[V] = {};
                int g_run = -1;
                for (int r0 = 0; r0 < rows; r0 += UNROLL) {
                    float v[UNROLL][V];
                    int g[UNROLL];
#pragma unroll
                    for (int u = 0; u < UNROLL; ++u) {
                        const int r = r0 + u;
                        g[u] = r < rows ? gid_s[r] : -1;
                        if (g[u] < 0) continue;
                        const int k = SHARED_BOUNDS ? jl : r * a.steps + jl;
                        window_values<V>(a, tile_vals + (int64_t)r * a.T * B + b0, lo_s[k],
                                         hi_s[k], fac_s[k], win_sum, w_s, v[u]);
                    }
#pragma unroll
                    for (int u = 0; u < UNROLL; ++u) {
                        if (g[u] < 0) continue;
                        if (g[u] != g_run) {
                            if (g_run >= 0) fold(g_run, col, run, n);
                            g_run = g[u];
                            for (int i = 0; i < V; ++i) run[i] = n[i] = 0.0f;
                        }
                        for (int i = 0; i < V; ++i) {
                            if (!isnan(v[u][i])) {
                                run[i] += v[u][i];
                                n[i] += 1.0f;
                            }
                        }
                    }
                }
                if (g_run >= 0) fold(g_run, col, run, n);
            }
            __syncthreads();  // before the next tile rewrites the gids and bounds
        });

    if (STORE) return;
    if (SHARED)  // the block's [G, steps*B] partials are columns j0*B .. of the global arrays
        group_acc::shared_flush(acc_s, cnt_s, a.G, width, a.acc + (int64_t)j0 * B,
                                a.cnt + (int64_t)j0 * B, a.ld, group_acc::ACC_ADD);
    if (!a.quantile) return;
    __threadfence();  // this block's partials are visible before it arrives
    __syncthreads();
    if (threadIdx.x == 0) last_s = atomicAdd(a.arrivals + blockIdx.y, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    for (int i = threadIdx.x; i < a.G * ns; i += blockDim.x) {
        const int g = i / ns;
        const int j = j0 + (i - g * ns);
        const int64_t o = (int64_t)g * a.ld + (int64_t)j * B;
        a.out[(int64_t)g * a.ld_out + j] = quantile_at(a.acc + o, a.cnt + o, a.les, B, a.q);
    }
    if (threadIdx.x == 0) a.arrivals[blockIdx.y] = 0;  // ready for the next launch
}

template <bool SB, bool SH, bool ST, int V, bool JT = false>
cudaError_t launch_range(const HistArgs& a, int smem, int threads, int grid, int slices,
                         cudaStream_t stream) {
    auto kern = hist_range_kernel<SB, SH, ST, V, false, JT>;
    int resident = 0;  // also raises the kernel's shared-memory allowance to smem
    const cudaError_t err = row_tiles::persistent_grid(kern, smem, 1 << 30, &resident, threads);
    if (err != cudaSuccess) return err;
    kern<<<dim3(grid, slices), threads, smem, stream>>>(a);
    return cudaGetLastError();
}

template <bool SB, bool SH, bool ST>
cudaError_t launch_vec(const HistArgs& a, int vec, int smem, int threads, int grid, int slices,
                       cudaStream_t st) {
    if (vec == 4) return launch_range<SB, SH, ST, 4>(a, smem, threads, grid, slices, st);
    if (vec == 2) return launch_range<SB, SH, ST, 2>(a, smem, threads, grid, slices, st);
    return launch_range<SB, SH, ST, 1>(a, smem, threads, grid, slices, st);
}

// the store mode: its persistent grid shares the resident blocks among
// the slices, at least one each and no more than a slice's tiles
template <bool SB, bool ST, int V>
cudaError_t launch_series(const HistArgs& a, int smem, int threads, int slices,
                          cudaStream_t stream) {
    auto kern = hist_range_kernel<SB, false, ST, V, true>;
    int resident = 0;
    const cudaError_t err = row_tiles::persistent_grid(kern, smem, 1 << 30, &resident, threads);
    if (err != cudaSuccess) return err;
    const int tiles = (a.S + a.R - 1) / a.R;
    const int grid = max(1, min(tiles, resident / slices));
    kern<<<dim3(grid, slices), threads, smem, stream>>>(a);
    return cudaGetLastError();
}

template <bool SB, bool ST>
cudaError_t series_vec(const HistArgs& a, int vec, int smem, int threads, int slices,
                       cudaStream_t st) {
    if (vec == 4) return launch_series<SB, ST, 4>(a, smem, threads, slices, st);
    if (vec == 2) return launch_series<SB, ST, 2>(a, smem, threads, slices, st);
    return launch_series<SB, ST, 1>(a, smem, threads, slices, st);
}

template <bool SB, bool SH, bool ST, int V, bool JT = false>
cudaError_t resident_of(int smem, int threads, int* blocks) {
    return row_tiles::persistent_grid(hist_range_kernel<SB, SH, ST, V, false, JT>, smem,
                                      1 << 30, blocks, threads);
}

// the jitter mode's kernels: per-series bounds tables, no staged rows
template <bool SH>
cudaError_t jitter_vec(const HistArgs& a, int vec, int smem, int threads, int grid, int slices,
                       cudaStream_t st) {
    if (vec == 4) return launch_range<false, SH, false, 4, true>(a, smem, threads, grid, slices, st);
    if (vec == 2) return launch_range<false, SH, false, 2, true>(a, smem, threads, grid, slices, st);
    return launch_range<false, SH, false, 1, true>(a, smem, threads, grid, slices, st);
}

cudaError_t jitter_resident(bool sh, int vec, int smem, int threads, int* blocks) {
#define FILODB_JITTER_RESIDENT(SH)                                                    \
    if (sh == SH) {                                                                   \
        if (vec == 4) return resident_of<false, SH, false, 4, true>(smem, threads, blocks); \
        if (vec == 2) return resident_of<false, SH, false, 2, true>(smem, threads, blocks); \
        return resident_of<false, SH, false, 1, true>(smem, threads, blocks);         \
    }
    FILODB_JITTER_RESIDENT(true)
    FILODB_JITTER_RESIDENT(false)
#undef FILODB_JITTER_RESIDENT
    return cudaErrorInvalidValue;
}

cudaError_t resident_vec(bool sb, bool sh, bool st, int vec, int smem, int threads,
                         int* blocks) {
#define FILODB_HIST_RESIDENT(SB, SH, ST)                                        \
    if (sb == SB && sh == SH && st == ST) {                                     \
        if (vec == 4) return resident_of<SB, SH, ST, 4>(smem, threads, blocks); \
        if (vec == 2) return resident_of<SB, SH, ST, 2>(smem, threads, blocks); \
        return resident_of<SB, SH, ST, 1>(smem, threads, blocks);               \
    }
    FILODB_HIST_RESIDENT(true, true, false)
    FILODB_HIST_RESIDENT(true, false, false)
    FILODB_HIST_RESIDENT(false, true, true)
    FILODB_HIST_RESIDENT(false, true, false)
    FILODB_HIST_RESIDENT(false, false, true)
    FILODB_HIST_RESIDENT(false, false, false)
#undef FILODB_HIST_RESIDENT
    return cudaErrorInvalidValue;
}


bool threads_ok(int threads) {
    return threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0;
}

}  // namespace

// Plain C entry for ctypes: histogram_quantile(q, .) of classic bucket
// series (one bucket scheme): for each of G groups, its B cumulative
// counts are the rows table[g, :] (int32 [G, B], le-ascending; < 0 reads
// NaN) of the finished partials part [*, ld] at steps [0, J), with bounds
// les [B] (les[B-1] = +inf); the quantiles go to out [*, ld_out] at rows
// rows[g] (int32 [G]), steps [0, J). Launches on `stream` and returns a
// cudaError_t (0 on success); it does not synchronise.
extern "C" int filodb_hist_quantile_gather(const void* part, int ld, const void* table,
                                           const void* rows, const void* les, int G, int B,
                                           int J, float q, void* out, int ld_out,
                                           void* stream) {
    if (G <= 0 || J <= 0) return 0;
    const int64_t blocks = gather_blocks(G, J);
    if (B <= 0 || ld < J || ld_out < J || !part || !table || !rows || !les || !out ||
        blocks < 0)
        return (int)cudaErrorInvalidValue;
    hist_quantile_gather_kernel<<<(int)blocks, GATHER_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)part, ld, (const int32_t*)table, (const int32_t*)rows, (const float*)les,
        G, B, J, q, (float*)out, ld_out);
    return (int)cudaGetLastError();
}

// Plain C entry for ctypes: an empty kernel over the blocks a gather of G
// groups x J steps launches, on `stream`: the floor a gather launch is
// timed against.
extern "C" int filodb_empty_launch(int G, int J, void* stream) {
    const int64_t blocks = G > 0 && J > 0 ? gather_blocks(G, J) : -1;
    if (blocks < 0) return (int)cudaErrorInvalidValue;
    empty_kernel<<<(int)blocks, GATHER_THREADS, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// Plain C entry for ctypes: the instant histogram functions of n_grids
// (<= MAX_GRIDS) [S_g, J, B_g] grids of per-series bucket values in one
// launch: grid g at h[g] (f32, strides strides[3g .. 3g+2] in floats: row,
// step, bucket) with bounds les[g] [B[g]] (the last +inf); its rows are
// rows row0[g] .. row0[g+1] of out (host arrays: h and les of n_grids
// pointers, strides of 3 n_grids, B of n_grids, row0 of n_grids + 1
// starting at 0). op 0 histogram_quantile(q, .), 1 the same over
// count + 1 positions (histogram_max_quantile_even), 2
// histogram_fraction(lower, upper, .); into the step-major out
// [J, ld_out] (ld_out >= row0[n_grids]). Launches on `stream` and returns
// a cudaError_t (0 on success); it does not synchronise.
extern "C" int filodb_hist_instant(const void* const* h, const long long* strides,
                                   const void* const* les, const int* B,
                                   const long long* row0, int n_grids, int J, int op, float q,
                                   float lower, float upper, void* out, long long ld_out,
                                   void* stream) {
    if (n_grids < 1 || n_grids > MAX_GRIDS || J < 0 || op < HOP_QUANTILE ||
        op > HOP_FRACTION || !h || !strides || !les || !B || !row0 || !out || row0[0] != 0)
        return (int)cudaErrorInvalidValue;
    InstantArgs a{};
    for (int g = 0; g < n_grids; ++g) {
        if (!h[g] || !les[g] || B[g] < 1 || row0[g + 1] < row0[g])
            return (int)cudaErrorInvalidValue;
        a.h[g] = (const float*)h[g];
        a.les[g] = (const float*)les[g];
        a.ss[g] = strides[3 * g];
        a.sj[g] = strides[3 * g + 1];
        a.sb[g] = strides[3 * g + 2];
        a.B[g] = B[g];
        a.row0[g + 1] = row0[g + 1];
    }
    const int64_t rows = row0[n_grids];
    if (ld_out < rows) return (int)cudaErrorInvalidValue;
    if (rows == 0 || J == 0) return 0;
    a.n_grids = n_grids;
    a.J = J;
    a.op = op;
    a.q = q;
    a.lower = lower;
    a.upper = upper;
    a.out = (float*)out;
    a.ld_out = ld_out;
    const int threads = 256;
    const int64_t blocks = (rows * J + threads - 1) / threads;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    hist_instant_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// Plain C entry for ctypes: the range kernel's store mode, func(m[w]) of
// every series of a [S, T, B] histogram block into the step-major out
// [J, B, ld_out] (ld_out >= S): out[(j * B + b) * ld_out + s] for every
// step j < J, bucket b and row s < S, each written once; a row whose
// gids[s] is not 0 (padding) is NaN. Bounds as filodb_hist_range_aggregate
// takes them (shared_bounds: the [J] lo, hi, t_first, t_last; else ts and
// lens, staged or searched in place), and the layout from the wrapper's
// plan (ops/hist_kernels.hist_plan with store=True): `rows` rows per tile,
// `steps` steps per slice, buckets fetched `vec` at a time, `threads`
// threads, `smem_bytes` of dynamic shared memory (checked here; no group
// partials). Launches on `stream` and returns a cudaError_t (0 on
// success); it does not synchronise.
extern "C" int filodb_hist_range_series(
    const void* ts, const void* vals, const void* lens, const void* gids, const void* lo,
    const void* hi, const void* t_first, const void* t_last, int S, int T, int B, int J,
    int start, int step, int window, int func, int is_delta, int shared_bounds, int rows,
    int steps, int vec, int staged, int threads, int smem_bytes, void* out, long long ld_out,
    void* stream) {
    if (S <= 0 || J <= 0 || B <= 0) return 0;
    const bool bounds_ok = shared_bounds ? (lo && hi && t_first && t_last) : (ts && lens);
    const bool vec_ok = (vec == 1 || vec == 2 || vec == 4) && B % vec == 0 &&
                        (uintptr_t)vals % (4 * vec) == 0;
    const bool staged_ok = !staged || (!shared_bounds && T % 4 == 0 && (uintptr_t)ts % 16 == 0);
    if (func < H_RATE || func > H_LAST || rows < 1 || steps < 1 || !threads_ok(threads) ||
        (J + steps - 1) / steps > 65535 || ld_out < S || !out || !gids || !bounds_ok ||
        !vec_ok || !staged_ok ||
        (int64_t)smem_bytes != 4 * smem_words(1, B, steps, rows, T, shared_bounds, false, staged))
        return (int)cudaErrorInvalidValue;
    HistArgs a{(const int32_t*)ts, (const float*)vals, (const int32_t*)lens,
               (const long long*)gids, (const int32_t*)lo, (const int32_t*)hi,
               (const int32_t*)t_first, (const int32_t*)t_last, nullptr, S, T, B, J,
               J * B, 1, (int32_t)start, (int32_t)step, (int32_t)window, func, is_delta, rows,
               steps, 0, 0.0f, 0, nullptr, nullptr, nullptr, nullptr, (float*)out,
               (int64_t)ld_out};
    const int slices = (J + steps - 1) / steps;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (shared_bounds)
        err = series_vec<true, false>(a, vec, smem_bytes, threads, slices, st);
    else if (staged)
        err = series_vec<false, true>(a, vec, smem_bytes, threads, slices, st);
    else
        err = series_vec<false, false>(a, vec, smem_bytes, threads, slices, st);
    return (int)err;
}

// Plain C entry for ctypes: how many blocks of the range kernel's variant
// (shared_bounds, shared partials, staged ts rows, vector width vec) with
// smem_bytes of dynamic shared memory and `threads` threads fit on the
// current card at once, into *blocks. Returns a cudaError_t (0 on
// success).
extern "C" int filodb_hist_resident(int shared_bounds, int shared, int staged, int vec,
                                    int smem_bytes, int threads, int* blocks) {
    if ((shared_bounds && staged) || (vec != 1 && vec != 2 && vec != 4) || !threads_ok(threads))
        return (int)cudaErrorInvalidValue;
    return (int)resident_vec(shared_bounds, shared, staged, vec, smem_bytes, threads, blocks);
}

// Plain C entry for ctypes: sum by (...) (func(m[w])) over a [S, T, B]
// histogram block, and with `quantile` histogram_quantile(q, .) of the
// sums. acc and cnt [G+1, ld] (ld >= J * B) must hold zeros; columns
// j * B + b of steps [0, J) are computed. shared_bounds: the [J] arrays lo,
// hi, t_first, t_last give every row's window (a regular grid); else each
// row's window is searched in ts [S, T] over lens, its rows copied into
// shared memory when `staged`. The layout comes from the wrapper's plan
// (ops/hist_kernels.hist_plan): `rows` rows per tile, `steps` steps per
// slice (ceil(J / steps) slices, grid `grid` x slices of `threads`
// threads), buckets fetched `vec` at a time, `shared` [G, steps*B]
// partials in shared memory, and
// `smem_bytes` of dynamic shared memory (checked here). With `quantile`:
// bounds les [B] (les[B-1] = +inf), out [G, ld_out] written at steps
// [0, J), and `arrivals` [slices] zeroed counters, left at zero. Launches
// on `stream` and returns a cudaError_t (0 on success); it does not
// synchronise.
extern "C" int filodb_hist_range_aggregate(
    const void* ts, const void* vals, const void* lens, const void* gids, const void* lo,
    const void* hi, const void* t_first, const void* t_last, int S, int T, int B, int J, int ld,
    int G, int start, int step, int window, int func, int is_delta, int shared_bounds, int rows,
    int steps, int vec, int shared, int staged, int threads, int grid, int smem_bytes, void* acc,
    void* cnt,
    int quantile, float q, const void* les, void* out, int ld_out, void* arrivals,
    void* stream) {
    if (S <= 0 || J <= 0 || G <= 0 || B <= 0) return 0;
    const bool bounds_ok = shared_bounds ? (lo && hi && t_first && t_last) : (ts && lens);
    const bool quantile_ok = !quantile || (les && out && arrivals && ld_out >= J);
    const bool vec_ok = (vec == 1 || vec == 2 || vec == 4) && B % vec == 0 &&
                        (uintptr_t)vals % (4 * vec) == 0;
    const bool staged_ok = !staged || (!shared_bounds && T % 4 == 0 && (uintptr_t)ts % 16 == 0);
    if (func < H_RATE || func > H_LAST || rows < 1 || steps < 1 || grid < 1 ||
        !threads_ok(threads) ||
        (J + steps - 1) / steps > 65535 || ld < J * B || !bounds_ok || !quantile_ok ||
        !vec_ok || !staged_ok ||
        (int64_t)smem_bytes != 4 * smem_words(G, B, steps, rows, T, shared_bounds, shared, staged))
        return (int)cudaErrorInvalidValue;
    HistArgs a{(const int32_t*)ts, (const float*)vals, (const int32_t*)lens,
               (const long long*)gids, (const int32_t*)lo, (const int32_t*)hi,
               (const int32_t*)t_first, (const int32_t*)t_last, (const float*)les, S, T, B, J,
               ld, G, (int32_t)start, (int32_t)step, (int32_t)window, func, is_delta, rows,
               steps, quantile, q, ld_out, (float*)out, (unsigned int*)arrivals, (float*)acc,
               (float*)cnt, nullptr, 0};
    const int slices = (J + steps - 1) / steps;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (shared_bounds)
        err = shared ? launch_vec<true, true, false>(a, vec, smem_bytes, threads, grid, slices, st)
                     : launch_vec<true, false, false>(a, vec, smem_bytes, threads, grid, slices, st);
    else if (staged)
        err = shared ? launch_vec<false, true, true>(a, vec, smem_bytes, threads, grid, slices, st)
                     : launch_vec<false, false, true>(a, vec, smem_bytes, threads, grid, slices, st);
    else
        err = shared ? launch_vec<false, true, false>(a, vec, smem_bytes, threads, grid, slices, st)
                     : launch_vec<false, false, false>(a, vec, smem_bytes, threads, grid, slices, st);
    return (int)err;
}

// Plain C entry for ctypes: how many blocks of the jitter mode's kernel
// (shared partials, vector width vec) with smem_bytes of dynamic shared
// memory and `threads` threads fit on the current card at once, into
// *blocks. Returns a cudaError_t (0 on success).
extern "C" int filodb_hist_jitter_resident(int shared, int vec, int smem_bytes, int threads,
                                           int* blocks) {
    if ((vec != 1 && vec != 2 && vec != 4) || !threads_ok(threads))
        return (int)cudaErrorInvalidValue;
    return (int)jitter_resident(shared, vec, smem_bytes, threads, blocks);
}

// Plain C entry for ctypes: filodb_hist_range_aggregate's jitter mode (B1)
// over a near-regular [S, T, B] histogram block: each row's window at step
// j is the step table's (steps [J] rows of jitter_steps::StepRow,
// ops/mxu_jitter.JitterWindowMatrices.steps) with the edge slots tested
// against the row's deviation ts - nominal (ts [S, T]). Everything else --
// acc, cnt, the layout from ops/hist_kernels.hist_plan(..., jitter=True)
// (per-series bounds tables, no staged rows), the quantile -- as
// filodb_hist_range_aggregate takes it. Launches on `stream` and returns a
// cudaError_t (0 on success); it does not synchronise.
extern "C" int filodb_hist_range_jitter(
    const void* ts, const void* vals, const void* gids, const void* steps_table, int S, int T,
    int B, int J, int ld, int G, int window, int func, int is_delta, int rows, int steps,
    int vec, int shared, int threads, int grid, int smem_bytes, void* acc, void* cnt,
    int quantile, float q, const void* les, void* out, int ld_out, void* arrivals,
    void* stream) {
    if (S <= 0 || J <= 0 || G <= 0 || B <= 0) return 0;
    const bool quantile_ok = !quantile || (les && out && arrivals && ld_out >= J);
    const bool vec_ok = (vec == 1 || vec == 2 || vec == 4) && B % vec == 0 &&
                        (uintptr_t)vals % (4 * vec) == 0;
    if (func < H_RATE || func > H_LAST || rows < 1 || steps < 1 || grid < 1 ||
        !threads_ok(threads) || (J + steps - 1) / steps > 65535 || ld < J * B || !ts ||
        !steps_table || !gids || !quantile_ok || !vec_ok ||
        (int64_t)smem_bytes != 4 * smem_words(G, B, steps, rows, T, false, shared, false))
        return (int)cudaErrorInvalidValue;
    HistArgs a{(const int32_t*)ts, (const float*)vals, nullptr, (const long long*)gids,
               nullptr, nullptr, nullptr, nullptr, (const float*)les, S, T, B, J, ld, G, 0, 0,
               (int32_t)window, func, is_delta, rows, steps, quantile, q, ld_out, (float*)out,
               (unsigned int*)arrivals, (float*)acc, (float*)cnt, nullptr, 0,
               (const jitter_steps::StepRow*)steps_table};
    const int slices = (J + steps - 1) / steps;
    cudaStream_t st = (cudaStream_t)stream;
    return (int)(shared ? jitter_vec<true>(a, vec, smem_bytes, threads, grid, slices, st)
                        : jitter_vec<false>(a, vec, smem_bytes, threads, grid, slices, st));
}

// Lane mode (B12: _batched_hist_shared_jit and _batched_hist_jit,
// filodb_tpu/ops/hist_kernels.py:486 and :507, which run the per-bucket
// range grid once per unique window and _hist_epilogue once per lane). One
// launch over U unique windows (blockIdx.y = u): the shared bounds of a
// regular grid stacked [U, ldw] (lo, hi, t_first, t_last), else bounds
// searched per (row, step) in place; start, step and window [U] int32. A
// block walks tiles of rows and its threads take the tile's (row, column)
// pairs, column j * B + b flattened, so a warp reads neighbouring buckets
// of one sample; each value (window_values, the solo kernel's function)
// is computed once and folded into every lane of u at the lane's group
// (group_acc.cuh lanes::). With a quantile, the last block of window u to
// finish interpolates each of its lanes' [G, J] quantiles with the lane's
// own q (qs [L]) into out [L, G, ld_out], as the solo kernel folds its
// quantile in. Bound: the sampled buckets each window reads, U times, L *
// S * 4 bytes of gids and the [L, G, J, B] partials.
namespace {

template <bool SHARED_BOUNDS, bool SHARED>
__global__ void __launch_bounds__(row_tiles::THREADS) hist_lanes_kernel(
    const HistArgs a0, const lanes::Table t, const int32_t* start, const int32_t* step,
    const int32_t* window, int ldw, const float* qs) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int lane_s[lanes::MAX_LANES];
    __shared__ int nl_s;
    __shared__ int last_s;
    const int u = blockIdx.y;
    HistArgs a = a0;  // window u's grid
    a.start = __ldg(start + u);
    a.step = __ldg(step + u);
    a.window = __ldg(window + u);
    if (SHARED_BOUNDS) {
        const int64_t wo = (int64_t)u * ldw;
        a.lo += wo;
        a.hi += wo;
        a.t_first += wo;
        a.t_last += wo;
    }
    lanes::collect(t, u, lane_s, &nl_s);
    __syncthreads();
    const int nl = nl_s;
    const int B = a.B;
    const int width = a.J * B;
    if (SHARED) {
        lanes::init(smem, nl, t.G, width, group_acc::ACC_ADD);
        __syncthreads();
    }
    const float w_s = (float)a.window * 1e-3f;
    const bool win_sum =
        a.func == H_SUM_OVER_TIME || (a.is_delta && (a.func == H_RATE || a.func == H_INCREASE));
    const bool extrap = !win_sum && a.func != H_LAST;
    const int R = a.R;
    row_tiles::for_each_tile<false>(a.S, R, [](int, int) {}, [&](int tile, int) {
        const int64_t s0 = (int64_t)tile * R;
        row_tiles::for_each_pair(min(R, a.S - (int)s0), width, [&](int r, int c) {
            const int64_t s = s0 + r;
            if (s >= a.S || !lanes::wants(t, lane_s, nl, s)) return;
            const int j = c / B, b = c - j * B;
            const int32_t t_j = wrap_add(a.start, wrap_mul(j, a.step));
            int lo, hi;
            float f = 0.0f;
            if (SHARED_BOUNDS) {
                lo = __ldg(a.lo + j);
                hi = __ldg(a.hi + j);
                if (extrap && hi - lo >= 2)
                    f = extrap_factor(hi - lo, __ldg(a.t_first + j), __ldg(a.t_last + j), t_j,
                                      a.window);
            } else {
                const int32_t* rt = a.ts + s * a.T;
                const int n = min(max(__ldg(a.lens + s), 0), a.T);
                hi = count_le<true>(rt, n, t_j);
                const int32_t t_lo = wrap_add(t_j, -a.window);
                lo = lower_edge(rt, hi, t_lo);
                if (extrap && hi - lo >= 2)
                    f = extrap_factor(hi - lo, __ldg(rt + lo), __ldg(rt + hi - 1), t_j, a.window);
            }
            float v[1];
            window_values<1>(a, a.vals + s * a.T * B + b, lo, hi, f, win_sum, w_s, v);
            if (!isnan(v[0])) lanes::add<SHARED>(t, lane_s, nl, smem, width, s, c, v[0]);
        });
    });
    if (SHARED) {
        __syncthreads();
        lanes::flush(t, lane_s, nl, smem, width, 0);
    }
    if (!a.quantile) return;
    __threadfence();  // this block's partials are visible before it arrives
    __syncthreads();
    if (threadIdx.x == 0) last_s = atomicAdd(a.arrivals + u, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    for (int k = 0; k < nl; ++k) {
        const int l = lane_s[k];
        const float q = __ldg(qs + l);
        const float* acc = a.acc + l * t.lane_words;
        const float* cnt = a.cnt + l * t.lane_words;
        float* out = a.out + (int64_t)l * t.G * a.ld_out;
        for (int i = threadIdx.x; i < t.G * a.J; i += blockDim.x) {
            const int g = i / a.J, j = i - g * a.J;
            const int64_t o = (int64_t)g * a.ld + (int64_t)j * B;
            out[(int64_t)g * a.ld_out + j] = quantile_at(acc + o, cnt + o, a.les, B, q);
        }
    }
    if (threadIdx.x == 0) a.arrivals[u] = 0;  // ready for the next launch
}

template <bool SB, bool SH>
cudaError_t launch_lanes(const HistArgs& a, const lanes::Table& t, const int32_t* const* win,
                         int ldw, const float* qs, int U, int smem, cudaStream_t stream) {
    auto kern = hist_lanes_kernel<SB, SH>;
    int resident = 0;  // also raises the kernel's shared-memory allowance to smem
    const cudaError_t err =
        row_tiles::persistent_grid(kern, smem, 1 << 30, &resident, row_tiles::THREADS);
    if (err != cudaSuccess) return err;
    const int tiles = (a.S + a.R - 1) / a.R;
    const int grid = max(1, min(tiles, resident / U));  // blocks per window
    kern<<<dim3(grid, U), row_tiles::THREADS, smem, stream>>>(a, t, win[0], win[1], win[2], ldw,
                                                              qs);
    return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes: the lane mode of filodb_hist_range_aggregate.
// vals [S, T, B]; with shared_bounds lo, hi, t_first, t_last [U, ldw]
// int32, else ts [S, T] and lens [S]; start, step and window [U] int32;
// gids [L, S] int32 and u_of_lane [L] int32 (L <= lanes::MAX_LANES); acc
// and cnt [L, G+1, ld] zeros, ld >= J * B; `rows` rows per tile (a
// persistent grid per window). `shared` keeps every lane's [G, J * B] partials in
// shared memory, sized by the wrapper for `lanes_max` lanes of one window
// (`smem_bytes`, checked here). With `quantile`: bounds les [B], qs [L]
// f32, out [L, G, ld_out] written at steps [0, J), and `arrivals` [U]
// zeroed counters, left at zero. Launches on `stream` and returns a
// cudaError_t (0 on success); it does not synchronise.
extern "C" int filodb_hist_range_lanes(
    const void* ts, const void* vals, const void* lens, const void* lo, const void* hi,
    const void* t_first, const void* t_last, int ldw, const void* start, const void* step,
    const void* window, int S, int T, int B, int J, int ld, int U, const void* gids,
    const void* u_of_lane, int L, int G, int func, int is_delta, int shared_bounds, int rows,
    int shared, int lanes_max, int smem_bytes, void* acc, void* cnt, int quantile,
    const void* qs, const void* les, void* out, int ld_out, void* arrivals, void* stream) {
    if (S <= 0 || J <= 0 || G <= 0 || B <= 0 || U <= 0 || L <= 0) return 0;
    const bool bounds_ok = shared_bounds ? (lo && hi && t_first && t_last && ldw >= J)
                                         : (ts && lens);
    const bool quantile_ok = !quantile || (qs && les && out && arrivals && ld_out >= J);
    const int64_t part = shared ? (((int64_t)2 * lanes_max * G * J * B + 3) & ~3) * 4 : 0;
    if (func < H_RATE || func > H_LAST || rows < 1 || U > 65535 || ld < J * B ||
        L > lanes::MAX_LANES || lanes_max < 1 || lanes_max > L || smem_bytes < part ||
        !bounds_ok || !quantile_ok || !start || !step || !window || !gids || !u_of_lane)
        return (int)cudaErrorInvalidValue;
    HistArgs a{(const int32_t*)ts, (const float*)vals, (const int32_t*)lens, nullptr,
               (const int32_t*)lo, (const int32_t*)hi, (const int32_t*)t_first,
               (const int32_t*)t_last, (const float*)les, S, T, B, J, ld, G, 0, 0, 0, func,
               is_delta, rows, J, quantile, 0.0f, ld_out, (float*)out, (unsigned int*)arrivals,
               (float*)acc, (float*)cnt, nullptr, 0, nullptr};
    const lanes::Table t{(const int32_t*)gids, (const int32_t*)u_of_lane, L, S, G,
                         (int64_t)(G + 1) * ld, ld, group_acc::ACC_ADD, (float*)acc,
                         (float*)cnt};
    const int32_t* win[3] = {(const int32_t*)start, (const int32_t*)step, (const int32_t*)window};
    const float* q = (const float*)qs;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (shared_bounds)
        err = shared ? launch_lanes<true, true>(a, t, win, ldw, q, U, smem_bytes, st)
                     : launch_lanes<true, false>(a, t, win, ldw, q, U, smem_bytes, st);
    else
        err = shared ? launch_lanes<false, true>(a, t, win, ldw, q, U, smem_bytes, st)
                     : launch_lanes<false, false>(a, t, win, ldw, q, U, smem_bytes, st);
    return (int)err;
}
