// The sorted-window range functions on Hopper (sm_90a).
//
// sorted_window_kernel (entry filodb_sorted_window) replaces the XLA
// program filodb_tpu/ops/kernels.py:333 sorted_window_kernel (B8):
// quantile_over_time(q), median_absolute_deviation_over_time and
// last_over_time_is_mad_outlier(tolerance, bounds) of every (row s, step
// j < J) over the window (t_j - w, t_j] = samples [lo, hi) of the row, into
// the [S, ld] grid out (row-major; the caller fills it with NaN first, so
// rows past n_rows and steps past J stay NaN). The JAX program sorts each
// masked [T] row per step (out-of-window slots +inf) in blocks of 16 steps;
// here each window's order statistics are selected on their own.
//
// Design. A grid of blocks of WARPS warps; each warp takes one row at a
// time (rows s = its global warp index, + all warps, ...):
// 1. Staging (STAGED, a block no wider than the plan's limit): the lanes
//    copy the row's timestamps and its values as order-preserving 32-bit
//    keys into the warp's shared buffer; every later read of the row is a
//    shared-memory read. (Wider rows are read in place.)
// 2. Steps in rounds of 32, lane l on step j0 + l: the lane searches its
//    window's bounds in the staged row (window_search.cuh).
// 3. Lane route, n = hi - lo <= LANE_CAP: the lane selects the two order
//    statistics an interpolation reads by counting -- key k_i has rank r
//    when #{k < k_i} <= r < #{k <= k_i} over the window -- n^2 compares,
//    with no barrier and no scratch; MAD counts a second time over the keys
//    of |v - median|.
// 4. Warp route, n > LANE_CAP (a ballot collects the round's long windows,
//    which the warp then takes one at a time): a radix select over the
//    staged keys, exact for any length -- four passes of an 8-bit
//    histogram of the keys matching the digits chosen so far
//    (shared-memory atomics into the warp's 256 bins), each pass picking
//    the digit whose bin holds the wanted rank.
// Keys: -0 becomes +0 and every NaN one canonical NaN, as jnp.sort
// canonicalises its comparison keys (it keeps each zero's sign in its
// output, which no interpolation can tell apart: a zero result rounds to
// +0); the key of a float is its bits with the sign bit set (positive) or
// all bits flipped (negative), so NaN sorts above +inf.
//
// Bound. Bytes: each real row's samples (ts and vals) read once and the
// [rows, J] output written once. Operations: ordering a window of n samples
// takes at least n log2 n comparisons; summed over the windows of the
// launch, at the card's 32-bit rate. The lane route does n^2 compares a
// window, so at 5 m windows of ~30 samples it is bound by its
// instructions, not by memory.
//
// Semantics kept from sorted_window_kernel: NaN samples sort last among the
// window's n values and the +inf padding of the T - n other slots of the
// row sorts between the finite values and NaN, so a rank r past the n -
// nnan non-NaN values reads +inf while r - (n - nnan) < T - n, else NaN;
// the interpolation v_lo + (v_hi - v_lo) * frac at rank q * (n - 1)
// (q clipped to [0, 1]; 0.5 for the median), rounded as separate f32
// operations (the build passes -fmad=false); the outlier's last value is
// the sum of the values at the window's last timestamp; an empty window is
// NaN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_acc.cuh"
#include "row_tiles.cuh"
#include "window_search.cuh"

namespace {

using window_search::count_le;
using window_search::lower_edge;
using window_search::wrap_add;
using window_search::wrap_mul;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;                   // warps per block (ops/sorted_window.WARPS)
constexpr int LANE_CAP = 64;               // windows a lane orders alone (ops/sorted_window.LANE_CAP)
constexpr int BINS = 256;                  // the warp route's histogram, in the warp's buffer
constexpr uint32_t NAN_KEY = 0xffc00000u;  // key of the canonical NaN

// functions (ops/sorted_window.SORTED_FUNC_CODES)
enum SFunc { S_QUANTILE = 0, S_MAD, S_MAD_OUTLIER };

struct SortArgs {
    const int32_t* ts;
    const float* vals;
    const int32_t* lens;
    int n_rows, T, J, ld;
    int32_t start, step, window;
    int func;
    float q;     // quantile_over_time's q, the outlier's tolerance
    float arg1;  // the outlier's bounds mode
    int words;   // 32-bit words of a warp's buffer: [T] ts, [T] keys (staged), [BINS] bins
    float* out;
};

__device__ __forceinline__ uint32_t key_of(float x) {
    const float c = isnan(x) ? __uint_as_float(0x7fc00000u) : (x == 0.0f ? 0.0f : x);
    const uint32_t u = __float_as_uint(c);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the value jnp.sort leaves at rank r of a window of n samples (nnan of
// them NaN) in a row padded with T - n slots of +inf
__device__ __forceinline__ float ranked(uint32_t key, int r, int n, int nnan, int pad) {
    if (key < NAN_KEY) return value_of(key);
    return r - (n - nnan) < pad ? group_acc::inf_f() : group_acc::nan_f();
}

// the interpolation at a fractional rank between the order statistics at
// floor(rank) and ceil(rank), as sorted_window_kernel's interp_at:
// at(r0, r1, v0, v1) reads both (r1 == r0 where the rank is whole)
template <typename F>
__device__ __forceinline__ float interp(F at, float rank) {
    const int lo = (int)floorf(rank), hi = (int)ceilf(rank);
    const float frac = rank - (float)lo;
    float v_lo, v_hi;
    at(lo, hi, v_lo, v_hi);
    return v_lo + (v_hi - v_lo) * frac;
}

// count of lanes' flags over a warp-uniform loop of n items: f(i) per item
template <typename F>
__device__ __forceinline__ int warp_count(int n, F f) {
    const int lane = threadIdx.x & 31;
    int c = 0;
    for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        c += __popc(__ballot_sync(FULL, i < n && f(i)));
    }
    return c;
}

// The key of rank r (0-based, ascending) among key(i), i < n, by a radix
// select of four 8-bit digits, the warp's 256-bin histogram in `hist`.
template <typename K>
__device__ __forceinline__ uint32_t radix_select(K key, int n, int r, uint32_t* hist) {
    const int lane = threadIdx.x & 31;
    uint32_t prefix = 0, mask = 0;
    uint32_t want = (uint32_t)r;
    for (int shift = 24; shift >= 0; shift -= 8) {
        for (int b = lane; b < BINS; b += 32) hist[b] = 0;
        __syncwarp();
        for (int i = lane; i < n; i += 32) {
            const uint32_t u = key(i);
            if ((u & mask) == prefix) atomicAdd(hist + ((u >> shift) & 0xffu), 1u);
        }
        __syncwarp();
        uint32_t c[8], sum = 0;  // the lane's bins 8 lane .. 8 lane + 7
#pragma unroll
        for (int t = 0; t < 8; ++t) {
            c[t] = hist[lane * 8 + t];
            sum += c[t];
        }
        uint32_t incl = sum;  // inclusive warp scan of the lanes' sums
        for (int o = 1; o < 32; o <<= 1) {
            const uint32_t y = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += y;
        }
        const uint32_t excl = incl - sum;
        const bool mine = want >= excl && want < incl;
        const int owner = __ffs(__ballot_sync(FULL, mine)) - 1;
        int bin = -1;  // the owner's bin holding rank `want`, and the keys below it
        uint32_t below = excl;
        if (mine) {
#pragma unroll
            for (int t = 0; t < 8; ++t) {
                if (bin >= 0) continue;
                if (want < below + c[t]) bin = lane * 8 + t;
                else below += c[t];
            }
        }
        bin = __shfl_sync(FULL, bin, owner);
        below = __shfl_sync(FULL, below, owner);
        want -= below;
        prefix |= (uint32_t)bin << shift;
        mask |= 0xffu << shift;
        __syncwarp();  // every lane has read the bins before the next pass clears them
    }
    return prefix;
}

// The function's value from its window's order statistics: `order(rank,
// dev, med)` interpolates at `rank` among the window's values (dev: their
// absolute deviations from med); `last()` is the outlier's last value.
template <typename O, typename L>
__device__ __forceinline__ float finish(const SortArgs& a, int n, O order, L last) {
    const float cnt = (float)n;
    if (a.func == S_QUANTILE)
        return order(fminf(fmaxf(a.q, 0.0f), 1.0f) * fmaxf(cnt - 1.0f, 0.0f), false, 0.0f);
    const float med_rank = 0.5f * fmaxf(cnt - 1.0f, 0.0f);
    const float med = order(med_rank, false, 0.0f);
    const float mad = order(med_rank, true, med);
    if (a.func == S_MAD) return mad;
    const float lastv = last();
    const float lower = med - a.q * mad;
    const float upper = med + a.q * mad;
    const bool out = (lastv < lower && a.arg1 <= 1.0f) || (lastv > upper && a.arg1 >= 1.0f);
    return out ? lastv : group_acc::nan_f();
}

template <bool STAGED>
__global__ void __launch_bounds__(WARPS * 32) sorted_window_kernel(const SortArgs a) {
    extern __shared__ __align__(16) uint32_t smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    uint32_t* wbuf = smem + (int64_t)warp * a.words;
    int32_t* ts_s = reinterpret_cast<int32_t*>(wbuf);  // staged: [T] ts, [T] keys
    uint32_t* key_s = wbuf + a.T;
    uint32_t* hist = wbuf + (STAGED ? 2 * a.T : 0);
    const int64_t stride = (int64_t)gridDim.x * WARPS;
    for (int64_t s = (int64_t)blockIdx.x * WARPS + warp; s < a.n_rows; s += stride) {
        const int32_t* rt_g = a.ts + s * a.T;
        const float* rv_g = a.vals + s * a.T;
        const int n_row = min(max(__ldg(a.lens + s), 0), a.T);
        if (STAGED) {
            for (int k = lane; k < n_row; k += 32) {
                ts_s[k] = __ldg(rt_g + k);
                key_s[k] = key_of(__ldg(rv_g + k));
            }
            __syncwarp();
        }
        const int32_t* rt = STAGED ? ts_s : rt_g;
        auto key = [&](int k) { return STAGED ? key_s[k] : key_of(__ldg(rv_g + k)); };
        // the outlier's last value of the window [lo, hi): ties at its last timestamp summed
        auto last_of = [&](int lo, int hi) {
            const int32_t t_max = rt[hi - 1];
            int k = hi - 1;
            while (k > lo && rt[k - 1] == t_max) --k;
            float sm = 0.0f;
            for (; k < hi; ++k) sm += value_of(key(k));
            return sm;
        };
        for (int j0 = 0; j0 < a.J; j0 += 32) {
            const int j = j0 + lane;
            int lo = 0, hi = 0;
            if (j < a.J) {
                const int32_t t_j = wrap_add(a.start, wrap_mul(j, a.step));
                hi = count_le<!STAGED>(rt, n_row, t_j);
                lo = lower_edge(rt, hi, wrap_add(t_j, -a.window));
            }
            const int n = hi - lo;
            float res = group_acc::nan_f();
            if (n > 0 && n <= LANE_CAP) {  // lane route: order statistics by counting
                const int pad = a.T - n;
                res = finish(a, n, [&](float rank, bool dev, float med) {
                    auto kf = [&](int k) {
                        return dev ? key_of(fabsf(value_of(key(k)) - med)) : key(k);
                    };
                    return interp([&](int r0, int r1, float& v0, float& v1) {
                        uint32_t k0 = 0, k1 = 0;
                        int nnan = 0;
                        for (int i = lo; i < hi; ++i) {
                            const uint32_t ki = kf(i);
                            int below = 0, upto = 0;
                            for (int k = lo; k < hi; ++k) {
                                const uint32_t kk = kf(k);
                                below += kk < ki;
                                upto += kk <= ki;
                            }
                            if (below <= r0 && r0 < upto) k0 = ki;
                            if (below <= r1 && r1 < upto) k1 = ki;
                            nnan += ki >= NAN_KEY;
                        }
                        v0 = ranked(k0, r0, n, nnan, pad);
                        v1 = r1 == r0 ? v0 : ranked(k1, r1, n, nnan, pad);
                    }, rank);
                }, [&] { return last_of(lo, hi); });
            }
            // warp route: the round's longer windows one at a time, every lane on each
            unsigned long_windows = __ballot_sync(FULL, n > LANE_CAP);
            while (long_windows) {
                const int b = __ffs(long_windows) - 1;
                long_windows &= long_windows - 1;
                const int lo_b = __shfl_sync(FULL, lo, b), hi_b = __shfl_sync(FULL, hi, b);
                const int n_b = hi_b - lo_b, pad = a.T - n_b;
                const float r = finish(a, n_b, [&](float rank, bool dev, float med) {
                    auto kf = [&](int i) {
                        const uint32_t k = key(lo_b + i);
                        return dev ? key_of(fabsf(value_of(k) - med)) : k;
                    };
                    const int nnan = warp_count(n_b, [&](int i) { return kf(i) >= NAN_KEY; });
                    return interp([&](int r0, int r1, float& v0, float& v1) {
                        v0 = ranked(radix_select(kf, n_b, r0, hist), r0, n_b, nnan, pad);
                        v1 = r1 == r0 ? v0
                                      : ranked(radix_select(kf, n_b, r1, hist), r1, n_b, nnan, pad);
                    }, rank);
                }, [&] { return last_of(lo_b, hi_b); });
                if (lane == b) res = r;
            }
            if (j < a.J) a.out[s * a.ld + j] = res;
        }
        __syncwarp();  // every lane is done with the row before the next one is staged
    }
}

template <bool STAGED>
int launch(const SortArgs& a, int smem, cudaStream_t stream) {
    auto kern = sorted_window_kernel<STAGED>;
    int resident = 0;  // also raises the kernel's shared-memory allowance to smem
    const cudaError_t err =
        row_tiles::persistent_grid(kern, smem, 1 << 30, &resident, WARPS * 32);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = ((int64_t)a.n_rows + WARPS - 1) / WARPS;
    const int grid = (int)(blocks < resident ? blocks : resident);
    kern<<<grid > 0 ? grid : 1, WARPS * 32, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes: func over the windows of rows [0, n_rows) of a
// staged block (ts int32 / vals f32 [>= n_rows, T], lens [>= n_rows]) at
// steps [0, J) into out [>= n_rows, ld] (row-major, ld >= J; nothing else
// is written). The layout comes from the wrapper's plan
// (ops/sorted_window.sorted_plan): `staged` (the row's ts and keys in the
// warp's shared buffer) and `words` 32-bit words of shared memory per warp
// (2 T + 256 staged, else at least 256); `smem_bytes` = WARPS * words * 4,
// checked here. Launches on `stream` and returns a cudaError_t (0 on
// success); it does not synchronise.
extern "C" int filodb_sorted_window(const void* ts, const void* vals, const void* lens,
                                    int n_rows, int T, int J, int ld, int start, int step,
                                    int window, int func, float q, float arg1, int staged,
                                    int words, int smem_bytes, void* out, void* stream) {
    if (n_rows <= 0 || J <= 0) return 0;
    const int64_t need = staged ? 2 * (int64_t)T + BINS : BINS;
    if (func < S_QUANTILE || func > S_MAD_OUTLIER || T <= 0 || ld < J || words < need ||
        (int64_t)smem_bytes != (int64_t)WARPS * words * 4)
        return (int)cudaErrorInvalidValue;
    SortArgs a{(const int32_t*)ts, (const float*)vals, (const int32_t*)lens, n_rows, T, J, ld,
               (int32_t)start, (int32_t)step, (int32_t)window, func, q, arg1, words,
               (float*)out};
    cudaStream_t st = (cudaStream_t)stream;
    return staged ? launch<true>(a, smem_bytes, st) : launch<false>(a, smem_bytes, st);
}
