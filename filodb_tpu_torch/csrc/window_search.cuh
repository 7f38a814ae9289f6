// Window bounds in a sorted timestamp row, shared by the port's kernels
// that search per series (window_stats.cu, hist_range.cu), on Hopper
// (sm_90a).
//
// A staged row holds strictly increasing int32 ms offsets in [0, lens[s])
// and INT32_MAX past it. The window of step j is (t_j - w, t_j]; its
// samples are [lo, hi) with hi = count_le(row, n, t_j) and
// lo = lower_edge(row, hi, t_j - w). Time math wraps in int32, as
// jnp.int32 does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace window_search {

// int32 add/multiply with two's-complement wrap (as jnp.int32 does)
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
}

// number of entries in row[0, n) that are <= x (row sorted ascending);
// the row lies in shared or device memory. LDG: a row in device memory,
// read through the read-only data cache
template <bool LDG = false>
__device__ __forceinline__ int count_le(const int32_t* row, int n, int32_t x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((LDG ? __ldg(row + mid) : row[mid]) <= x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// lo of the window: the entries of row[0, hi) that are <= t_lo (all of
// them when the bounds wrapped, t_lo > t_j: an empty window). They form a
// prefix that usually ends within a window's worth of samples below hi,
// so gallop down from hi in strides of 32, 64, ... and bisect the last
// stride: a handful of probes instead of a search over the whole row.
__device__ __forceinline__ int lower_edge(const int32_t* row, int hi, int32_t t_lo) {
    int top = hi, stride = 32, bot = hi - stride;
    while (bot > 0 && row[bot] > t_lo) {  // every entry from bot up is > t_lo
        top = bot;
        stride <<= 1;
        bot = hi - stride;
    }
    bot = bot < 0 ? 0 : bot;
    return bot + count_le(row + bot, top - bot, t_lo);
}

}  // namespace window_search
