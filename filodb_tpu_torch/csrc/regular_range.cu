// Regular-grid range function fused with the group aggregate, on Hopper
// (sm_90a).
//
// Replaces two XLA programs of the JAX package that
// filodb_tpu/ops/aggregations.py:_fused_mxu_jit runs as one: B2
// mxu_range_kernel (filodb_tpu/ops/mxu_kernels.py:250) and B3
// _segment_aggregate_jit (filodb_tpu/ops/aggregations.py:49). Every real row
// of the block shares one timestamp vector, so the window of step j is the
// same index range [lo[j], hi[j]) in every row. For each (row s, step j) the
// kernel computes the range function and reduces it straight into the
// [G+1, J] group accumulators acc (sum, min or max) and cnt (valid
// members); no [S, J] grid is written. The [G, J] finish (has = cnt > 0,
// the avg division, NaN for empty groups) is a few torch ops in the wrapper.
//
// Design. The TPU gathers with one-hot matmuls (vals @ F, vals @ L) and
// sums windows with vals @ W. Here a load at lo[j], hi[j]-1 or hi[j]-2 is
// the gather, and a loop over [lo[j], hi[j]) is the window sum, taken in
// index order. One thread per (row, step): the threads of a block take 128
// neighbouring steps, and each walks ROWS rows of a tile at its step,
// keeping a running partial of its group. It flushes the partial with
// atomicAdd (sum, count) or an ordered-int atomic (min, max) when the group
// changes and at the end of the tile, so sum(...) (one group) flushes once
// per tile. Rows of the trash group G (padding) are skipped outright, as
// are group ids outside [0, G) (jax.ops.segment_sum drops them too).
//
// Bound. Device-memory bytes: the sectors of vals (and of raw, for the
// counter zero-crossing cap) that the function reads, gids, and the
// outputs; a few dozen flops per (row, step). Neighbouring steps read
// neighbouring samples of one row, so a warp's loads share sectors in
// L1/L2. wgmma, TMA and a shared-memory row tile are later work.
//
// Semantics kept line by line from mxu_range_kernel: f32 Prometheus
// extrapolation of rate/increase/delta with the zero-crossing cap read from
// raw[lo]; irate/idelta from hi-1 and hi-2 (idelta on diff-staged counters
// is vals[hi-1]); stddev/stdvar/z_score by s2/c - mean^2; count and
// present give values on every row. A NaN result means absence and is
// skipped by the aggregate. The build passes -fmad=false so that each f32
// multiply and add rounds separately, as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// range functions (ops/mxu_kernels.py FUNC_CODES)
enum Func {
    SUM_OVER_TIME = 0, COUNT_OVER_TIME, AVG_OVER_TIME, LAST, FIRST_OVER_TIME,
    PRESENT_OVER_TIME, STDDEV_OVER_TIME, STDVAR_OVER_TIME, Z_SCORE, RATE,
    INCREASE, DELTA, IRATE, IDELTA,
};
// group accumulators (ops/mxu_kernels.py ACC_CODES)
enum Acc { ACC_ADD = 0, ACC_MIN, ACC_MAX };

constexpr int THREADS = 128;  // steps per block
constexpr int ROWS = 64;      // rows a thread walks at its step

__device__ __forceinline__ float nan_min(float a, float b) {  // as jnp.minimum
    return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// float min/max through integer atomics: a float with its sign bit clear
// orders as a signed int, one with it set orders reversed as an unsigned int
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
    if (__float_as_int(v) >= 0) atomicMin((int*)addr, __float_as_int(v));
    else atomicMax((unsigned int*)addr, __float_as_uint(v));
}
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
    if (__float_as_int(v) >= 0) atomicMax((int*)addr, __float_as_int(v));
    else atomicMin((unsigned int*)addr, __float_as_uint(v));
}

__global__ void __launch_bounds__(THREADS) regular_range_kernel(
    const float* __restrict__ vals, const float* __restrict__ raw,
    const int64_t* __restrict__ gids, const int32_t* __restrict__ lo_a,
    const int32_t* __restrict__ hi_a, const int32_t* __restrict__ idx_a,
    const float* __restrict__ count_a,
    const float* __restrict__ tf_a, const float* __restrict__ tl_a,
    const float* __restrict__ tl2_a, const float* __restrict__ out_t_a,
    int S, int T, int J, int G, float window_ms, int func, int acc_op,
    int is_counter, int is_delta, float* __restrict__ acc, float* __restrict__ cnt) {
    const int j = blockIdx.y * THREADS + threadIdx.x;
    if (j >= J) return;
    const int s0 = blockIdx.x * ROWS;
    const int s1 = min(S, s0 + ROWS);
    const float NaN = __int_as_float(0x7fc00000);
    const float INF = __int_as_float(0x7f800000);

    const int lo = __ldg(lo_a + j), hi = __ldg(hi_a + j);
    const float count = __ldg(count_a + j);
    const bool has = count > 0.0f;
    const bool has2 = count >= 2.0f;
    // first / last / second-to-last positions, clipped to the row
    const int iF = __ldg(idx_a + j), iL = __ldg(idx_a + J + j), iL2 = __ldg(idx_a + 2 * J + j);
    const float w_s = window_ms * 1e-3f;

    // functions whose value is a window sum of vals (mxu: vals @ W)
    const bool win_sum = func == SUM_OVER_TIME || func == AVG_OVER_TIME ||
                         (is_delta && (func == RATE || func == INCREASE));
    const bool moments = func == STDDEV_OVER_TIME || func == STDVAR_OVER_TIME ||
                         func == Z_SCORE;
    const bool extrap = !win_sum && (func == RATE || func == INCREASE || func == DELTA);
    const bool zero_cap = extrap && is_counter && func != DELTA;
    const bool diff_idelta = func == IDELTA && is_counter && !is_delta;

    // per-step terms of the extrapolation (mxu_kernels.py:324-333, :343)
    float sampled = 0.0f, dur_start = 0.0f, avg_dur = 0.0f, thresh = 0.0f,
          de = 0.0f, denom = 1.0f, dt_s = 1.0f;
    if (extrap) {
        const float tf = __ldg(tf_a + j) * 1e-3f;
        const float tl = __ldg(tl_a + j) * 1e-3f;
        const float out_t = __ldg(out_t_a + j);
        sampled = tl - tf;
        const float range_start = (out_t - window_ms) * 1e-3f;
        const float range_end = out_t * 1e-3f;
        dur_start = tf - range_start;
        const float dur_end = range_end - tl;
        avg_dur = sampled / fmaxf(count - 1.0f, 1.0f);
        thresh = avg_dur * 1.1f;
        de = dur_end >= thresh ? avg_dur / 2.0f : dur_end;
        denom = fmaxf(sampled, 1e-30f);
    } else if (func == IRATE || func == IDELTA) {
        dt_s = (__ldg(tl_a + j) - __ldg(tl2_a + j)) * 1e-3f;
    }

    const float init = acc_op == ACC_MIN ? INF : (acc_op == ACC_MAX ? -INF : 0.0f);
    float part = init, part_n = 0.0f;
    int64_t g_cur = -1;
    for (int s = s0; s < s1; ++s) {
        const int64_t g = __ldg((const long long*)gids + s);
        if (g < 0 || g >= (int64_t)G) continue;  // trash group G (padding) or no group
        if (g != g_cur) {
            if (g_cur >= 0 && part_n > 0.0f) {
                float* a = acc + g_cur * J + j;
                atomicAdd(cnt + g_cur * J + j, part_n);
                if (acc_op == ACC_ADD) atomicAdd(a, part);
                else if (acc_op == ACC_MIN) atomic_min_f32(a, part);
                else atomic_max_f32(a, part);
            }
            g_cur = g;
            part = init;
            part_n = 0.0f;
        }
        const float* row = vals + (int64_t)s * T;
        float r = NaN;
        if (func == COUNT_OVER_TIME) {
            r = has ? count : NaN;
        } else if (func == PRESENT_OVER_TIME) {
            r = has ? 1.0f : NaN;
        } else if (win_sum || moments) {
            if (has) {
                float sm = 0.0f, sm2 = 0.0f;
                for (int k = lo; k < hi; ++k) {
                    const float v = __ldg(row + k);
                    sm += v;
                    if (moments) sm2 += v * v;
                }
                if (func == SUM_OVER_TIME || func == INCREASE) {
                    r = sm;
                } else if (func == RATE) {
                    r = sm / w_s;
                } else if (func == AVG_OVER_TIME) {
                    r = sm / fmaxf(count, 1.0f);
                } else {
                    const float c = fmaxf(count, 1.0f);
                    const float mean = sm / c;
                    const float var = fmaxf(sm2 / c - mean * mean, 0.0f);
                    const float sd = sqrtf(var);
                    if (func == STDVAR_OVER_TIME) r = var;
                    else if (func == STDDEV_OVER_TIME) r = sd;
                    else r = (__ldg(row + iL) - mean) / fmaxf(sd, 1e-30f);
                }
            }
        } else if (func == LAST) {
            r = has ? __ldg(row + iL) : NaN;
        } else if (func == FIRST_OVER_TIME) {
            r = has ? __ldg(row + iF) : NaN;
        } else if (extrap) {
            if (has2) {
                const float vf = __ldg(row + iF);
                const float dlt = __ldg(row + iL) - vf;
                float ds = dur_start;
                if (zero_cap) {
                    const float vfr = __ldg(raw + (int64_t)s * T + iF);
                    const float dur_zero = dlt > 0.0f ? sampled * (vfr / fmaxf(dlt, 1e-30f)) : INF;
                    ds = nan_min(dur_start, vfr >= 0.0f ? dur_zero : INF);
                }
                ds = ds >= thresh ? avg_dur / 2.0f : ds;
                const float factor = (sampled + ds + de) / denom;
                r = dlt * factor;
                if (func == RATE) r = r / w_s;
            }
        } else if (diff_idelta) {
            r = has2 ? __ldg(row + iL) : NaN;
        } else if (func == IRATE || func == IDELTA) {
            if (has2) {
                const float dv = __ldg(row + iL) - __ldg(row + iL2);
                r = func == IRATE ? dv / fmaxf(dt_s, 1e-30f) : dv;
            }
        }
        if (!isnan(r)) {
            part_n += 1.0f;
            if (acc_op == ACC_ADD) part += r;
            else if (acc_op == ACC_MIN) part = fminf(part, r);
            else part = fmaxf(part, r);
        }
    }
    if (g_cur >= 0 && part_n > 0.0f) {
        float* a = acc + g_cur * J + j;
        atomicAdd(cnt + g_cur * J + j, part_n);
        if (acc_op == ACC_ADD) atomicAdd(a, part);
        else if (acc_op == ACC_MIN) atomic_min_f32(a, part);
        else atomic_max_f32(a, part);
    }
}

}  // namespace

// Plain C entry for ctypes. acc [G+1, J] must hold the accumulator's
// identity (0, +inf or -inf) and cnt [G+1, J] zeros. Launches on `stream`
// and returns the launch's cudaGetLastError() (0 on success); it does not
// synchronise.
extern "C" int filodb_regular_range(
    const void* vals, const void* raw, const void* gids, const void* lo,
    const void* hi, const void* idx, const void* count, const void* t_first, const void* t_last,
    const void* t_last2, const void* out_t, int S, int T, int J, int G,
    float window_ms, int func, int acc_op, int is_counter, int is_delta,
    void* acc, void* cnt, void* stream) {
    if (S <= 0 || J <= 0) return 0;
    dim3 grid((unsigned int)((S + ROWS - 1) / ROWS), (unsigned int)((J + THREADS - 1) / THREADS));
    regular_range_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)vals, (const float*)raw, (const int64_t*)gids,
        (const int32_t*)lo, (const int32_t*)hi, (const int32_t*)idx, (const float*)count,
        (const float*)t_first, (const float*)t_last, (const float*)t_last2,
        (const float*)out_t, S, T, J, G, window_ms, func, acc_op, is_counter,
        is_delta, (float*)acc, (float*)cnt);
    return (int)cudaGetLastError();
}
