// Near-regular range functions fused with the group aggregate, on Hopper
// (sm_90a): the jitter and masked rungs.
//
// Replaces the XLA programs of B6 (filodb_tpu/ops/mxu_jitter.py):
// jitter_range_kernel (:236) and jitter_minmax (:428), which
// filodb_tpu/ops/aggregations.py fuses with the segment aggregate in
// _fused_jitter_jit (:335) and _fused_jitter_minmax_jit (:375); and their
// missed-scrape twins jitter_masked_kernel (:478) and jitter_masked_minmax
// (:709), fused in _fused_masked_jit (:355) and _fused_masked_minmax_jit
// (:394). Two compile-time variants:
//
// - JITTER: every series has the same sample count and each sample lies
//   within maxdev of a shared nominal grid (2 * maxdev < the smallest
//   interval). For a window (b, e] the slots with nominal time in
//   (b + maxdev, e - maxdev] are in it for every series: the certain range
//   [clo, chi), shared. At most one slot per edge is uncertain (klo at b,
//   khi at e); it is in the window for series s when its deviation passes
//   the edge: dev > b - R[klo], dev <= e - R[khi]. The deviation is
//   ts[s, t] - nominal[t], exact in int32 and equal to the JAX package's
//   f32 ts_dev, so no deviation plane is staged.
// - MASKED: the same over the slot-aligned MaskedGrid of a grid with missed
//   scrapes (ops/staging.py): per-slot validity, the running valid count
//   cc and forward/backward fills of values and time offsets, all [S, T']
//   f32. A window's count is cc[chi-1] - cc[clo] + valid[clo]; first/last
//   read the fills at the shared indices. Validity, edge membership and the
//   deviations come from the time fills alone (at a valid slot ffd == bfd ==
//   dev with |dev| <= maxdev; at a hole |ffd| > maxdev), the JAX package's
//   lean gather plan, so no validity or deviation plane is read.
//
// Each has an aggregate mode (group_acc.cuh partials, [G+1, ld]) and a
// store mode (STORE: the step-major [J_pad, S] grid of the fused epilogues
// and the reference tree), like the other rungs.
//
// Design. The TPU evaluates the certain range as one [S, T] x [T, J]
// matmul and the <= 5 per-window selections as one-hot matmuls, because a
// gather is slow there. Here a load at an index is the gather: per (row,
// step) pair a thread reads the certain range (the sum family) or scans it
// (min/max), plus at most five single slots. The skeleton is
// regular_range.cu's: persistent blocks over tiles of R rows
// (row_tiles.cuh), the tile's (row, step) pairs flattened over the
// block's threads, rows read in place. The per-step window structure (the
// JAX package's JitterWindowMatrices vectors, 96 bytes a step) is staged
// once per block in shared memory, after the group partials, while it fits
// (the wrapper decides: `stage_steps`).
//
// Semantics kept branch by branch from the JAX kernels, in f32 with each
// window's times relative to its start (the build passes -fmad=false, so
// every multiply and add rounds as in the plain PyTorch version). min/max
// scan the certain range (the JAX package's 16-wide tile hierarchy is
// exact, so the scan equals it) with the sentinel 3e38. A NaN result is
// absence and is skipped by the aggregate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_acc.cuh"
#include "jitter_steps.cuh"
#include "row_tiles.cuh"

namespace {

using group_acc::nan_min;
using row_tiles::THREADS;

// range functions (ops/mxu_kernels.py FUNC_CODES, the regular kernel's)
enum Func {
    SUM_OVER_TIME = 0, COUNT_OVER_TIME, AVG_OVER_TIME, LAST, FIRST_OVER_TIME,
    PRESENT_OVER_TIME, STDDEV_OVER_TIME, STDVAR_OVER_TIME, Z_SCORE, RATE,
    INCREASE, DELTA, IRATE, IDELTA, MIN_OVER_TIME = 16, MAX_OVER_TIME = 17,
    ABSENT_OVER_TIME = 20,
};

constexpr float SENTINEL = 3e38f;

using jitter_steps::StepRow;

struct JitterArgs {
    const float* vals;   // JITTER: the block's vals; MASKED: the sidecar's
    const int32_t* ts;   // JITTER: the block's ts
    const float* raw;    // JITTER: raw (counters), else vals
    const float* cc;     // MASKED planes
    const float* ffv;
    const float* ffd;
    const float* bfv;
    const float* bfd;
    const float* ff2v;
    const float* ff2d;
    const float* bfraw;  // bfv for non-counters
    const long long* gids;
    const StepRow* steps;  // [J]
    int S, T, J, ld, G;
    float window_ms, maxdev;
    int func, acc_op, is_counter, is_delta;
    int R, stage_steps;
    float* acc;
    float* cnt;
};

__device__ __forceinline__ float w3(bool m1, float a, bool m2, float b, float c) {
    return m1 ? a : (m2 ? b : c);
}

__device__ __forceinline__ bool is_win_sum(const JitterArgs& a) {
    return a.func == SUM_OVER_TIME || (a.is_delta && (a.func == RATE || a.func == INCREASE));
}

// rate/increase/delta from the window's first/last values and times
// (relative to the window's start, ms) and its count
__device__ __forceinline__ float extrapolate(const JitterArgs& a, float cnt, float v_first,
                                             float v_last, float tf_rel, float tl_rel,
                                             float v_first_raw) {
    const float INF = group_acc::inf_f();
    const float dlt = v_last - v_first;
    const float sampled = (tl_rel - tf_rel) * 1e-3f;
    const float dur_start = tf_rel * 1e-3f;
    const float dur_end = (a.window_ms - tl_rel) * 1e-3f;
    const float avg_dur = sampled / fmaxf(cnt - 1.0f, 1.0f);
    const float thresh = avg_dur * 1.1f;
    float ds = dur_start;
    if (a.is_counter && a.func != DELTA) {
        const float dur_zero = dlt > 0.0f ? sampled * (v_first_raw / fmaxf(dlt, 1e-30f)) : INF;
        ds = nan_min(dur_start, v_first_raw >= 0.0f ? dur_zero : INF);
    }
    ds = ds >= thresh ? avg_dur / 2.0f : ds;
    const float de = dur_end >= thresh ? avg_dur / 2.0f : dur_end;
    const float factor = (sampled + ds + de) / fmaxf(sampled, 1e-30f);
    const float r = dlt * factor;
    if (!(cnt >= 2.0f)) return group_acc::nan_f();
    return a.func == RATE ? r / (a.window_ms * 1e-3f) : r;
}

// the sum family and the moments over [clo, chi) plus the edge values:
// s = sum + lo + hi (and s2 of the squares), as the JAX matmul + corrections
__device__ __forceinline__ float sums(const JitterArgs& a, const float* v, const StepRow& r,
                                      bool in_lo, float vKlo, bool in_hi, float vKhi,
                                      float cnt, float v_last) {
    const float NaN = group_acc::nan_f();
    const bool moments = a.func == STDDEV_OVER_TIME || a.func == STDVAR_OVER_TIME ||
                         a.func == Z_SCORE;
    float sm = 0.0f, sm2 = 0.0f;
    for (int t = r.clo; t < r.chi; ++t) {
        const float x = v[t];
        sm += x;
        if (moments) sm2 += x * x;
    }
    const float s = sm + (in_lo ? vKlo : 0.0f) + (in_hi ? vKhi : 0.0f);
    const bool has = cnt > 0.0f;
    if (!has) return NaN;
    if (a.func == AVG_OVER_TIME) return s / fmaxf(cnt, 1.0f);
    if (!moments) return a.func == RATE ? s / (a.window_ms * 1e-3f) : s;
    const float s2 = sm2 + (in_lo ? vKlo * vKlo : 0.0f) + (in_hi ? vKhi * vKhi : 0.0f);
    const float c = fmaxf(cnt, 1.0f);
    const float mean = s / c;
    const float var = fmaxf(s2 / c - mean * mean, 0.0f);
    if (a.func == STDVAR_OVER_TIME) return var;
    const float sd = sqrtf(var);
    if (a.func == STDDEV_OVER_TIME) return sd;
    return (v_last - mean) / fmaxf(sd, 1e-30f);
}

// min/max over [clo, chi) (valid slots) and the members among klo, khi
__device__ __forceinline__ float minmax(const JitterArgs& a, const float* v, const float* ffd,
                                        const StepRow& r, bool in_lo, bool in_hi, float cnt) {
    const bool is_min = a.func == MIN_OVER_TIME;
    float m = SENTINEL;
    for (int t = r.clo; t < r.chi; ++t) {
        if (ffd && !(fabsf(ffd[t]) <= a.maxdev)) continue;  // a hole
        m = fminf(m, is_min ? v[t] : -v[t]);
    }
    const float vKlo = is_min ? v[r.iKlo] : -v[r.iKlo];
    const float vKhi = is_min ? v[r.iKhi] : -v[r.iKhi];
    m = fminf(m, in_lo ? vKlo : SENTINEL);
    m = fminf(m, in_hi ? vKhi : SENTINEL);
    if (!(cnt > 0.0f)) return group_acc::nan_f();
    return is_min ? m : -m;
}

// JITTER: the range function of row s at step row r
__device__ __forceinline__ float jitter_value(const JitterArgs& a, int64_t s, const StepRow& r) {
    const float NaN = group_acc::nan_f();
    const float* v = a.vals + s * a.T;
    const int32_t* ts = a.ts + s * a.T;
    const int func = a.func;
    auto dev = [&](int i, int nom) { return (float)((long long)ts[i] - (long long)nom); };
    const bool c0pos = r.flags & 1, c0ge2 = r.flags & 2;
    const float dKlo = dev(r.iKlo, r.nKlo), dKhi = dev(r.iKhi, r.nKhi);
    const bool in_lo = (r.flags & 4) && dKlo > r.blo_rel;
    const bool in_hi = (r.flags & 8) && dKhi <= r.ehi_rel;
    const float cnt = r.count0 + (in_lo ? 1.0f : 0.0f) + (in_hi ? 1.0f : 0.0f);
    const bool has = cnt > 0.0f;
    if (func == COUNT_OVER_TIME) return has ? cnt : NaN;
    if (func == PRESENT_OVER_TIME) return has ? 1.0f : NaN;
    if (func == ABSENT_OVER_TIME) return has ? NaN : 1.0f;
    if (func == MIN_OVER_TIME || func == MAX_OVER_TIME)
        return minmax(a, v, nullptr, r, in_lo, in_hi, cnt);
    const float vKlo = v[r.iKlo], vKhi = v[r.iKhi];
    // the last in-window sample: [klo?] certain[clo..chi) [khi?]
    auto vlast = [&](float vL0) { return w3(in_hi, vKhi, c0pos, vL0, vKlo); };
    auto tlast = [&](float dL0) {
        return w3(in_hi, r.Khi_rel + dKhi, c0pos, r.L0_rel + dL0, r.Klo_rel + dKlo);
    };
    if (is_win_sum(a) || func == AVG_OVER_TIME || func == STDDEV_OVER_TIME ||
        func == STDVAR_OVER_TIME || func == Z_SCORE)
        return sums(a, v, r, in_lo, vKlo, in_hi, vKhi, cnt,
                    func == Z_SCORE ? vlast(v[r.iL0]) : 0.0f);
    if (func == FIRST_OVER_TIME) return has ? w3(in_lo, vKlo, c0pos, v[r.iF0], vKhi) : NaN;
    if (func == LAST) return has ? vlast(v[r.iL0]) : NaN;
    if (func == RATE || func == INCREASE || func == DELTA) {
        const float dF0 = dev(r.iF0, r.nF0), dL0 = dev(r.iL0, r.nL0);
        const float v_first = w3(in_lo, vKlo, c0pos, v[r.iF0], vKhi);
        const float tf_rel = w3(in_lo, r.Klo_rel + dKlo, c0pos, r.F0_rel + dF0,
                                r.Khi_rel + dKhi);
        float vfr = 0.0f;
        if (a.is_counter && func != DELTA) {
            const float* rw = a.raw + s * a.T;
            vfr = w3(in_lo, rw[r.iKlo], c0pos, rw[r.iF0], rw[r.iKhi]);
        }
        return extrapolate(a, cnt, v_first, vlast(v[r.iL0]), tf_rel, tlast(dL0), vfr);
    }
    // irate, idelta
    if (!(cnt >= 2.0f)) return NaN;
    const float v_last = vlast(v[r.iL0]);
    if (func == IDELTA && a.is_counter && !a.is_delta) return v_last;  // diff-staged
    const float dL0 = dev(r.iL0, r.nL0), dL2 = dev(r.iL2, r.nL2);
    const float v_prev = in_hi ? (c0pos ? v[r.iL0] : vKlo) : (c0ge2 ? v[r.iL2] : vKlo);
    const float tp_rel = in_hi ? (c0pos ? r.L0_rel + dL0 : r.Klo_rel + dKlo)
                               : (c0ge2 ? r.L2_rel + dL2 : r.Klo_rel + dKlo);
    const float dv = v_last - v_prev;
    if (func == IDELTA) return dv;
    const float dt_s = (tlast(dL0) - tp_rel) * 1e-3f;
    return dv / fmaxf(dt_s, 1e-30f);
}

// MASKED: the range function of row s at step row r, over the sidecar
__device__ __forceinline__ float masked_value(const JitterArgs& a, int64_t s, const StepRow& r) {
    const float NaN = group_acc::nan_f();
    const int64_t o = s * a.T;
    const float* mv = a.vals + o;
    const float* ffd = a.ffd + o;
    const float* bfd = a.bfd + o;
    const int func = a.func;
    const bool c0pos_g = r.flags & 1;
    const float vaF0 = fabsf(ffd[r.iF0]) <= a.maxdev ? 1.0f : 0.0f;
    const float* cc = a.cc + o;
    const float cnt0v = c0pos_g ? cc[r.iL0] - cc[r.iF0] + vaF0 : 0.0f;
    if (func == MIN_OVER_TIME || func == MAX_OVER_TIME) {
        // the validity-masked form (jitter_masked_minmax): a hole is never in
        const bool va_lo = fabsf(ffd[r.iKlo]) <= a.maxdev, va_hi = fabsf(ffd[r.iKhi]) <= a.maxdev;
        const bool in_lo = (r.flags & 4) && ffd[r.iKlo] > r.blo_rel && va_lo;
        const bool in_hi = (r.flags & 8) && ffd[r.iKhi] <= r.ehi_rel && va_hi;
        const float cnt = cnt0v + (in_lo ? 1.0f : 0.0f) + (in_hi ? 1.0f : 0.0f);
        return minmax(a, mv, ffd, r, in_lo, in_hi, cnt);
    }
    const float dKlo = ffd[r.iKlo], dKhi = bfd[r.iKhi];
    const bool in_lo = (r.flags & 4) && dKlo > r.blo_rel;
    const bool in_hi = (r.flags & 8) && dKhi <= r.ehi_rel;
    const float cnt = cnt0v + (in_lo ? 1.0f : 0.0f) + (in_hi ? 1.0f : 0.0f);
    const bool has = cnt > 0.0f;
    const bool c0pos = cnt0v > 0.0f, c0ge2 = cnt0v >= 2.0f;
    if (func == COUNT_OVER_TIME) return has ? cnt : NaN;
    if (func == PRESENT_OVER_TIME) return has ? 1.0f : NaN;
    if (func == ABSENT_OVER_TIME) return has ? NaN : 1.0f;
    const float ffvL0 = a.ffv[o + r.iL0];
    if (func == RATE || func == INCREASE || func == DELTA) {
        if (!is_win_sum(a)) {
            // the backward fill at a valid klo/khi is the value there
            const float* bfv = a.bfv + o;
            const float vKlo = bfv[r.iKlo], vKhi = bfv[r.iKhi];
            const float v_first = w3(in_lo, vKlo, c0pos, bfv[r.iF0], vKhi);
            const float v_last = w3(in_hi, vKhi, c0pos, ffvL0, vKlo);
            const float tf_rel = w3(in_lo, r.Klo_rel + dKlo, c0pos, r.F0_rel + bfd[r.iF0],
                                    r.Khi_rel + dKhi);
            const float tl_rel = w3(in_hi, r.Khi_rel + dKhi, c0pos, r.L0_rel + a.ffd[o + r.iL0],
                                    r.Klo_rel + dKlo);
            float vfr = 0.0f;
            if (a.is_counter && func != DELTA) {
                const float* br = a.bfraw + o;
                vfr = w3(in_lo, br[r.iKlo], c0pos, br[r.iF0], br[r.iKhi]);
            }
            return extrapolate(a, cnt, v_first, v_last, tf_rel, tl_rel, vfr);
        }
    }
    const float vKlo = mv[r.iKlo], vKhi = mv[r.iKhi];
    auto vlast = [&](float vL0) { return w3(in_hi, vKhi, c0pos, vL0, vKlo); };
    if (is_win_sum(a) || func == AVG_OVER_TIME || func == STDDEV_OVER_TIME ||
        func == STDVAR_OVER_TIME || func == Z_SCORE)
        return sums(a, mv, r, in_lo, vKlo, in_hi, vKhi, cnt,
                    func == Z_SCORE ? vlast(ffvL0) : 0.0f);
    if (func == FIRST_OVER_TIME)
        return has ? w3(in_lo, vKlo, c0pos, a.bfv[o + r.iF0], vKhi) : NaN;
    if (func == LAST) return has ? vlast(ffvL0) : NaN;
    // irate, idelta
    if (!(cnt >= 2.0f)) return NaN;
    const float v_last = vlast(ffvL0);
    if (func == IDELTA && a.is_counter && !a.is_delta) return v_last;  // diff-staged
    const float ffdL0 = ffd[r.iL0];
    const float tl_rel = w3(in_hi, r.Khi_rel + dKhi, c0pos, r.L0_rel + ffdL0, r.Klo_rel + dKlo);
    const float v_prev = in_hi ? (c0pos ? ffvL0 : vKlo) : (c0ge2 ? a.ff2v[o + r.iL0] : vKlo);
    const float tp_rel = in_hi ? (c0pos ? r.L0_rel + ffdL0 : r.Klo_rel + dKlo)
                               : (c0ge2 ? r.L0_rel + a.ff2d[o + r.iL0] : r.Klo_rel + dKlo);
    const float dv = v_last - v_prev;
    if (func == IDELTA) return dv;
    return dv / fmaxf((tl_rel - tp_rel) * 1e-3f, 1e-30f);
}

template <bool MASKED, bool SHARED, bool STORE>
__global__ void __launch_bounds__(THREADS) jitter_range_kernel(const JitterArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int part = SHARED ? a.G * a.J : 0;
    float* acc_s = smem;
    float* cnt_s = smem + part;
    // the step table after the partials (16-byte aligned, as the wrapper sized it)
    StepRow* steps_s = reinterpret_cast<StepRow*>(smem + (SHARED ? ((2 * part + 3) & ~3) : 0));
    const StepRow* steps = a.stage_steps ? steps_s : a.steps;
    if (a.stage_steps) {
        const int* src = reinterpret_cast<const int*>(a.steps);
        int* dst = reinterpret_cast<int*>(steps_s);
        for (int i = threadIdx.x; i < a.J * 24; i += blockDim.x) dst[i] = __ldg(src + i);
    }
    const group_acc::Sink sink = SHARED ? group_acc::Sink{acc_s, cnt_s, a.J, a.acc_op}
                                        : group_acc::Sink{a.acc, a.cnt, a.ld, a.acc_op};
    const group_acc::Store store{a.acc, a.S};
    if (SHARED) group_acc::shared_init(acc_s, cnt_s, part, a.acc_op);
    if (SHARED || a.stage_steps) __syncthreads();
    const int R = a.R;
    row_tiles::for_each_tile<false>(a.S, R, [](int, int) {}, [&](int tile, int) {
        const int64_t s0 = (int64_t)tile * R;
        row_tiles::for_each_pair(min(R, a.S - (int)s0), a.J, [&](int r, int j) {
            const int64_t s = s0 + r;
            if (s >= a.S) return;
            const long long g = __ldg(a.gids + s);
            if (g < 0 || g >= a.G) {  // trash group G (padding) or no group
                if (STORE) store.put(s, j, group_acc::nan_f());
                return;
            }
            const float v = MASKED ? masked_value(a, s, steps[j]) : jitter_value(a, s, steps[j]);
            if (STORE) store.put(s, j, v);
            else if (!isnan(v)) sink.add(g, j, v);
        });
    });
    if (SHARED) {
        __syncthreads();
        group_acc::shared_flush(acc_s, cnt_s, a.G, a.J, a.acc, a.cnt, a.ld, a.acc_op);
    }
}

template <bool MASKED, bool SHARED, bool STORE>
int launch(const JitterArgs& a, int smem, cudaStream_t stream) {
    auto kern = jitter_range_kernel<MASKED, SHARED, STORE>;
    int grid = 0;
    const cudaError_t err = row_tiles::persistent_grid(kern, smem, (a.S + a.R - 1) / a.R, &grid);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <bool MASKED>
int dispatch(const JitterArgs& a, bool store, bool shared, int smem, cudaStream_t st) {
    if (store) return launch<MASKED, false, true>(a, smem, st);
    return shared ? launch<MASKED, true, false>(a, smem, st)
                  : launch<MASKED, false, false>(a, smem, st);
}

}  // namespace

// Plain C entry for ctypes. `masked` picks the variant. JITTER reads vals,
// ts (int32) and raw; MASKED reads the sidecar planes vals (as `vals`), cc,
// ffv, ffd, bfv, bfd, ff2v, ff2d and bfraw (bfv for non-counters), all
// [S, T] with T the sidecar's width. `steps` is the [J] step table
// (ops/mxu_jitter.py). acc [G+1, ld] holds the accumulator's identity and
// cnt [G+1, ld] zeros; steps [0, J) are computed. `rows` rows per tile;
// `shared` keeps the group partials in shared memory; `stage_steps` copies
// the step table into shared memory after them; `smem_bytes` is the
// dynamic shared memory the wrapper sized for both (checked here).
// acc_op ACC_STORE is the store mode: acc is the [ld, S] grid, cnt is not
// read, `shared` must be 0. Launches on `stream` and returns a cudaError_t
// (0 on success); it does not synchronise.
extern "C" int filodb_jitter_range(
    int masked, const void* vals, const void* ts, const void* raw, const void* cc,
    const void* ffv, const void* ffd, const void* bfv, const void* bfd, const void* ff2v,
    const void* ff2d, const void* bfraw, const void* gids, const void* steps, int S, int T,
    int J, int ld, int G, float window_ms, float maxdev, int func, int acc_op, int is_counter,
    int is_delta, int rows, int shared, int stage_steps, int smem_bytes, void* acc, void* cnt,
    void* stream) {
    if (S <= 0 || J <= 0 || G <= 0) return 0;
    JitterArgs a{(const float*)vals, (const int32_t*)ts, (const float*)raw, (const float*)cc,
                 (const float*)ffv, (const float*)ffd, (const float*)bfv, (const float*)bfd,
                 (const float*)ff2v, (const float*)ff2d, (const float*)bfraw,
                 (const long long*)gids, (const StepRow*)steps, S, T, J, ld, G, window_ms,
                 maxdev, func, acc_op, is_counter, is_delta, rows, stage_steps, (float*)acc,
                 (float*)cnt};
    const int64_t part = shared ? (((int64_t)2 * G * J + 3) & ~3) * 4 : 0;
    const int64_t need = part + (stage_steps ? (int64_t)J * (int64_t)sizeof(StepRow) : 0);
    const bool store = acc_op == group_acc::ACC_STORE;
    if (rows < 1 || smem_bytes < need || (store && shared)) return (int)cudaErrorInvalidValue;
    if (masked ? !(cc && ffv && ffd && bfv && bfd && ff2v && ff2d && bfraw) : !(ts && raw))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return masked ? dispatch<true>(a, store, shared, smem_bytes, st)
                  : dispatch<false>(a, store, shared, smem_bytes, st);
}
