// The reference tree's map phase on Hopper (sm_90a): one launch reduces a
// per-series [S, J] grid into the [G, J] group components the tree's
// aggregates merge (count, sum, sumsq, min, max, group).
//
// Replaces _segment_aggregate_jit (filodb_tpu/ops/aggregations.py:49) as
// the JAX package's _partial_aggregate (query/exec/plans.py:777) calls it:
// once per component, each a separate XLA program over the whole grid. A
// NaN value is absent: it adds nothing, and a (group, step) with no value
// is NaN in every component; group is 1.0 where a group has a value;
// sumsq sums v * v rounded to f32 (-fmad=false keeps the multiply and the
// add separately rounded). min and max order the floats totally (-0 below
// +0), through group_acc.cuh's ordered-int atomics.
//
// Input: the step-major grid the tree's leaves hold (the store mode's
// [J_pad, S_pad] grid, step j's column of series at grid + j * ld), the
// series' int32 group ids (a row whose id lies outside [0, G) is skipped)
// and a mask of the components wanted (count is always computed). Output:
// out [n_comp, G, J], one plane per wanted component in the order count,
// sum, sumsq, min, max, group.
//
// Bound: device-memory bytes, one read of the S x J values and of the gids
// and n_comp x G x J written once; a few operations a value.
//
// Design. One cooperative launch of at most the card's resident blocks,
// in three phases split by grid-wide barriers: (0) every block sets the
// planes to each accumulator's identity; (1) each warp takes items of 32
// series (a lane each, so a step's 32 values are one coalesced read) by 8
// consecutive steps, the 8 loads in flight together (a warp walking every
// step of its series one load at a time measured 2.09 ms for 8 leaves of
// 12,500 x 111 on an H100, 156 x the bound, latency-bound on 49 SMs); the
// item's lanes are grouped by group id (__match_any_sync), and at each
// step the lanes of one group combine their values by shuffles
// (a butterfly when the whole warp is one group, as in a global sum)
// before one lane folds them into the partials: shared-memory [G, J]
// partials per block while they fit (then one flush of atomics per
// (group, step) per block, group_acc.cuh's shared_flush pattern), else the
// global planes directly; (2) every block finishes its share of the [G, J]
// entries: NaN where the count is 0, group 1.0 elsewhere.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_acc.cuh"

namespace {

namespace cg = cooperative_groups;
using group_acc::atomic_max_f32;
using group_acc::atomic_min_f32;
using group_acc::inf_f;
using group_acc::nan_f;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
// the components (ops/segment_agg.py COMPONENTS), their mask bits
enum Comp { C_COUNT = 0, C_SUM, C_SUMSQ, C_MIN, C_MAX, C_GROUP, N_COMP };
constexpr int N_ACC = 5;  // the accumulated ones: count .. max (group reads count)
constexpr int CHUNK = 8;  // steps a warp's item covers, their loads in flight together

__device__ __forceinline__ float identity_of(int c) {
    return c == C_MIN ? inf_f() : (c == C_MAX ? -inf_f() : 0.0f);
}

// the signed key of a float's total order (-0 below +0); x is not NaN
__device__ __forceinline__ int order_key(float x) {
    const int b = __float_as_int(x);
    return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float total_min(float a, float b) {
    return order_key(b) < order_key(a) ? b : a;
}
__device__ __forceinline__ float total_max(float a, float b) {
    return order_key(b) > order_key(a) ? b : a;
}

// one lane's values of one step: count, sum, sumsq, min, max
struct Acc {
    float v[N_ACC];

    __device__ __forceinline__ void combine(const Acc& o) {
        v[C_COUNT] += o.v[C_COUNT];
        v[C_SUM] += o.v[C_SUM];
        v[C_SUMSQ] += o.v[C_SUMSQ];
        v[C_MIN] = total_min(v[C_MIN], o.v[C_MIN]);
        v[C_MAX] = total_max(v[C_MAX], o.v[C_MAX]);
    }
};

__device__ __forceinline__ Acc shfl_xor(const Acc& a, int m) {
    Acc o;
#pragma unroll
    for (int c = 0; c < N_ACC; ++c) o.v[c] = __shfl_xor_sync(FULL, a.v[c], m);
    return o;
}

__device__ __forceinline__ Acc shfl_from(const Acc& a, int src) {
    Acc o;
#pragma unroll
    for (int c = 0; c < N_ACC; ++c) o.v[c] = __shfl_sync(FULL, a.v[c], src);
    return o;
}

// fold one (group, step)'s combined values into the accumulator planes
// acc + p * plane (plane = G * J entries), the wanted ones only
__device__ __forceinline__ void fold(float* acc, int64_t plane, int64_t i, const Acc& a,
                                     const int (&slot)[N_ACC]) {
    atomicAdd(acc + i, a.v[C_COUNT]);  // slot[C_COUNT] is 0
    if (slot[C_SUM] >= 0) atomicAdd(acc + slot[C_SUM] * plane + i, a.v[C_SUM]);
    if (slot[C_SUMSQ] >= 0) atomicAdd(acc + slot[C_SUMSQ] * plane + i, a.v[C_SUMSQ]);
    if (slot[C_MIN] >= 0) atomic_min_f32(acc + slot[C_MIN] * plane + i, a.v[C_MIN]);
    if (slot[C_MAX] >= 0) atomic_max_f32(acc + slot[C_MAX] * plane + i, a.v[C_MAX]);
}

__global__ void __launch_bounds__(MAX_THREADS)
    segment_agg_kernel(const float* __restrict__ grid, int64_t ld, int S, int J,
                       const int* __restrict__ gids, int G, int mask, int shared,
                       float* __restrict__ out) {
    extern __shared__ __align__(16) float parts[];
    cg::grid_group gg = cg::this_grid();
    const int lane = threadIdx.x & 31;
    const int64_t GJ = (int64_t)G * J;
    // the plane of each accumulated component in out and in the shared
    // partials (-1: not wanted); count is plane 0 of both
    int slot[N_ACC];
    int n_acc = 0;
#pragma unroll
    for (int c = 0; c < N_ACC; ++c) slot[c] = (c == C_COUNT || (mask >> c) & 1) ? n_acc++ : -1;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;

    // (0) the planes at their identities, the block's partials too
    for (int64_t i = tid; i < GJ; i += nthreads) {
#pragma unroll
        for (int c = 0; c < N_ACC; ++c)
            if (slot[c] >= 0) out[slot[c] * GJ + i] = identity_of(c);
    }
    if (shared) {
        for (int i = threadIdx.x; i < n_acc * (int)GJ; i += blockDim.x) {
            const int p = i / (int)GJ;
            int c = 0;
#pragma unroll
            for (int k = 0; k < N_ACC; ++k)
                if (slot[k] == p) c = k;
            parts[i] = identity_of(c);
        }
    }
    gg.sync();

    // (1) a warp per item: 32 series (a lane each) x CHUNK consecutive
    // steps, the chunk's loads issued before any is reduced
    float* sink = shared ? parts : out;
    const int64_t plane = GJ;
    const int warps = blockDim.x >> 5;
    const int64_t tiles = ((int64_t)S + 31) / 32;
    const int64_t items = tiles * ((J + CHUNK - 1) / CHUNK);
    for (int64_t item = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); item < items;
         item += (int64_t)gridDim.x * warps) {
        const int64_t s = (item % tiles) * 32 + lane;
        const int j0 = (int)(item / tiles) * CHUNK;
        int g = s < S ? __ldg(gids + s) : -1;
        if (g >= G) g = -1;
        if (!__any_sync(FULL, g >= 0)) continue;
        const unsigned peers = __match_any_sync(FULL, g);
        const bool leader = (__ffs(peers) - 1) == lane && g >= 0;
        const bool uniform = peers == FULL;
        const int most = __reduce_max_sync(FULL, __popc(peers));
        float x[CHUNK];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u)
            x[u] = g >= 0 && j0 + u < J ? __ldg(grid + (int64_t)(j0 + u) * ld + s) : nan_f();
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
            const bool valid = !isnan(x[u]);
            Acc a;
            a.v[C_COUNT] = valid ? 1.0f : 0.0f;
            a.v[C_SUM] = valid ? x[u] : 0.0f;
            a.v[C_SUMSQ] = valid ? x[u] * x[u] : 0.0f;
            a.v[C_MIN] = valid ? x[u] : inf_f();
            a.v[C_MAX] = valid ? x[u] : -inf_f();
            if (uniform) {
#pragma unroll
                for (int m = 16; m > 0; m >>= 1) a.combine(shfl_xor(a, m));
            } else if (most > 1) {
                const Acc own = a;  // the lanes read each other's own values, not partial sums
                unsigned rest = peers & ~(1u << lane);  // this lane's group, but itself
                for (int r = 1; r < most; ++r) {
                    const int src = rest ? __ffs(rest) - 1 : lane;
                    const Acc o = shfl_from(own, src);
                    if (rest) {
                        a.combine(o);
                        rest &= rest - 1;
                    }
                }
            }
            if (leader && a.v[C_COUNT] > 0.0f)
                fold(sink, plane, (int64_t)g * J + j0 + u, a, slot);
        }
    }
    if (shared) {
        __syncthreads();  // the block's partials are complete
        for (int i = threadIdx.x; i < (int)GJ; i += blockDim.x) {
            if (parts[i] > 0.0f) {
                Acc a;
#pragma unroll
                for (int c = 0; c < N_ACC; ++c)
                    a.v[c] = slot[c] >= 0 ? parts[slot[c] * (int)GJ + i] : identity_of(c);
                fold(out, plane, i, a, slot);
            }
        }
    }
    gg.sync();

    // (2) finish: NaN where a group has no value, group 1.0 elsewhere
    const int group_plane = (mask >> C_GROUP) & 1 ? n_acc : -1;
    for (int64_t i = tid; i < GJ; i += nthreads) {
        const float n = out[i];
        if (n > 0.0f) {
            if (group_plane >= 0) out[group_plane * GJ + i] = 1.0f;
            continue;
        }
#pragma unroll
        for (int c = 0; c < N_ACC; ++c)
            if (slot[c] >= 0) out[slot[c] * GJ + i] = nan_f();
        if (group_plane >= 0) out[group_plane * GJ + i] = nan_f();
    }
}

}  // namespace

// Plain C entry for ctypes: the components in `mask` (bits in the order
// count, sum, sumsq, min, max, group; count is always written) of the
// [J, S] step-major grid (step j's column at grid + j * ld, ld >= S) by
// the int32 group ids of its S series into out [n_comp, G, J] f32, n_comp
// the bits of mask | 1. `shared` says whether the [G, J] partials of the
// accumulated components live in each block's shared memory, and
// smem_bytes must be their size then (0 otherwise; at most 48 KB). One
// cooperative launch of `threads` per block (a multiple of 32), at most as
// many blocks as the card holds at once. Launches on `stream` and returns
// a cudaError_t (0 on success); it does not synchronise.
extern "C" int filodb_segment_aggregate(const void* grid, long long ld, int S, int J,
                                        const void* gids, int G, int mask, int threads,
                                        int shared, int smem_bytes, void* out, void* stream) {
    if (G <= 0 || J <= 0) return 0;
    mask |= 1;
    int n_acc = 0;
    for (int c = 0; c < N_ACC; ++c) n_acc += (mask >> c) & 1;
    const long long parts = (long long)n_acc * G * J * 4;
    if (S < 0 || ld < S || threads < 32 || threads > MAX_THREADS || threads % 32 ||
        mask >> N_COMP || smem_bytes != (shared ? parts : 0) || smem_bytes > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_agg_kernel, threads,
                                                            smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long items = ((long long)S + 31) / 32 * ((J + CHUNK - 1) / CHUNK);
    const long long wanted = (items + threads / 32 - 1) / (threads / 32);
    const long long blocks = wanted < (long long)per_sm * sms
                                 ? (wanted > 0 ? wanted : 1)
                                 : (long long)per_sm * sms;
    const float* g = (const float*)grid;
    int64_t ld64 = (int64_t)ld;
    const int* gid = (const int*)gids;
    float* o = (float*)out;
    void* args[] = {(void*)&g, (void*)&ld64, (void*)&S, (void*)&J, (void*)&gid,
                    (void*)&G, (void*)&mask, (void*)&shared, (void*)&o};
    err = cudaLaunchCooperativeKernel((const void*)segment_agg_kernel, dim3((unsigned)blocks),
                                      dim3((unsigned)threads), args, (size_t)smem_bytes,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
