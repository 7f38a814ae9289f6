// The part-key index's postings intersection on Hopper (sm_90a): the AND
// of M packed posting bitmaps of W 64-bit words each, one word of the
// result per word of the id universe (part id i at word i >> 6, bit i & 63,
// memstore/postings.py's order).
//
// Replaces _intersect_jit (filodb_tpu/ops/postings_kernels.py:58), the
// XLA program the JAX package's device tier (memstore/index_device.py)
// runs over a stacked [M, W] array split into uint32 words (JAX runs
// without 64-bit integers). Here the words stay 64 bits end to end, and
// the M rows need not be stacked: the launch takes the staged bitmaps'
// own device pointers (at most MAX_ROWS; ops/postings_kernels.py chains
// launches past that).
//
// Bound: device-memory bytes, each of the M rows read once and the result
// written once, (M + 1) * W * 8 bytes: at M = 3 and a 1,048,576-id
// universe 0.5 MB, 0.16 us of HBM time, so a launch is launch-bound.
//
// Design: one grid-stride pass over pairs of words, 16-byte loads
// (ulonglong2, read through the non-coherent cache: the staged bitmaps are
// read-only while a launch runs) with the M rows ANDed in registers and
// one 16-byte store. Where a row or the result is not 16-byte aligned, or
// W is odd, the kernel takes the same pass a word at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS = 64;
constexpr int MAX_THREADS = 1024;

struct Rows {
    const uint64_t* p[MAX_ROWS];
};

template <bool VEC>
__global__ void postings_intersect_kernel(Rows rows, int M, int64_t W, uint64_t* out) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (VEC) {
        const int64_t pairs = W / 2;
        for (int64_t i = first; i < pairs; i += stride) {
            ulonglong2 acc = __ldg(reinterpret_cast<const ulonglong2*>(rows.p[0]) + i);
            for (int r = 1; r < M; ++r) {
                const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(rows.p[r]) + i);
                acc.x &= v.x;
                acc.y &= v.y;
            }
            reinterpret_cast<ulonglong2*>(out)[i] = acc;
        }
    } else {
        for (int64_t i = first; i < W; i += stride) {
            unsigned long long acc = __ldg(reinterpret_cast<const unsigned long long*>(rows.p[0]) + i);
            for (int r = 1; r < M; ++r)
                acc &= __ldg(reinterpret_cast<const unsigned long long*>(rows.p[r]) + i);
            out[i] = acc;
        }
    }
}

// An empty kernel over the blocks an intersection of W words launches: the
// card's floor for such a launch, timed beside it (filodb_postings_empty).
__global__ void empty_kernel() {}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The blocks of a launch over W words at `threads` a block: one item per
// thread (a pair of words on the vector path), at most 32 blocks an SM.
int64_t grid_blocks(int64_t W, bool vec, int threads) {
    int device = 0, sms = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
        return -1;
    const int64_t items = vec ? W / 2 : W;
    const int64_t wanted = (items + threads - 1) / threads;
    const int64_t cap = (int64_t)sms * 32;
    return wanted < 1 ? 1 : (wanted < cap ? wanted : cap);
}

}  // namespace

// Plain C entry for ctypes: out[w] = rows[0][w] & ... & rows[M-1][w] for
// w < W, on `stream`. rows is a host array of M device pointers (1 <= M <=
// MAX_ROWS), each to W 64-bit words; out holds W words (it may be one of
// the rows). Returns the launch's cudaError_t (0 on success).
extern "C" int filodb_postings_intersect(const void* const* rows, int M, long long W, void* out,
                                         int threads, void* stream) {
    if (M < 1 || M > MAX_ROWS || W < 0 || !rows || !out || threads < 32 ||
        threads > MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    if (W == 0) return 0;
    Rows r;
    bool vec = (W % 2 == 0) && aligned16(out);
    for (int i = 0; i < M; ++i) {
        if (!rows[i]) return (int)cudaErrorInvalidValue;
        r.p[i] = (const uint64_t*)rows[i];
        vec = vec && aligned16(rows[i]);
    }
    for (int i = M; i < MAX_ROWS; ++i) r.p[i] = nullptr;
    const int64_t blocks = grid_blocks(W, vec, threads);
    if (blocks < 0) return (int)cudaErrorInvalidDevice;
    if (vec)
        postings_intersect_kernel<true><<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
            r, M, (int64_t)W, (uint64_t*)out);
    else
        postings_intersect_kernel<false><<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
            r, M, (int64_t)W, (uint64_t*)out);
    return (int)cudaGetLastError();
}

// Plain C entry for ctypes: an empty kernel over the blocks an intersection
// of W aligned words launches at `threads` a block, on `stream`.
extern "C" int filodb_postings_empty(long long W, int threads, void* stream) {
    if (W <= 0 || threads < 32 || threads > MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = grid_blocks(W, W % 2 == 0, threads);
    if (blocks < 0) return (int)cudaErrorInvalidDevice;
    empty_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
