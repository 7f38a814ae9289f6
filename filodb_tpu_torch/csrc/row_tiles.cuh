// Row tiles for the port's fused range kernels, on Hopper (sm_90a).
//
// A persistent block walks tiles of R consecutive series rows, and its
// threads take each tile's (row, step) pairs flattened (for_each_pair).
// The window-stats kernel also stages each tile's rows in shared memory
// (for_each_tile): cp.async 16-byte copies that bypass L1 fill one of two
// buffers, so the copies of the block's next tile are in flight while the
// current one is computed. A buffer holds n_arrays arrays of R rows each;
// array a's row r is at buf + (a * R + r) * T. Rows in device memory are
// contiguous with a pitch of T words (staging.pad_time makes T a multiple
// of 128) and the wrapper checks 16-byte alignment, so every copy is an
// aligned 16-byte chunk of one row. Only the chunks a row needs are copied
// (its samples); rows the kernel skips copy nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace row_tiles {

constexpr int THREADS = 256;  // threads per block of both fused kernels

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(__cvta_generic_to_global(gmem_src))
                 : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most the newest committed group is still in flight
__device__ __forceinline__ void wait_prior1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue one tile's copies: rows s0 .. s0+rows-1 of up to three arrays
// (src0..src2, `narr` of them), into `buf`. `chunks(r)` is how many
// leading 16-byte chunks of row r to copy (0 skips the row). Every thread
// of the block takes part.
template <typename Chunks>
__device__ __forceinline__ void issue_tile(const void* src0, const void* src1, const void* src2,
                                           int narr, int64_t s0, int rows, int R, int T,
                                           float* buf, Chunks chunks) {
    const int cpr = T / 4;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < rows * cpr; c += blockDim.x) {
        const int r = c / cpr;
        const int k = c - r * cpr;
        if (k >= chunks(r)) continue;
        const int64_t off = (s0 + r) * T + 4 * k;  // in words
        float* d = buf + (int64_t)r * T + 4 * k;
        cp_async16(d, (const float*)src0 + off);
        if (narr > 1) cp_async16(d + (int64_t)R * T, (const float*)src1 + off);
        if (narr > 2) cp_async16(d + (int64_t)2 * R * T, (const float*)src2 + off);
    }
}

// Walk the block's tiles of R rows out of S (tile blockIdx.x, then +
// gridDim.x, ...), calling compute(tile, b) on each. STAGED:
// issue(tile, b) starts the copies of a tile into buffer b, and the copies
// of the block's next tile are in flight while compute runs on this one;
// else rows are read in place and issue is never called.
template <bool STAGED, typename Issue, typename Compute>
__device__ __forceinline__ void for_each_tile(int S, int R, Issue issue, Compute compute) {
    const int ntiles = (S + R - 1) / R;
    int tile = blockIdx.x;
    if (STAGED) {
        if (tile < ntiles) issue(tile, 0);
        commit();
    }
    for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
        const int b = it & 1;
        if (STAGED) {
            const int next = tile + gridDim.x;
            if (next < ntiles) issue(next, b ^ 1);
            commit();
            wait_prior1();  // this tile's copies have landed
            __syncthreads();
        }
        compute(tile, b);
        if (STAGED) __syncthreads();  // before the next issue overwrites buffer b
    }
}

// Call f(r, j) for this thread's (row, step) pairs of a tile of `rows` x
// J, flattened row by row: p = r * J + j for p = threadIdx.x, +
// blockDim.x, ... Every lane has a pair whatever J is; only the tile's
// last warp is partly idle.
template <typename F>
__device__ __forceinline__ void for_each_pair(int rows, int J, F f) {
    const int dr = blockDim.x / J, dj = blockDim.x - dr * J;
    for (int r = threadIdx.x / J, j = threadIdx.x - r * J; r < rows;
         r += dr, j += dj, r += j >= J, j -= j >= J ? J : 0)
        f(r, j);
}

// Host: the grid of a persistent launch of `kern` with `smem` bytes of
// dynamic shared memory and `threads` threads per block -- as many blocks
// as fit on the card at once, but no more than `tiles`. The kernel's shared-memory allowance only ever
// grows (it is one attribute per kernel, whatever size a launch asks
// for), and the occupancy is asked once per (device, kernel, smem), so a
// launch pays a map lookup; the lock keeps concurrent host threads safe.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kern, int smem, int tiles, int* grid, int threads = THREADS) {
    static std::mutex mu;
    static std::map<std::pair<int, const void*>, int> allowed;
    static std::map<std::tuple<int, const void*, int, int>, int> resident;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    int& allow = allowed[std::make_pair(dev, (const void*)kern)];
    if (smem > allow) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        allow = smem;
    }
    const auto key = std::make_tuple(dev, (const void*)kern, smem, threads);
    auto it = resident.find(key);
    if (it == resident.end()) {
        int sms = 0, per_sm = 0;
        if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
                cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                                 smem)) != cudaSuccess)
            return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        it = resident.emplace(key, sms * per_sm).first;
    }
    *grid = tiles < it->second ? tiles : it->second;
    return cudaSuccess;
}

}  // namespace row_tiles
