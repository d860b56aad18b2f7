// lane_buckets: the live op lanes of every view grouped by the row their
// key gathers, each group later walked in lane order by the MVRegister's
// apply kernels (mvr_apply.cu, their one user: the LWW-Set's lww_apply.cu
// groups its lanes in one launch of its own).
//
// A sequential per-row apply (the lax.scan of
// mvregister._apply_ops_impl) only has to see, in lane order, the lanes
// that gather its row; a no-op lane changes nothing. Three launches on the
// caller's stream build the groups from op [V, B] and key [V, B]:
//
//   count  one thread per lane: a live lane (its op code in `mask`) adds
//          one to count[v, g], g = the row its key gathers (JAX's gather
//          rule: negative counts from the end, then clamp)
//   scan   one block per view: start[v, g] = the exclusive prefix sum of
//          count[v, :], start[v, K] = the view's live lanes; count[v, :]
//          is zeroed to serve as the fill cursor
//   fill   one thread per live lane: lanes[v, start[v, g] + cursor] = b
//
// A group's lanes are in no order after the fill (atomics); the walk puts
// them in lane order with `sorted_window` below. Bytes: the op and key
// fields read twice, 4 bytes a live lane written, 8 bytes a (view, row).
#pragma once

#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace lane_buckets {

// count: int32 [V, K], zero on entry (the fill's cursor afterwards);
// start: int32 [V, K + 1]; lanes: int32 [V, B]
struct Lists {
  int* count;
  int* start;
  int* lanes;
};

__device__ __forceinline__ bool is_live(int op, unsigned mask) {
  return op >= 0 && op < 32 && ((mask >> op) & 1u);
}

__global__ void count_kernel(const int* __restrict__ op,
                             const int* __restrict__ key, unsigned mask,
                             long long total, int B, int K, int* count) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (!is_live(op[i], mask)) continue;
    const long long v = i / B;
    atomicAdd(&count[v * K + slot_sort::gather_row(key[i], K)], 1);
  }
}

__global__ void scan_kernel(int* count, int* start, int K) {
  const long long v = blockIdx.x;
  int* s = start + v * (K + 1);
  int* c = count + v * K;
  for (int g = threadIdx.x; g < K; g += blockDim.x) s[g] = c[g];
  __syncthreads();
  const int total = slot_sort::block_exclusive_scan(s, K);
  if (threadIdx.x == 0) s[K] = total;
  for (int g = threadIdx.x; g < K; g += blockDim.x) c[g] = 0;
}

__global__ void fill_kernel(const int* __restrict__ op,
                            const int* __restrict__ key, unsigned mask,
                            long long total, int B, int K, int* count,
                            const int* __restrict__ start,
                            int* __restrict__ lanes) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (!is_live(op[i], mask)) continue;
    const long long v = i / B;
    const int g = slot_sort::gather_row(key[i], K);
    const int at = atomicAdd(&count[v * K + g], 1);
    lanes[v * B + start[v * (K + 1) + g] + at] = (int)(i - v * B);
  }
}

// Build the groups of op/key [V, B] (K > 0) on `stream`.
inline cudaError_t build(const int* op, const int* key, unsigned mask, int V,
                         int K, int B, Lists l, cudaStream_t stream) {
  const long long total = (long long)V * B;
  if (total <= 0) return cudaSuccess;
  const long long want = (total + 255) / 256;
  const unsigned grid = (unsigned)(want < 132LL * 16 ? want : 132LL * 16);
  count_kernel<<<grid, 256, 0, stream>>>(op, key, mask, total, B, K,
                                         l.count);
  scan_kernel<<<V, 256, 0, stream>>>(l.count, l.start, K);
  fill_kernel<<<grid, 256, 0, stream>>>(op, key, mask, total, B, K, l.count,
                                        l.start, l.lanes);
  return cudaGetLastError();
}

struct Less {
  __device__ bool operator()(int a, int b) const { return a < b; }
};

// The lanes of one group (list[0, n), lane indices in [0, B), distinct)
// into win[] in lane order, a window of lane indices at a time: with
// n <= wcap one window holds them all; otherwise windows [w0, w0 + wcap)
// of lane index, each holding at most wcap of the group's lanes. Calls
// fn(win, m) for each window in order, with the whole block; `s_count`
// is a shared int. Every thread of the block calls it.
template <typename Fn>
__device__ void sorted_windows(const int* list, int n, int B, int* win,
                               int wcap, int* s_count, Fn fn) {
  const int width = n <= wcap ? B : wcap;
  for (int w0 = 0; w0 < B; w0 += width) {
    if (threadIdx.x == 0) *s_count = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int b = list[i];
      if (b >= w0 && b - w0 < width) win[atomicAdd(s_count, 1)] = b;
    }
    __syncthreads();
    const int m = *s_count;
    slot_sort::block_sort(win, m, Less());
    __syncthreads();
    fn(win, m);
    __syncthreads();
  }
}

}  // namespace lane_buckets
