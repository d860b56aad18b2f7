// Helpers shared by the slot kernels (slot_union, orset_capture,
// orset_replay, orset_apply, orset_compact, the RGA's, mark_members): a
// block-wide sort of records in shared or global memory, block-wide prefix
// sums, and JAX's index rules.
//
// A record is an int4 compared lexicographically on the fields a
// comparator names, or a packed integer key. Every sort key ends in a
// field that is unique within the sorted array (an original position or
// lane), or the records that tie are identical, so the unstable network
// gives the one result a stable sort would.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

namespace slot_sort {

constexpr int SENT = INT_MAX;  // the empty-slot key (ops.SENTINEL)

// (x, y, z) lexicographic: a slot record (rep, ctr, position, -)
struct LessXYZ {
  __device__ bool operator()(const int4& a, const int4& b) const {
    if (a.x != b.x) return a.x < b.x;
    if (a.y != b.y) return a.y < b.y;
    return a.z < b.z;
  }
};

// (w, x, y, z) lexicographic: a keyed record (rep, ctr, origin, key)
struct LessWXYZ {
  __device__ bool operator()(const int4& a, const int4& b) const {
    if (a.w != b.w) return a.w < b.w;
    if (a.x != b.x) return a.x < b.x;
    if (a.y != b.y) return a.y < b.y;
    return a.z < b.z;
  }
};

// Sort a[0, n) (records of type T: an int4, or a packed key) ascending by
// `less`, in place, with the whole block. The
// network is the bitonic sorter over the next power of two p >= n in its
// form whose comparators all point the same way (the first step of each
// merge compares mirror positions), so positions >= n act as +infinity:
// a comparator that reaches one never swaps, and nothing is read or
// written there. `a` may lie in shared or global memory; every step ends
// in __syncthreads(), which also orders the block's global accesses.
template <typename T, typename Less>
__device__ void block_sort(T* a, int n, Less less) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (p >> 1); t += blockDim.x) {
        const int lo = (t / j) * 2 * j + (t % j);
        const int hi = (j == (k >> 1)) ? (lo ^ (k - 1)) : (lo + j);
        if (hi < n) {
          const T x = a[lo], y = a[hi];
          if (less(y, x)) {
            a[lo] = y;
            a[hi] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// In-place exclusive prefix sum of d[0, n) (shared or global) with the
// whole block; returns the total to every thread. blockDim.x <= 1024.
__device__ int block_exclusive_scan(int* d, int n) {
  __shared__ int part[1024];
  __shared__ int total;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += d[i];
  part[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int t = 0; t < (int)blockDim.x; ++t) {
      const int v = part[t];
      part[t] = run;
      run += v;
    }
    total = run;
  }
  __syncthreads();
  int run = part[threadIdx.x];
  for (int i = lo; i < hi; ++i) {
    const int v = d[i];
    d[i] = run;
    run += v;
  }
  const int out = total;
  __syncthreads();
  return out;
}

// Exclusive prefix sum of one flag per thread across the block; *sum gets
// the block's total. blockDim.x a multiple of 32, <= 1024.
__device__ int block_count_before(bool flag, int* sum) {
  __shared__ int warp_part[32];
  __shared__ int total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_part[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      const int v = warp_part[w];
      warp_part[w] = run;
      run += v;
    }
    total = run;
  }
  __syncthreads();
  const int before = warp_part[warp] + in_warp;
  *sum = total;
  __syncthreads();
  return before;
}

// Exclusive prefix sum of one count per thread across the block; *sum
// gets the block's total. blockDim.x a multiple of 32, <= 1024.
__device__ int block_exclusive_sum(int v, int* sum) {
  __shared__ int warp_part[32];
  __shared__ int total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_part[warp] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      const int x = warp_part[w];
      warp_part[w] = run;
      run += x;
    }
    total = run;
  }
  __syncthreads();
  const int before = warp_part[warp] + inc - v;
  *sum = total;
  __syncthreads();
  return before;
}

// JAX's gather rule for a row index: negative counts from the end, then
// clamp into [0, size).
__device__ __forceinline__ int gather_row(int key, int size) {
  int k = key < 0 ? key + size : key;
  return k < 0 ? 0 : (k >= size ? size - 1 : k);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// x rounded up to a multiple of 16 (a 16-byte aligned carve of shared
// memory).
__host__ __device__ inline size_t round16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Blocks of `threads` threads of `kernel` resident on the whole card at
// `bytes` of dynamic shared memory, at least one a multiprocessor.
template <typename K>
inline cudaError_t resident_blocks(K kernel, int threads, size_t bytes,
                                   long long* out) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads,
                                                        bytes);
  *out = (long long)sms * (per > 0 ? per : 1);
  return err;
}

}  // namespace slot_sort
