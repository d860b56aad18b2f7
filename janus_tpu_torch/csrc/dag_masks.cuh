// Helpers shared by the consensus kernels (tusk_commit, causal_closure,
// dag_round): DAG rows held as 64-bit masks over nodes, and int32 round
// arithmetic with the semantics of XLA and torch.
//
// A bool[rows, n] tensor (n <= 64) becomes `rows` masks; bit t of mask i
// is element [i, t]. Round numbers are int32 that may wrap: sums and
// products go through uint32 (signed overflow is undefined in C++), and
// the ring slot of a round is the floor modulo, as `%` is in JAX and torch
// (C++ `%` truncates toward zero).
#pragma once

#include <cuda_runtime.h>

namespace dag_masks {

typedef unsigned long long u64;

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

__device__ __forceinline__ bool bit(u64 mask, int i) {
  return (mask >> i) & 1ull;
}

// all n low bits set
__device__ __forceinline__ u64 low_mask(int n) {
  return n >= 64 ? ~0ull : (1ull << n) - 1ull;
}

// Rows of a bool[rows, n] array into masks, one warp per row (the block's
// warps stride over the rows). blockDim.x must be a multiple of 32.
__device__ inline void load_masks(const unsigned char* __restrict__ src,
                                  int rows, int n, u64* dst) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int row = threadIdx.x >> 5; row < rows; row += warps) {
    const unsigned char* p = src + (long long)row * n;
    const unsigned lo = __ballot_sync(0xffffffffu, lane < n && p[lane]);
    const unsigned hi =
        __ballot_sync(0xffffffffu, lane + 32 < n && p[lane + 32]);
    if (lane == 0) dst[row] = (u64)lo | ((u64)hi << 32);
  }
}

// Masks back into a bool[rows, n] array, one thread per element.
__device__ inline void store_masks(const u64* src, int rows, int n,
                                   unsigned char* __restrict__ dst) {
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x)
    dst[i] = (unsigned char)bit(src[i / n], i % n);
}

// OR of a 64-bit value over the 32 lanes of a warp.
__device__ __forceinline__ u64 warp_or(u64 x) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)x);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(x >> 32));
  return (u64)lo | ((u64)hi << 32);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace dag_masks
