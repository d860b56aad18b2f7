// Helpers shared by the consensus kernels (tusk_commit, causal_closure,
// dag_round, gc_frontier): DAG rows held as 64-bit masks over nodes, and
// int32 round arithmetic with the semantics of XLA and torch.
//
// A bool[rows, n] tensor (n <= 64) becomes `rows` masks; bit t of mask i
// is element [i, t]: a warp a row (load_masks), a thread a row by the
// widest loads the row allows (load_row, and store_row back), or one
// flat bit array, bit i its element i, from which row r's mask is a
// 64-bit window (row_bits). transpose32 turns a warp's rows of a 32 x 32
// bit matrix into its columns. Round numbers are int32 that may wrap:
// sums and products go through uint32 (signed overflow is undefined in
// C++), and the ring slot of a round is the floor modulo, as `%` is in
// JAX and torch (C++ `%` truncates toward zero).
#pragma once

#include <cuda_runtime.h>

namespace dag_masks {

typedef unsigned long long u64;

// the most nodes a kernel takes: a row is one 64-bit mask
constexpr int MAX_N = 64;

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

// bit k of the result: byte k of x is not zero
__device__ __forceinline__ unsigned nibble(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// words of the flat bit array of `len` bool, with two words of padding
// (a row's window reads up to two words past its first)
__host__ __device__ __forceinline__ int bit_words(int len) {
  return ((len + 31) >> 5) + 2;
}

// row r of a bool[rows, n] array held as flat bits: its mask over n <= 64
__device__ __forceinline__ u64 row_bits(const unsigned* b, int r, int n) {
  const int at = r * n, q = at >> 5, sh = at & 31;
  u64 x = ((u64)b[q] | ((u64)b[q + 1] << 32)) >> sh;
  if (sh) x |= (u64)b[q + 2] << (64 - sh);
  return x & low_mask(n);
}

// a row of n bool at p as a mask: 16-byte loads where n is a multiple of
// 16 and p aligned, 4-byte ones where n is a multiple of 4 and p aligned,
// else a byte at a time
__device__ __forceinline__ u64 load_row(const unsigned char* p, int n) {
  if (!p) return 0;
  u64 x = 0;
  if ((n & 15) == 0 && ((size_t)p & 15) == 0) {
    uint4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (16 * i < n) v[i] = __ldg((const uint4*)p + i);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (16 * i < n)
        x |= (u64)(nibble(v[i].x) | nibble(v[i].y) << 4 | nibble(v[i].z) << 8 |
                   nibble(v[i].w) << 12) << (16 * i);
  } else if ((n & 3) == 0 && ((size_t)p & 3) == 0) {
    for (int i = 0; i < n; i += 4)
      x |= (u64)nibble(__ldg((const unsigned*)(p + i))) << i;
  } else {
    for (int i = 0; i < n; ++i) x |= (u64)(__ldg(p + i) != 0) << i;
  }
  return x;
}

// four bits of a nibble, a byte each (0 or 1)
__device__ __forceinline__ unsigned spread4(unsigned nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// a mask back into a row of n bool at p (stores as wide as load_row's)
__device__ __forceinline__ void store_row(unsigned char* p, int n, u64 x) {
  if ((n & 15) == 0 && ((size_t)p & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (16 * i < n) {
        const unsigned b = (unsigned)(x >> (16 * i));
        ((uint4*)p)[i] = make_uint4(spread4(b & 15u), spread4(b >> 4 & 15u),
                                    spread4(b >> 8 & 15u),
                                    spread4(b >> 12 & 15u));
      }
  } else if ((n & 3) == 0 && ((size_t)p & 3) == 0) {
    for (int i = 0; i < n; i += 4)
      *(unsigned*)(p + i) = spread4((unsigned)(x >> i) & 15u);
  } else {
    for (int i = 0; i < n; ++i) p[i] = (unsigned char)(x >> i & 1ull);
  }
}

// lane i's row i of a 32 x 32 bit matrix in, its column i out
__device__ __forceinline__ unsigned transpose32(unsigned x) {
  const int lane = threadIdx.x & 31;
  unsigned m = 0x0000ffffu;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1, m ^= m << j) {
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, j);
    x = lane & j ? (x & ~m) | (y >> j & m) : (x & m) | (y << j & ~m);
  }
  return x;
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
