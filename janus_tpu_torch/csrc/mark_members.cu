// mark_members: membership of two-part int32 keys in a masked query set.
//
// Replaces: janus_tpu/ops/setops.py mark_members (a sort-merge over M + T
// records), the protection test of janus_tpu/models/rga.py compact_fence.
// out[i] is true where A record i's key (a1[i], a2[i]) equals the key
// (b1[j], b2[j]) of some query j whose b_valid[j] is set; equality is
// exact, so duplicates and keys at SENTINEL are ordinary keys.
//
// What bounds it on the H100: bytes. The function reads each A key (8
// bytes) and each query (9 bytes) once and writes one byte per A record:
// at the rga_consensus geometry's fence (4 views x 128 documents x 1,024
// slots per state, M = 524,288; T = 2 x 8 x 4 x 1,024 = 65,536 queries)
// ~5.3 MB, ~1.6 us at 3.35 TB/s.
//
// Design: two launches. (1) One block per chunk of CHUNK queries packs the
// valid ones as 64-bit keys (k1 << 32 | k2, compared unsigned) in order by
// a ballot prefix, sorts them in shared memory (slot_sort::block_sort) and
// writes the sorted chunk and its count to scratch. (2) Each block takes
// tiles of TILE A records (PER a thread, in registers), stages each sorted
// chunk in shared memory in turn and binary-searches every record still
// unmarked in it. T has no limit: the chunks are as many as T needs, and
// every A tile reads them all once (T x 8 bytes from L2). Launches on the
// caller's stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;
constexpr int PER = 8;
constexpr int TILE = THREADS * PER;

using u64 = unsigned long long;

struct LessU64 {
  __device__ bool operator()(u64 a, u64 b) const { return a < b; }
};

__device__ __forceinline__ u64 pack(int k1, int k2) {
  return ((u64)(unsigned)k1 << 32) | (u64)(unsigned)k2;
}

__global__ void __launch_bounds__(THREADS)
sort_chunks(const int* __restrict__ b1, const int* __restrict__ b2,
            const unsigned char* __restrict__ valid, long long T,
            u64* __restrict__ sorted, int* __restrict__ counts) {
  __shared__ u64 s[CHUNK];
  const long long base = (long long)blockIdx.x * CHUNK;
  const int len = (int)(T - base < CHUNK ? T - base : CHUNK);
  int n = 0;
  for (int i0 = 0; i0 < len; i0 += THREADS) {
    const int i = i0 + threadIdx.x;
    const bool v = i < len && valid[base + i];
    int total;
    const int at = block_count_before(v, &total);
    if (v) s[n + at] = pack(b1[base + i], b2[base + i]);
    n += total;
  }
  __syncthreads();
  block_sort(s, n, LessU64());
  for (int i = threadIdx.x; i < n; i += THREADS) sorted[base + i] = s[i];
  if (threadIdx.x == 0) counts[blockIdx.x] = n;
}

__global__ void __launch_bounds__(THREADS)
probe(const int* __restrict__ a1, const int* __restrict__ a2, long long M,
      const u64* __restrict__ sorted, const int* __restrict__ counts,
      int chunks, unsigned char* __restrict__ out) {
  __shared__ u64 s[CHUNK];
  const int tid = threadIdx.x;
  for (long long t0 = (long long)blockIdx.x * TILE; t0 < M;
       t0 += (long long)gridDim.x * TILE) {
    u64 key[PER];
    bool hit[PER];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const long long i = t0 + p * THREADS + tid;
      key[p] = i < M ? pack(a1[i], a2[i]) : 0;
      hit[p] = false;
    }
    for (int c = 0; c < chunks; ++c) {
      const int n = counts[c];
      __syncthreads();  // every thread is done with the previous chunk
      for (int i = tid; i < n; i += THREADS)
        s[i] = sorted[(long long)c * CHUNK + i];
      __syncthreads();
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        if (hit[p]) continue;
        int lo = 0, hi = n;  // the first key not below the record's
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s[mid] < key[p]) lo = mid + 1; else hi = mid;
        }
        hit[p] = lo < n && s[lo] == key[p];
      }
    }
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const long long i = t0 + p * THREADS + tid;
      if (i < M) out[i] = hit[p];
    }
  }
}

}  // namespace

// a1, a2: int32 [M]; b1, b2: int32 [T]; b_valid: bool [T]; sorted: int64
// scratch [ceil(T / CHUNK) * CHUNK]; counts: int32 scratch [ceil(T /
// CHUNK)]; out: bool [M]. Contiguous on one device. Returns the first CUDA
// error of the two launches.
extern "C" int mark_members_launch(const void* a1, const void* a2,
                                   long long M, const void* b1,
                                   const void* b2, const void* b_valid,
                                   long long T, void* sorted, void* counts,
                                   void* out, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  const long long chunks = (T + CHUNK - 1) / CHUNK;
  cudaStream_t s = (cudaStream_t)stream;
  if (chunks > 0) {
    sort_chunks<<<(unsigned)chunks, THREADS, 0, s>>>(
        (const int*)b1, (const int*)b2, (const unsigned char*)b_valid, T,
        (u64*)sorted, (int*)counts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long tiles = (M + TILE - 1) / TILE;
  const long long grid = tiles < 132LL * 8 ? tiles : 132LL * 8;
  probe<<<(unsigned)grid, THREADS, 0, s>>>(
      (const int*)a1, (const int*)a2, M, (const u64*)sorted,
      (const int*)counts, (int)chunks, (unsigned char*)out);
  return (int)cudaGetLastError();
}
