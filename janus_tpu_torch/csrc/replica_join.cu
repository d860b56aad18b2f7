// replica_join: full anti-entropy of the PN-Counter as a hand kernel for
// Hopper. Every replica row of P and N is set, in place, to the max over
// the replica axis.
//
// Replaces: janus_tpu/runtime/store.py converge (join_all's halving tree of
// pncounter.merge = lattice.join_max over the replica axis, then a
// broadcast of the joined [K, W] state to all R rows).
//
// What bounds it on the H100: bytes. Each of P and N is read once and
// written once: at R=256, K=1024, W=256 that is 2 x 256 MiB each way,
// about 1.07 GB, or ~0.32 ms at 3.35 TB/s. The max itself is one integer
// op per element read.
//
// Design: one thread per 16-byte vector (four int32) of a row when the row
// length allows it, else one per int32. Thread t reads element t of every
// replica row in turn, so neighbouring threads touch neighbouring
// addresses on every load; the R loads of a thread are independent and
// unrolled, which keeps many requests in flight. The max lives in
// registers and is written back R times. blockIdx.y picks P or N, so both
// polarities share one launch; with N null the launch joins P alone (the
// RGA's [R, K] Lamport floor, ctr_floor). Max is exact, so the result is bit-equal to
// the halving tree. Launches on the caller's stream, allocates nothing,
// does not synchronise.
//
// Row-list mode (replica_join_rows_launch): replaces converge_delta's slab
// path for the PN-Counter (store.py:114-121: gather the listed key rows
// into an [R, D, W] slab, join_all, scatter the joined rows back into
// every replica). Each thread takes one vector of one listed key row, maxes
// it over the R replicas and writes it back into all R, in place: the
// gather, the join and the scatter in one pass. The number of listed rows
// to join is read from device memory (delta_select's n_join: the dirty
// count, or every key on overflow), so the grid covers every key and the
// threads past that number do nothing. Bound: 2 x R x n_join x W x 4
// bytes each way; at mixed_delta (R=64, W=64) and 32 dirty rows ~1 MB,
// ~0.0003 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }

__device__ __forceinline__ int4 vmax(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z),
                   max(a.w, b.w));
}

template <typename V>
__global__ void replica_join_kernel(V* __restrict__ p, V* __restrict__ n,
                                    long long replicas, long long row) {
  V* x = blockIdx.y == 0 ? p : n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < row; e += stride) {
    V m = x[e];
#pragma unroll 8
    for (long long r = 1; r < replicas; ++r) m = vmax(m, x[r * row + e]);
#pragma unroll 8
    for (long long r = 0; r < replicas; ++r) x[r * row + e] = m;
  }
}

template <typename V>
int launch(void* p, void* n, long long replicas, long long row,
           cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (row + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  replica_join_kernel<V><<<dim3((unsigned)blocks, n ? 2 : 1), threads, 0,
                           stream>>>(
      (V*)p, (V*)n, replicas, row);
  return (int)cudaGetLastError();
}

template <typename V>
__global__ void replica_join_rows_kernel(V* __restrict__ p, V* __restrict__ n,
                                         long long replicas, int num_keys,
                                         long long row,
                                         const int* __restrict__ rows,
                                         int listed,
                                         const int* __restrict__ n_rows) {
  V* x = blockIdx.y == 0 ? p : n;
  int m = *n_rows;
  m = m < 0 ? 0 : (m > listed ? listed : m);
  const long long plane = (long long)num_keys * row;
  const long long total = (long long)m * row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int k = rows[e / row];
    if (k < 0 || k >= num_keys) continue;
    const long long at = (long long)k * row + e % row;
    V m_ = x[at];
#pragma unroll 8
    for (long long r = 1; r < replicas; ++r) m_ = vmax(m_, x[r * plane + at]);
#pragma unroll 8
    for (long long r = 0; r < replicas; ++r) x[r * plane + at] = m_;
  }
}

template <typename V>
int launch_rows(void* p, void* n, long long replicas, int num_keys,
                long long row, const int* rows, int listed, const int* n_rows,
                cudaStream_t stream) {
  const int threads = 256;
  long long blocks = ((long long)listed * row + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  if (blocks < 1) blocks = 1;
  replica_join_rows_kernel<V><<<dim3((unsigned)blocks, n ? 2 : 1), threads,
                                0, stream>>>((V*)p, (V*)n, replicas, num_keys,
                                          row, rows, listed, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// p, n: int32[R, K, E] (E int32 per key row); rows: int32[listed] distinct
// keys in [0, K) (others are skipped); n_rows: int32[] on the device, the
// count of listed rows to join. Contiguous on one device. Returns the
// launch's CUDA error.
extern "C" int replica_join_rows_launch(void* p, void* n, long long replicas,
                                        int num_keys, long long row,
                                        const void* rows, int listed,
                                        const void* n_rows, void* stream) {
  if (replicas <= 0 || row <= 0 || listed <= 0) return (int)cudaSuccess;
  const bool vec = row % 4 == 0 && (uintptr_t)p % 16 == 0 &&
                   (uintptr_t)n % 16 == 0;  // n may be null: one operand
  if (vec)
    return launch_rows<int4>(p, n, replicas, num_keys, row / 4,
                             (const int*)rows, listed, (const int*)n_rows,
                             (cudaStream_t)stream);
  return launch_rows<int>(p, n, replicas, num_keys, row, (const int*)rows,
                          listed, (const int*)n_rows, (cudaStream_t)stream);
}

// p, n: int32[R, E] (E = K*W), contiguous on one device. Returns
// cudaGetLastError() after the launch.
extern "C" int replica_join_launch(void* p, void* n, long long replicas,
                                   long long row, void* stream) {
  if (replicas <= 0 || row <= 0) return (int)cudaSuccess;
  const bool vec = row % 4 == 0 && (uintptr_t)p % 16 == 0 &&
                   (uintptr_t)n % 16 == 0;  // n may be null: one operand
  if (vec)
    return launch<int4>(p, n, replicas, row / 4, (cudaStream_t)stream);
  return launch<int>(p, n, replicas, row, (cudaStream_t)stream);
}
