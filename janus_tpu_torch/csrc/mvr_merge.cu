// mvr_merge: the MVRegister's join of two states, one row per warp
// (mvr_merge_launch), and its row-list mode, one level of
// converge_delta's tree over listed key rows (mvr_merge_rows_launch).
//
// Replaces: janus_tpu/models/mvregister.py merge / merge_with_stats
// (139-181), the join of merge and of the replica-axis converge
// (store.join_all's halving tree, store.py:59-85), and the slab path of
// converge_delta (store.py:114-121). Per row: the va + vb entries (a's
// row, then b's) reduced to their causal frontier (mvr_frontier.cuh:
// strictly dominated entries and later exact twins dropped, the kept
// ordered by (val, clock lanes)), written into `cap` slots, the rest
// (SENTINEL, zero clock, invalid); overflow = kept - cap. Row-list mode
// pairs rows exactly as slot_union_rows does: virtual row v = j * pairs +
// r joins key row `gather ? rows[j] : j` of pair r for j < n_rows (read
// from device memory), written to out[r, j] or, with `scatter`, to
// out[p, rows[j]] for every replica p < repeat.
//
// What bounds it on the H100: bytes, by the card's rates, though not by
// much. A row moves (va + vb) (5 + 4W) bytes in and cap (5 + 4W) out per
// output replica, and the frontier compares every pair of entries over W
// lanes, twice (dominance, then rank): at the typed_store converge (64
// replicas x 500 keys, V = 8, W = 64, 66.8 MB of state) a level-1 row
// moves 6.3 KB and does ~2 x 16^2 x 64 = 32,768 int32 compares, ~5 a byte,
// under the card's ~20 int32 operations a byte. The tree moves about
// 4 x 66.8 MB, ~0.08 ms at 3.35 TB/s.
//
// Design: one warp per row, four warps a block, grid-stride. A warp stages
// its row's entries in its own shared memory (clocks W | 1 ints apart, so
// a lane per entry reads 32 banks), computes the frontier there and writes
// the output from it: every read of the inputs happens before any write,
// so the output may alias an input row (the converge writes the last
// level into the replicas it read). Clock rows are read and written with
// the warp's lanes across W, coalesced. Launches on the caller's stream,
// allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include "mvr_frontier.cuh"
#include "slot_sort.cuh"

namespace {

constexpr int WARPS = 4;

struct In {
  const int* val;
  const unsigned char* valid;
  const int* clock;
};

struct Out {
  int* val;
  unsigned char* valid;
  int* clock;
};

// shared bytes of one warp for n entries of w clock lanes
__host__ __device__ inline int warp_bytes(int n, int w) {
  const int bytes = 4 * (n * mvr::clock_ld(w) + 2 * n) + 2 * n;
  return (bytes + 15) & ~15;
}

// The frontier of row a_at of a (va slots) and row b_at of b (vb slots),
// written into cap slots at row out_at + p * out_plane of out for
// p < repeat. Every lane of the warp calls it. Returns the kept count.
__device__ int merge_row(const In& a, long long a_at, int va, const In& b,
                         long long b_at, int vb, const Out& out,
                         long long out_at, long long out_plane, int repeat,
                         int cap, int w, unsigned char* ws) {
  const int lane = threadIdx.x & 31;
  const int n = va + vb, ld = mvr::clock_ld(w);
  int* clock = (int*)ws;
  int* val = clock + n * ld;
  int* inv = val + n;
  unsigned char* valid = (unsigned char*)(inv + n);
  unsigned char* keep = valid + n;
  for (int i = lane; i < n; i += 32) {
    // select each field's pointer, not a whole In (see slot_union.cu)
    const bool in_a = i < va;
    const long long at = in_a ? a_at * va + i : b_at * vb + (i - va);
    val[i] = (in_a ? a.val : b.val)[at];
    valid[i] = (in_a ? a.valid : b.valid)[at];
  }
  for (int i = 0; i < n; ++i) {
    const bool in_a = i < va;
    const long long at = in_a ? a_at * va + i : b_at * vb + (i - va);
    const int* src = (in_a ? a.clock : b.clock) + at * w;
    for (int q = lane; q < w; q += 32) clock[i * ld + q] = src[q];
  }
  __syncwarp();
  const int kept = mvr::frontier(val, valid, clock, ld, n, w, cap, keep, inv);
  const int fill = kept < cap ? kept : cap;
  for (int rep = 0; rep < repeat; ++rep) {
    const long long row = rep * out_plane + out_at;
    for (int p = lane; p < cap; p += 32) {
      out.val[row * cap + p] = p < fill ? val[inv[p]] : mvr::SENT;
      out.valid[row * cap + p] = p < fill;
    }
    for (int p = 0; p < cap; ++p) {
      int* dst = out.clock + (row * cap + p) * w;
      const int* src = clock + (p < fill ? inv[p] : 0) * ld;
      for (int q = lane; q < w; q += 32) dst[q] = p < fill ? src[q] : 0;
    }
  }
  __syncwarp();
  return kept;
}

__global__ void __launch_bounds__(WARPS * 32)
mvr_merge_kernel(In a, In b, Out out, int* __restrict__ overflow,
                 long long rows, int va, int vb, int cap, int w, int repeat) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  unsigned char* ws = smem + warp * warp_bytes(va + vb, w);
  for (long long row = (long long)blockIdx.x * WARPS + warp; row < rows;
       row += (long long)gridDim.x * WARPS) {
    const int kept = merge_row(a, row, va, b, row, vb, out, row, rows,
                               repeat, cap, w, ws);
    if ((threadIdx.x & 31) == 0) overflow[row] = kept > cap ? kept - cap : 0;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
mvr_merge_rows_kernel(In a, In b, Out out, const int* __restrict__ rows,
                      int listed, const int* __restrict__ n_rows, int pairs,
                      int num_keys, int v, int w, int gather, int scatter,
                      int repeat) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  unsigned char* ws = smem + warp * warp_bytes(2 * v, w);
  int m = *n_rows;
  m = m < 0 ? 0 : (m > listed ? listed : m);
  const long long total = (long long)m * pairs;
  for (long long x = (long long)blockIdx.x * WARPS + warp; x < total;
       x += (long long)gridDim.x * WARPS) {
    const int j = (int)(x / pairs);
    const long long r = x % pairs;
    const int k = rows[j];
    if (k < 0 || k >= num_keys) continue;  // uniform across the warp
    const long long in_at = r * num_keys + (gather ? k : j);
    const long long out_at = scatter ? (long long)k : r * num_keys + j;
    merge_row(a, in_at, v, b, in_at, v, out, out_at, num_keys,
              scatter ? repeat : 1, v, w, ws);
  }
}

In in_of(const void* const* f) {
  return In{(const int*)f[0], (const unsigned char*)f[1], (const int*)f[2]};
}

Out out_of(void* const* f) {
  return Out{(int*)f[0], (unsigned char*)f[1], (int*)f[2]};
}

}  // namespace

// Each state is three field pointers: val (int32), valid (bool), clock
// (int32, a trailing axis of w lanes). a: [rows, va], b: [rows, vb], o:
// [repeat, rows, cap] (cap <= va + vb); overflow int32[rows]. Contiguous
// on one device; the outputs may alias the inputs row for row. Returns the
// launch's CUDA error.
extern "C" int mvr_merge_launch(const void* const* a, const void* const* b,
                                void* const* o, void* overflow,
                                long long rows, int va, int vb, int cap,
                                int w, int repeat, void* stream) {
  if (rows <= 0 || repeat <= 0) return (int)cudaSuccess;
  if (cap > va + vb || w < 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)WARPS * warp_bytes(va + vb, w);
  cudaError_t err = slot_sort::allow_shared(mvr_merge_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long want = (rows + WARPS - 1) / WARPS;
  const long long grid = want < 132LL * 64 ? want : 132LL * 64;
  mvr_merge_kernel<<<(unsigned)grid, WARPS * 32, bytes,
                     (cudaStream_t)stream>>>(in_of(a), in_of(b), out_of(o),
                                             (int*)overflow, rows, va, vb,
                                             cap, w, repeat);
  return (int)cudaGetLastError();
}

// Row-list mode. a, b: [pairs, num_keys, v]; o: [pairs, num_keys, v], or
// with `scatter` [repeat, num_keys, v] (pairs == 1); clocks with a
// trailing axis of w lanes; rows: int32[listed] distinct keys in
// [0, num_keys) (others are skipped); n_rows: int32[] on the device.
// Contiguous on one device; with `gather` and `scatter` the outputs alias
// the inputs row for row. Returns the launch's CUDA error.
extern "C" int mvr_merge_rows_launch(const void* const* a,
                                     const void* const* b, void* const* o,
                                     const void* rows, int listed,
                                     const void* n_rows, int pairs,
                                     int num_keys, int v, int w, int gather,
                                     int scatter, int repeat, void* stream) {
  if (listed <= 0 || pairs <= 0 || repeat <= 0 || v <= 0)
    return (int)cudaSuccess;
  const size_t bytes = (size_t)WARPS * warp_bytes(2 * v, w);
  cudaError_t err = slot_sort::allow_shared(mvr_merge_rows_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  // one wave of 8 blocks per SM; warps past the rows to join exit at once
  const long long want = ((long long)listed * pairs + WARPS - 1) / WARPS;
  const long long grid = want < 132LL * 8 ? want : 132LL * 8;
  mvr_merge_rows_kernel<<<(unsigned)grid, WARPS * 32, bytes,
                          (cudaStream_t)stream>>>(
      in_of(a), in_of(b), out_of(o), (const int*)rows, listed,
      (const int*)n_rows, pairs, num_keys, v, w, gather, scatter, repeat);
  return (int)cudaGetLastError();
}
