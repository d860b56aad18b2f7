// slot_union: the sorted union of two OR-Set slot sets, one row per block.
//
// Replaces: janus_tpu/ops/setops.py slot_union with the OR-Set fold
// (janus_tpu/models/orset.py _combine), the join of OR-Set merge and of
// the replica-axis converge (store.join_all's halving tree). Per row: the
// Ca + Cb records sorted stably by (tag_rep, tag_ctr), invalid slots keyed
// SENTINEL; a record that repeats the valid tag of the record before it is
// a duplicate and is dropped, and a kept record ORs its tombstone with the
// record right after it when that one is a duplicate (elem stays the kept
// copy's); the kept records fill the output in order, cut to `cap`, the
// rest canonical (SENTINEL keys, zero payloads); overflow = kept - cap.
//
// What bounds it on the H100: bytes. A row reads (Ca + Cb) x 14 bytes and
// writes cap x 14 bytes per output replica; at the converge of 64 replicas
// x 500 keys x 256 slots (114.7 MB of state) the halving tree reads about
// 2 x 114.7 MB and writes 114.7 MB into its levels, then 114.7 MB into the
// replicas, ~0.13 ms of traffic at 3.35 TB/s. The sort is
// (Ca + Cb) log^2 (Ca + Cb) / 4 compare-swaps per row in shared memory.
//
// Design: one block per row (grid-stride over rows). The records (tag,
// position, valid and tombstone bits) and the elems are staged in shared
// memory, so every read of the inputs happens before any write: the
// output may alias an input row (the converge writes the last level into
// the replicas it read). The sort is slot_sort::block_sort on (rep, ctr,
// position), which is the stable order; the kept flags are prefix-summed
// in shared memory to place each kept record. With `repeat` > 1 the row is
// written into each of `repeat` output replicas (the converge's
// broadcast). Launches on the caller's stream, allocates nothing, does not
// synchronise.
//
// Row-list mode (slot_union_rows_launch): replaces converge_delta's slab
// path for the OR-Set (store.py:114-121: gather the listed key rows into
// an [R, D, C] slab, join_all's halving tree, scatter back into every
// replica). The tree runs as in the full converge, but each level joins
// only the listed rows: level 1 reads them straight from the [R, K, C]
// state, the middle levels work in [pairs, K, C] scratch, and the last
// level writes each joined row into all R replicas at its key. How many
// rows to join is read from device memory (delta_select's n_join: the
// dirty count, or every key on overflow); the grid is one wave and blocks
// past that number exit. When R == 2 level 1 is also the last and writes
// the rows it read: a block stages its row before writing, and listed rows
// are distinct, so no block reads a row another block writes. Bound at
// mixed_delta (R=64, C=256) per listed row: level 1 reads 64 and writes
// 32 rows of 3,584 bytes, 344 KB, the whole tree ~2 x 126 rows, 903 KB.
#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

struct Slots {
  const int* rep;
  const int* ctr;
  const int* elem;
  const unsigned char* removed;
  const unsigned char* valid;
};

struct OutSlots {
  int* rep;
  int* ctr;
  int* elem;
  unsigned char* removed;
  unsigned char* valid;
};

// record: x = rep, y = ctr (SENTINEL when invalid), z = position in the
// concatenation, w = valid | removed << 1
//
// The union of row `a_at` of a (ca slots) and row `b_at` of b (cb slots),
// written at out + out_at + p * out_plane for p < repeat. Every thread of
// the block calls it. Returns the kept count (before the cut to cap).
__device__ int union_row(const Slots& a, long long a_at, const Slots& b,
                         long long b_at, const OutSlots& out, long long out_at,
                         long long out_plane, int repeat, int ca, int cb,
                         int cap) {
  extern __shared__ int4 smem[];
  const int n = ca + cb;
  int4* rec = smem;                       // [n]
  int* elem = (int*)(rec + n);            // [n] by position
  int* place = elem + n;                  // [n] kept flags -> output slot

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool in_a = i < ca;
    const long long at = in_a ? a_at + i : b_at + (i - ca);
    const bool v = (in_a ? a.valid : b.valid)[at];
    const bool rm = (in_a ? a.removed : b.removed)[at];
    rec[i] = make_int4(v ? (in_a ? a.rep : b.rep)[at] : SENT,
                       v ? (in_a ? a.ctr : b.ctr)[at] : SENT, i,
                       (int)v | ((int)rm << 1));
    elem[i] = (in_a ? a.elem : b.elem)[at];
  }
  __syncthreads();
  block_sort(rec, n, LessXYZ());

  // kept: valid and not a repeat of the valid tag before it
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int4 r = rec[i];
    bool keep = r.w & 1;
    if (keep && i > 0) {
      const int4 q = rec[i - 1];
      keep = !((q.w & 1) && q.x == r.x && q.y == r.y);
    }
    place[i] = keep;
  }
  __syncthreads();
  // keep flags are re-derived below; place[] becomes the output slot
  const int kept = block_exclusive_scan(place, n);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int4 r = rec[i];
    if (!(r.w & 1)) continue;
    if (i > 0) {
      const int4 q = rec[i - 1];
      if ((q.w & 1) && q.x == r.x && q.y == r.y) continue;  // a duplicate
    }
    const int slot = place[i];
    if (slot >= cap) continue;
    bool rm = (r.w >> 1) & 1;
    if (i + 1 < n) {
      const int4 nx = rec[i + 1];
      if ((nx.w & 1) && nx.x == r.x && nx.y == r.y) rm |= (nx.w >> 1) & 1;
    }
    const int e = elem[r.z];
    for (int p = 0; p < repeat; ++p) {
      const long long at = p * out_plane + out_at + slot;
      out.rep[at] = r.x;
      out.ctr[at] = r.y;
      out.elem[at] = e;
      out.removed[at] = rm;
      out.valid[at] = 1;
    }
  }
  for (int slot = min(kept, cap) + threadIdx.x; slot < cap;
       slot += blockDim.x) {
    for (int p = 0; p < repeat; ++p) {
      const long long at = p * out_plane + out_at + slot;
      out.rep[at] = SENT;
      out.ctr[at] = SENT;
      out.elem[at] = 0;
      out.removed[at] = 0;
      out.valid[at] = 0;
    }
  }
  __syncthreads();
  return kept;
}

__global__ void slot_union_kernel(Slots a, Slots b, OutSlots out,
                                  int* __restrict__ overflow, long long rows,
                                  int ca, int cb, int cap, int repeat) {
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const int kept = union_row(a, row * ca, b, row * cb, out, row * cap,
                               rows * (long long)cap, repeat, ca, cb, cap);
    if (threadIdx.x == 0) overflow[row] = kept > cap ? kept - cap : 0;
  }
}

// Row-list mode: virtual row v = j * pairs + r joins key row
// `gather ? rows[j] : j` of pair r of a and b ([pairs, num_keys, c] each)
// for j < n_join (read from device memory, clamped to `listed`). Without
// `scatter` the result goes to out[r, j] ([pairs, num_keys, c] scratch);
// with it (pairs == 1) to out[p, rows[j]] for every p < repeat, the
// replicas of the state.
__global__ void slot_union_rows_kernel(Slots a, Slots b, OutSlots out,
                                       const int* __restrict__ rows,
                                       int listed,
                                       const int* __restrict__ n_rows,
                                       int pairs, int num_keys, int c,
                                       int gather, int scatter, int repeat) {
  int m = *n_rows;
  m = m < 0 ? 0 : (m > listed ? listed : m);
  const long long total = (long long)m * pairs;
  const long long plane = (long long)num_keys * c;
  for (long long v = blockIdx.x; v < total; v += gridDim.x) {
    const int j = (int)(v / pairs);
    const long long r = v % pairs;
    const int k = rows[j];
    if (k < 0 || k >= num_keys) continue;  // uniform across the block
    const long long in_at = (r * num_keys + (gather ? k : j)) * c;
    const long long out_at = scatter ? (long long)k * c
                                     : (r * num_keys + j) * c;
    union_row(a, in_at, b, in_at, out, out_at, plane, scatter ? repeat : 1,
              c, c, c);
  }
}

}  // namespace

static inline Slots in_slots(const void* rep, const void* ctr,
                             const void* elem, const void* removed,
                             const void* valid) {
  return Slots{(const int*)rep, (const int*)ctr, (const int*)elem,
               (const unsigned char*)removed, (const unsigned char*)valid};
}

static inline OutSlots out_slots(void* rep, void* ctr, void* elem,
                                 void* removed, void* valid) {
  return OutSlots{(int*)rep, (int*)ctr, (int*)elem, (unsigned char*)removed,
                  (unsigned char*)valid};
}

// a_*: [rows, ca], b_*: [rows, cb], out_*: [repeat, rows, cap] (int32 tags
// and elem, bool removed and valid), overflow int32[rows]; contiguous on
// one device. The outputs may alias the inputs row for row. Returns the
// launch's CUDA error.
extern "C" int slot_union_launch(
    const void* a_rep, const void* a_ctr, const void* a_elem,
    const void* a_removed, const void* a_valid, const void* b_rep,
    const void* b_ctr, const void* b_elem, const void* b_removed,
    const void* b_valid, void* o_rep, void* o_ctr, void* o_elem,
    void* o_removed, void* o_valid, void* overflow, long long rows, int ca,
    int cb, int cap, int repeat, void* stream) {
  if (rows <= 0 || repeat <= 0) return (int)cudaSuccess;
  const int n = ca + cb;
  const size_t bytes = (size_t)n * (sizeof(int4) + 2 * sizeof(int)) + 16;
  cudaError_t err = allow_shared(slot_union_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = rows < 132LL * 64 ? rows : 132LL * 64;
  slot_union_kernel<<<(unsigned)grid, 256, bytes, (cudaStream_t)stream>>>(
      in_slots(a_rep, a_ctr, a_elem, a_removed, a_valid),
      in_slots(b_rep, b_ctr, b_elem, b_removed, b_valid),
      out_slots(o_rep, o_ctr, o_elem, o_removed, o_valid), (int*)overflow,
      rows, ca, cb, cap, repeat);
  return (int)cudaGetLastError();
}

// Row-list mode. a_*, b_*: [pairs, num_keys, c]; out_*: [pairs, num_keys,
// c], or with `scatter` [repeat, num_keys, c] (pairs == 1); rows:
// int32[listed] distinct keys in [0, num_keys) (others are skipped);
// n_rows: int32[] on the device. Contiguous on one device; with `gather`
// and `scatter` the outputs alias the inputs row for row. Returns the
// launch's CUDA error.
extern "C" int slot_union_rows_launch(
    const void* a_rep, const void* a_ctr, const void* a_elem,
    const void* a_removed, const void* a_valid, const void* b_rep,
    const void* b_ctr, const void* b_elem, const void* b_removed,
    const void* b_valid, void* o_rep, void* o_ctr, void* o_elem,
    void* o_removed, void* o_valid, const void* rows, int listed,
    const void* n_rows, int pairs, int num_keys, int c, int gather,
    int scatter, int repeat, void* stream) {
  if (listed <= 0 || pairs <= 0 || repeat <= 0 || c <= 0)
    return (int)cudaSuccess;
  const size_t bytes = (size_t)(2 * c) * (sizeof(int4) + 2 * sizeof(int)) + 16;
  cudaError_t err = allow_shared(slot_union_rows_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  // one wave of 8 blocks per SM; blocks past the rows to join exit at once
  const long long most = (long long)listed * pairs;
  const long long grid = most < 132LL * 8 ? most : 132LL * 8;
  slot_union_rows_kernel<<<(unsigned)grid, 256, bytes,
                           (cudaStream_t)stream>>>(
      in_slots(a_rep, a_ctr, a_elem, a_removed, a_valid),
      in_slots(b_rep, b_ctr, b_elem, b_removed, b_valid),
      out_slots(o_rep, o_ctr, o_elem, o_removed, o_valid),
      (const int*)rows, listed, (const int*)n_rows, pairs, num_keys, c,
      gather, scatter, repeat);
  return (int)cudaGetLastError();
}
