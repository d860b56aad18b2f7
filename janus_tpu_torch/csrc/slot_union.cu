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
__global__ void slot_union_kernel(Slots a, Slots b, OutSlots out,
                                  int* __restrict__ overflow, long long rows,
                                  int ca, int cb, int cap, int repeat) {
  extern __shared__ int4 smem[];
  const int n = ca + cb;
  int4* rec = smem;                       // [n]
  int* elem = (int*)(rec + n);            // [n] by position
  int* place = elem + n;                  // [n] kept flags -> output slot
  const long long plane = rows * (long long)cap;

  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const bool in_a = i < ca;
      const long long at = in_a ? row * ca + i : row * cb + (i - ca);
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
        const long long at = p * plane + row * cap + slot;
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
        const long long at = p * plane + row * cap + slot;
        out.rep[at] = SENT;
        out.ctr[at] = SENT;
        out.elem[at] = 0;
        out.removed[at] = 0;
        out.valid[at] = 0;
      }
    }
    if (threadIdx.x == 0) overflow[row] = kept > cap ? kept - cap : 0;
    __syncthreads();
  }
}

}  // namespace

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
  Slots a{(const int*)a_rep, (const int*)a_ctr, (const int*)a_elem,
          (const unsigned char*)a_removed, (const unsigned char*)a_valid};
  Slots b{(const int*)b_rep, (const int*)b_ctr, (const int*)b_elem,
          (const unsigned char*)b_removed, (const unsigned char*)b_valid};
  OutSlots out{(int*)o_rep, (int*)o_ctr, (int*)o_elem,
               (unsigned char*)o_removed, (unsigned char*)o_valid};
  slot_union_kernel<<<(unsigned)grid, 256, bytes, (cudaStream_t)stream>>>(
      a, b, out, (int*)overflow, rows, ca, cb, cap, repeat);
  return (int)cudaGetLastError();
}
