// edge_mask: the 2P2P Graph's dangling-edge filter, per key row: the live
// edges whose two endpoints are both live vertices.
//
// Replaces: janus_tpu/models/graph.py edge_mask (209-221), the
// [..., K, CE, CV] broadcast membership test behind edge_count and
// contains_edge (the reference's LookupEdges filter, TPTPGraph.cs:139-154).
// Per row: vset[j] = v[j] where vertex slot j is valid and not
// tombstoned, else INT32_MAX; edge slot c is marked iff it is valid, not
// tombstoned, and both src[c] and dst[c] equal some vset[j]. As in JAX, an
// endpoint equal to INT32_MAX matches a slot that holds no live vertex, so
// a live edge with such an endpoint counts as live whenever its row has one
// (interned ids never reach that value; the port gives the same answer).
//
// What bounds it on the H100: bytes. A row needs every slot's valid flag
// and writes CE bytes (CV + 2 CE bytes); only a valid slot's tombstone, a
// live vertex's id and a live edge's two endpoints are read beyond that
// (1, 4 and 8 bytes), so the bytes follow how full the rows are: 2,784
// bytes a row with every slot live at CV = 32, CE = 256, 544 with none.
// The membership test is at most 2 CV int32 compares a live edge.
//
// Design: one 128-thread block per row (grid-stride over rows) stages
// vset in shared memory; each thread takes edge slots c = tid, tid + 128,
// ... and scans vset for both endpoints (every thread reads the same
// vset[j] at once: a broadcast), stopping once both are found. Launches on
// the caller's stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>
#include <limits.h>

#include "slot_sort.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
edge_mask_kernel(const int* __restrict__ v,
                 const unsigned char* __restrict__ v_removed,
                 const unsigned char* __restrict__ v_valid,
                 const int* __restrict__ src, const int* __restrict__ dst,
                 const unsigned char* __restrict__ e_removed,
                 const unsigned char* __restrict__ e_valid,
                 unsigned char* __restrict__ out, long long rows, int CV,
                 int CE) {
  extern __shared__ int vset[];
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long vb = r * CV, eb = r * CE;
    for (int j = threadIdx.x; j < CV; j += THREADS)
      vset[j] = v_valid[vb + j] && !v_removed[vb + j] ? v[vb + j] : INT_MAX;
    __syncthreads();
    for (int c = threadIdx.x; c < CE; c += THREADS) {
      bool mark = e_valid[eb + c] && !e_removed[eb + c];
      if (mark) {
        const int s = src[eb + c], d = dst[eb + c];
        bool hs = false, hd = false;
        for (int j = 0; j < CV && !(hs && hd); ++j) {
          const int x = vset[j];
          hs |= x == s;
          hd |= x == d;
        }
        mark = hs && hd;
      }
      out[eb + c] = mark;
    }
    __syncthreads();
  }
}

}  // namespace

// fields: seven pointers (v int32, v_removed, v_valid bool of [rows, CV];
// src, dst int32, e_removed, e_valid bool of [rows, CE]); out: bool
// [rows, CE]. Contiguous on one device. Returns the launch's CUDA error.
extern "C" int edge_mask_launch(const void* const* f, void* out,
                                long long rows, int CV, int CE,
                                void* stream) {
  if (rows <= 0 || CE <= 0) return (int)cudaSuccess;
  const size_t bytes = (size_t)CV * sizeof(int);
  cudaError_t err = slot_sort::allow_shared(edge_mask_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = rows < 132LL * 16 ? rows : 132LL * 16;
  edge_mask_kernel<<<(unsigned)grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const int*)f[0], (const unsigned char*)f[1],
      (const unsigned char*)f[2], (const int*)f[3], (const int*)f[4],
      (const unsigned char*)f[5], (const unsigned char*)f[6],
      (unsigned char*)out, rows, CV, CE);
  return (int)cudaGetLastError();
}
