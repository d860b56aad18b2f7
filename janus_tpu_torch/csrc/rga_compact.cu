// rga_compact: the RGA's compaction of tombstoned leaves, one row per
// block, in place or into another state.
//
// Replaces: janus_tpu/models/rga.py compact (vmapped over replicas). Per
// row: slot i is a parent when some valid slot's (par_ctr, par_rep) equals
// i's (id_ctr, id_rep); keep = valid & (!dead | parent), ORed with valid &
// protect when a protect mask is given; the kept slots move to the front in
// their order (a stable partition), the rest are filled canonically
// (SENTINEL keys, zero payloads, dead and valid false). dead stays as it was
// on kept slots.
//
// What bounds it on the H100: bytes, if the parent test costs no more than
// reading the row. Each slot is read once and written once (22 bytes, plus
// one of protect): at the rga preset (R=1,024, K=128, C=1,024; 131,072
// rows) 2 x 2.95 GB, ~1.76 ms at 3.35 TB/s. JAX's parent test is a [C, C]
// compare matrix, 137 G compares per compaction at this shape; here it is a
// sort of the row's valid parent references and one binary search per slot,
// C log^2 C / 4 compare-swaps and C log C probes per row in shared memory.
//
// Design: one block per row (grid-stride), 256 threads. The row is staged
// in shared memory (so the output may alias the input); the valid slots'
// parent references are packed in slot order by a ballot prefix and sorted
// (slot_sort::block_sort; equal references are identical records); each
// slot searches its id among them; the keep flags are prefix-summed to
// place each kept slot. Launches on the caller's stream, allocates
// nothing, does not synchronise.
#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 256;

// (x, y) lexicographic
struct LessXY {
  __device__ bool operator()(const int4& a, const int4& b) const {
    if (a.x != b.x) return a.x < b.x;
    return a.y < b.y;
  }
};

struct Fields {
  int* f[5];  // id_ctr, id_rep, par_ctr, par_rep, chr
  unsigned char* dead;
  unsigned char* valid;
};

__global__ void __launch_bounds__(THREADS)
rga_compact_kernel(Fields in, Fields out, const unsigned char* protect,
                   long long rows, int C) {
  extern __shared__ int4 smem[];
  int4* ref = smem;                   // [C] parent references
  int* f = (int*)(ref + C);           // [5][C] the row
  int* place = f + 5 * C;             // [C] keep flags -> output slot
  unsigned char* dead = (unsigned char*)(place + C);
  unsigned char* valid = dead + C;
  unsigned char* keep = valid + C;
  const int tid = threadIdx.x;

  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * C;
    for (int c = tid; c < C; c += THREADS) {
#pragma unroll
      for (int k = 0; k < 5; ++k) f[k * C + c] = in.f[k][base + c];
      dead[c] = in.dead[base + c];
      valid[c] = in.valid[base + c];
      keep[c] = protect ? protect[base + c] : 0;
    }
    __syncthreads();
    // the valid slots' parent references, packed
    int m = 0;
    for (int c0 = 0; c0 < C; c0 += THREADS) {
      const int c = c0 + tid;
      const bool v = c < C && valid[c];
      int n;
      const int at = block_count_before(v, &n);
      if (v) ref[m + at] = make_int4(f[2 * C + c], f[3 * C + c], 0, 0);
      m += n;
    }
    __syncthreads();
    block_sort(ref, m, LessXY());
    for (int c = tid; c < C; c += THREADS) {
      bool k = false;
      if (valid[c]) {
        k = !dead[c] || keep[c];
        if (!k) {
          const int4 id = make_int4(f[c], f[C + c], 0, 0);
          int lo = 0, hi = m;  // first reference not below the id
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (LessXY()(ref[mid], id)) lo = mid + 1; else hi = mid;
          }
          k = lo < m && ref[lo].x == id.x && ref[lo].y == id.y;
        }
      }
      keep[c] = k;
      place[c] = k;
    }
    __syncthreads();
    const int kept = block_exclusive_scan(place, C);
    for (int c = tid; c < C; c += THREADS) {
      if (!keep[c]) continue;
      const long long at = base + place[c];
#pragma unroll
      for (int k = 0; k < 5; ++k) out.f[k][at] = f[k * C + c];
      out.dead[at] = dead[c] != 0;
      out.valid[at] = 1;
    }
    for (int s = kept + tid; s < C; s += THREADS) {
      const long long at = base + s;
      out.f[0][at] = SENT;
      out.f[1][at] = SENT;
      out.f[2][at] = 0;
      out.f[3][at] = 0;
      out.f[4][at] = 0;
      out.dead[at] = 0;
      out.valid[at] = 0;
    }
    __syncthreads();
  }
}

Fields fields_of(void* const* p) {
  return Fields{{(int*)p[0], (int*)p[1], (int*)p[2], (int*)p[3], (int*)p[4]},
                (unsigned char*)p[5], (unsigned char*)p[6]};
}

}  // namespace

// in, out: seven field pointers (id_ctr, id_rep, par_ctr, par_rep, chr
// int32; dead, valid bool) of [rows, C]; out may equal in. protect: bool
// [rows, C] or null. Contiguous on one device. Returns the launch's CUDA
// error.
extern "C" int rga_compact_launch(void* const* in, void* const* out,
                                  const void* protect, long long rows, int C,
                                  void* stream) {
  if (rows <= 0 || C <= 0) return (int)cudaSuccess;
  const size_t bytes = (size_t)C * (sizeof(int4) + 6 * sizeof(int) + 3);
  cudaError_t err = allow_shared(rga_compact_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = rows < 132LL * 64 ? rows : 132LL * 64;
  rga_compact_kernel<<<(unsigned)grid, THREADS, bytes,
                       (cudaStream_t)stream>>>(
      fields_of(in), fields_of(out), (const unsigned char*)protect, rows, C);
  return (int)cudaGetLastError();
}
