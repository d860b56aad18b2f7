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
// What bounds it on the H100: bytes. Each slot is read once and written
// once (22 bytes, plus one of protect): at the rga preset (R=1,024, K=128,
// C=1,024; 131,072 rows) 2 x 2.95 GB, ~1.76 ms at 3.35 TB/s. JAX's parent
// test is a [C, C] compare matrix, 137 G compares per compaction at this
// shape; here it is C binary searches of log2 C probes per row in shared
// memory, with no sort when the row's ids are sorted.
//
// Design: a persistent grid of 256-thread blocks, each walking rows
// (grid-stride). A row is staged in shared memory by cp.async (16-byte
// copies when every field is 16-byte aligned and C % 16 == 0), so the
// output may alias the input. The block first tests whether the row's ids
// (SENTINEL for an invalid slot) never descend in (id_ctr, id_rep), the
// test slot_union.cu's merge makes; every row the rga preset compacts is so
// (a union writes rows sorted, the compaction is a stable partition, an
// apply mints ids above every id of its row). Sorted row: each valid slot
// finds its parent reference among the row's ids by a lower bound and flags
// every slot of the run of equal ids from there (JAX's [C, C] compare seen
// from the referencing side). Unsorted row (a fence compaction may see one:
// a remote op's captured id can be older than the row's): the valid slots'
// parent references are packed in slot order, sorted (slot_sort::
// block_sort) and each slot binary-searches its id among them; the packed
// references (8 bytes a slot) overlay the staged parent fields, which are
// read again from global memory afterwards (the block has not written its
// row yet). The keep flags are counted per warp by ballots and scanned by
// one warp to place each kept slot. Shared memory: 24 bytes a slot (24.6 KB
// at C = 1,024), one staged row; the launch bound asks for MIN_BLOCKS
// blocks an SM (an A/B on the card chose one staged row and 4 blocks over
// a second row in flight and 6 or 8 blocks: PERF.md).
// Launches on the caller's stream, allocates nothing, does not
// synchronise.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 4;  // the launch bound's blocks an SM
constexpr unsigned FULL = 0xffffffffu;

// (x, y) lexicographic: a parent reference
struct LessXY {
  __device__ bool operator()(const int2& a, const int2& b) const {
    if (a.x != b.x) return a.x < b.x;
    return a.y < b.y;
  }
};

struct Fields {
  int* f[5];  // id_ctr, id_rep, par_ctr, par_rep, chr
  unsigned char* dead;
  unsigned char* valid;
};

// One staged row in shared memory: the five int fields [5][C], then dead,
// valid and protect bytes [C] each.
struct Row {
  int* f;
  unsigned char* dead;
  unsigned char* valid;
  unsigned char* prot;
};

__host__ __device__ inline size_t row_bytes(int C) {
  return round16((size_t)C * 23);
}

// Shared memory of one block: the staged row, the keep flags [C] and the
// per-(chunk, warp) kept counts with their total.
__host__ __device__ inline size_t shared_bytes(int C) {
  const int chunks = (C + THREADS - 1) / THREADS;
  return row_bytes(C) + round16(C) +
         sizeof(int) * (chunks * WARPS + 1);
}

__device__ inline Row carve(unsigned char* at, int C) {
  Row r;
  r.f = (int*)at;
  r.dead = at + (size_t)20 * C;
  r.valid = r.dead + C;
  r.prot = r.valid + C;
  return r;
}

// Start copying row `base` of the inputs into r (one commit group per
// thread). VEC: 16-byte copies; otherwise 4-byte copies of the int fields
// and plain loads of the bytes.
template <bool VEC>
__device__ __forceinline__ void stage(const Fields& in,
                                      const unsigned char* protect,
                                      long long base, int C, const Row& r) {
  const int tid = threadIdx.x;
  if (VEC) {
    for (int k = 0; k < 5; ++k)
      for (int i = 4 * tid; i < C; i += 4 * THREADS)
        __pipeline_memcpy_async(r.f + k * C + i, in.f[k] + base + i, 16);
    for (int i = 16 * tid; i < C; i += 16 * THREADS) {
      __pipeline_memcpy_async(r.dead + i, in.dead + base + i, 16);
      __pipeline_memcpy_async(r.valid + i, in.valid + base + i, 16);
      if (protect)
        __pipeline_memcpy_async(r.prot + i, protect + base + i, 16);
      else
        *(int4*)(r.prot + i) = make_int4(0, 0, 0, 0);
    }
  } else {
    for (int k = 0; k < 5; ++k)
      for (int c = tid; c < C; c += THREADS)
        __pipeline_memcpy_async(r.f + k * C + c, in.f[k] + base + c, 4);
    for (int c = tid; c < C; c += THREADS) {
      r.dead[c] = in.dead[base + c];
      r.valid[c] = in.valid[base + c];
      r.prot[c] = protect ? protect[base + c] : 0;
    }
  }
  __pipeline_commit();
}

// keep[c] of a staged row whose ids may descend: a sort of the valid
// slots' parent references and one binary search per slot. The references
// overlay the row's par_ctr and par_rep, which are loaded again after.
__device__ __forceinline__ void parents_by_sort(const Fields& in,
                                                long long base, int C,
                                                const Row& r,
                                                unsigned char* keep) {
  const int tid = threadIdx.x;
  int* kx = r.f;
  int* ky = r.f + C;
  int2* ref = (int2*)(r.f + 2 * C);  // [C] over par_ctr, par_rep
  int m = 0;
  for (int c0 = 0; c0 < C; c0 += THREADS) {
    const int c = c0 + tid;
    const bool v = c < C && r.valid[c];
    int n;
    const int at = block_count_before(v, &n);
    if (v) ref[m + at] = make_int2(in.f[2][base + c], in.f[3][base + c]);
    m += n;
  }
  __syncthreads();
  block_sort(ref, m, LessXY());
  for (int c = tid; c < C; c += THREADS) {
    bool k = false;
    if (r.valid[c]) {
      k = !r.dead[c] || r.prot[c];
      if (!k) {
        const int2 id = make_int2(kx[c], ky[c]);
        int lo = 0, hi = m;  // first reference not below the id
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (LessXY()(ref[mid], id)) lo = mid + 1; else hi = mid;
        }
        k = lo < m && ref[lo].x == id.x && ref[lo].y == id.y;
      }
    }
    keep[c] = k;
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {
    r.f[2 * C + c] = in.f[2][base + c];
    r.f[3 * C + c] = in.f[3][base + c];
  }
}

// Compact the staged row r into out at `base`.
__device__ __forceinline__ void compact_row(const Fields& in,
                                            const Fields& out, long long base,
                                            int C, const Row& r,
                                            unsigned char* keep, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* kx = r.f;
  int* ky = r.f + C;
  // the row's ids (SENTINEL for an invalid slot) never descend?
  bool down = false;
  for (int c = tid + 1; c < C; c += THREADS) {
    const bool v1 = r.valid[c], v0 = r.valid[c - 1];
    const int x1 = v1 ? kx[c] : SENT, y1 = v1 ? ky[c] : SENT;
    const int x0 = v0 ? kx[c - 1] : SENT, y0 = v0 ? ky[c - 1] : SENT;
    down |= x1 < x0 || (x1 == x0 && y1 < y0);
  }
  if (!__syncthreads_or(down)) {
    // sorted: the ids as the test read them; then each valid slot flags
    // the run of ids equal to its parent reference
    for (int c = tid; c < C; c += THREADS) {
      if (!r.valid[c]) kx[c] = ky[c] = SENT;
      keep[c] = 0;
    }
    __syncthreads();
    for (int c = tid; c < C; c += THREADS) {
      if (!r.valid[c]) continue;
      const int x = r.f[2 * C + c], y = r.f[3 * C + c];
      int lo = 0, hi = C;  // first id not below the reference
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (kx[mid] < x || (kx[mid] == x && ky[mid] < y)) lo = mid + 1;
        else hi = mid;
      }
      for (int i = lo; i < C && kx[i] == x && ky[i] == y; ++i) keep[i] = 1;
    }
    __syncthreads();
    for (int c = tid; c < C; c += THREADS)
      keep[c] = r.valid[c] && (!r.dead[c] || keep[c] || r.prot[c]);
  } else {
    parents_by_sort(in, base, C, r, keep);
  }
  __syncthreads();
  // place: kept slots counted per (chunk of THREADS slots, warp), scanned
  // in that order by warp 0
  const int chunks = (C + THREADS - 1) / THREADS;
  for (int k = 0; k < chunks; ++k) {
    const int c = k * THREADS + tid;
    const unsigned b = __ballot_sync(FULL, c < C && keep[c]);
    if (lane == 0) wsum[k * WARPS + warp] = __popc(b);
  }
  __syncthreads();
  if (warp == 0) {
    const int n = chunks * WARPS;
    int carry = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const int v = i < n ? wsum[i] : 0;
      int inc = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += u;
      }
      if (i < n) wsum[i] = carry + inc - v;
      carry += __shfl_sync(FULL, inc, 31);
    }
    if (lane == 0) wsum[n] = carry;
  }
  __syncthreads();
  const int kept = wsum[chunks * WARPS];
  for (int k = 0; k < chunks; ++k) {
    const int c = k * THREADS + tid;
    const bool keep_c = c < C && keep[c];
    const unsigned b = __ballot_sync(FULL, keep_c);
    if (!keep_c) continue;
    const long long at =
        base + wsum[k * WARPS + warp] + __popc(b & ((1u << lane) - 1u));
#pragma unroll
    for (int f = 0; f < 5; ++f) out.f[f][at] = r.f[f * C + c];
    out.dead[at] = r.dead[c] != 0;
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
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
rga_compact_kernel(Fields in, Fields out, const unsigned char* protect,
                   long long rows, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Row r = carve(smem, C);
  unsigned char* keep = smem + row_bytes(C);
  int* wsum = (int*)(keep + round16(C));
  long long row = blockIdx.x;
  if (row < rows) stage<VEC>(in, protect, row * C, C, r);
  for (; row < rows; row += gridDim.x) {
    __pipeline_wait_prior(0);
    __syncthreads();
    compact_row(in, out, row * C, C, r, keep, wsum);
    const long long next = row + gridDim.x;
    if (next < rows) {
      __syncthreads();
      stage<VEC>(in, protect, next * C, C, r);
    }
  }
}

Fields fields_of(void* const* p) {
  return Fields{{(int*)p[0], (int*)p[1], (int*)p[2], (int*)p[3], (int*)p[4]},
                (unsigned char*)p[5], (unsigned char*)p[6]};
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

template <bool VEC>
int launch(void* const* in, void* const* out, const void* protect,
           long long rows, int C, void* stream) {
  const size_t bytes = shared_bytes(C);
  cudaError_t err = allow_shared(rga_compact_kernel<VEC>, bytes);
  if (err != cudaSuccess) return (int)err;
  long long grid = 0;
  err = resident_blocks(rga_compact_kernel<VEC>, THREADS, bytes, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid > rows) grid = rows;
  rga_compact_kernel<VEC><<<(unsigned)grid, THREADS, bytes,
                            (cudaStream_t)stream>>>(
      fields_of(in), fields_of(out), (const unsigned char*)protect, rows, C);
  return (int)cudaGetLastError();
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
  bool vec = C % 16 == 0 && (protect == nullptr || aligned16(protect));
  for (int k = 0; k < 7; ++k) vec = vec && aligned16(in[k]);
  return vec ? launch<true>(in, out, protect, rows, C, stream)
             : launch<false>(in, out, protect, rows, C, stream);
}
