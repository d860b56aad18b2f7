// rga_order: the RGA's linearization (document order) of slot rows, one
// row per block.
//
// Replaces: janus_tpu/models/rga.py _order_row, the path-key sort behind
// text. Per row of C slots with depth D: a valid slot's parent index is the
// first valid slot (lowest index) whose id equals its (par_ctr, par_rep),
// else C, the root (also for an invalid slot and a dangling reference); a
// slot's chain is itself, then parent steps, D entries at most, C past the
// root; depth_of counts its entries below C; overflow is set when some
// valid slot's chain is D long and its last entry still has a parent. The
// order is the stable sort of the slots by 2D keys, level d (root-down) of
// a valid slot being (BIG - id_ctr, BIG - id_rep) of its ancestor at that
// level (int32, wrapping; BIG = SENTINEL) or (-1, -1) past its depth, and
// (BIG, BIG) at every level for an invalid slot.
//
// What bounds it on the H100: operations, not bytes: a row is 18 bytes a
// slot read once, and 8 a slot written, while the sort compares up to 2D
// keys per comparison, C log^2 C / 4 comparisons a row (text reads one row:
// 1,024 slots at the rga preset, 56 KB).
//
// Design: one block per row (grid-stride), 256 threads, the row in shared
// memory. The valid ids are packed with their slot index and sorted, so a
// binary search finds each parent's lowest slot (the first-match rule of
// JAX's argmax). Each thread walks its slots' chains, D pointer steps at
// most, and stores them root-down ([C, D] slot indices in shared memory);
// the block sort's comparator reads the keys through them, so the [C, 2D]
// keys are never materialised. Launches on the caller's stream, allocates
// nothing, does not synchronise.
#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 256;

// the path-key order of slots x (record field x), then slot index
struct PathLess {
  const int* id_ctr;
  const int* id_rep;
  const unsigned char* valid;
  const int* lev;    // [C][D] ancestors root-down
  const int* depth;  // [C]
  int D;

  __device__ void key(int i, int d, int* kc, int* kr) const {
    if (!valid[i]) {
      *kc = SENT;
      *kr = SENT;
    } else if (d < depth[i]) {
      const int a = lev[i * D + d];
      *kc = (int)((unsigned)SENT - (unsigned)id_ctr[a]);
      *kr = (int)((unsigned)SENT - (unsigned)id_rep[a]);
    } else {
      *kc = -1;
      *kr = -1;
    }
  }

  __device__ bool operator()(const int4& a, const int4& b) const {
    const int i = a.x, j = b.x;
    for (int d = 0; d < D; ++d) {
      int ci, ri, cj, rj;
      key(i, d, &ci, &ri);
      key(j, d, &cj, &rj);
      if (ci != cj) return ci < cj;
      if (ri != rj) return ri < rj;
    }
    return i < j;
  }
};

struct Rows {
  const int* id_ctr;
  const int* id_rep;
  const int* par_ctr;
  const int* par_rep;
  const unsigned char* valid;
};

__global__ void __launch_bounds__(THREADS)
rga_order_kernel(Rows in, int* __restrict__ order, int* __restrict__ depth_of,
                 unsigned char* __restrict__ overflow, long long rows, int C,
                 int D) {
  extern __shared__ int4 smem[];
  int4* rec = smem;                 // [C] sort records
  int* id_ctr = (int*)(rec + C);
  int* id_rep = id_ctr + C;
  int* par_ctr = id_rep + C;
  int* par_rep = par_ctr + C;
  int* par_idx = par_rep + C;
  int* depth = par_idx + C;
  int* lev = depth + C;             // [C][D]
  unsigned char* valid = (unsigned char*)(lev + C * D);
  __shared__ int s_overflow;
  const int tid = threadIdx.x;

  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * C;
    for (int c = tid; c < C; c += THREADS) {
      id_ctr[c] = in.id_ctr[base + c];
      id_rep[c] = in.id_rep[base + c];
      par_ctr[c] = in.par_ctr[base + c];
      par_rep[c] = in.par_rep[base + c];
      valid[c] = in.valid[base + c];
    }
    if (tid == 0) s_overflow = 0;
    __syncthreads();
    // the valid ids with their slots, sorted by (ctr, rep, slot)
    int m = 0;
    for (int c0 = 0; c0 < C; c0 += THREADS) {
      const int c = c0 + tid;
      const bool v = c < C && valid[c];
      int n;
      const int at = block_count_before(v, &n);
      if (v) rec[m + at] = make_int4(id_ctr[c], id_rep[c], c, 0);
      m += n;
    }
    __syncthreads();
    block_sort(rec, m, LessXYZ());
    for (int c = tid; c < C; c += THREADS) {
      int p = C;
      if (valid[c]) {
        const int pc = par_ctr[c], pr = par_rep[c];
        int lo = 0, hi = m;  // first id not below (pc, pr)
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const int4 r = rec[mid];
          if (r.x < pc || (r.x == pc && r.y < pr)) lo = mid + 1; else hi = mid;
        }
        if (lo < m && rec[lo].x == pc && rec[lo].y == pr) p = rec[lo].z;
      }
      par_idx[c] = p;
    }
    __syncthreads();
    // chains: self first, then parent steps; stored root-down
    for (int c = tid; c < C; c += THREADS) {
      int* ch = lev + c * D;
      ch[0] = c;
      int dep = 1;
      while (dep < D) {
        const int nxt = par_idx[ch[dep - 1]];
        if (nxt >= C) break;
        ch[dep++] = nxt;
      }
      if (dep == D && valid[c] && par_idx[ch[D - 1]] < C) s_overflow = 1;
      for (int a = 0, b = dep - 1; a < b; ++a, --b) {
        const int t = ch[a];
        ch[a] = ch[b];
        ch[b] = t;
      }
      depth[c] = dep;
      depth_of[base + c] = dep;
    }
    __syncthreads();
    for (int c = tid; c < C; c += THREADS) rec[c] = make_int4(c, 0, 0, 0);
    __syncthreads();
    block_sort(rec, C, PathLess{id_ctr, id_rep, valid, lev, depth, D});
    for (int c = tid; c < C; c += THREADS) order[base + c] = rec[c].x;
    if (tid == 0) overflow[row] = s_overflow;
    __syncthreads();
  }
}

}  // namespace

// rows: five pointers (id_ctr, id_rep, par_ctr, par_rep int32; valid bool)
// of [rows, C]; order, depth_of: int32 [rows, C]; overflow: bool [rows]; D
// >= 1. Contiguous on one device. Returns the launch's CUDA error.
extern "C" int rga_order_launch(const void* const* in, void* order,
                                void* depth_of, void* overflow,
                                long long rows, int C, int D, void* stream) {
  if (rows <= 0 || C <= 0) return (int)cudaSuccess;
  const size_t bytes =
      (size_t)C * (sizeof(int4) + 6 * sizeof(int) + (size_t)D * sizeof(int) +
                   1);
  cudaError_t err = allow_shared(rga_order_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = rows < 132LL * 64 ? rows : 132LL * 64;
  const Rows r{(const int*)in[0], (const int*)in[1], (const int*)in[2],
               (const int*)in[3], (const unsigned char*)in[4]};
  rga_order_kernel<<<(unsigned)grid, THREADS, bytes, (cudaStream_t)stream>>>(
      r, (int*)order, (int*)depth_of, (unsigned char*)overflow, rows, C, D);
  return (int)cudaGetLastError();
}
