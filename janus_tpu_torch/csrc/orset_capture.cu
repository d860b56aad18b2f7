// orset_capture: batched effect capture of OR-Set remove/clear ops, one
// block per view.
//
// Replaces: janus_tpu/models/orset.py prepare_ops_batch, vmapped over the
// views. A remove (matching elem a0) or a clear at lane i captures (1) the
// first min(r_cap, C) selected tags of the pre-batch row its key gathers,
// in row order, padded with SENTINEL tags, (2) the first r_cap matching
// adds of lanes j < i whose raw key equals its raw key, in (a1, a2, lane)
// order, where an add counts only if its a1 is not SENTINEL, padded the
// same way; and outputs the first r_cap of (1) ++ (2) sorted stably by tag.
// Every other lane captures SENTINEL tags with elem 0.
//
// What bounds it on the H100: neither bytes nor operations at the path's
// shapes. It reads 20 bytes per op lane and, per remove/clear lane, one C-
// slot row (a gathered row, L2-resident: the state is 4 x 100 x 64 slots),
// and writes 12 x r_cap bytes per lane, ~1.6 MB at 4 views x 8192 lanes
// (~0.5 us at 3.35 TB/s); the work is a sort of the adds and, per lane, a
// scan of its key's adds.
//
// Design: the JAX version avoids a [B, B] sort with a [B, B] mask and r_cap
// rank selections; here the adds are bucketed by key instead. One block
// per view gathers its add lanes as (key, a1, a2, lane) records in shared
// memory (global scratch when B does not fit), sorts them with
// slot_sort::block_sort, so each key's adds are contiguous and in tag
// order, and then one thread per remove/clear lane scans its row for the
// state prefix, binary-searches its key's bucket and walks it for the
// batch prefix, and merges the two (at most 2 r_cap entries) by a stable
// insertion sort in registers. Launches on the caller's stream, allocates
// nothing, does not synchronise.
#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 512;
constexpr int MAX_RCAP = 32;
constexpr int OP_ADD = 1, OP_REMOVE = 2, OP_CLEAR = 3;

struct Ops {
  const int* op;
  const int* key;
  const int* a0;
  const int* a1;
  const int* a2;
};

struct Rows {
  const int* rep;
  const int* ctr;
  const int* elem;
  const unsigned char* valid;
};

__device__ __forceinline__ bool tag_less(int r0, int c0, int r1, int c1) {
  return r0 < r1 || (r0 == r1 && c0 < c1);
}

__global__ void __launch_bounds__(THREADS)
orset_capture_kernel(Ops ops, Rows st, int* __restrict__ out_rep,
                     int* __restrict__ out_ctr, int* __restrict__ out_elem,
                     int4* __restrict__ scratch, int V, int B, int K, int C,
                     int R, int in_shared) {
  extern __shared__ int4 smem[];
  __shared__ int n_adds;
  const int v = blockIdx.x;
  const long long ob = (long long)v * B;  // the view's first op lane
  int4* adds = in_shared ? smem : scratch + ob;

  if (threadIdx.x == 0) n_adds = 0;
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += THREADS) {
    const int a1 = ops.a1[ob + b];
    if (ops.op[ob + b] == OP_ADD && a1 != SENT) {
      const int at = atomicAdd(&n_adds, 1);
      adds[at] = make_int4(a1, ops.a2[ob + b], b, ops.key[ob + b]);
    }
  }
  __syncthreads();
  const int n = n_adds;
  block_sort(adds, n, LessWXYZ());  // (key, a1, a2, lane)

  const int ns = R < C ? R : C;  // width of the state prefix
  for (int i = threadIdx.x; i < B; i += THREADS) {
    const int op = ops.op[ob + i];
    const long long out = (ob + i) * R;
    if (op != OP_REMOVE && op != OP_CLEAR) {
      for (int r = 0; r < R; ++r) {
        out_rep[out + r] = SENT;
        out_ctr[out + r] = SENT;
        out_elem[out + r] = 0;
      }
      continue;
    }
    const int key = ops.key[ob + i], a0 = ops.a0[ob + i];
    const bool by_elem = op == OP_REMOVE;
    int mr[2 * MAX_RCAP], mc[2 * MAX_RCAP], me[2 * MAX_RCAP];

    // (1) selected tags of the gathered row, in row order
    const long long row = ((long long)v * K + gather_row(key, K)) * C;
    int cnt = 0;
    for (int c = 0; c < C && cnt < ns; ++c) {
      if (st.valid[row + c] && (!by_elem || st.elem[row + c] == a0)) {
        mr[cnt] = st.rep[row + c];
        mc[cnt] = st.ctr[row + c];
        me[cnt] = st.elem[row + c];
        ++cnt;
      }
    }
    for (; cnt < ns; ++cnt) {
      mr[cnt] = SENT;
      mc[cnt] = SENT;
      me[cnt] = 0;
    }

    // (2) matching adds of earlier lanes of the same raw key, tag order
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (adds[mid].w < key) lo = mid + 1; else hi = mid;
    }
    int nb = 0;
    for (int j = lo; j < n && nb < R; ++j) {
      const int4 x = adds[j];
      if (x.w != key) break;
      if (x.z < i) {
        const int e = ops.a0[ob + x.z];
        if (!by_elem || e == a0) {
          mr[ns + nb] = x.x;
          mc[ns + nb] = x.y;
          me[ns + nb] = e;
          ++nb;
        }
      }
    }
    for (; nb < R; ++nb) {
      mr[ns + nb] = SENT;
      mc[ns + nb] = SENT;
      me[ns + nb] = 0;
    }

    // (3) stable insertion sort by tag, first R out
    const int len = ns + R;
    for (int a = 1; a < len; ++a) {
      const int xr = mr[a], xc = mc[a], xe = me[a];
      int b = a - 1;
      while (b >= 0 && tag_less(xr, xc, mr[b], mc[b])) {
        mr[b + 1] = mr[b];
        mc[b + 1] = mc[b];
        me[b + 1] = me[b];
        --b;
      }
      mr[b + 1] = xr;
      mc[b + 1] = xc;
      me[b + 1] = xe;
    }
    for (int r = 0; r < R; ++r) {
      out_rep[out + r] = mr[r];
      out_ctr[out + r] = mc[r];
      out_elem[out + r] = me[r];
    }
  }
}

}  // namespace

// op fields int32 [V, B]; state rows [V, K, C] (int32 tags and elem, bool
// valid); outputs int32 [V, B, R]; scratch int4 [V * B] when in_shared is
// 0. Contiguous on one device, 1 <= R <= 32. Returns the launch's CUDA
// error.
extern "C" int orset_capture_launch(const void* op, const void* key,
                                    const void* a0, const void* a1,
                                    const void* a2, const void* rep,
                                    const void* ctr, const void* elem,
                                    const void* valid, void* out_rep,
                                    void* out_ctr, void* out_elem,
                                    void* scratch, int V, int B, int K, int C,
                                    int R, int in_shared, void* stream) {
  if (V <= 0 || B <= 0 || R <= 0) return (int)cudaSuccess;
  if (R > MAX_RCAP || K <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = in_shared ? sizeof(int4) * (size_t)B : 0;
  cudaError_t err = allow_shared(orset_capture_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  Ops ops{(const int*)op, (const int*)key, (const int*)a0, (const int*)a1,
          (const int*)a2};
  Rows st{(const int*)rep, (const int*)ctr, (const int*)elem,
          (const unsigned char*)valid};
  orset_capture_kernel<<<V, THREADS, bytes, (cudaStream_t)stream>>>(
      ops, st, (int*)out_rep, (int*)out_ctr, (int*)out_elem, (int4*)scratch,
      V, B, K, C, R, in_shared);
  return (int)cudaGetLastError();
}
