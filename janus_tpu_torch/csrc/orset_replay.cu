// orset_replay: batched replay of effect-captured OR-Set ops, the
// consensus path's apply, for every view in one call (four launches).
//
// Replaces: janus_tpu/models/orset.py _apply_captured_batch, vmapped over
// the views: one global sort of the K*C state records and the B*R op
// records by (key, tag). Per key row k in [0, K): the valid state slots of
// row k and the op records whose raw key is k (an add is one record, at
// capture lane 0; a remove/clear one tombstone per captured tag that is
// not SENTINEL) are grouped by tag; a tag takes the elem of its first
// record in (state slot, then op lane, then capture lane) order and ORs
// the tombstones of all its records; the C smallest distinct tags form the
// canonical row, and the distinct tags beyond C are dropped and counted.
// Records with a negative raw key are lost, and their distinct tags beyond
// C per key value counted as dropped; records with raw keys >= K are
// ignored (the JAX sort sends them past the last row).
//
// What bounds it on the H100: bytes and the sort. Per view the state is
// read once and written once (K*C*14 bytes), the op fields read twice
// (32 + 12 R bytes per op lane: counting and filling), and every record
// moves through a 16-byte scratch slot; at path A's delta apply (4 views,
// K=100, C=64, 65,536 ops of R=4) that is ~25 MB, ~7.5 us at 3.35 TB/s.
// The per-row sorts are n log^2 n / 4 compare-swaps for a row of n
// records, mostly in shared memory.
//
// Design: a counting pass buckets the op records per (view, key) with
// atomics (negative raw keys into one extra bucket per view), a per-view
// prefix sum lays the buckets out in one scratch array with C slots
// reserved in front of each row's bucket, and a fill pass scatters each
// record as (rep, ctr, origin, key), the origin being its index in the JAX
// record order, so the order atomics leave inside a bucket does not
// matter. Then one block per (view, row): it writes the row's state slots
// into the reserved slots (invalid ones as a marker that sorts last),
// sorts the bucket by (key, rep, ctr, origin) with slot_sort::block_sort in
// shared memory when it fits, else in place in the scratch array (a hot
// key is slower, never cut), and folds: a tile-wide prefix count of the
// first records of each tag gives the output slot; the first record's
// thread reads its elem by origin and ORs the tombstones of its run. The
// negative-key bucket only counts its drops, one thread walking it.
// Launches on the caller's stream, allocates nothing, does not
// synchronise.
#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 256;
constexpr int SHARED_RECORDS = 2048;  // a bucket sorted in shared memory
constexpr int OP_ADD = 1, OP_REMOVE = 2, OP_CLEAR = 3;

struct State {
  const int* rep;
  const int* ctr;
  const int* elem;
  const unsigned char* removed;
  const unsigned char* valid;
};

struct Ops {
  const int* op;
  const int* key;
  const int* a0;
  const int* a1;
  const int* a2;
  const int* rm_rep;
  const int* rm_ctr;
  const int* rm_elem;
};

struct Out {
  int* rep;
  int* ctr;
  int* elem;
  unsigned char* removed;
  unsigned char* valid;
};

struct Dims {
  int V, K, C, B, R;
  long long per_view;  // scratch records per view: K*C + B*R
};

// the bucket of a raw key: its row, K for a negative key, -1 past the rows
__device__ __forceinline__ int bucket_of(int key, int K) {
  return key >= K ? -1 : (key < 0 ? K : key);
}

// op records of lane o: (add) lane 0 only; (remove/clear) captured tags
// that are not SENTINEL. Calls f(r, rep, ctr) for each.
template <typename F>
__device__ void for_records(const Ops& ops, long long o, int R, F f) {
  const int op = ops.op[o];
  if (op == OP_ADD) {
    if (R > 0) f(0, ops.a1[o], ops.a2[o]);
  } else if (op == OP_REMOVE || op == OP_CLEAR) {
    for (int r = 0; r < R; ++r) {
      const int rep = ops.rm_rep[o * R + r];
      if (rep != SENT) f(r, rep, ops.rm_ctr[o * R + r]);
    }
  }
}

__global__ void count_kernel(Ops ops, int* __restrict__ counts, Dims d) {
  const long long n = (long long)d.V * d.B;
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < n;
       o += (long long)gridDim.x * blockDim.x) {
    const int bucket = bucket_of(ops.key[o], d.K);
    if (bucket < 0) continue;
    int c = 0;
    for_records(ops, o, d.R, [&](int, int, int) { ++c; });
    if (c) atomicAdd(&counts[(o / d.B) * (d.K + 1) + bucket], c);
  }
}

// per view: offsets of the K+1 buckets (rows reserve C slots each), the
// total at [K+1], and each bucket's fill cursor after its reserve
__global__ void scan_kernel(const int* __restrict__ counts,
                            int* __restrict__ offsets,
                            int* __restrict__ cursor, Dims d) {
  const int v = blockIdx.x;
  int* off = offsets + (long long)v * (d.K + 2);
  const int* cnt = counts + (long long)v * (d.K + 1);
  for (int k = threadIdx.x; k <= d.K; k += blockDim.x)
    off[k] = cnt[k] + (k < d.K ? d.C : 0);
  __syncthreads();
  const int total = block_exclusive_scan(off, d.K + 1);
  if (threadIdx.x == 0) off[d.K + 1] = total;
  for (int k = threadIdx.x; k <= d.K; k += blockDim.x)
    cursor[(long long)v * (d.K + 1) + k] = off[k] + (k < d.K ? d.C : 0);
}

__global__ void fill_kernel(Ops ops, int* __restrict__ cursor,
                            int4* __restrict__ records, Dims d) {
  const long long n = (long long)d.V * d.B;
  const int kc = d.K * d.C;
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < n;
       o += (long long)gridDim.x * blockDim.x) {
    const int key = ops.key[o];
    const int bucket = bucket_of(key, d.K);
    if (bucket < 0) continue;
    const long long v = o / d.B;
    const int b = (int)(o % d.B);
    int* cur = &cursor[v * (d.K + 1) + bucket];
    int4* mine = records + v * d.per_view;
    for_records(ops, o, d.R, [&](int r, int rep, int ctr) {
      mine[atomicAdd(cur, 1)] = make_int4(rep, ctr, kc + b * d.R + r, key);
    });
  }
}

__device__ __forceinline__ bool same_tag(const int4& a, const int4& b) {
  return a.w == b.w && a.x == b.x && a.y == b.y;
}

// elem and tombstone of the record with JAX order index `origin`
__device__ __forceinline__ void payload(const State& st, const Ops& ops,
                                        const Dims& d, int v, int origin,
                                        int* elem, bool* rm) {
  const int kc = d.K * d.C;
  if (origin < kc) {
    const long long s = (long long)v * kc + origin;
    *elem = st.elem[s];
    *rm = st.removed[s];
    return;
  }
  const int o = origin - kc;
  const long long lane = (long long)v * d.B + o / d.R;
  const int r = o % d.R;
  if (ops.op[lane] == OP_ADD && r == 0) {
    *elem = ops.a0[lane];
    *rm = false;
  } else {
    *elem = ops.rm_elem[lane * d.R + r];
    *rm = true;
  }
}

__global__ void __launch_bounds__(THREADS)
process_kernel(State st, Ops ops, Out out, int* __restrict__ dropped,
               const int* __restrict__ offsets, int4* __restrict__ records,
               Dims d) {
  extern __shared__ int4 smem[];
  __shared__ int s_invalid;
  const int k = blockIdx.x, v = blockIdx.y;
  const int* off = offsets + (long long)v * (d.K + 2);
  const int n = off[k + 1] - off[k];
  int4* bucket = records + v * d.per_view + off[k];
  const int tid = threadIdx.x;

  // the row's state slots into the reserved front of its bucket
  if (tid == 0) s_invalid = 0;
  __syncthreads();
  if (k < d.K) {
    int invalid = 0;
    const long long row = ((long long)v * d.K + k) * d.C;
    for (int c = tid; c < d.C; c += THREADS) {
      if (st.valid[row + c]) {
        bucket[c] = make_int4(st.rep[row + c], st.ctr[row + c], k * d.C + c, k);
      } else {
        bucket[c] = make_int4(INT_MAX, INT_MAX, INT_MAX, k);  // sorts last
        ++invalid;
      }
    }
    if (invalid) atomicAdd(&s_invalid, invalid);
  }
  __syncthreads();
  int4* work = bucket;
  if (n <= SHARED_RECORDS) {
    for (int i = tid; i < n; i += THREADS) smem[i] = bucket[i];
    work = smem;
    __syncthreads();
  }
  block_sort(work, n, LessWXYZ());  // (key, rep, ctr, origin)
  const int real = n - s_invalid;

  if (k == d.K) {  // negative raw keys: count the drops only
    if (tid == 0) {
      int drop = 0, distinct = 0;
      for (int i = 0; i < real; ++i) {
        if (i == 0 || work[i].w != work[i - 1].w) distinct = 0;
        if (i == 0 || !same_tag(work[i], work[i - 1])) {
          if (++distinct > d.C) ++drop;
        }
      }
      if (drop) atomicAdd(&dropped[v], drop);
    }
    return;
  }

  const long long row = ((long long)v * d.K + k) * d.C;
  int kept = 0;  // distinct tags so far, the same in every thread
  for (int t0 = 0; t0 < real; t0 += THREADS) {
    const int i = t0 + tid;
    const bool first = i < real && (i == 0 || !same_tag(work[i], work[i - 1]));
    int tile;
    const int slot = kept + block_count_before(first, &tile);
    if (first && slot < d.C) {
      const int4 x = work[i];
      int e;
      bool rm;
      payload(st, ops, d, v, x.z, &e, &rm);
      for (int j = i + 1; j < real && same_tag(work[j], x); ++j) {
        int e2;
        bool rm2;
        payload(st, ops, d, v, work[j].z, &e2, &rm2);
        rm |= rm2;
      }
      out.rep[row + slot] = x.x;
      out.ctr[row + slot] = x.y;
      out.elem[row + slot] = e;
      out.removed[row + slot] = rm;
      out.valid[row + slot] = 1;
    }
    kept += tile;
  }
  for (int slot = min(kept, d.C) + tid; slot < d.C; slot += THREADS) {
    out.rep[row + slot] = SENT;
    out.ctr[row + slot] = SENT;
    out.elem[row + slot] = 0;
    out.removed[row + slot] = 0;
    out.valid[row + slot] = 0;
  }
  if (tid == 0 && kept > d.C) atomicAdd(&dropped[v], kept - d.C);
}

unsigned grid_for(long long n) {
  const long long g = (n + THREADS - 1) / THREADS;
  return (unsigned)(g < 132LL * 32 ? g : 132LL * 32);
}

}  // namespace

// state fields [V, K, C] (int32 tags and elem, bool removed and valid);
// op fields int32 [V, B]; captured fields int32 [V, B, R]; outputs [V, K,
// C]; dropped int32 [V], zeroed by the caller. Scratch: counts int32
// [V, K+1] zeroed by the caller, offsets int32 [V, K+2], cursor int32
// [V, K+1], records int4 [V * (K*C + B*R)]. Contiguous on one device.
// Returns the first CUDA error of the four launches.
extern "C" int orset_replay_launch(
    const void* rep, const void* ctr, const void* elem, const void* removed,
    const void* valid, const void* op, const void* key, const void* a0,
    const void* a1, const void* a2, const void* rm_rep, const void* rm_ctr,
    const void* rm_elem, void* o_rep, void* o_ctr, void* o_elem,
    void* o_removed, void* o_valid, void* dropped, void* counts,
    void* offsets, void* cursor, void* records, int V, int K, int C, int B,
    int R, void* stream) {
  if (V <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  State st{(const int*)rep, (const int*)ctr, (const int*)elem,
           (const unsigned char*)removed, (const unsigned char*)valid};
  Ops ops{(const int*)op, (const int*)key, (const int*)a0, (const int*)a1,
          (const int*)a2, (const int*)rm_rep, (const int*)rm_ctr,
          (const int*)rm_elem};
  Out out{(int*)o_rep, (int*)o_ctr, (int*)o_elem, (unsigned char*)o_removed,
          (unsigned char*)o_valid};
  Dims d{V, K, C, B, R, (long long)K * C + (long long)B * R};
  const long long lanes = (long long)V * B;
  if (lanes > 0) {
    count_kernel<<<grid_for(lanes), THREADS, 0, s>>>(ops, (int*)counts, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  scan_kernel<<<V, THREADS, 0, s>>>((const int*)counts, (int*)offsets,
                                    (int*)cursor, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (lanes > 0) {
    fill_kernel<<<grid_for(lanes), THREADS, 0, s>>>(ops, (int*)cursor,
                                                   (int4*)records, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t bytes = sizeof(int4) * SHARED_RECORDS;
  process_kernel<<<dim3(K + 1, V), THREADS, bytes, s>>>(
      st, ops, out, (int*)dropped, (const int*)offsets, (int4*)records, d);
  return (int)cudaGetLastError();
}
