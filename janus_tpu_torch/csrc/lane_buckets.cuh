// lane_buckets: an apply's op lanes grouped by the row their key gathers,
// each group later walked in lane order. Two schemes live here.
//
// The lists (`Lists`, `build`, `sorted_windows`; mvr_apply.cu): a
// sequential per-row apply (the lax.scan of mvregister._apply_ops_impl)
// only has to see, in lane order, the lanes that gather its row; a no-op
// lane changes nothing. Three launches on the caller's stream build the
// groups from op [V, B] and key [V, B]:
//
//   count  one thread per lane: a live lane (its op code in `mask`) adds
//          one to count[v, g], g = the row its key gathers (JAX's gather
//          rule: negative counts from the end, then clamp)
//   scan   one block per view: start[v, g] = the exclusive prefix sum of
//          count[v, :], start[v, K] = the view's live lanes; count[v, :]
//          is zeroed to serve as the fill cursor
//   fill   one thread per live lane: lanes[v, start[v, g] + cursor] = b
//
// A group's lanes are in no order after the fill (atomics); the walk puts
// them in lane order with `sorted_windows` below. Bytes: the op and key
// fields read twice, 4 bytes a live lane written, 8 bytes a (view, row).
//
// The buckets (`Groups`, `claim`, `lane_order`, `walk_records`;
// lww_apply.cu, orset_apply.cu): one launch, a thread a lane, writes each
// lane's 16-byte record into its group's bucket of `cap` records at the
// group's count (`claim`) and lists each group its first lane reaches; a
// walk then takes G threads of a warp a listed group, puts the group's
// records in lane order (`lane_order`) and reads them back a window at a
// time (`walk_records`). The sources keep their fill kernel (its record)
// and the row step.
#pragma once

#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace lane_buckets {

// count: int32 [V, K], zero on entry (the fill's cursor afterwards);
// start: int32 [V, K + 1]; lanes: int32 [V, B]
struct Lists {
  int* count;
  int* start;
  int* lanes;
};

__device__ __forceinline__ bool is_live(int op, unsigned mask) {
  return op >= 0 && op < 32 && ((mask >> op) & 1u);
}

__global__ void count_kernel(const int* __restrict__ op,
                             const int* __restrict__ key, unsigned mask,
                             long long total, int B, int K, int* count) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (!is_live(op[i], mask)) continue;
    const long long v = i / B;
    atomicAdd(&count[v * K + slot_sort::gather_row(key[i], K)], 1);
  }
}

__global__ void scan_kernel(int* count, int* start, int K) {
  const long long v = blockIdx.x;
  int* s = start + v * (K + 1);
  int* c = count + v * K;
  for (int g = threadIdx.x; g < K; g += blockDim.x) s[g] = c[g];
  __syncthreads();
  const int total = slot_sort::block_exclusive_scan(s, K);
  if (threadIdx.x == 0) s[K] = total;
  for (int g = threadIdx.x; g < K; g += blockDim.x) c[g] = 0;
}

__global__ void fill_kernel(const int* __restrict__ op,
                            const int* __restrict__ key, unsigned mask,
                            long long total, int B, int K, int* count,
                            const int* __restrict__ start,
                            int* __restrict__ lanes) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (!is_live(op[i], mask)) continue;
    const long long v = i / B;
    const int g = slot_sort::gather_row(key[i], K);
    const int at = atomicAdd(&count[v * K + g], 1);
    lanes[v * B + start[v * (K + 1) + g] + at] = (int)(i - v * B);
  }
}

// Build the groups of op/key [V, B] (K > 0) on `stream`.
inline cudaError_t build(const int* op, const int* key, unsigned mask, int V,
                         int K, int B, Lists l, cudaStream_t stream) {
  const long long total = (long long)V * B;
  if (total <= 0) return cudaSuccess;
  const long long want = (total + 255) / 256;
  const unsigned grid = (unsigned)(want < 132LL * 16 ? want : 132LL * 16);
  count_kernel<<<grid, 256, 0, stream>>>(op, key, mask, total, B, K,
                                         l.count);
  scan_kernel<<<V, 256, 0, stream>>>(l.count, l.start, K);
  fill_kernel<<<grid, 256, 0, stream>>>(op, key, mask, total, B, K, l.count,
                                        l.start, l.lanes);
  return cudaGetLastError();
}

struct Less {
  __device__ bool operator()(int a, int b) const { return a < b; }
};

// The lanes of one group (list[0, n), lane indices in [0, B), distinct)
// into win[] in lane order, a window of lane indices at a time: with
// n <= wcap one window holds them all; otherwise windows [w0, w0 + wcap)
// of lane index, each holding at most wcap of the group's lanes. Calls
// fn(win, m) for each window in order, with the whole block; `s_count`
// is a shared int. Every thread of the block calls it.
template <typename Fn>
__device__ void sorted_windows(const int* list, int n, int B, int* win,
                               int wcap, int* s_count, Fn fn) {
  const int width = n <= wcap ? B : wcap;
  for (int w0 = 0; w0 < B; w0 += width) {
    if (threadIdx.x == 0) *s_count = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int b = list[i];
      if (b >= w0 && b - w0 < width) win[atomicAdd(s_count, 1)] = b;
    }
    __syncthreads();
    const int m = *s_count;
    slot_sort::block_sort(win, m, Less());
    __syncthreads();
    fn(win, m);
    __syncthreads();
  }
}

// ---- the buckets ----

constexpr int WINDOW = 32;        // records of a group read back at a time
constexpr int MAX_BUCKET = 2048;  // the most records a bucket holds
constexpr int PLACE_BITS = 11;    // a record's place in its bucket
constexpr unsigned ALL_LANES = 0xffffffffu;

// count[V K] (lanes a group; zero on entry, zeroed by the walk),
// rec[V K, cap], list[V K] (the groups with lanes, in the order the fill
// met them), hot[] (the groups past their bucket; null where the walk
// finds those itself) and live[4] (the lengths of list, at `parity`, and
// of hot, at 2 + `parity`: this call's zero on entry, the walk zeroes the
// other ones for the next call)
struct Groups {
  int* count;
  int4* rec;
  int* list;
  int* hot;
  int* live;
  int parity;
  int cap;
};

// This lane's place in the bucket of its group vg (a place at cap or past
// it has no room), the lanes `takers` of its warp (this one among them)
// claiming theirs with it: a warp's lanes of one group by one atomic, in
// lane order; the lane that reaches a group first lists it.
__device__ __forceinline__ int claim(const Groups& gr, unsigned takers,
                                     long long vg) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(takers, vg);
  const int leader = __ffs(peers) - 1;
  int at = 0;
  if ((int)lane == leader) {
    at = atomicAdd(&gr.count[vg], __popc(peers));
    if (at == 0) gr.list[atomicAdd(&gr.live[gr.parity], 1)] = (int)vg;
  }
  return __shfl_sync(peers, at, leader) +
         __popc(peers & ((1u << lane) - 1u));
}

// The (lane, place) keys of the warp's groups, G threads a group: this
// thread's group's m records of `bucket` (the lane index at bit `shift` of
// a record's first word) keyed into keys[(lane / G) cap, ...) in
// ascending order, so in lane order. A bucket is in lane order unless a
// later lane's atomic came first; the groups whose keys do not ascend are
// sorted by the whole warp, a group at a time. Every lane calls it.
template <int G>
__device__ __forceinline__ void lane_order(unsigned* keys, int cap,
                                           const int4* bucket, int m,
                                           int shift) {
  constexpr unsigned GROUP = G == 32 ? ALL_LANES : (1u << G) - 1u;
  const int lane = threadIdx.x & 31, s = lane % G;
  unsigned* mine = keys + (lane / G) * cap;
  for (int i = s; i < m; i += G)
    mine[i] = (unsigned)(bucket[i].x >> shift) << PLACE_BITS | i;
  __syncwarp();
  bool up = true;
  for (int i = s + 1; i < m; i += G) up &= mine[i] > mine[i - 1];
  unsigned unsorted = __ballot_sync(ALL_LANES, !up);
  while (unsorted) {
    const int q = (__ffs(unsorted) - 1) / G;
    unsorted &= ~(GROUP << (q * G));
    const int mq = __shfl_sync(ALL_LANES, m, q * G);
    unsigned* kq = keys + q * cap;
    int p = 1;
    while (p < mq) p <<= 1;
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int x = lane; x < (p >> 1); x += 32) {
          const int lo = ((x & ~(j - 1)) << 1) | (x & (j - 1));
          const int hi = j == (k >> 1) ? (lo ^ (k - 1)) : lo + j;
          if (hi < mq) {
            const unsigned a = kq[lo], c = kq[hi];
            if (c < a) {
              kq[lo] = c;
              kq[hi] = a;
            }
          }
        }
        __syncwarp();
      }
    }
  }
}

// step(r, active) for j in [0, the most records a group of the warp
// has): record j of this thread's group (its m records of `bucket` in the
// order of its keys from `lane_order`; active: j < m, else r is zero),
// read back into win[WINDOW] (this group's) a window at a time, the next
// window's loads in flight while one is walked. G threads a group; every
// lane calls it.
template <int G, typename Step>
__device__ __forceinline__ void walk_records(const int4* bucket,
                                             const unsigned* keys, int m,
                                             int4* win, Step step) {
  constexpr int PW = WINDOW / G;  // a window's records a thread loads
  const int s = (threadIdx.x & 31) % G;
  const int steps = __reduce_max_sync(ALL_LANES, m);
  int4 next[PW];
  const auto fetch = [&](int j0) {
#pragma unroll
    for (int q = 0; q < PW; ++q) {
      const int i = j0 + s + q * G;
      if (i < m) next[q] = bucket[keys[i] & ((1u << PLACE_BITS) - 1u)];
    }
  };
  fetch(0);
  for (int j0 = 0; j0 < steps; j0 += WINDOW) {
    __syncwarp();
#pragma unroll
    for (int q = 0; q < PW; ++q)
      if (j0 + s + q * G < m) win[s + q * G] = next[q];
    __syncwarp();
    if (j0 + WINDOW < steps) fetch(j0 + WINDOW);
    const int end = min(steps - j0, WINDOW);
    for (int j = 0; j < end; ++j) {
      const bool active = j0 + j < m;
      step(active ? win[j] : make_int4(0, 0, 0, 0), active);
    }
  }
}

}  // namespace lane_buckets
