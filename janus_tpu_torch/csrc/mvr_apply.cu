// mvr_apply: the MVRegister's sequential apply of write ops, per view, in
// place, in three modes: captured (mvr_apply_launch with wclock), the
// uncaptured write (mvr_apply_launch without) and the capture
// (mvr_capture_launch).
//
// Replaces: the lax.scan of janus_tpu/models/mvregister.py
// _apply_ops_impl (100-135), vmapped over the views, with _row_join
// (67-77); and, as the capture mode, the scan of janus_tpu/models/base.py
// capture_and_apply (160-186) with janus_tpu/models/mvregister.py
// prepare_ops (49-64). Writes (op 1: a0 = value, writer = writer lane)
// apply in lane order; other codes change nothing. A write reads the row
// its key gathers (negative keys count from the end, then the index is
// clamped) and changes it only if the normalised key is in range.
// captured: the row's V entries and the singleton (a0, wclock) reduced to
// their causal frontier (mvr_frontier.cuh), cut to V; the overflow adds to
// the view's drops (whether or not the key is in range). uncaptured: the
// observed clock (per lane the max over the row's entries of valid ? clock
// : 0) with lane `writer` bumped by JAX's scatter rule (negative counts
// from the end, out of range bumps nothing), and the row replaced by the
// single value (a0, that clock). capture: the observed clock with lane
// `writer` bumped only for 0 <= writer < W (prepare_ops' arange compare)
// is the lane's wclock, written out, and the write then applies captured.
// Clock bumps wrap as int32.
//
// What bounds it on the H100: bytes. The function needs 16 bytes a write
// lane (op, key, a0, writer) and its 4W of wclock (read, captured), only
// the op of any other lane, the capture's wclock written for every lane,
// and the rows its writes touch, each read and written once (V (5 + 4W)
// bytes); a row's first captured write does the frontier's 2 (V + 1)^2 W
// compares and each later one 2 V W, which the row's staging in shared
// memory keeps on chip. At the mvr_consensus phase (64 views, 500 keys,
// V = 8, W = 64, Zipf keys) a delta apply's batch is 16,384 lanes a view
// and touches at most 32,000 rows of 2.1 KB. The walk of a row is
// sequential, so the time is the longest walk's (the hottest key's, some
// hundreds of writes a view) unless each write is short.
//
// Design: a write touches only the row it gathers, so rows are
// independent. lane_buckets.cuh groups the write lanes by (view, row); its
// scan step is replaced here by scan_order_kernel, which also sorts each
// view's groups by write count, most first. A persistent grid of one-warp
// blocks takes the groups from a work counter (atomicAdd) in the order
// (rank, view): every view's longest walk first, then every view's second,
// and so on, so the hottest walks all start in the first wave (a block
// whose walk is short claims its next group before walking, a long one
// after). A block stages its row by cp.async in V + 1 entry slots of
// shared memory (a clock row of W + 4 ints, 16-byte aligned, when W % 4 ==
// 0), with the row's order as an array of V slot indices and one free
// slot, puts its lanes in lane order (up to 32 by a bitonic sort across
// the warp's registers; more in windows of at most 2,048 lane indices,
// bitonic-sorted in shared memory) and walks them. The lanes' op fields,
// and in the captured mode their wclock (4W contiguous bytes, 16-byte
// copies), arrive by cp.async in a ring of RING lanes issued that many
// lanes ahead, so a write reads only shared memory. The row's first
// captured write computes the frontier of its V + 1 entries (the
// singleton in the free slot; one entry a lane, O(V^2 W)), and since that
// leaves the row a frontier, every later one joins only the singleton
// (join_slots: a group of lanes per position compares it with the
// singleton's clock where the ring holds it, with all its 16-byte loads
// issued before the compares; one warp reduction a direction; O(V W)),
// rewrites the order array and copies the singleton into the free slot
// only when it is kept; nothing else is copied. The row goes back to
// global memory once, in canonical order, when its walk ends. V <= 32.
// Launches on the caller's stream, allocates nothing (the caller passes
// the groups' scratch), does not synchronise.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>

#include "lane_buckets.cuh"
#include "mvr_frontier.cuh"
#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 32;
constexpr int WCAP = 2048;
// lanes whose fields are in flight ahead of the write being applied (an
// A/B on the card chose 8 over 16: PERF.md)
constexpr int RING = 8;
constexpr int OP_WRITE = 1;
constexpr int MODE_UNCAPTURED = 0, MODE_CAPTURED = 1, MODE_CAPTURE = 2;
constexpr int ORDER_THREADS = 256;
// 16-byte loads a lane issues before it compares them, in a join
constexpr int JOIN_LOADS = 4;
// groups of a view sorted in shared memory (8 bytes each, 48 KB, beside
// the kernel's static shared memory, so the launch opts in past 48 KB); a
// view with more is sorted in global memory
constexpr int ORDER_SHARED_GROUPS = 6144;

struct Rows {
  int* val;
  unsigned char* valid;
  int* clock;  // [V, K, Vc, W]
};

struct Ops {
  const int* op;
  const int* key;
  const int* a0;
  const int* writer;
  const int* wclock;  // [V, B, W] (captured) or null
};

// n entry slots in shared memory
struct Entries {
  int* clock;  // [n][ld]
  int* val;
  unsigned char* valid;
};

// The row stride of an entry slot's clock: 16-byte rows (vector loads)
// when W % 4 == 0, else odd (mvr::clock_ld).
__host__ __device__ inline int slot_ld(int w) {
  return w % 4 == 0 ? w + 4 : mvr::clock_ld(w);
}

__device__ Entries carve(unsigned char*& at, int n, int ld) {
  Entries e;
  e.clock = (int*)at;
  e.val = e.clock + n * ld;
  e.valid = (unsigned char*)(e.val + n);
  at += round16(4 * (n * ld + n) + n);
  return e;
}

// a group's rank: more writes first, then the lower row
struct MoreWrites {
  const int* cnt;
  __device__ bool operator()(int a, int b) const {
    return cnt[a] != cnt[b] ? cnt[a] > cnt[b] : a < b;
  }
};

// One block per view, after lane_buckets' count: start[v, :] = the
// exclusive prefix sum of count[v, :] and start[v, K] the total (as
// lane_buckets' scan), order[v, r] = the view's row of rank r by write
// count (MoreWrites), count[v, :] zeroed as the fill's cursor, and
// *most_groups raised to the view's count of rows with writes.
__global__ void scan_order_kernel(int* count, int* start, int* order,
                                  int* most_groups, int K) {
  extern __shared__ int sh[];  // [2K] when K <= ORDER_SHARED_GROUPS
  __shared__ int s_groups;
  const long long v = blockIdx.x;
  int* s = start + v * (K + 1);
  int* c = count + v * K;
  int* ord = order + v * K;
  const bool in_shared = K <= ORDER_SHARED_GROUPS;
  int* cnt = in_shared ? sh : c;
  int* perm = in_shared ? sh + K : ord;
  if (threadIdx.x == 0) s_groups = 0;
  __syncthreads();
  int groups = 0;
  for (int g = threadIdx.x; g < K; g += blockDim.x) {
    const int x = c[g];
    s[g] = x;
    if (in_shared) cnt[g] = x;
    perm[g] = g;
    groups += x > 0;
  }
  if (groups) atomicAdd(&s_groups, groups);
  __syncthreads();
  block_sort(perm, K, MoreWrites{cnt});
  const int total = block_exclusive_scan(s, K);
  if (threadIdx.x == 0) {
    s[K] = total;
    atomicMax(most_groups, s_groups);
  }
  for (int g = threadIdx.x; g < K; g += blockDim.x) {
    if (in_shared) ord[g] = perm[g];
    c[g] = 0;
  }
}

// The warp's lanes split into one group of 32 / P lanes per position of
// a row (P the power of two >= vc): lane `lane` compares position e at the
// clock lanes sub, sub + group, ... (in 4-lane steps on 16-byte rows).
struct Split {
  int group, e, sub;
};

__device__ inline Split split_of(int vc) {
  int p2 = 1;
  while (p2 < vc) p2 <<= 1;
  const int group = 32 / p2, lane = threadIdx.x & 31;
  return Split{group, lane / group, lane % group};
}

// The frontier of a row that is one already (its `fill` valid entries at
// positions 0.., in slots ord[0..fill), sorted by (val, clock), pairwise
// non-dominated, distinct: what mvr::frontier leaves) joined with the
// valid singleton (sval, the clock at cs); the same result as
// mvr::frontier on the vc + 1 entries, in O(vc W) instead of O(vc^2 W):
// only the singleton s can drop an entry (strictly dominating it), only an
// entry can drop s (strictly dominating it, or as its earlier exact twin),
// the kept entries stay in their order and s goes in after those that
// order before it. Each group compares its position with s across the
// clock; one warp reduction a direction tells every position whether it
// is above or below s somewhere, and the first differing clock lane is
// reduced only when some entry's value equals s's (the order needs it
// only then). *slot gets the slot of output position `lane`, fs for s
// (meaningful for lane < min(kept, vc)). Returns kept. vc <= 32. Every
// lane of the warp calls it.
__device__ int join_slots(const Entries& r, const int* cs, int sval,
                          const int* ord, int fill, int fs, int ld, int w,
                          Split g, int* slot) {
  const int lane = threadIdx.x & 31;
  const bool has = g.e < fill;
  const int se = has ? ord[g.e] : fs;
  const int* ce = r.clock + se * ld;
  bool le = true, ge = true;
  int diff = INT_MAX;  // the first clock lane where entry and s differ
  if (has && w % 4 == 0) {  // 16-byte rows: four lanes a load
    const int step = 4 * g.group;
    for (int q0 = 4 * g.sub; q0 < w; q0 += JOIN_LOADS * step) {
      int4 x[JOIN_LOADS], y[JOIN_LOADS];  // all loads first, then compare
#pragma unroll
      for (int t = 0; t < JOIN_LOADS; ++t) {
        const int q = q0 + t * step;
        if (q < w) {
          x[t] = *(const int4*)(ce + q);
          y[t] = *(const int4*)(cs + q);
        }
      }
#pragma unroll
      for (int t = 0; t < JOIN_LOADS; ++t) {
        const int q = q0 + t * step;
        if (q >= w) break;
        const int4 a = x[t], c = y[t];
        le &= a.x <= c.x && a.y <= c.y && a.z <= c.z && a.w <= c.w;
        ge &= a.x >= c.x && a.y >= c.y && a.z >= c.z && a.w >= c.w;
        if (diff == INT_MAX) {
          diff = a.x != c.x ? q : a.y != c.y ? q + 1 : a.z != c.z ? q + 2
               : a.w != c.w ? q + 3 : INT_MAX;
        }
      }
    }
  } else if (has) {
    for (int q = g.sub; q < w; q += g.group) {
      const int x = ce[q], y = cs[q];
      le &= x <= y;
      ge &= x >= y;
      if (x != y && q < diff) diff = q;
    }
  }
  const unsigned bit = has ? 1u << g.e : 0u;
  const unsigned above = __reduce_or_sync(mvr::FULL, le ? 0u : bit);
  const unsigned below = __reduce_or_sync(mvr::FULL, ge ? 0u : bit);
  const int ev = has ? r.val[se] : 0;
  if (__any_sync(mvr::FULL, has && ev == sval)) {
    for (int off = 1; off < g.group; off <<= 1)
      diff = min(diff, __shfl_xor_sync(mvr::FULL, diff, off));
  }
  const bool all_le = has && !(above & bit), all_ge = has && !(below & bit);
  const bool lead = g.sub == 0 && has;
  const bool kept = lead && !(all_le && !all_ge);  // s does not dominate it
  const bool less = ev != sval ? ev < sval
                               : diff != INT_MAX && ce[diff] < cs[diff];
  const bool s_out =
      lead && ((all_ge && !all_le) || (all_le && all_ge && ev == sval));
  const unsigned kept_m = __ballot_sync(mvr::FULL, kept);
  const bool s_keep = !__any_sync(mvr::FULL, s_out);
  const int before = __popc(__ballot_sync(mvr::FULL, kept && less));
  // output position `lane`: s at `before`, else the k-th kept entry
  unsigned rest = kept_m;
  for (int k = lane - (s_keep && lane > before); k > 0 && rest; --k)
    rest &= rest - 1u;
  const int from = __shfl_sync(mvr::FULL, se, rest ? __ffs(rest) - 1 : 0);
  *slot = s_keep && lane == before ? fs : from;
  return __popc(kept_m) + s_keep;
}

// Shared memory of one walk block: V + 1 entry slots; the order (32
// slot indices), the frontier's map and flags; the ring's clocks (W
// rounded up to 4 ints a lane) and op fields (4 ints a lane); a window
// of lane indices.
__host__ __device__ inline size_t shared_bytes(int vc, int w) {
  const int n = vc + 1, ld = slot_ld(w), w4 = (w + 3) & ~3;
  return round16(4 * (n * ld + n) + n) + round16(4 * 32 + 4 * n + n) +
         (size_t)RING * (4 * w4 + 16) + 4 * WCAP;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
mvr_walk_kernel(Rows st, Ops ops, lane_buckets::Lists lists,
                const int* __restrict__ order, int* work,
                int* __restrict__ wclock_out, int* __restrict__ dropped,
                int V, int K, int vc, int w, int B, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count;
  const int lane = threadIdx.x;
  const int n = vc + 1, ld = slot_ld(w), w4 = (w + 3) & ~3;
  const Split split = split_of(vc);
  unsigned char* at = smem;
  const Entries e = carve(at, n, ld);
  int* ord = (int*)at;  // [32] the slot at each position of the row
  int* inv = ord + 32;  // [n]
  unsigned char* keep = (unsigned char*)(inv + n);
  at += round16(4 * 32 + 4 * n + n);
  int* ring_clock = (int*)at;  // [RING][w4]
  at += (size_t)RING * 4 * w4;
  int* ring_op = (int*)at;  // [RING][4]: key, a0, writer
  at += (size_t)RING * 16;
  int* win = (int*)at;  // [WCAP]
  const long long limit = (long long)V * work[1];
  const bool vec_rows = w % 4 == 0 && ((size_t)st.clock & 15) == 0;

  // the next item, claimed ahead while a short walk runs (a long one
  // claims when it ends, so that no waiting walk is held behind it)
  unsigned claimed = 0;
  bool ahead = false;
  for (;;) {
    if (!ahead && lane == 0) claimed = atomicAdd((unsigned*)work, 1u);
    const long long item = __shfl_sync(mvr::FULL, claimed, 0);
    ahead = false;
    if (item >= limit) break;
    const int v = (int)(item % V), rank = (int)(item / V);
    const int g = order[(long long)v * K + rank];
    const int* start = lists.start + (long long)v * (K + 1);
    const int lo = start[g], cnt = start[g + 1] - lo;
    if (cnt == 0) continue;  // uniform across the block
    if (cnt <= THREADS) {
      if (lane == 0) claimed = atomicAdd((unsigned*)work, 1u);
      ahead = true;
    }
    const long long base = ((long long)v * K + g) * vc;
    if (vec_rows) {
      for (int i = 0; i < vc; ++i)
        for (int q = 4 * lane; q < w; q += 4 * THREADS)
          __pipeline_memcpy_async(e.clock + i * ld + q,
                                  st.clock + (base + i) * w + q, 16);
      __pipeline_commit();
    } else {
      for (int i = 0; i < vc; ++i)
        for (int q = lane; q < w; q += THREADS)
          e.clock[i * ld + q] = st.clock[(base + i) * w + q];
    }
    for (int i = lane; i < vc; i += THREADS) {
      e.val[i] = st.val[base + i];
      e.valid[i] = st.valid[base + i];
      ord[i] = i;
    }
    __pipeline_wait_prior(0);
    __syncwarp();
    // the row as staged (raw: slots in place, slot vc free) until its
    // first in-range write; then canonical: `fill` valid entries in slots
    // ord[0..fill), the other positions empty
    bool canon = false, touched = false;
    int fill = 0, fs = vc, drop = 0;

    // lane j's op fields (and wclock) into ring slot j % RING, one commit
    // group per lane (empty past the window's end)
    const auto fetch = [&](const int* lanes, int m, int j) {
      if (j < m) {
        const int s = j % RING;
        const long long o = (long long)v * B + lanes[j];
        if (lane == 0) {
          __pipeline_memcpy_async(ring_op + 4 * s, ops.key + o, 4);
          __pipeline_memcpy_async(ring_op + 4 * s + 1, ops.a0 + o, 4);
          __pipeline_memcpy_async(ring_op + 4 * s + 2, ops.writer + o, 4);
        }
        if (MODE == MODE_CAPTURED) {
          int* dst = ring_clock + s * w4;
          const int* src = ops.wclock + o * w;
          if (vec) {
            for (int q = 4 * lane; q < w; q += 4 * THREADS)
              __pipeline_memcpy_async(dst + q, src + q, 16);
          } else {
            for (int q = lane; q < w; q += THREADS)
              __pipeline_memcpy_async(dst + q, src + q, 4);
          }
        }
      }
      __pipeline_commit();
    };

    const auto walk = [&](const int* lanes, int m) {
      if (m == 0) return;
      for (int j = 0; j < RING; ++j) fetch(lanes, m, j);
      for (int j = 0; j < m; ++j) {
        __pipeline_wait_prior(RING - 1);
        __syncwarp();
        const int s = j % RING;
        const int key = ring_op[4 * s], a0 = ring_op[4 * s + 1],
                  wr = ring_op[4 * s + 2];
        const int nk = key < 0 ? key + K : key;
        const bool in_range = nk >= 0 && nk < K;
        int* single = e.clock + fs * ld;  // the free slot
        const int* cs = single;  // the singleton's clock
        if (MODE == MODE_CAPTURED) {
          cs = ring_clock + s * w4;
        } else {
          // observed clock, then the writer's lane bumped (as uint32)
          const int bump = MODE == MODE_UNCAPTURED ? (wr < 0 ? wr + w : wr)
                                                   : wr;
          for (int q = lane; q < w; q += THREADS) {
            int mx = INT_MIN;
            if (canon) {
              if (fill < vc) mx = 0;  // an empty position observes 0
              for (int p = 0; p < fill; ++p)
                mx = max(mx, e.clock[ord[p] * ld + q]);
            } else {
              for (int i = 0; i < vc; ++i)
                mx = max(mx, e.valid[i] ? e.clock[i * ld + q] : 0);
            }
            single[q] = (int)((unsigned)mx + (q == bump ? 1u : 0u));
          }
          __syncwarp();  // ring slot s is read: refill it
          fetch(lanes, m, j + RING);
        }
        if (MODE == MODE_CAPTURE) {
          const long long o = (long long)v * B + lanes[j];
          for (int q = lane; q < w; q += THREADS)
            wclock_out[o * w + q] = single[q];
        }
        if (MODE == MODE_UNCAPTURED) {
          if (in_range) {
            if (lane == 0) {
              e.val[fs] = a0;
              ord[0] = fs;
            }
            fill = 1;
            fs = fs == vc ? 0 : fs + 1;  // any slot but the value's
            canon = touched = true;
          }
          __syncwarp();
          continue;
        }
        int kept, slot = 0;
        if (canon) {
          kept = join_slots(e, cs, a0, ord, fill, fs, ld, w, split, &slot);
        } else {
          // raw: the staged slots are the entries in place, the singleton
          // in slot vc, so the frontier's output positions are slot indices
          if (MODE == MODE_CAPTURED)
            for (int q = lane; q < w; q += THREADS) single[q] = cs[q];
          if (lane == 0) {
            e.val[fs] = a0;
            e.valid[fs] = 1;
          }
          __syncwarp();
          kept = mvr::frontier(e.val, e.valid, e.clock, ld, n, w, vc, keep,
                               inv);
          if (lane < vc) slot = inv[lane];
        }
        drop += kept > vc ? kept - vc : 0;
        if (in_range) {
          const int filled = kept < vc ? kept : vc;
          if (canon) {  // s into the free slot (a slot only if kept)
            if (MODE == MODE_CAPTURED)
              for (int q = lane; q < w; q += THREADS) single[q] = cs[q];
            if (lane == 0) e.val[fs] = a0;
          }
          __syncwarp();
          if (lane < filled) ord[lane] = slot;
          const unsigned used = __reduce_or_sync(
              mvr::FULL, lane < filled && slot < 32 ? 1u << slot : 0u);
          fs = used == mvr::FULL ? 32 : __ffs(~used) - 1;  // a free slot
          fill = filled;
          canon = touched = true;
        }
        __syncwarp();
        if (MODE == MODE_CAPTURED) fetch(lanes, m, j + RING);
      }
      __pipeline_wait_prior(0);
      __syncwarp();
    };
    if (cnt <= THREADS) {
      // one window: the lanes sorted across the warp (bitonic, shuffles)
      int b = lane < cnt ? lists.lanes[(long long)v * B + lo + lane] : INT_MAX;
      for (int k = 2; k <= THREADS; k <<= 1)
        for (int j = k >> 1; j > 0; j >>= 1) {
          const int o = __shfl_xor_sync(mvr::FULL, b, j);
          b = ((lane & j) == 0) == ((lane & k) == 0) ? min(b, o) : max(b, o);
        }
      win[lane] = b;
      __syncwarp();
      walk(win, cnt);
    } else {
      lane_buckets::sorted_windows(lists.lanes + (long long)v * B + lo, cnt,
                                   B, win, WCAP, &s_count, walk);
    }
    if (touched) {  // canonical: the row in order, the rest empty
      for (int p = lane; p < vc; p += THREADS) {
        st.val[base + p] = p < fill ? e.val[ord[p]] : mvr::SENT;
        st.valid[base + p] = p < fill;
      }
      for (int p = 0; p < vc; ++p) {
        const int* src = e.clock + (p < fill ? ord[p] : 0) * ld;
        for (int q = lane; q < w; q += THREADS)
          st.clock[(base + p) * w + q] = p < fill ? src[q] : 0;
      }
    }
    if (lane == 0 && drop) atomicAdd(&dropped[v], drop);
    __syncwarp();
  }
}

template <int MODE>
int launch(void* const* state, const void* const* ops, void* wclock_out,
           void* dropped, void* const* scratch, int V, int K, int vc, int w,
           int B, void* stream) {
  if (V <= 0 || K <= 0 || B <= 0 || vc <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const lane_buckets::Lists lists{(int*)scratch[0], (int*)scratch[1],
                                  (int*)scratch[2]};
  const int* order = (const int*)scratch[3];
  // after count[V, K]: the work counter and the most groups of a view
  int* work = lists.count + (long long)V * K;
  const int* op = (const int*)ops[0];
  const int* key = (const int*)ops[1];
  const unsigned mask = 1u << OP_WRITE;
  // lane_buckets::build with scan_order_kernel as its scan
  const long long total = (long long)V * B;
  const long long want = (total + 255) / 256;
  const unsigned lanes_grid =
      (unsigned)(want < 132LL * 16 ? want : 132LL * 16);
  const size_t order_bytes =
      K <= ORDER_SHARED_GROUPS ? 2 * sizeof(int) * (size_t)K : 0;
  // the dynamic part and the static part (block_exclusive_scan's) together
  // pass 48 KB at the largest K, which needs the opt-in
  cudaError_t err = cudaFuncSetAttribute(
      scan_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)order_bytes);
  if (err != cudaSuccess) return (int)err;
  lane_buckets::count_kernel<<<lanes_grid, 256, 0, s>>>(op, key, mask, total,
                                                        B, K, lists.count);
  scan_order_kernel<<<V, ORDER_THREADS, order_bytes, s>>>(
      lists.count, lists.start, (int*)order, work + 1, K);
  lane_buckets::fill_kernel<<<lanes_grid, 256, 0, s>>>(
      op, key, mask, total, B, K, lists.count, lists.start, lists.lanes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = shared_bytes(vc, w);
  err = allow_shared(mvr_walk_kernel<MODE>, bytes);
  if (err != cudaSuccess) return (int)err;
  long long grid = 0;
  err = resident_blocks(mvr_walk_kernel<MODE>, THREADS, bytes, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid > (long long)V * K) grid = (long long)V * K;
  const Rows st{(int*)state[0], (unsigned char*)state[1], (int*)state[2]};
  const Ops o{op, key, (const int*)ops[2], (const int*)ops[3],
              (const int*)ops[4]};
  const bool vec = w % 4 == 0 && ((size_t)ops[4] & 15) == 0;
  mvr_walk_kernel<MODE><<<(unsigned)grid, THREADS, bytes, s>>>(
      st, o, lists, order, work, (int*)wclock_out, (int*)dropped, V, K, vc, w,
      B, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// state: three field pointers (val int32 [V, K, vc], valid bool [V, K,
// vc], clock int32 [V, K, vc, w]), updated in place; ops: five pointers
// (op, key, a0, writer int32 [V, B]; wclock int32 [V, B, w], null when
// uncaptured); dropped int32 [V], added to; scratch: four int32 buffers,
// [V * K + 2] zeroed, [V, K + 1], [V, B] and [V, K]. Contiguous on one
// device. Returns the first CUDA error of the launches.
extern "C" int mvr_apply_launch(void* const* state, const void* const* ops,
                                void* dropped, void* const* scratch, int V,
                                int K, int vc, int w, int B, void* stream) {
  if (ops[4] != nullptr)
    return launch<MODE_CAPTURED>(state, ops, nullptr, dropped, scratch, V, K,
                                 vc, w, B, stream);
  return launch<MODE_UNCAPTURED>(state, ops, nullptr, dropped, scratch, V, K,
                                 vc, w, B, stream);
}

// The capture mode: as mvr_apply_launch uncaptured (ops[4] ignored), the
// write then applying captured, and wclock_out int32 [V, B, w], which the
// caller zeroes, receiving each write lane's clock.
extern "C" int mvr_capture_launch(void* const* state, const void* const* ops,
                                  void* wclock_out, void* dropped,
                                  void* const* scratch, int V, int K, int vc,
                                  int w, int B, void* stream) {
  return launch<MODE_CAPTURE>(state, ops, wclock_out, dropped, scratch, V, K,
                              vc, w, B, stream);
}
