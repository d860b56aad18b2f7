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
// and touches at most 32,000 rows of 2.1 KB.
//
// Design: a write touches only the row it gathers, so rows are
// independent. lane_buckets.cuh groups the write lanes by (view, row);
// then one 32-thread block per (view, row) with writes stages the row in
// shared memory (clocks W | 1 ints apart), puts its lanes in lane order
// (windows of at most 2,048 lane indices, bitonic-sorted in shared memory)
// and walks them: the observed max and the wclock copy with the lanes
// across W; the first captured write of a row computes the frontier of its
// V + 1 entries (one entry a lane, O(V^2 W)), and since that leaves the row
// a frontier, every later one joins only the singleton (join_one: a group
// of lanes per entry across the clock, O(V W)); the joined row goes into a
// second buffer that becomes the row. The next lane's op fields, and its
// wclock (cp.async into shared memory), load while a lane is walked. The
// longest walk is the hottest row's. V <= 32. Launches on the caller's stream,
// allocates nothing (the caller passes the groups' scratch), does not
// synchronise.
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
constexpr int OP_WRITE = 1;
constexpr int MODE_UNCAPTURED = 0, MODE_CAPTURED = 1, MODE_CAPTURE = 2;

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

// one row of n entries in shared memory
struct Entries {
  int* clock;  // [n][ld]
  int* val;
  unsigned char* valid;
};

__device__ Entries carve(unsigned char*& at, int n, int ld) {
  Entries e;
  e.clock = (int*)at;
  e.val = e.clock + n * ld;
  e.valid = (unsigned char*)(e.val + n);
  at += ((4 * (n * ld + n) + n) + 15) & ~15;
  return e;
}

// The frontier of a row that is one already (valid entries first, sorted
// by (val, clock), pairwise non-dominated, distinct: what mvr::frontier
// leaves) joined with the valid singleton in entry vc; the same result as
// mvr::frontier on the vc + 1 entries, in O(vc W) instead of O(vc^2 W):
// only the singleton s can drop an entry (strictly dominating it), only an
// entry can drop s (strictly dominating it, or as its earlier exact twin),
// the kept entries stay in their order and s goes in after those that
// order before it. The warp's lanes split into one group of 32 / P lanes
// per entry (P the power of two >= vc), each group comparing its entry
// with s across the clock. Writes inv[p] for p < min(kept, vc); returns
// kept. vc <= 32. Every lane of the warp calls it; ends in __syncwarp().
__device__ int join_one(const Entries& r, int vc, int ld, int w, int* inv) {
  const int lane = threadIdx.x & 31;
  int p2 = 1;
  while (p2 < vc) p2 <<= 1;
  const int group = 32 / p2, e = lane / group, sub = lane % group;
  const bool has = e < vc && r.valid[e];
  const int* ce = r.clock + (e < vc ? e : 0) * ld;
  const int* cs = r.clock + vc * ld;
  bool le = true, ge = true;
  int diff = INT_MAX;  // the first clock lane where entry and s differ
  if (e < vc) {
    for (int q = sub; q < w; q += group) {
      const int x = ce[q], y = cs[q];
      le &= x <= y;
      ge &= x >= y;
      if (x != y && q < diff) diff = q;
    }
  }
  for (int off = 1; off < group; off <<= 1) {
    le &= __shfl_xor_sync(mvr::FULL, le, off);
    ge &= __shfl_xor_sync(mvr::FULL, ge, off);
    diff = min(diff, __shfl_xor_sync(mvr::FULL, diff, off));
  }
  const int ev = e < vc ? r.val[e] : 0, sval = r.val[vc];
  const bool lead = sub == 0 && has;
  const bool kept = lead && !(le && !ge);  // s does not dominate it
  const bool less = ev != sval ? ev < sval
                               : diff != INT_MAX && ce[diff] < cs[diff];
  const bool s_out = lead && ((ge && !le) || (le && ge && ev == sval));
  const unsigned kept_m = __ballot_sync(mvr::FULL, kept);
  const bool s_keep = !__any_sync(mvr::FULL, s_out);
  const int before = __popc(__ballot_sync(mvr::FULL, kept && less));
  if (kept) {
    const int rank = __popc(kept_m & ((1u << lane) - 1u));
    const int pos = rank + (s_keep && rank >= before);
    if (pos < vc) inv[pos] = e;
  }
  if (lane == 0 && s_keep && before < vc) inv[before] = vc;
  __syncwarp();
  return __popc(kept_m) + s_keep;
}

// Start copying the clock of w lanes at src into pre (shared), each lane
// of the warp its share, asynchronously (cp.async).
__device__ inline void prefetch_clock(int* pre, const int* src, int w) {
  for (int q = threadIdx.x & 31; q < w; q += 32)
    __pipeline_memcpy_async(pre + q, src + q, sizeof(int));
  __pipeline_commit();
}

__host__ __device__ inline size_t shared_bytes(int vc, int w) {
  const int n = vc + 1, ld = mvr::clock_ld(w);
  const size_t row = ((4 * (n * ld + n) + n) + 15) & ~15;
  return 2 * row + ((size_t)(4 * n + n + 15) & ~15) +
         ((size_t)(4 * w + 15) & ~15) + 4 * WCAP;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
mvr_walk_kernel(Rows st, Ops ops, lane_buckets::Lists lists,
                int* __restrict__ wclock_out, int* __restrict__ dropped,
                int V, int K, int vc, int w, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count;
  const int lane = threadIdx.x;
  const int n = vc + 1, ld = mvr::clock_ld(w);
  unsigned char* at = smem;
  Entries cur = carve(at, n, ld);
  Entries nxt = carve(at, n, ld);
  int* inv = (int*)at;
  unsigned char* keep = (unsigned char*)(inv + n);
  at += (4 * n + n + 15) & ~15;
  int* pre = (int*)at;  // [w]: the next captured write's clock, in flight
  at += (4 * w + 15) & ~15;
  int* win = (int*)at;  // [WCAP]

  for (long long blk = blockIdx.x; blk < (long long)V * K; blk += gridDim.x) {
    const int v = (int)(blk / K), g = (int)(blk % K);
    const int* start = lists.start + (long long)v * (K + 1);
    const int lo = start[g], cnt = start[g + 1] - lo;
    if (cnt == 0) continue;  // uniform across the block
    const long long base = blk * vc;
    for (int i = lane; i < vc; i += THREADS) {
      cur.val[i] = st.val[base + i];
      cur.valid[i] = st.valid[base + i];
    }
    for (int i = 0; i < vc; ++i)
      for (int q = lane; q < w; q += THREADS)
        cur.clock[i * ld + q] = st.clock[(base + i) * w + q];
    __syncwarp();
    bool touched = false;
    bool frontier_row = false;  // the staged row is a frontier output
    int drop = 0;
    auto walk = [&](const int* lanes, int m) {
      if (m == 0) return;
      // the next lane's fields are loaded while this one is walked
      long long o_n = (long long)v * B + lanes[0];
      int key_n = ops.key[o_n], a0_n = ops.a0[o_n], wr_n = ops.writer[o_n];
      if (MODE == MODE_CAPTURED) prefetch_clock(pre, ops.wclock + o_n * w, w);
      for (int j = 0; j < m; ++j) {
        const long long o = o_n;
        const int key = key_n, a0 = a0_n, wr = wr_n;
        if (j + 1 < m) {
          o_n = (long long)v * B + lanes[j + 1];
          key_n = ops.key[o_n];
          a0_n = ops.a0[o_n];
          wr_n = ops.writer[o_n];
        }
        const int nk = key < 0 ? key + K : key;
        const bool in_range = nk >= 0 && nk < K;
        int* single = cur.clock + vc * ld;  // the spare entry
        if (MODE == MODE_CAPTURED) {
          __pipeline_wait_prior(0);
          __syncwarp();
          for (int q = lane; q < w; q += THREADS) single[q] = pre[q];
          __syncwarp();
          if (j + 1 < m) prefetch_clock(pre, ops.wclock + o_n * w, w);
        } else {
          // observed clock, then the writer's lane bumped (as uint32)
          const int bump = MODE == MODE_UNCAPTURED ? (wr < 0 ? wr + w : wr)
                                                   : wr;
          for (int q = lane; q < w; q += THREADS) {
            int mx = INT_MIN;
            for (int i = 0; i < vc; ++i)
              mx = max(mx, cur.valid[i] ? cur.clock[i * ld + q] : 0);
            single[q] = (int)((unsigned)mx + (q == bump ? 1u : 0u));
          }
        }
        if (MODE == MODE_CAPTURE)
          for (int q = lane; q < w; q += THREADS)
            wclock_out[o * w + q] = single[q];
        __syncwarp();
        if (MODE == MODE_UNCAPTURED) {
          if (in_range) {
            for (int q = lane; q < w; q += THREADS) {
              cur.clock[q] = single[q];
              for (int i = 1; i < vc; ++i) cur.clock[i * ld + q] = 0;
            }
            for (int i = lane; i < vc; i += THREADS) {
              cur.val[i] = i == 0 ? a0 : mvr::SENT;
              cur.valid[i] = i == 0;
            }
            touched = true;
          }
          __syncwarp();
          continue;
        }
        if (lane == 0) {
          cur.val[vc] = a0;
          cur.valid[vc] = 1;
        }
        __syncwarp();
        const int kept =
            frontier_row
                ? join_one(cur, vc, ld, w, inv)
                : mvr::frontier(cur.val, cur.valid, cur.clock, ld, n, w, vc,
                                keep, inv);
        drop += kept > vc ? kept - vc : 0;
        if (!in_range) continue;
        touched = true;
        frontier_row = true;
        const int fill = kept < vc ? kept : vc;
        for (int p = lane; p < vc; p += THREADS) {
          nxt.val[p] = p < fill ? cur.val[inv[p]] : mvr::SENT;
          nxt.valid[p] = p < fill;
        }
        for (int p = 0; p < vc; ++p) {
          const int* src = cur.clock + (p < fill ? inv[p] : 0) * ld;
          for (int q = lane; q < w; q += THREADS)
            nxt.clock[p * ld + q] = p < fill ? src[q] : 0;
        }
        __syncwarp();
        const Entries t = cur;
        cur = nxt;
        nxt = t;
      }
    };
    lane_buckets::sorted_windows(lists.lanes + (long long)v * B + lo, cnt, B,
                                 win, WCAP, &s_count, walk);
    if (touched) {
      for (int i = lane; i < vc; i += THREADS) {
        st.val[base + i] = cur.val[i];
        st.valid[base + i] = cur.valid[i];
      }
      for (int i = 0; i < vc; ++i)
        for (int q = lane; q < w; q += THREADS)
          st.clock[(base + i) * w + q] = cur.clock[i * ld + q];
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
  cudaError_t err = lane_buckets::build((const int*)ops[0],
                                        (const int*)ops[1], 1u << OP_WRITE, V,
                                        K, B, lists, s);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = shared_bytes(vc, w);
  err = allow_shared(mvr_walk_kernel<MODE>, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)V * K;
  const long long grid = blocks < 132LL * 64 ? blocks : 132LL * 64;
  const Rows st{(int*)state[0], (unsigned char*)state[1], (int*)state[2]};
  const Ops o{(const int*)ops[0], (const int*)ops[1], (const int*)ops[2],
              (const int*)ops[3], (const int*)ops[4]};
  mvr_walk_kernel<MODE><<<(unsigned)grid, THREADS, bytes, s>>>(
      st, o, lists, (int*)wclock_out, (int*)dropped, V, K, vc, w, B);
  return (int)cudaGetLastError();
}

}  // namespace

// state: three field pointers (val int32 [V, K, vc], valid bool [V, K,
// vc], clock int32 [V, K, vc, w]), updated in place; ops: five pointers
// (op, key, a0, writer int32 [V, B]; wclock int32 [V, B, w], null when
// uncaptured); dropped int32 [V], added to; scratch: three int32 buffers,
// [V, K] zeroed, [V, K + 1] and [V, B]. Contiguous on one device. Returns
// the first CUDA error of the launches.
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
