// slot_union: the sorted union of two slot sets, one row per warp or
// block, for the OR-Set (slot_union_launch), the RGA (rga_union_launch),
// the LWW-Set (lww_union_launch), the 2P-Set and the 2P2P Graph's vertices
// (tp_union_launch) and the Graph's edges (edge_union_launch).
//
// Replaces: janus_tpu/ops/setops.py slot_union with the OR-Set fold
// (janus_tpu/models/orset.py _combine) and with the RGA fold
// (janus_tpu/models/rga.py _combine) and with the LWW-Set fold
// (janus_tpu/models/lwwset.py _combine, with lattice.ts_max) and with the
// tombstone OR of janus_tpu/models/tpset.py _combine (38-40) and
// janus_tpu/models/graph.py merge (184-193): the join of merge and of the
// replica-axis converge (store.join_all's halving tree).
// Per row: the Ca + Cb records sorted stably by their int32 key fields
// (OR-Set: tag_rep, tag_ctr; RGA: id_ctr, id_rep; LWW-Set and 2P: elem;
// edges: src, dst), invalid slots keyed SENTINEL; a record that repeats
// the valid key of the record before it is a duplicate and is dropped, and
// a kept record ORs its flag (OR-Set and 2P: removed; RGA: dead; the
// LWW-Set has none) with the record right
// after it when that one is a duplicate, and folds its int32 payloads with
// that record's by the layout's fold (OR-Set: elem stays the kept copy's;
// RGA: par_ctr, par_rep and chr take the max; LWW-Set: (add_hi, add_lo)
// and (rm_hi, rm_lo) each take the lexicographic max, the low word
// unsigned, the kept copy's on a tie); the kept records fill the output in
// order, cut to `cap`, the rest canonical (SENTINEL keys, zero payloads);
// overflow = kept - cap.
//
// The layout is a set of template parameters (NK int32 key fields, NP
// int32 payload fields, whether a bool flag exists, and the payloads'
// fold, the "fold selector"), so the five layouts share one merge, one
// duplicate rule and one compaction; each instantiation compiles only its
// own layout (a one-key record orders on (key, position)). The 2P
// layouts have no payload (NP = 0): the payload arrays are declared with
// one unused entry there (PAY_SLOTS), a compile-time size, so every
// payload loop is empty and the layouts with payloads compile as before.
//
// What bounds it on the H100: bytes. A row reads (Ca + Cb) slots and
// writes cap slots per output replica (14 bytes an OR-Set slot, 22 an RGA
// one, 21 an LWW-Set one, 6 a 2P one, 10 an edge). At the OR-Set converge
// of 64 replicas x 500 keys x 256 slots (114.7 MB of state) the halving
// tree reads about 2 x 114.7 MB and writes 114.7 MB into its levels, then
// 114.7 MB into the replicas, ~0.13 ms of traffic at 3.35 TB/s. At the RGA
// converge (rga preset: R=1,024, K=128, C=1,024, 2.95 GB of state) it
// reads ~2 x 2.95 GB and writes ~2.95 GB into its levels, then 2.95 GB
// into the replicas, ~3.5 ms; level 1 joins 65,536 rows of 2,048 records.
// The LWW-Set's Store converge at the same 64 x 500 x 256 holds 172 MB and
// moves ~4 x 172 MB, ~0.2 ms. The merge is O(Ca + Cb) per row once its
// two rows are sorted, which every union output is; a row's unsorted tail
// of t records costs t log^2 t / 4 compare-swaps more.
//
// Design: the rows are merged, not sorted (merge_row). Every layout's rows
// come sorted by key, or nearly (a union writes them sorted, the
// compaction is a stable partition, an RGA apply mints ids above every id
// of its row into the first free slot, an OR-Set apply and the captured
// replay leave every row they touch in tag order; a 2P-Set, Graph or
// LWW-Set apply inserts new keys at the first free slot, after the sorted
// ones), so each input row is checked for a descent, its tail after the
// first descent sorted alone and merged into its prefix (order_row), and
// the two rows are merged along the merge path. The records (keys,
// payloads, the row's order and the merged order, valid and flag bits) are
// staged in shared memory, 25 bytes a record for the RGA and the LWW-Set,
// 17 for the OR-Set, 13 for edges, 9 for the 2P layout, so every read of
// the inputs happens before any write: the output may alias an input row
// (the converge writes the last level into the replicas it read). The
// RGA's 2,048-record rows take a block of 256 threads; the other layouts'
// rows take one warp each (WarpRow), WARP_ROWS rows a block, synchronised
// by the warp alone, so an SM holds ~24 OR-Set rows in flight (one
// 256-thread block a row held ~8). With `repeat` > 1 the row is written
// into each of `repeat` output replicas (the converge's broadcast; outside
// the RGA by a block of 256 threads a row, one output slot a thread).
// Launches on the caller's stream, allocates nothing, does not
// synchronise.
//
// Row-list mode (slot_union_rows_launch, rga_union_rows_launch,
// lww_union_rows_launch, tp_union_rows_launch, edge_union_rows_launch):
// replaces
// converge_delta's slab path (store.py:114-121: gather the listed key rows
// into an [R, D, C] slab, join_all's halving tree, scatter back into every
// replica). The tree runs as in the full converge, but each level joins
// only the listed rows: level 1 reads them straight from the [R, K, C]
// state, the middle levels work in [pairs, K, C] scratch, and the last
// level writes each joined row into all R replicas at its key. How many
// rows to join is read from device memory (delta_select's n_join: the dirty
// count, or every key on overflow); the grid is one wave and blocks past
// that number exit. When R == 2 level 1 is also the last and writes the
// rows it read: a block stages its row before writing, and listed rows are
// distinct, so no block reads a row another block writes. Bound at
// mixed_delta (R=64, C=256) per listed row: level 1 reads 64 and writes 32
// rows of 3,584 bytes, 344 KB, the whole tree ~2 x 126 rows, 903 KB.
#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

// the fold of a kept record's int32 payloads with its duplicate's:
// FOLD_TS_MAX takes payloads (0, 1) and (2, 3) as (hi, lo) timestamps
enum Fold { FOLD_KEEP = 0, FOLD_MAX = 1, FOLD_TS_MAX = 2 };

// entries of a payload array: NP, or one unused entry when the layout has
// no payload (a zero-length array is ill-formed)
template <int NP>
constexpr int PAY_SLOTS = NP > 0 ? NP : 1;

// a slot set: NK (1 or 2) int32 key fields, NP int32 payload fields, a
// bool flag folded by OR (unused without one), and the bool valid mask
template <int NP>
struct Slots {
  const int* key[2];
  const int* pay[PAY_SLOTS<NP>];
  const unsigned char* flag;
  const unsigned char* valid;
};

template <int NP>
struct OutSlots {
  int* key[2];
  int* pay[PAY_SLOTS<NP>];
  unsigned char* flag;
  unsigned char* valid;
};

// timestamp (hi_a, lo_a) >= (hi_b, lo_b), the low word unsigned
// (janus_tpu/ops/lattice.py ts_after)
__device__ __forceinline__ bool ts_after(int hi_a, int lo_a, int hi_b,
                                         int lo_b) {
  return hi_a > hi_b || (hi_a == hi_b && (unsigned)lo_a >= (unsigned)lo_b);
}

// shared memory per staged record of a merge: NK keys, NP payloads, two
// orders and the flags
template <int NK, int NP>
__host__ __device__ constexpr size_t record_bytes() {
  return NK * sizeof(int) + NP * sizeof(int) + 2 * sizeof(short) + 1;
}

// the least of one int over the block's threads (every thread calls it)
__device__ __forceinline__ int block_min(int v) {
  __shared__ int part[32];
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = v;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = min(m, part[w]);
  __syncthreads();
  return m;
}

// The threads that join one row. BlockRow: the whole block, one row at a
// time (the RGA's merge, a broadcast). WarpRow: one
// warp, blockDim.x / 32 rows a block side by side, each in its own slice
// of the dynamic shared memory and synchronised by its warp alone (the
// warp merge when it writes one replica).
struct BlockRow {
  static constexpr bool BLOCK = true;
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ long long first() const { return blockIdx.x; }
  __device__ long long stride() const { return gridDim.x; }
  __device__ void sync() const { __syncthreads(); }
  __device__ int min_of(int v) const { return block_min(v); }
  __device__ __forceinline__ int exclusive_sum(int v, int* total) const {
    return block_exclusive_sum(v, total);
  }
  template <typename T, typename Less>
  __device__ void sort(T* a, int n, Less less) const {
    block_sort(a, n, less);
  }
  // the row's first int4 of the dynamic shared memory
  __device__ size_t slice(size_t) const { return 0; }
};

struct WarpRow {
  static constexpr bool BLOCK = false;
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ long long first() const {
    return (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  }
  __device__ long long stride() const {
    return (long long)gridDim.x * (blockDim.x >> 5);
  }
  __device__ void sync() const { __syncwarp(); }
  __device__ int min_of(int v) const {
    return __reduce_min_sync(0xffffffffu, v);
  }
  __device__ __forceinline__ int exclusive_sum(int v, int* total) const {
    const int lane = threadIdx.x & 31;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    *total = __shfl_sync(0xffffffffu, inc, 31);
    return inc - v;
  }
  // slot_sort::block_sort's network on the warp's 32 threads
  template <typename T, typename Less>
  __device__ __forceinline__ void sort(T* a, int n, Less less) const {
    int p = 1;
    while (p < n) p <<= 1;
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int t = rank(); t < (p >> 1); t += 32) {
          const int lo = (t / j) * 2 * j + (t % j);
          const int hi = (j == (k >> 1)) ? (lo ^ (k - 1)) : (lo + j);
          if (hi < n) {
            const T x = a[lo], y = a[hi];
            if (less(y, x)) {
              a[lo] = y;
              a[hi] = x;
            }
          }
        }
        __syncwarp();
      }
    }
  }
  // the warp's row's first int4, rows of `bytes` (a multiple of 16)
  __device__ size_t slice(size_t bytes) const {
    return (threadIdx.x >> 5) * (bytes / sizeof(int4));
  }
};

// The staged keys of a merge: NK int32 fields by position (ky unused when
// NK == 1), compared as signed int32 in field order.
template <int NK>
struct Keys {
  const int* kx;
  const int* ky;
  // the key at position p before the key at q (every field is loaded
  // before any is compared, so the loads go out together)
  __device__ bool lt(int p, int q) const {
    const int xp = kx[p], xq = kx[q];
    if constexpr (NK == 2) {
      const int yp = ky[p], yq = ky[q];
      return xp < xq || (xp == xq && yp < yq);
    } else {
      return xp < xq;
    }
  }
  __device__ bool eq(int p, int q) const {
    const int xp = kx[p], xq = kx[q];
    if constexpr (NK == 2) {
      const int yp = ky[p], yq = ky[q];
      return xp == xq && yp == yq;
    } else {
      return xp == xq;
    }
  }
  // the greatest key: SENTINEL in every field (an invalid slot's)
  __device__ bool top(int p) const {
    if constexpr (NK == 2) return kx[p] == SENT && ky[p] == SENT;
    else return kx[p] == SENT;
  }
  // (key, position) of two staged positions: the stable order
  __device__ bool operator()(int i, int j) const {
    if (lt(i, j)) return true;
    if (lt(j, i)) return false;
    return i < j;
  }
};

// The order of the staged row at positions [base, base + c) whose keys
// first descend at d (d > 0): its positions by (key, position), written to
// perm[base, base + c). The row is a sorted prefix [0, d) and a tail (the
// 2P-Set's and the Graph's applies insert at the first free slot, so a
// touched row holds its sorted records, then its new keys in apply order,
// then invalid slots). The tail up to its last record whose key is not
// the greatest, [d, e), is sorted alone and merged into the prefix, ties
// to the prefix; [e, c) hold the greatest key at the highest positions
// and stay last. Only the prefix from the first record above the tail's
// least key moves. `tmp` ([base, base + c) free) takes the merged order
// before it is copied back.
template <int NK, class G>
__device__ __forceinline__ void order_row(const G& grp, Keys<NK> key,
                                          unsigned short* perm,
                                          unsigned short* tmp, int base,
                                          int c, int d) {
  int last = d + 1;  // the record at d is below another: not the greatest
  for (int i = d + 1 + grp.rank(); i < c; i += grp.size())
    if (!key.top(base + i)) last = i + 1;
  const int e = -grp.min_of(-last);
  const int t = e - d;
  grp.sort(perm + base + d, t, key);
  grp.sync();
  const unsigned short* tail = perm + base + d;
  // s: the first prefix record above the tail's least key
  const int least = tail[0];
  int lo = 0, hi = d;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key.lt(least, base + mid)) hi = mid;
    else lo = mid + 1;
  }
  const int s = lo;
  // a prefix record goes after the tail's records with a lower key
  for (int p = s + grp.rank(); p < d; p += grp.size()) {
    int l = 0, h = t;
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (key.lt(tail[mid], base + p)) l = mid + 1;
      else h = mid;
    }
    tmp[base + p + l] = (unsigned short)(base + p);
  }
  // a tail record after the prefix's records with a key at most its own
  for (int r = grp.rank(); r < t; r += grp.size()) {
    const int q = tail[r];
    int l = s, h = d;
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (key.lt(q, base + mid)) h = mid;
      else l = mid + 1;
    }
    tmp[base + l + r] = (unsigned short)q;
  }
  grp.sync();
  for (int i = base + s + grp.rank(); i < base + e; i += grp.size())
    perm[i] = tmp[i];
  grp.sync();
}

// Stage slot i of row `at` of s at position base + i: its NK keys
// (SENTINEL when invalid), valid | flag << 1, its payloads, and the
// position as the row's order.
template <int NK, int NP, bool FLAG>
__device__ __forceinline__ void stage_slot(const Slots<NP>& s, long long at,
                                           int i, int base, int n, int* kx,
                                           int* ky, int* pay,
                                           unsigned short* perm,
                                           unsigned char* fl) {
  const long long g = at + i;
  const bool v = s.valid[g];
  const bool f = FLAG && s.flag[g];
  const int k0 = s.key[0][g];
  const int k1 = NK == 2 ? s.key[1][g] : 0;
  const int k = base + i;
  kx[k] = v ? k0 : SENT;
  if constexpr (NK == 2) ky[k] = v ? k1 : SENT;
  fl[k] = (unsigned char)((int)v | ((int)f << 1));
  perm[k] = (unsigned short)k;
#pragma unroll
  for (int p = 0; p < NP; ++p) pay[p * n + k] = s.pay[p][g];
}

// Stage row `at` of s (c slots) at positions [base, base + c), one slot a
// thread at a time: a block's threads in the loop the RGA's merge compiled
// with (its batched form cost that kernel four registers and a spill), a
// warp's lanes 32 slots apart (four slots a lane in flight spilled every
// warp kernel).
template <int NK, int NP, bool FLAG, class G>
__device__ __forceinline__ void stage_row(const G& grp, const Slots<NP>& s,
                                          long long at, int c, int base,
                                          int n, int* kx, int* ky, int* pay,
                                          unsigned short* perm,
                                          unsigned char* fl) {
  if constexpr (G::BLOCK) {
    for (int i = threadIdx.x; i < c; i += blockDim.x)
      stage_slot<NK, NP, FLAG>(s, at, i, base, n, kx, ky, pay, perm, fl);
  } else {
    for (int i = grp.rank(); i < c; i += 32)
      stage_slot<NK, NP, FLAG>(s, at, i, base, n, kx, ky, pay, perm, fl);
  }
}

// The union of row `a_at` of a (ca slots) and row `b_at` of b (cb slots),
// written at out + out_at + p * out_plane for p < repeat, by a merge of the
// two rows sorted (returns the kept count before the cut to cap). Every
// thread of the group calls it. The order on (key, position) is a's
// records in their order on (key, position) merged with b's, ties to a;
// each row is already in that order when its keys do not descend, and a
// row whose keys do descend is put in order alone first (order_row: its
// tail sorted and merged into its sorted prefix). Each thread then
// takes a run of `per` merged positions, finds where it starts in a and b
// by a binary search on its diagonal (the merge path) and merges the run
// sequentially. A merged record is kept when it is valid and does not
// repeat the valid key before it; the kept records' slots come from a
// prefix sum of the runs' counts, and the writes go out by slot. Shared
// memory per record: keys 4 bytes a field, 4 per payload, the row's order
// and the merged order 2 each, flags 1 (25 for the RGA and the LWW-Set,
// 17 for the OR-Set, 13 for edges, 9 for the 2P layout). `grp` is the block
// (BlockRow) or one warp (WarpRow).
template <int NK, int NP, bool FLAG, int FOLD, class G>
__device__ __forceinline__ int merge_row(const G& grp, const Slots<NP>& a,
                                         long long a_at, const Slots<NP>& b,
                                         long long b_at,
                                         const OutSlots<NP>& out,
                                         long long out_at,
                                         long long out_plane, int repeat,
                                         int ca, int cb, int cap) {
  extern __shared__ int4 smem[];
  const int n = ca + cb;
  const size_t row_bytes = round16((size_t)n * record_bytes<NK, NP>());
  int* kx = (int*)(smem + grp.slice(row_bytes));       // [NK][n] by position
  int* ky = kx + (NK - 1) * n;                         // kx when NK == 1
  int* pay = kx + NK * n;                              // [NP][n]
  unsigned short* perm = (unsigned short*)(pay + NP * n);  // [n] see below
  unsigned short* ord = perm + n;                      // [n] merged order
  unsigned char* fl = (unsigned char*)(ord + n);       // [n] valid|flag|kept

  stage_row<NK, NP, FLAG>(grp, a, a_at, ca, 0, n, kx, ky, pay, perm, fl);
  stage_row<NK, NP, FLAG>(grp, b, b_at, cb, ca, n, kx, ky, pay, perm, fl);
  grp.sync();

  // each row's first descent (its width when its keys never descend)
  const Keys<NK> key{kx, ky};
  int first_a = ca, first_b = cb;
  for (int i = grp.rank() + 1; i < n; i += grp.size()) {
    if (i == ca) continue;  // the seam between the rows
    if (key.lt(i, i - 1)) {
      if (i < ca) first_a = min(first_a, i);
      else first_b = min(first_b, i - ca);
    }
  }
  const int da = grp.min_of(first_a), db = grp.min_of(first_b);
  const bool sort_a = da < ca, sort_b = db < cb;
  // perm: each row's positions in its own order (the identity unless the
  // row's keys descend somewhere); ord is free until the merge below
#pragma unroll 1
  for (int r = 0; r < 2; ++r)  // a loop, so the rows share one sort
    if (r ? sort_b : sort_a)
      order_row(grp, key, perm, ord, r ? ca : 0, r ? cb : ca, r ? db : da);
  // the position of a's i-th and b's j-th record in their rows' order
  // (a sorted row reads its positions directly)
  const auto at_a = [&](int i) { return sort_a ? (int)perm[i] : i; };
  const auto at_b = [&](int j) {
    return sort_b ? (int)perm[ca + j] : ca + j;
  };

  // the merge path: positions [d0, d1) of the merged order
  const int per = (n + grp.size() - 1) / grp.size();
  const int d0 = min(n, grp.rank() * per), d1 = min(n, d0 + per);
  if (d0 < d1) {
    int lo = max(0, d0 - cb), hi = min(d0, ca);
    while (lo < hi) {  // a's count among the first d0 merged
      const int mid = (lo + hi) >> 1;
      const int pa = at_a(mid), pb = at_b(d0 - 1 - mid);
      if (key.lt(pb, pa)) hi = mid;
      else lo = mid + 1;
    }
    int i = lo, j = d0 - lo;
    for (int d = d0; d < d1; ++d) {
      bool take_a = j >= cb;
      if (i < ca && j < cb) {
        const int pa = at_a(i), pb = at_b(j);
        take_a = !key.lt(pb, pa);
      }
      ord[d] = (unsigned short)(take_a ? at_a(i++) : at_b(j++));
    }
  }
  grp.sync();

  // kept: valid and not a repeat of the valid key before it (marked in fl)
  int count = 0;
  for (int d = d0; d < d1; ++d) {
    const int o = ord[d];
    bool keep = fl[o] & 1;
    if (keep && d > 0) {
      const int q = ord[d - 1];
      keep = !((fl[q] & 1) && key.eq(q, o));
    }
    if (keep) {
      fl[o] |= 4;
      ++count;
    }
  }
  int kept;
  int slot = grp.exclusive_sum(count, &kept);
  // perm now maps each output slot to its merged position
  for (int d = d0; d < d1 && slot < cap; ++d)
    if (fl[ord[d]] & 4) perm[slot++] = (unsigned short)d;
  grp.sync();

  const int fill = min(kept, cap);
  for (int s = grp.rank(); s < fill; s += grp.size()) {
    const int d = perm[s];
    const int o = ord[d];
    bool f = (fl[o] >> 1) & 1;
    int next = -1;  // the duplicate right after, if any: valid, not kept
    if (d + 1 < n) {
      const int nx = ord[d + 1];
      if ((fl[nx] & 5) == 1) {
        f |= (fl[nx] >> 1) & 1;
        next = nx;
      }
    }
    int v[PAY_SLOTS<NP>];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      v[p] = pay[p * n + o];
      if (FOLD == FOLD_MAX && next >= 0) v[p] = max(v[p], pay[p * n + next]);
    }
    if (FOLD == FOLD_TS_MAX && next >= 0) {
#pragma unroll
      for (int p = 0; p + 1 < NP; p += 2) {
        const int hi = pay[p * n + next], lo = pay[(p + 1) * n + next];
        if (!ts_after(v[p], v[p + 1], hi, lo)) {
          v[p] = hi;
          v[p + 1] = lo;
        }
      }
    }
    for (int p = 0; p < repeat; ++p) {
      const long long at = p * out_plane + out_at + s;
      out.key[0][at] = kx[o];
      if constexpr (NK == 2) out.key[1][at] = ky[o];
#pragma unroll
      for (int q = 0; q < NP; ++q) out.pay[q][at] = v[q];
      if (FLAG) out.flag[at] = f;
      out.valid[at] = 1;
    }
  }
  for (int s = fill + grp.rank(); s < cap; s += grp.size()) {
    for (int p = 0; p < repeat; ++p) {
      const long long at = p * out_plane + out_at + s;
      out.key[0][at] = SENT;
      if (NK == 2) out.key[1][at] = SENT;
#pragma unroll
      for (int q = 0; q < NP; ++q) out.pay[q][at] = 0;
      if (FLAG) out.flag[at] = 0;
      out.valid[at] = 0;
    }
  }
  grp.sync();
  return kept;
}

template <int NK, int NP, bool FLAG, int FOLD, class G>
__device__ __forceinline__ void union_all(const G& grp, const Slots<NP>& a,
                                          const Slots<NP>& b,
                                          const OutSlots<NP>& out,
                                          int* __restrict__ overflow,
                                          long long rows, int ca, int cb,
                                          int cap, int repeat) {
  if constexpr (G::BLOCK) {
    for (long long row = grp.first(); row < rows; row += grp.stride()) {
      const int kept = merge_row<NK, NP, FLAG, FOLD>(
          grp, a, row * ca, b, row * cb, out, row * cap,
          rows * (long long)cap, repeat, ca, cb, cap);
      if (grp.rank() == 0) overflow[row] = kept > cap ? kept - cap : 0;
    }
  } else {
    // a warp counts its rows in 32 bits (rows < 2^31, launch), as the
    // row-list mode does
    const int n = (int)rows, step = (int)grp.stride();
    for (int row = (int)grp.first(); row < n; row += step) {
      const int kept = merge_row<NK, NP, FLAG, FOLD>(
          grp, a, (long long)row * ca, b, (long long)row * cb, out,
          (long long)row * cap, rows * (long long)cap, repeat, ca, cb, cap);
      if (grp.rank() == 0) overflow[row] = kept > cap ? kept - cap : 0;
    }
  }
}

// Row-list mode: virtual row v = j * pairs + r joins key row
// `gather ? rows[j] : j` of pair r of a and b ([pairs, num_keys, c] each)
// for j < n_join (read from device memory, clamped to `listed`). Without
// `scatter` the result goes to out[r, j] ([pairs, num_keys, c] scratch);
// with it (pairs == 1) to out[p, rows[j]] for every p < repeat, the
// replicas of the state.
template <int NK, int NP, bool FLAG, int FOLD, class G>
__device__ __forceinline__ void join_listed(
    const G& grp, const Slots<NP>& a, const Slots<NP>& b,
    const OutSlots<NP>& out, const int* __restrict__ rows, int num_keys,
    int c, int gather, int scatter, int repeat, int j, long long r) {
  const int k = rows[j];
  if (k < 0 || k >= num_keys) return;  // uniform across the group
  const long long in_at = (r * num_keys + (gather ? k : j)) * c;
  const long long out_at = scatter ? (long long)k * c
                                   : (r * num_keys + j) * c;
  merge_row<NK, NP, FLAG, FOLD>(grp, a, in_at, b, in_at, out, out_at,
                                (long long)num_keys * c,
                                scatter ? repeat : 1, c, c, c);
}

// The virtual rows are counted in 32 bits (listed * pairs < 2^30,
// launch_rows): a 64-bit division is a routine whose call costs the
// kernels a stack frame.
template <int NK, int NP, bool FLAG, int FOLD, class G>
__device__ __forceinline__ void union_listed(
    const G& grp, const Slots<NP>& a, const Slots<NP>& b,
    const OutSlots<NP>& out, const int* __restrict__ rows, int listed,
    const int* __restrict__ n_rows, int pairs, int num_keys, int c,
    int gather, int scatter, int repeat) {
  int m = *n_rows;
  m = m < 0 ? 0 : (m > listed ? listed : m);
  const int total = m * pairs;
  for (int v = (int)grp.first(); v < total; v += (int)grp.stride())
    join_listed<NK, NP, FLAG, FOLD>(grp, a, b, out, rows, num_keys, c, gather,
                                    scatter, repeat, v / pairs, v % pairs);
}

// The block kernels are bounded by the
// threads a block launches with, THREADS. The RGA's are kept to 64
// registers a thread (at most 1,024 threads a block), so that four blocks
// of 256 threads fit an SM, as shared memory allows at 1,024-slot rows; an
// RGA broadcast (repeat > 1) runs MERGE_BROADCAST_THREADS a block, its one
// block a row spreading the writes of every output replica over more
// warps. The warp merge's broadcast runs 256, one thread an output slot.
constexpr int MERGE_BROADCAST_THREADS = 1024;

template <int NK, int NP, bool FLAG, int FOLD, int THREADS>
__global__ void __launch_bounds__(THREADS)
    merge_union_kernel(Slots<NP> a, Slots<NP> b, OutSlots<NP> out,
                       int* __restrict__ overflow, long long rows, int ca,
                       int cb, int cap, int repeat) {
  union_all<NK, NP, FLAG, FOLD>(BlockRow(), a, b, out, overflow, rows,
                                      ca, cb, cap, repeat);
}

template <int NK, int NP, bool FLAG, int FOLD, int THREADS>
__global__ void __launch_bounds__(THREADS)
    merge_union_rows_kernel(Slots<NP> a, Slots<NP> b, OutSlots<NP> out,
                            const int* __restrict__ rows, int listed,
                            const int* __restrict__ n_rows, int pairs,
                            int num_keys, int c, int gather, int scatter,
                            int repeat) {
  union_listed<NK, NP, FLAG, FOLD>(BlockRow(), a, b, out, rows, listed,
                                         n_rows, pairs, num_keys, c, gather,
                                         scatter, repeat);
}

// The warp merge's kernels: one warp a row, WARP_ROWS rows a block (fewer
// when a block cannot hold that many rows' shared memory). Shared memory
// holds ~26 OR-Set rows an SM whatever the block; two rows a block spread
// a short row list over the most SMs.
constexpr int WARP_ROWS = 2;

template <int NK, int NP, bool FLAG, int FOLD>
__global__ void __launch_bounds__(32 * WARP_ROWS)
    warp_union_kernel(Slots<NP> a, Slots<NP> b, OutSlots<NP> out,
                      int* __restrict__ overflow, long long rows, int ca,
                      int cb, int cap, int repeat) {
  union_all<NK, NP, FLAG, FOLD>(WarpRow(), a, b, out, overflow, rows,
                                      ca, cb, cap, repeat);
}

template <int NK, int NP, bool FLAG, int FOLD>
__global__ void __launch_bounds__(32 * WARP_ROWS)
    warp_union_rows_kernel(Slots<NP> a, Slots<NP> b, OutSlots<NP> out,
                           const int* __restrict__ rows, int listed,
                           const int* __restrict__ n_rows, int pairs,
                           int num_keys, int c, int gather, int scatter,
                           int repeat) {
  union_listed<NK, NP, FLAG, FOLD>(WarpRow(), a, b, out, rows, listed,
                                         n_rows, pairs, num_keys, c, gather,
                                         scatter, repeat);
}

// The same two kernels bounded to one block an SM, for the LWW layout:
// bounded by their threads alone, ptxas held its warp merge (four
// payloads a record) to 64 registers and spilled to a stack frame; so
// bounded they take ~110 registers and no stack, and shared memory (25.6
// KB a block of two 512-record rows) holds them to 8 blocks an SM, as
// those registers do.
template <int NK, int NP, bool FLAG, int FOLD>
__global__ void __launch_bounds__(32 * WARP_ROWS, 1)
    wide_warp_union_kernel(Slots<NP> a, Slots<NP> b, OutSlots<NP> out,
                           int* __restrict__ overflow, long long rows,
                           int ca, int cb, int cap, int repeat) {
  union_all<NK, NP, FLAG, FOLD>(WarpRow(), a, b, out, overflow, rows, ca, cb,
                                cap, repeat);
}

template <int NK, int NP, bool FLAG, int FOLD>
__global__ void __launch_bounds__(32 * WARP_ROWS, 1)
    wide_warp_union_rows_kernel(Slots<NP> a, Slots<NP> b, OutSlots<NP> out,
                                const int* __restrict__ rows, int listed,
                                const int* __restrict__ n_rows, int pairs,
                                int num_keys, int c, int gather,
                                int scatter, int repeat) {
  union_listed<NK, NP, FLAG, FOLD>(WarpRow(), a, b, out, rows, listed,
                                   n_rows, pairs, num_keys, c, gather,
                                   scatter, repeat);
}

// a layout's warp merge kernels: the LWW layout's bounded to one block an
// SM (wide_*), the others' by their threads alone
template <int NK, int NP, bool FLAG, int FOLD>
auto warp_kernel() {
  if constexpr (FOLD == FOLD_TS_MAX)
    return wide_warp_union_kernel<NK, NP, FLAG, FOLD>;
  else
    return warp_union_kernel<NK, NP, FLAG, FOLD>;
}

template <int NK, int NP, bool FLAG, int FOLD>
auto warp_rows_kernel() {
  if constexpr (FOLD == FOLD_TS_MAX)
    return wide_warp_union_rows_kernel<NK, NP, FLAG, FOLD>;
  else
    return warp_union_rows_kernel<NK, NP, FLAG, FOLD>;
}

// fields in the entry points' order: the NK keys, the NP payloads, the
// flag (if the layout has one), valid
template <int NK, int NP, bool FLAG>
Slots<NP> in_slots(const void* const* f) {
  Slots<NP> s;
  s.key[0] = (const int*)f[0];
  s.key[1] = NK == 2 ? (const int*)f[1] : nullptr;
  for (int p = 0; p < NP; ++p) s.pay[p] = (const int*)f[NK + p];
  s.flag = FLAG ? (const unsigned char*)f[NK + NP] : nullptr;
  s.valid = (const unsigned char*)f[NK + NP + FLAG];
  return s;
}

template <int NK, int NP, bool FLAG>
OutSlots<NP> out_slots(void* const* f) {
  OutSlots<NP> s;
  s.key[0] = (int*)f[0];
  s.key[1] = NK == 2 ? (int*)f[1] : nullptr;
  for (int p = 0; p < NP; ++p) s.pay[p] = (int*)f[NK + p];
  s.flag = FLAG ? (unsigned char*)f[NK + NP] : nullptr;
  s.valid = (unsigned char*)f[NK + NP + FLAG];
  return s;
}

// How a layout joins two rows: the block merge of the two sorted rows
// (MERGE: the RGA's 2,048-record rows), or the merge by one warp a row
// (WARP_MERGE: the OR-Set's and the LWW-Set's 512-record rows, 16 a
// thread, and the 2P and edge layouts' rows of 64 or 512 records; a
// broadcast runs the block merge at 256 threads a row).
enum Join { MERGE = 1, WARP_MERGE = 2 };

constexpr size_t MAX_SHARED = 232448;  // a block's most, opted in

// rows a block of the warp merge holds at `row_bytes` of shared memory a
// row: WARP_ROWS, or as many as fit
inline int warp_rows(size_t row_bytes) {
  const size_t fit = MAX_SHARED / row_bytes;
  return (int)(fit < (size_t)WARP_ROWS ? fit : WARP_ROWS);
}

// A launch of a warp merge kernel over `rows` rows of n records each: as
// many rows a block as fit (warp_rows), at most `most_blocks` blocks.
template <int NK, int NP, typename Kernel, typename... Args>
int launch_warps(Kernel kernel, int n, long long rows, long long most_blocks,
                 cudaStream_t stream, Args... args) {
  const size_t row = round16((size_t)n * record_bytes<NK, NP>());
  const int per = warp_rows(row);
  if (per == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_shared(kernel, per * row);
  if (err != cudaSuccess) return (int)err;
  const long long need = (rows + per - 1) / per;
  const long long grid = need < most_blocks ? need : most_blocks;
  kernel<<<(unsigned)grid, 32 * per, per * row, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int NK, int NP, bool FLAG, int FOLD, int JOIN>
int launch(const void* const* a, const void* const* b, void* const* o,
           void* overflow, long long rows, int ca, int cb, int cap,
           int repeat, cudaStream_t stream) {
  if (rows <= 0 || repeat <= 0) return (int)cudaSuccess;
  if constexpr (JOIN == WARP_MERGE) {
    if (rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    if (repeat == 1)
      return launch_warps<NK, NP>(
          warp_kernel<NK, NP, FLAG, FOLD>(), ca + cb, rows, 132LL * 64,
          stream, in_slots<NK, NP, FLAG>(a), in_slots<NK, NP, FLAG>(b),
          out_slots<NK, NP, FLAG>(o), (int*)overflow, rows, ca, cb, cap,
          repeat);
  }
  const size_t bytes = (size_t)(ca + cb) * record_bytes<NK, NP>() + 16;
  constexpr int MOST = JOIN == MERGE ? MERGE_BROADCAST_THREADS : 256;
  const auto kernel = merge_union_kernel<NK, NP, FLAG, FOLD, MOST>;
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = rows < 132LL * 64 ? rows : 132LL * 64;
  const int threads =
      JOIN == MERGE && repeat > 1 ? MERGE_BROADCAST_THREADS : 256;
  kernel<<<(unsigned)grid, threads, bytes, stream>>>(
      in_slots<NK, NP, FLAG>(a), in_slots<NK, NP, FLAG>(b),
      out_slots<NK, NP, FLAG>(o), (int*)overflow,
      rows, ca, cb, cap, repeat);
  return (int)cudaGetLastError();
}

template <int NK, int NP, bool FLAG, int FOLD, int JOIN>
int launch_rows(const void* const* a, const void* const* b, void* const* o,
                const void* rows, int listed, const void* n_rows, int pairs,
                int num_keys, int c, int gather, int scatter, int repeat,
                cudaStream_t stream) {
  if (listed <= 0 || pairs <= 0 || repeat <= 0 || c <= 0)
    return (int)cudaSuccess;
  // one wave of 8 blocks per SM; blocks past the rows to join exit at once
  const long long most = (long long)listed * pairs;
  if (most >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  if constexpr (JOIN == WARP_MERGE) {
    if (!(scatter && repeat > 1))
      return launch_warps<NK, NP>(
          warp_rows_kernel<NK, NP, FLAG, FOLD>(), 2 * c, most, 132LL * 8,
          stream, in_slots<NK, NP, FLAG>(a), in_slots<NK, NP, FLAG>(b),
          out_slots<NK, NP, FLAG>(o), (const int*)rows, listed,
          (const int*)n_rows, pairs, num_keys, c, gather, scatter, repeat);
  }
  const size_t bytes = (size_t)(2 * c) * record_bytes<NK, NP>() + 16;
  constexpr int MOST = JOIN == MERGE ? MERGE_BROADCAST_THREADS : 256;
  const auto kernel = merge_union_rows_kernel<NK, NP, FLAG, FOLD, MOST>;
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = most < 132LL * 8 ? most : 132LL * 8;
  const int threads =
      JOIN == MERGE && scatter && repeat > 1 ? MERGE_BROADCAST_THREADS : 256;
  kernel<<<(unsigned)grid, threads, bytes, stream>>>(
      in_slots<NK, NP, FLAG>(a), in_slots<NK, NP, FLAG>(b),
      out_slots<NK, NP, FLAG>(o), (const int*)rows,
      listed, (const int*)n_rows, pairs, num_keys, c, gather, scatter,
      repeat);
  return (int)cudaGetLastError();
}

}  // namespace

// Each slot set is an array of field pointers in the layout's order: OR-Set
// tag_rep, tag_ctr, elem (int32), removed, valid (bool); RGA id_ctr,
// id_rep, par_ctr, par_rep, chr (int32), dead, valid (bool); LWW-Set elem,
// add_hi, add_lo, rm_hi, rm_lo (int32), valid (bool); 2P elem (int32),
// removed, valid (bool); edges src, dst (int32), removed, valid (bool).
//
// a: [rows, ca], b: [rows, cb], o: [repeat, rows, cap], overflow
// int32[rows], rows < 2^31; contiguous on one device. The outputs may
// alias the inputs row for row. Returns the launch's CUDA error.
extern "C" int slot_union_launch(const void* const* a, const void* const* b,
                                 void* const* o, void* overflow,
                                 long long rows, int ca, int cb, int cap,
                                 int repeat, void* stream) {
  return launch<2, 1, true, FOLD_KEEP, WARP_MERGE>(a, b, o, overflow, rows, ca,
                                                   cb, cap, repeat,
                                                   (cudaStream_t)stream);
}

extern "C" int rga_union_launch(const void* const* a, const void* const* b,
                                void* const* o, void* overflow,
                                long long rows, int ca, int cb, int cap,
                                int repeat, void* stream) {
  return launch<2, 3, true, FOLD_MAX, MERGE>(a, b, o, overflow, rows, ca, cb,
                                            cap, repeat, (cudaStream_t)stream);
}

extern "C" int lww_union_launch(const void* const* a, const void* const* b,
                                void* const* o, void* overflow,
                                long long rows, int ca, int cb, int cap,
                                int repeat, void* stream) {
  return launch<1, 4, false, FOLD_TS_MAX, WARP_MERGE>(a, b, o, overflow, rows,
                                                      ca, cb, cap, repeat,
                                                      (cudaStream_t)stream);
}

extern "C" int tp_union_launch(const void* const* a, const void* const* b,
                               void* const* o, void* overflow,
                               long long rows, int ca, int cb, int cap,
                               int repeat, void* stream) {
  return launch<1, 0, true, FOLD_KEEP, WARP_MERGE>(a, b, o, overflow, rows,
                                                   ca, cb, cap, repeat,
                                                   (cudaStream_t)stream);
}

extern "C" int edge_union_launch(const void* const* a, const void* const* b,
                                 void* const* o, void* overflow,
                                 long long rows, int ca, int cb, int cap,
                                 int repeat, void* stream) {
  return launch<2, 0, true, FOLD_KEEP, WARP_MERGE>(a, b, o, overflow, rows,
                                                   ca, cb, cap, repeat,
                                                   (cudaStream_t)stream);
}

// Row-list mode. a, b: [pairs, num_keys, c]; o: [pairs, num_keys, c], or
// with `scatter` [repeat, num_keys, c] (pairs == 1); rows: int32[listed]
// distinct keys in [0, num_keys) (others are skipped), listed * pairs <
// 2^30; n_rows: int32[] on the device. Contiguous on one device; with
// `gather` and `scatter` the outputs alias the inputs row for row. Returns
// the launch's CUDA error.
extern "C" int slot_union_rows_launch(const void* const* a,
                                      const void* const* b, void* const* o,
                                      const void* rows, int listed,
                                      const void* n_rows, int pairs,
                                      int num_keys, int c, int gather,
                                      int scatter, int repeat, void* stream) {
  return launch_rows<2, 1, true, FOLD_KEEP, WARP_MERGE>(
      a, b, o, rows, listed, n_rows, pairs, num_keys, c, gather, scatter,
      repeat, (cudaStream_t)stream);
}

extern "C" int rga_union_rows_launch(const void* const* a,
                                     const void* const* b, void* const* o,
                                     const void* rows, int listed,
                                     const void* n_rows, int pairs,
                                     int num_keys, int c, int gather,
                                     int scatter, int repeat, void* stream) {
  return launch_rows<2, 3, true, FOLD_MAX, MERGE>(a, b, o, rows, listed,
                                                 n_rows, pairs, num_keys, c,
                                                 gather, scatter, repeat,
                                                 (cudaStream_t)stream);
}

extern "C" int lww_union_rows_launch(const void* const* a,
                                     const void* const* b, void* const* o,
                                     const void* rows, int listed,
                                     const void* n_rows, int pairs,
                                     int num_keys, int c, int gather,
                                     int scatter, int repeat, void* stream) {
  return launch_rows<1, 4, false, FOLD_TS_MAX, WARP_MERGE>(
      a, b, o, rows, listed, n_rows, pairs, num_keys, c, gather, scatter,
      repeat, (cudaStream_t)stream);
}

extern "C" int tp_union_rows_launch(const void* const* a,
                                    const void* const* b, void* const* o,
                                    const void* rows, int listed,
                                    const void* n_rows, int pairs,
                                    int num_keys, int c, int gather,
                                    int scatter, int repeat, void* stream) {
  return launch_rows<1, 0, true, FOLD_KEEP, WARP_MERGE>(
      a, b, o, rows, listed, n_rows, pairs, num_keys, c, gather, scatter,
      repeat, (cudaStream_t)stream);
}

extern "C" int edge_union_rows_launch(const void* const* a,
                                      const void* const* b, void* const* o,
                                      const void* rows, int listed,
                                      const void* n_rows, int pairs,
                                      int num_keys, int c, int gather,
                                      int scatter, int repeat, void* stream) {
  return launch_rows<2, 0, true, FOLD_KEEP, WARP_MERGE>(
      a, b, o, rows, listed, n_rows, pairs, num_keys, c, gather, scatter,
      repeat, (cudaStream_t)stream);
}
