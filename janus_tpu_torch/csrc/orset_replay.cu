// orset_replay: batched replay of effect-captured OR-Set ops, the
// consensus path's apply, for every view in one call (two launches).
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
// What bounds it on the H100: bytes. Per view the state is read once and
// written once (K*C*14 bytes) and the op fields read once (20 + 12 R
// bytes an op lane); at path A's delta apply (4 views, K=100, C=64,
// 65,536 ops of R=4) that is ~18.5 MB, ~5.5 us at 3.35 TB/s. The per-row
// sorts of the op records are n log^2 n / 4 compare-swaps for a row of n.
//
// Design: two launches. The fill writes each op record as (rep, ctr,
// origin, elem) into the bucket of its (view, row) group, the negative raw
// keys of a view into one more group as (rep, ctr, key, -); `origin` is
// twice the record's index in the JAX record order plus its tombstone
// bit, so the order the atomics leave inside a bucket does not matter. A
// call of CHUNK_MIN_LANES lanes or more over views of at most
// SHARED_GROUPS groups is filled a chunk of lanes a block (at least
// 1,024, four a group): the chunk's records are counted per
// group in shared memory first, so one global atomic a group and chunk
// reserves their places (orset_consensus's K = 100 rows take ~700 records
// each, and their counts serialized on one atomic a record); any other
// call one atomic a warp's records of a group. A bucket holds `cap`
// records (twice the lanes a row on average, plus 32, at most
// MAX_BUCKET); a group past it is gathered again from its view's op fields
// by the walk, into a spill area of global memory. The walk gives each
// group a warp (WARPS a block) where the rows average fewer than
// BLOCK_LANES op lanes (the harness's 16-view calls: ~100 records a row),
// else a block (the delta applies of 4 views: 250-900). A warp sorts up
// to 256 of a row's records in registers (the bitonic network, shuffles
// across lanes); a block, or a longer group, sorts in shared memory; all
// by (rep, ctr, origin). The row's C state slots are read straight from
// global memory; a canonical row holds them in tag order (one vote checks
// that its valid slots are a prefix that ascends), any other row is
// sorted alone by (rep, ctr, slot). The two sorted lists are merged by
// rank: with `first` flagging the first record of each distinct tag (a
// state record first of its tag among the state's, an op record first
// among the ops' and its tag absent from the state), the exclusive prefix
// counts of the flags over each list give every record its tag's rank,
// the firsts of both lists below its tag (a binary search in each list).
// A record ranked below C ORs its tombstone into that output slot, and
// the first record in JAX order of each kept tag writes its tag and elem;
// the distinct tags beyond C are counted as dropped; the negative-key
// group sorts by (key, tag) and counts, per key, the distinct tags ranked
// C or more. The output row goes out once from shared memory. Scratch:
// the groups' counts, which the walk zeroes after reading them (zero on
// entry), and the buckets and spill, which need no initialisation.
// Launches on the caller's stream, allocates nothing, does not
// synchronise.
#include <cuda_runtime.h>
#include <limits.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int WARPS = 4;           // warps a block of the warp walk
constexpr int BLOCK_THREADS = 256;  // a block of the block walk
// op lanes a row on average from which groups are walked a block each,
// and the groups under which they are too
constexpr int BLOCK_LANES = 192;
constexpr int WARP_GROUPS = 4096;
constexpr int FILL_THREADS = 256;  // a fill block
// a view's groups a chunk of the fill counts in shared memory, and the
// lanes of a call from which it is filled by chunks (a chunk an SM; other
// calls are filled a warp of lanes at a time)
constexpr int SHARED_GROUPS = 512;
constexpr long long CHUNK_MIN_LANES = 131072;
constexpr int MAX_BUCKET = 2048;   // the most records a bucket holds
constexpr int MAX_SLOTS = 2048;    // the widest row the walk takes
constexpr int OP_ADD = 1, OP_REMOVE = 2, OP_CLEAR = 3;
constexpr unsigned FULL = 0xffffffffu;

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
  int cap;         // records a bucket holds
  long long span;  // a view's spill: B R + K + 1 records (and counts)
};

// count[V (K+1)]: records a group (zero on entry, zeroed by the walk);
// spill_at[V]: a view's spill cursor (zeroed by the fill); bucket[V (K+1)
// cap]; spill[V span] records and spill_scan[V span] counts of groups past
// their bucket
struct Scratch {
  int* count;
  int* spill_at;
  int4* bucket;
  int4* spill;
  int* spill_scan;
};

// the group of a raw key: its row, K for a negative key, -1 past the rows
__device__ __forceinline__ int group_of(int key, int K) {
  return key >= K ? -1 : (key < 0 ? K : key);
}

// capture lanes an op lane's records take: an add lane 0 (none when R is
// 0), a remove or clear all R, any other code none
__device__ __forceinline__ int record_lanes(int op, int R) {
  return op == OP_ADD ? (R > 0) : (op == OP_REMOVE || op == OP_CLEAR) ? R : 0;
}

// record r of op lane i (lane b of its view) of group g, if it has one:
// (rep, ctr, 2 origin + tombstone, elem) on a row, (rep, ctr, key, 0) on
// the negative-key group
__device__ __forceinline__ bool record_of(const Ops& ops, long long i, int b,
                                          int r, int op, int key, int g,
                                          const Dims& d, int4* out) {
  int rep, ctr, elem, tomb;
  if (op == OP_ADD) {
    rep = ops.a1[i];
    ctr = ops.a2[i];
    elem = ops.a0[i];
    tomb = 0;
  } else {
    const long long at = i * d.R + r;
    rep = ops.rm_rep[at];
    if (rep == SENT) return false;
    ctr = ops.rm_ctr[at];
    elem = ops.rm_elem[at];
    tomb = 1;
  }
  *out = g == d.K ? make_int4(rep, ctr, key, 0)
                  : make_int4(rep, ctr, 2 * (b * d.R + r) + tomb, elem);
  return true;
}

// one thread a lane (blockIdx.y the view): each record into its group's
// bucket at the group's count, a warp's records of one group by one
// atomic; none past the bucket. Zeroes each view's spill cursor and drop
// count.
__global__ void __launch_bounds__(FILL_THREADS)
    group_fill_kernel(Ops ops, Scratch sc, int* __restrict__ dropped,
                      Dims d) {
  const int b = blockIdx.x * FILL_THREADS + threadIdx.x, v = blockIdx.y;
  if (b == 0) {
    sc.spill_at[v] = 0;
    dropped[v] = 0;
  }
  const long long i = (long long)v * d.B + b;
  int op = 0, key = 0;
  if (b < d.B) {
    op = ops.op[i];
    key = ops.key[i];
  }
  const int g = group_of(key, d.K);
  const int n = b < d.B && g >= 0 ? record_lanes(op, d.R) : 0;
  const long long vg = (long long)v * (d.K + 1) + g;
  const unsigned lane = threadIdx.x & 31;
  const int steps = __reduce_max_sync(FULL, n);
  for (int r = 0; r < steps; ++r) {
    int4 rec;
    const bool has = r < n && record_of(ops, i, b, r, op, key, g, d, &rec);
    const unsigned m = __ballot_sync(FULL, has);
    if (has) {
      const unsigned peers = __match_any_sync(m, vg);
      const int leader = __ffs(peers) - 1;
      int at = 0;
      if ((int)lane == leader) at = atomicAdd(&sc.count[vg], __popc(peers));
      at = __shfl_sync(peers, at, leader) +
           __popc(peers & ((1u << lane) - 1u));
      if (at < d.cap) sc.bucket[vg * d.cap + at] = rec;
    }
  }
}

// One block a chunk of `lanes` lanes of a view (blockIdx.y), for views of
// at most SHARED_GROUPS groups: the chunk's records are counted per group
// in shared memory, one global atomic a group the chunk touches reserves
// their places in its bucket, and each record goes to its place (none
// past the bucket). Zeroes each view's spill cursor and drop count.
__global__ void __launch_bounds__(FILL_THREADS)
    chunk_fill_kernel(Ops ops, Scratch sc, int* __restrict__ dropped, Dims d,
                      int lanes) {
  __shared__ int s_cnt[SHARED_GROUPS], s_at[SHARED_GROUPS];
  const int v = blockIdx.y, t = threadIdx.x, groups = d.K + 1;
  if (blockIdx.x == 0 && t == 0) {
    sc.spill_at[v] = 0;
    dropped[v] = 0;
  }
  const int b0 = blockIdx.x * lanes, end = min(d.B, b0 + lanes);
  for (int g = t; g < groups; g += FILL_THREADS) s_cnt[g] = 0;
  __syncthreads();
  for (int b = b0 + t; b < end; b += FILL_THREADS) {
    const long long i = (long long)v * d.B + b;
    const int op = ops.op[i], g = group_of(ops.key[i], d.K);
    if (g < 0) continue;
    int c = 0;
    for (int r = 0; r < record_lanes(op, d.R); ++r)
      c += op == OP_ADD || ops.rm_rep[i * d.R + r] != SENT;
    if (c) atomicAdd(&s_cnt[g], c);
  }
  __syncthreads();
  for (int g = t; g < groups; g += FILL_THREADS) {
    const int c = s_cnt[g];
    if (c) s_at[g] = atomicAdd(&sc.count[(long long)v * groups + g], c);
    s_cnt[g] = 0;
  }
  __syncthreads();
  for (int b = b0 + t; b < end; b += FILL_THREADS) {
    const long long i = (long long)v * d.B + b;
    const int op = ops.op[i], key = ops.key[i], g = group_of(key, d.K);
    if (g < 0) continue;
    for (int r = 0; r < record_lanes(op, d.R); ++r) {
      int4 x;
      if (!record_of(ops, i, b, r, op, key, g, d, &x)) continue;
      const int at = s_at[g] + atomicAdd(&s_cnt[g], 1);
      if (at < d.cap) sc.bucket[((long long)v * groups + g) * d.cap + at] = x;
    }
  }
}

__device__ __forceinline__ bool tag_less(const int4& a, int rep, int ctr) {
  return a.x < rep || (a.x == rep && a.y < ctr);
}

__device__ __forceinline__ bool same_tag(const int4& a, const int4& b) {
  return a.x == b.x && a.y == b.y;
}

// records of a[0, n) whose tag is below (rep, ctr); a sorted by tag
__device__ __forceinline__ int lower_tag(const int4* a, int n, int rep,
                                         int ctr) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tag_less(a[mid], rep, ctr)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// records of a[0, n) whose key (z) is below `key`; a sorted by key first
__device__ __forceinline__ int lower_key(const int4* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid].z < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The first record of each tag in a sorted list: of the state's slots
// (StFirst); of the op records, whose tag the state also lacks (OpFirst);
// of each (key, tag) among the negative-key records (KeyFirst). A record's
// rank is the firsts of both lists below its tag.
struct StFirst {
  const int4* a;
  __device__ __forceinline__ bool operator()(int j) const {
    return j == 0 || !same_tag(a[j], a[j - 1]);
  }
};

struct OpFirst {
  const int4* rec;
  const int4* st;
  int m;
  __device__ __forceinline__ bool operator()(int i) const {
    if (i > 0 && same_tag(rec[i], rec[i - 1])) return false;
    const int j = lower_tag(st, m, rec[i].x, rec[i].y);
    return j == m || !same_tag(st[j], rec[i]);
  }
};

struct KeyFirst {
  const int4* rec;
  __device__ __forceinline__ bool operator()(int i) const {
    return i == 0 || rec[i].z != rec[i - 1].z || !same_tag(rec[i], rec[i - 1]);
  }
};

// (z, x, y) lexicographic: a negative-key record (rep, ctr, key, -)
struct LessZXY {
  __device__ bool operator()(const int4& a, const int4& b) const {
    if (a.z != b.z) return a.z < b.z;
    if (a.x != b.x) return a.x < b.x;
    return a.y < b.y;
  }
};

// The threads that walk one group together: a warp (WarpTeam) or the
// block (BlockTeam, `part` shared ints for its sums and broadcasts).
struct WarpTeam {
  static constexpr int SIZE = 32;
  __device__ __forceinline__ int rank() const { return threadIdx.x & 31; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ bool any(bool p) const {
    return __any_sync(FULL, p);
  }
  __device__ __forceinline__ int sum(int v) const {
    return __reduce_add_sync(FULL, v);
  }
  __device__ __forceinline__ int bcast(int v) const {
    return __shfl_sync(FULL, v, 0);
  }
  // the exclusive prefix sum of v over the team; `total` its sum
  __device__ __forceinline__ int exclusive_sum(int v, int& total) const {
    const int lane = threadIdx.x & 31;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += u;
    }
    total = __shfl_sync(FULL, inc, 31);
    return inc - v;
  }
};

struct BlockTeam {
  static constexpr int SIZE = BLOCK_THREADS;
  int* part;  // shared [SIZE / 32 + 1]
  __device__ __forceinline__ int rank() const { return threadIdx.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ bool any(bool p) const {
    return __syncthreads_or(p);
  }
  __device__ __forceinline__ int exclusive_sum(int v, int& total) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = WarpTeam{}.exclusive_sum(v, total) + v;
    if (lane == 31) part[warp] = inc;
    __syncthreads();
    if (threadIdx.x == 0) {
      int run = 0;
      for (int w = 0; w < SIZE / 32; ++w) {
        const int x = part[w];
        part[w] = run;
        run += x;
      }
      part[SIZE / 32] = run;
    }
    __syncthreads();
    const int before = part[warp] + inc - v;
    total = part[SIZE / 32];
    __syncthreads();
    return before;
  }
  __device__ __forceinline__ int sum(int v) const {
    int total;
    exclusive_sum(v, total);
    return total;
  }
  __device__ __forceinline__ int bcast(int v) const {
    if (threadIdx.x == 0) part[0] = v;
    __syncthreads();
    v = part[0];
    __syncthreads();
    return v;
  }
};

// Sort a[0, n) ascending by `less` with the team: the bitonic network of
// slot_sort::block_sort (positions past n act as +infinity). `a` may lie
// in shared or global memory.
template <typename Team, typename T, typename Less>
__device__ __forceinline__ void team_sort(Team team, T* a, int n,
                                          Less less) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = team.rank(); t < (p >> 1); t += Team::SIZE) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = j == (k >> 1) ? (lo ^ (k - 1)) : lo + j;
        if (hi < n) {
          const T x = a[lo], y = a[hi];
          if (less(y, x)) {
            a[lo] = y;
            a[hi] = x;
          }
        }
      }
      team.sync();
    }
  }
}

__device__ __forceinline__ int4 shfl_xor4(const int4& x, int m) {
  return make_int4(__shfl_xor_sync(FULL, x.x, m), __shfl_xor_sync(FULL, x.y, m),
                   __shfl_xor_sync(FULL, x.z, m), __shfl_xor_sync(FULL, x.w, m));
}

// One step (merge size K, distance J) of the bitonic network over the
// warp's 32 E records in registers, lane L holding places [L E, L E + E):
// within a lane as register swaps (J < E), across lanes by shuffles.
template <int E, int K, int J, typename Less>
__device__ __forceinline__ void sort_step(int4 (&x)[E], Less less,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const bool up = ((lane * E + i) & K) == 0;
    if constexpr (J < E) {
      if ((i ^ J) > i && less(x[i ^ J], x[i]) == up) {
        const int4 t = x[i];
        x[i] = x[i ^ J];
        x[i ^ J] = t;
      }
    } else {
      const bool lower = (lane & (J / E)) == 0;
      const int4 y = shfl_xor4(x[i], J / E);
      if (lower == up ? less(y, x[i]) : less(x[i], y)) x[i] = y;
    }
  }
  if constexpr (J > 1) sort_step<E, K, J / 2>(x, less, lane);
}

template <int E, int K, typename Less>
__device__ __forceinline__ void register_sort(int4 (&x)[E], Less less,
                                              int lane) {
  sort_step<E, K, K / 2>(x, less, lane);
  if constexpr (2 * K <= 32 * E) register_sort<E, 2 * K>(x, less, lane);
}

// The warp's records of a group (n <= 32 E, from its bucket) sorted in
// registers and stored to rec[0, n).
template <int E, typename Less>
__device__ __forceinline__ void warp_sorted(const int4* bucket, int n, int4* rec,
                            Less less) {
  const int lane = threadIdx.x & 31;
  int4 x[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int at = i * 32 + lane;  // coalesced loads, any order
    x[i] = at < n ? bucket[at] : make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
  }
  register_sort<E, 2>(x, less, lane);
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (lane * E + i < n) rec[lane * E + i] = x[i];
  __syncwarp();
}

// scan[0, n] := the exclusive prefix count of flag(i) over [0, n), with
// the team (each thread a contiguous run); ends in a team sync
template <typename Team, typename Flag>
__device__ __forceinline__ void flag_scan(Team team, int n, int* scan,
                                          Flag flag) {
  const int per = (n + Team::SIZE - 1) / Team::SIZE;
  const int lo = min(n, team.rank() * per), hi = min(n, lo + per);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += flag(i);
  int total;
  int run = team.exclusive_sum(c, total);
  for (int i = lo; i < hi; ++i) {
    scan[i] = run;
    run += flag(i);
  }
  if (team.rank() == 0) scan[n] = total;
  team.sync();
}

// A group's shared memory (16-byte aligned): its records [cap], the
// state's [C], their prefix counts [cap + 1] and [C + 1], the output
// row's tags and elems [C] and tombstones [C]
struct Region {
  int4* rec;
  int4* st;
  int* oscan;
  int* sscan;
  int* o_rep;
  int* o_ctr;
  int* o_elem;
  unsigned char* o_tomb;

  __device__ __forceinline__ Region(unsigned char* at, int cap, int C) {
    rec = (int4*)at;
    st = rec + cap;
    oscan = (int*)(st + C);
    sscan = oscan + cap + 1;
    o_rep = sscan + C + 1;
    o_ctr = o_rep + C;
    o_elem = o_ctr + C;
    o_tomb = (unsigned char*)(o_elem + C);
  }
};

__host__ __device__ inline size_t region_bytes(int cap, int C) {
  return round16((size_t)16 * (cap + C) + 4 * (cap + 1 + C + 1) +
                 (size_t)13 * C);
}

// the group's record count, read and zeroed by the team's first thread
template <typename Team>
__device__ __forceinline__ int take_count(Team team, int* count) {
  int n = 0;
  if (team.rank() == 0) {
    n = *count;
    if (n) *count = 0;
  }
  return team.bcast(n);
}

// One group by a team: its records from the bucket (a warp sorts up to
// 256 of a row in registers) or, past the bucket, gathered again from the view's op
// fields into the spill; sorted by (rep, ctr, origin) (the negative-key
// group's by (key, rep, ctr), which only counts its drops); the state read
// and sorted unless its valid slots are a prefix in tag order; the first
// record of each tag flagged in each list (an op record's also absent
// from the state) and counted (prefix counts); each record's rank, the
// firsts of both lists below its tag, by a binary search in each list. A
// record ranked below C ORs its tombstone into that output slot, and the
// first record of each kept tag writes its tag and elem. `fill` a shared
// int of the team's.
template <typename Team>
__device__ __forceinline__ void replay_group(Team team, State st, Ops ops,
                                             Out out, Scratch sc,
                                             int* dropped, Dims d, int v,
                                             int g, Region r, int* fill) {
  const int C = d.C;
  const long long vg = (long long)v * (d.K + 1) + g;
  const long long row = ((long long)v * d.K + g) * C;
  // the row's state first, its loads in flight with the count's: valid
  // slots as (rep, ctr, 2 slot + tombstone, elem), invalid ones as a
  // marker that sorts last (its z above any slot's)
  int mine = 0;
  if (g < d.K) {
#pragma unroll 2
    for (int c = team.rank(); c < C; c += Team::SIZE) {
      const bool valid = st.valid[row + c];
      const int4 x = make_int4(st.rep[row + c], st.ctr[row + c],
                               2 * c + (st.removed[row + c] ? 1 : 0),
                               st.elem[row + c]);
      r.st[c] = valid ? x : make_int4(INT_MAX, INT_MAX, INT_MAX, 0);
      r.o_tomb[c] = 0;
      mine += valid;
    }
  }
  const int n = take_count(team, &sc.count[vg]);
  if (g == d.K && n == 0) return;  // no negative key: nothing to count
  const int4* bucket = sc.bucket + vg * d.cap;
  int4* rec = r.rec;
  int* oscan = r.oscan;
  bool sorted = false;
  if (n <= d.cap) {
    if (Team::SIZE == 32 && n <= 256 && g < d.K) {
      if (n <= 32) warp_sorted<1>(bucket, n, rec, LessXYZ());
      else if (n <= 128) warp_sorted<4>(bucket, n, rec, LessXYZ());
      else warp_sorted<8>(bucket, n, rec, LessXYZ());
      sorted = true;
    } else {
      for (int i = team.rank(); i < n; i += Team::SIZE) rec[i] = bucket[i];
    }
  } else {
    const int base = team.bcast(
        team.rank() == 0 ? atomicAdd(&sc.spill_at[v], n + 1) : 0);
    rec = sc.spill + v * d.span + base;
    oscan = sc.spill_scan + v * d.span + base;
    if (team.rank() == 0) *fill = 0;
    team.sync();
    for (int b = team.rank(); b < d.B; b += Team::SIZE) {
      const long long i = (long long)v * d.B + b;
      const int key = ops.key[i];
      if (group_of(key, d.K) != g) continue;
      const int op = ops.op[i];
      for (int q = 0; q < record_lanes(op, d.R); ++q) {
        int4 x;
        if (record_of(ops, i, b, q, op, key, g, d, &x))
          rec[atomicAdd(fill, 1)] = x;
      }
    }
  }
  team.sync();

  if (g == d.K) {  // negative raw keys: count the drops only
    if (!sorted) team_sort(team, rec, n, LessZXY());
    const KeyFirst first{rec};
    flag_scan(team, n, oscan, first);
    int drop = 0;
    for (int i = team.rank(); i < n; i += Team::SIZE)
      if (first(i) && oscan[i] - oscan[lower_key(rec, n, rec[i].z)] >= C)
        ++drop;
    drop = team.sum(drop);
    if (team.rank() == 0 && drop) atomicAdd(&dropped[v], drop);
    return;
  }

  const int m = team.sum(mine);
  team.sync();
  bool descent = false;
  for (int c = team.rank() + 1; c < C; c += Team::SIZE) {
    const int4 a = r.st[c - 1], x = r.st[c];
    descent |= x.z != INT_MAX && (a.z == INT_MAX || tag_less(x, a.x, a.y));
  }
  if (team.any(descent)) team_sort(team, r.st, C, LessXYZ());
  if (!sorted) team_sort(team, rec, n, LessXYZ());  // (rep, ctr, origin)

  const StFirst st_first{r.st};
  const OpFirst op_first{rec, r.st, m};
  flag_scan(team, m, r.sscan, st_first);
  flag_scan(team, n, oscan, op_first);
  const int total = r.sscan[m] + oscan[n];
  for (int j = team.rank(); j < m; j += Team::SIZE) {
    const int4 x = r.st[j];
    const int k = r.sscan[lower_tag(r.st, m, x.x, x.y)] +
                  oscan[lower_tag(rec, n, x.x, x.y)];
    if (k >= C) continue;
    if (x.z & 1) r.o_tomb[k] = 1;
    if (st_first(j)) {
      r.o_rep[k] = x.x;
      r.o_ctr[k] = x.y;
      r.o_elem[k] = x.w;
    }
  }
  for (int i = team.rank(); i < n; i += Team::SIZE) {
    const int4 x = rec[i];
    const int k = r.sscan[lower_tag(r.st, m, x.x, x.y)] +
                  oscan[lower_tag(rec, n, x.x, x.y)];
    if (k >= C) continue;
    if (x.z & 1) r.o_tomb[k] = 1;
    if (op_first(i)) {
      r.o_rep[k] = x.x;
      r.o_ctr[k] = x.y;
      r.o_elem[k] = x.w;
    }
  }
  team.sync();
  const int kept = min(total, C);
  for (int c = team.rank(); c < C; c += Team::SIZE) {
    const bool in = c < kept;
    out.rep[row + c] = in ? r.o_rep[c] : SENT;
    out.ctr[row + c] = in ? r.o_ctr[c] : SENT;
    out.elem[row + c] = in ? r.o_elem[c] : 0;
    out.removed[row + c] = in && r.o_tomb[c];
    out.valid[row + c] = in;
  }
  if (team.rank() == 0 && total > C) atomicAdd(&dropped[v], total - C);
}

// The blocks an SM each walk's launch bound asks for: bounded by its
// threads alone, ptxas spilled both walks to a stack frame at 40 and 56
// registers; at 2 blocks an SM the block walk took 88 registers, too many
// for the 4-view calls' 404 blocks to be resident at once (1.5x slower).
constexpr int WARP_WALK_BLOCKS = 8, BLOCK_WALK_BLOCKS = 4;

// A warp a group: group vg = view * (K + 1) + row (row K: the view's
// negative keys) to warp vg % WARPS of block vg / WARPS.
__global__ void __launch_bounds__(32 * WARPS, WARP_WALK_BLOCKS)
    warp_walk_kernel(State st, Ops ops, Out out, Scratch sc,
                     int* __restrict__ dropped, Dims d) {
  extern __shared__ int4 smem[];
  __shared__ int s_fill[WARPS];
  const int warp = threadIdx.x >> 5;
  const long long vg = (long long)blockIdx.x * WARPS + warp;
  if (vg >= (long long)d.V * (d.K + 1)) return;  // the whole warp
  const int v = (int)(vg / (d.K + 1)), g = (int)(vg - (long long)v * (d.K + 1));
  replay_group(WarpTeam{}, st, ops, out, sc, dropped, d, v, g,
               Region((unsigned char*)smem + warp * region_bytes(d.cap, d.C),
                      d.cap, d.C),
               &s_fill[warp]);
}

// A block a group: group blockIdx.x = view * (K + 1) + row.
__global__ void __launch_bounds__(BLOCK_THREADS, BLOCK_WALK_BLOCKS)
    block_walk_kernel(State st, Ops ops, Out out, Scratch sc,
                      int* __restrict__ dropped, Dims d) {
  extern __shared__ int4 smem[];
  __shared__ int s_part[BLOCK_THREADS / 32 + 1], s_fill;
  const long long vg = blockIdx.x;
  const int v = (int)(vg / (d.K + 1)), g = (int)(vg - (long long)v * (d.K + 1));
  replay_group(BlockTeam{s_part}, st, ops, out, sc, dropped, d, v, g,
               Region((unsigned char*)smem, d.cap, d.C), &s_fill);
}

}  // namespace

// state fields [V, K, C] (int32 tags and elem, bool removed and valid);
// op fields int32 [V, B]; captured fields int32 [V, B, R]; outputs [V, K,
// C]; dropped int32 [V] (written). Scratch: count int32 [V (K+1)], zero
// on entry (and on return); work, 16-byte aligned: spill_at int32 [V]
// (padded to 16 bytes), bucket int4 [V (K+1) cap], spill int4 [V span],
// spill_scan int32 [V span], span = B R + K + 1. cap a multiple of 32 in
// [32, MAX_BUCKET], C <= MAX_SLOTS, B R < 2^30, V <= 65,535. Contiguous on
// one device. Returns the first CUDA error of the two launches.
extern "C" int orset_replay_launch(
    const void* rep, const void* ctr, const void* elem, const void* removed,
    const void* valid, const void* op, const void* key, const void* a0,
    const void* a1, const void* a2, const void* rm_rep, const void* rm_ctr,
    const void* rm_elem, void* o_rep, void* o_ctr, void* o_elem,
    void* o_removed, void* o_valid, void* dropped, void* count, void* work,
    int V, int K, int C, int B, int R, int cap, void* stream) {
  if (V <= 0) return (int)cudaSuccess;
  if (V > 65535 || K < 0 || C < 0 || C > MAX_SLOTS || B < 0 || R < 0 ||
      cap < 32 || cap > MAX_BUCKET || cap % 32 ||
      (long long)B * R >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  State st{(const int*)rep, (const int*)ctr, (const int*)elem,
           (const unsigned char*)removed, (const unsigned char*)valid};
  Ops ops{(const int*)op, (const int*)key, (const int*)a0, (const int*)a1,
          (const int*)a2, (const int*)rm_rep, (const int*)rm_ctr,
          (const int*)rm_elem};
  Out out{(int*)o_rep, (int*)o_ctr, (int*)o_elem, (unsigned char*)o_removed,
          (unsigned char*)o_valid};
  const long long groups = (long long)V * (K + 1);
  const long long span = (long long)B * R + K + 1;
  const Dims d{V, K, C, B, R, cap, span};
  int4* spill_at = (int4*)work;
  int4* bucket = spill_at + (V + 3) / 4;
  int4* spill = bucket + groups * cap;
  const Scratch sc{(int*)count, (int*)spill_at, bucket, spill,
                   (int*)(spill + V * span)};
  if (K + 1 <= SHARED_GROUPS && (long long)V * B >= CHUNK_MIN_LANES) {
    // chunks of at least 1,024 lanes and four a group
    const int lanes = max(1024, (4 * (K + 1) + 255) / 256 * 256);
    const dim3 fill((unsigned)((B + lanes - 1) / lanes + (B == 0)),
                    (unsigned)V);
    chunk_fill_kernel<<<fill, FILL_THREADS, 0, s>>>(ops, sc, (int*)dropped,
                                                     d, lanes);
  } else {
    const dim3 fill(
        (unsigned)((B + FILL_THREADS - 1) / FILL_THREADS + (B == 0)),
        (unsigned)V);
    group_fill_kernel<<<fill, FILL_THREADS, 0, s>>>(ops, sc, (int*)dropped,
                                                     d);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // groups of many records (on average BLOCK_LANES op lanes a row or
  // more), few groups (under WARP_GROUPS: a warp each would leave most of
  // the card idle) or wide rows (WARPS regions over 96 KB) by a block
  // each, the others by a warp each
  if ((long long)B >= (long long)BLOCK_LANES * (K > 0 ? K : 1) ||
      groups < WARP_GROUPS || WARPS * region_bytes(cap, C) > 96 * 1024) {
    const size_t bytes = region_bytes(cap, C);
    err = allow_shared(block_walk_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    block_walk_kernel<<<(unsigned)groups, BLOCK_THREADS, bytes, s>>>(
        st, ops, out, sc, (int*)dropped, d);
  } else {
    const size_t bytes = WARPS * region_bytes(cap, C);
    err = allow_shared(warp_walk_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    warp_walk_kernel<<<(unsigned)((groups + WARPS - 1) / WARPS), 32 * WARPS,
                       bytes, s>>>(st, ops, out, sc, (int*)dropped, d);
  }
  return (int)cudaGetLastError();
}
