// lww_apply: the LWW-Set's sequential apply of add/remove ops, per view,
// in place, in three modes: uncaptured (lww_apply_launch, mode 0),
// captured (lww_apply_launch, mode 1) and the capture (lww_capture_launch).
//
// Replaces: the lax.scan of janus_tpu/models/lwwset.py _apply_ops_impl
// (93-137) with janus_tpu/ops/setops.py row_upsert (191-234), vmapped over
// the views; and, as the capture mode, the scan of
// janus_tpu/models/base.py capture_and_apply (160-186) with
// janus_tpu/models/lwwset.py prepare_ops (57-74). Ops apply in lane order.
// An op reads the row its key gathers (negative keys count from the end,
// then the index is clamped) and changes it only if the normalised key is
// in range. add (op 1: a0 = elem, (a1, a2) = the stamp): an upsert of elem
// with add stamp (a1, a2) and remove stamp (0, 0); remove (op 2, the same
// arguments): an upsert with add stamp (0, 0) and remove stamp (a1, a2),
// gated: uncaptured, on the elem being contained in the row (some valid
// slot of it whose add stamp is not (0, 0) and is >= its remove stamp, the
// low word unsigned); captured, on the op's ok flag; in the capture mode
// on the same containment, which is also written as the lane's ok (every
// other lane's ok is 1). The upsert folds into the first valid slot
// holding elem (each stamp pair takes the lexicographic max with the op's,
// the slot's on a tie), else fills the first invalid slot; an enabled
// upsert of an absent elem into a full row counts one drop (whether or not
// the key is in range) and changes nothing.
//
// What bounds it on the H100: bytes. The function needs 20 bytes a live
// lane (op, key, a0, a1, a2; 24 with ok), only the op of any other lane,
// the capture's ok written for every lane, and the rows its live lanes
// touch, each read and written once (21 bytes a slot). At the
// lww_consensus phase (16 views, 1,000 keys of 64 slots, up to 64 blocks
// of 5,120 ops a view per apply) a batch is up to 327,680 lanes a view and
// touches at most 16,000 rows of 1.3 KB. Each live lane is one pass over
// its row.
//
// Design: many rows in flight, each walked from registers by a group of G
// threads of a warp (graph_apply.cu's walk with the LWW row). Two
// launches (the buckets of lane_buckets.cuh). group_fill_kernel, one
// thread a lane, writes each live lane
// (add or remove) of a view as a 16-byte record (lane index with the op
// code and its in-range and ok bits, elem, the stamp's two words) into
// the bucket of its (view, gathered row) group at an atomic count (a
// warp's lanes of one group take one atomic), `cap` records a bucket (the
// lanes a row on average, six of their square roots and 32), appends each
// group its first lane reaches to a list of the groups with lanes, and
// writes the capture's ok of every lane that is not a remove. The walk
// kernel's warps take PER = 32 / G groups of that list at a time (so a
// view's hot rows, which sit side by side, spread over warps: typed_store
// puts a replica's 64 lanes on ~20 rows of a hot window) and walk them
// side by side. A group's records are put in lane order by their (lane,
// place) keys in shared memory (a bitonic sort by the whole warp, a group
// at a time, skipped when the bucket already ascends) and read back from
// the bucket WINDOW at a time, the next window's loads in flight while
// one is walked. Thread s of a group holds the elems of slots [s S, s S +
// S) in registers (S a template argument) and their valid, live
// (contained) and free slots as bit masks; the stamps lie in shared
// memory. So each lane is a few warp ballots: the first slot holding its
// elem, the first free slot and the containment gate, each the first set
// bit of the first thread with any, and the upsert is the owning
// thread's. A touched row goes back to global memory once, when its walk
// ends. A group whose bucket overflowed is walked alone, on the first G
// threads, from the view's op fields, 32 lanes at a time. A row no live
// lane gathers is never read. Instantiations: S = 8 slots a thread, G = 8
// (C <= 64: four rows a warp), 32 (C <= 256), and S = 16, G = 32 (C <=
// 512). Launches on the caller's stream, allocates nothing (the caller
// passes the groups' scratch), does not synchronise.
#include <cuda_runtime.h>

#include "lane_buckets.cuh"
#include "slot_sort.cuh"

namespace {

using namespace slot_sort;
using lane_buckets::Groups;
using lane_buckets::MAX_BUCKET;
using lane_buckets::WINDOW;

constexpr int WARPS = 4;          // warps a block of the walk
constexpr int FILL_THREADS = 256;  // a fill block
constexpr int OP_ADD = 1, OP_REMOVE = 2;
constexpr int MODE_APPLY = 0, MODE_CAPTURED = 1, MODE_CAPTURE = 2;
// a record's first word: lane << 4 | flags (the op code, in range, ok)
constexpr int CODE_BITS = 3, IN_RANGE = 4, OK_BIT = 8;
constexpr unsigned FULL = 0xffffffffu;

struct Rows {
  int* elem;
  int* add_hi;
  int* add_lo;
  int* rm_hi;
  int* rm_lo;
  unsigned char* valid;
};

struct Ops {
  const int* op;
  const int* key;
  const int* a0;
  const int* a1;
  const int* a2;
  const int* ok;  // [V, B] (captured mode) or null
};

// (hi_a, lo_a) >= (hi_b, lo_b), the low word unsigned
__device__ __forceinline__ bool ts_after(int hi_a, int lo_a, int hi_b,
                                         int lo_b) {
  return hi_a > hi_b || (hi_a == hi_b && (unsigned)lo_a >= (unsigned)lo_b);
}

// a slot's stamps contain its elem: an add stamp, not below the remove's
__device__ __forceinline__ bool stamps_live(const int4& t) {
  return (t.x != 0 || t.y != 0) && ts_after(t.x, t.y, t.z, t.w);
}

__device__ __forceinline__ bool is_live(int op) {
  return op == OP_ADD || op == OP_REMOVE;
}

// lane b of view v's record (i its index in the op fields)
template <bool CAPTURED>
__device__ __forceinline__ int4 record(const Ops& ops, long long i, int b,
                                       int op, int key, int K) {
  const int nk = key < 0 ? key + K : key;
  int flags = op | (nk >= 0 && nk < K ? IN_RANGE : 0);
  if (CAPTURED && ops.ok[i] != 0) flags |= OK_BIT;
  return make_int4(b << 4 | flags, ops.a0[i], ops.a1[i], ops.a2[i]);
}

// one thread a lane (blockIdx.y the view): each live lane's record into
// its group's bucket at the group's count (a warp's lanes of one group by
// one atomic, in lane order); none past the bucket. Zeroes the view's
// drops; in the capture mode writes ok 1 for every lane but a remove.
template <int MODE>
__global__ void __launch_bounds__(FILL_THREADS)
    group_fill_kernel(Ops ops, int B, int K, Groups gr,
                      int* __restrict__ ok_out, int* __restrict__ dropped) {
  const int b = blockIdx.x * FILL_THREADS + threadIdx.x, v = blockIdx.y;
  if (b == 0) dropped[v] = 0;
  const long long i = (long long)v * B + b;
  int op = 0, key = 0;
  if (b < B) {
    op = ops.op[i];
    key = ops.key[i];
    if (MODE == MODE_CAPTURE && op != OP_REMOVE) ok_out[i] = 1;
  }
  const bool live = b < B && is_live(op);
  const unsigned lives = __ballot_sync(FULL, live);
  if (!live) return;
  const long long vg = (long long)v * K + gather_row(key, K);
  const int at = lane_buckets::claim(gr, lives, vg);
  if (at < gr.cap)
    gr.rec[vg * gr.cap + at] =
        record<MODE == MODE_CAPTURED>(ops, i, b, op, key, K);
}

// bit i set where byte i of w is not zero
__device__ __forceinline__ unsigned byte_bits(unsigned w) {
  return (w & 0xffu ? 1u : 0u) | (w & 0xff00u ? 2u : 0u) |
         (w & 0xff0000u ? 4u : 0u) | (w & 0xff000000u ? 8u : 0u);
}

// byte i of the result 1 where bit i of m is set (i < 4)
__device__ __forceinline__ unsigned bits_bytes(unsigned m) {
  return (m & 1u) | ((m >> 1) & 1u) << 8 | ((m >> 2) & 1u) << 16 |
         ((m >> 3) & 1u) << 24;
}

// One LWW row held by a group of threads: thread s of the group holds the
// elems of slots [s S, s S + S) (those below C) in registers, their stamps
// (add hi, add lo, rm hi, rm lo) in shared memory at stamp[i], and bit
// masks of its valid slots, its live ones (valid and contained) and the
// slots that exist.
template <int S>
struct Row {
  int elem[S];
  unsigned valid, live, have;
  int4* stamp;  // this thread's S slots

  __device__ __forceinline__ void load(const Rows& st, long long at, int C,
                                      bool vec, int s, int4* st_shared) {
    const int n = min(max(C - s * S, 0), S);
    at += (long long)s * S;
    stamp = st_shared + s * S;
    have = (1u << n) - 1u;
    valid = live = 0;
    if constexpr (S % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int j = 0; j < S / 4; ++j) {
          const int4 e = ((const int4*)(st.elem + at))[j];
          const int4 ah = ((const int4*)(st.add_hi + at))[j];
          const int4 al = ((const int4*)(st.add_lo + at))[j];
          const int4 rh = ((const int4*)(st.rm_hi + at))[j];
          const int4 rl = ((const int4*)(st.rm_lo + at))[j];
          elem[4 * j] = e.x;
          elem[4 * j + 1] = e.y;
          elem[4 * j + 2] = e.z;
          elem[4 * j + 3] = e.w;
          stamp[4 * j] = make_int4(ah.x, al.x, rh.x, rl.x);
          stamp[4 * j + 1] = make_int4(ah.y, al.y, rh.y, rl.y);
          stamp[4 * j + 2] = make_int4(ah.z, al.z, rh.z, rl.z);
          stamp[4 * j + 3] = make_int4(ah.w, al.w, rh.w, rl.w);
          valid |= byte_bits(((const unsigned*)(st.valid + at))[j]) << (4 * j);
        }
#pragma unroll
        for (int i = 0; i < S; ++i)
          live |= (unsigned)stamps_live(stamp[i]) << i;
        live &= valid;
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const bool in = i < n;
      elem[i] = in ? st.elem[at + i] : 0;
      if (in) {
        stamp[i] = make_int4(st.add_hi[at + i], st.add_lo[at + i],
                             st.rm_hi[at + i], st.rm_lo[at + i]);
        const bool v = st.valid[at + i];
        valid |= (unsigned)v << i;
        live |= (unsigned)(v && stamps_live(stamp[i])) << i;
      }
    }
  }

  // no row: no slot exists
  __device__ __forceinline__ void clear(int s, int4* st_shared) {
    stamp = st_shared + s * S;
    have = valid = live = 0;
  }

  __device__ __forceinline__ void store(const Rows& st, long long at,
                                        bool vec, int s) const {
    at += (long long)s * S;
    if constexpr (S % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int j = 0; j < S / 4; ++j) {
          const int4 a = stamp[4 * j], b = stamp[4 * j + 1],
                     c = stamp[4 * j + 2], d = stamp[4 * j + 3];
          ((int4*)(st.elem + at))[j] = make_int4(elem[4 * j], elem[4 * j + 1],
                                                 elem[4 * j + 2],
                                                 elem[4 * j + 3]);
          ((int4*)(st.add_hi + at))[j] = make_int4(a.x, b.x, c.x, d.x);
          ((int4*)(st.add_lo + at))[j] = make_int4(a.y, b.y, c.y, d.y);
          ((int4*)(st.rm_hi + at))[j] = make_int4(a.z, b.z, c.z, d.z);
          ((int4*)(st.rm_lo + at))[j] = make_int4(a.w, b.w, c.w, d.w);
          ((unsigned*)(st.valid + at))[j] = bits_bytes(valid >> (4 * j));
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if ((have >> i) & 1u) {
        const int4 t = stamp[i];
        st.elem[at + i] = elem[i];
        st.add_hi[at + i] = t.x;
        st.add_lo[at + i] = t.y;
        st.rm_hi[at + i] = t.z;
        st.rm_lo[at + i] = t.w;
        st.valid[at + i] = (valid >> i) & 1u;
      }
    }
  }

  // this thread's valid slots holding elem e
  __device__ __forceinline__ unsigned holding(int e) const {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) m |= (unsigned)(elem[i] == e) << i;
    return m & valid;
  }

  __device__ __forceinline__ unsigned free_slots() const {
    return have & ~valid;
  }

  // slot i folds the op's stamps (each pair the max, the slot's on a tie)
  __device__ __forceinline__ void fold(int i, const int4& op) {
    int4 t = stamp[i];
    if (!ts_after(t.x, t.y, op.x, op.y)) {
      t.x = op.x;
      t.y = op.y;
    }
    if (!ts_after(t.z, t.w, op.z, op.w)) {
      t.z = op.z;
      t.w = op.w;
    }
    stamp[i] = t;
    live = stamps_live(t) ? live | (1u << i) : live & ~(1u << i);
  }

  // slot i := elem e with the op's stamps, valid
  __device__ __forceinline__ void put(int i, int e, const int4& op) {
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (j == i) elem[j] = e;
    stamp[i] = op;
    valid |= 1u << i;
    live = stamps_live(op) ? live | (1u << i) : live & ~(1u << i);
  }
};

// What a walk carries from lane to lane: whether an in-range lane came
// (the row goes back) and the drops.
struct Walk {
  bool touched;
  int drop;
};

// `steps` steps of the warp's groups, G threads a group: step j applies
// record j of each group that has one (m records, read from the window
// `win`, which holds records [j0, j0 + WINDOW)), to its row; `v` the
// group's view. Every lane of the warp calls it; every ballot is the whole
// warp's, each group reading its own G bits.
template <int MODE, int G, int S>
__device__ __forceinline__ void walk_step(Row<S>& row, const int4& r,
                                          bool active, int v, int B,
                                          int* ok_out, Walk& w) {
  const int lane = threadIdx.x & 31, s = lane % G, base = lane - s;
  constexpr unsigned GROUP = G == 32 ? FULL : (1u << G) - 1u;
  const auto mine = [&](unsigned ballot) { return (ballot >> base) & GROUP; };
  const int op = active ? r.x & CODE_BITS : 0;
  const bool in_range = active && (r.x & IN_RANGE);
  const int e = r.y;
  w.touched |= in_range;
  const unsigned hold = active ? row.holding(e) : 0u;
  const unsigned has = mine(__ballot_sync(FULL, hold != 0));
  bool en = op == OP_ADD;
  if (MODE == MODE_CAPTURED) {
    en |= op == OP_REMOVE && (r.x & OK_BIT);
  } else {
    const bool contained =
        mine(__ballot_sync(FULL, (hold & row.live) != 0)) != 0;
    en |= op == OP_REMOVE && contained;
    if (MODE == MODE_CAPTURE && op == OP_REMOVE && s == 0)
      ok_out[(long long)v * B + (r.x >> 4)] = contained;
  }
  const unsigned fr = mine(__ballot_sync(FULL, row.free_slots() != 0));
  if (!en) return;
  const int4 stamps = op == OP_ADD ? make_int4(r.z, r.w, 0, 0)
                                   : make_int4(0, 0, r.z, r.w);
  if (has) {
    if (in_range && s == __ffs(has) - 1) row.fold(__ffs(hold) - 1, stamps);
  } else if (fr) {
    if (in_range && s == __ffs(fr) - 1)
      row.put(__ffs(row.free_slots()) - 1, e, stamps);
  } else {
    w.drop += 1;
  }
}

// The walk's blocks an SM its launch bound asks for (so that ptxas does
// not hold it to fewer registers than the row takes).
constexpr int WALK_MIN_BLOCKS = 3;

// shared memory of a warp: its groups' sort keys [PER cap], their windows
// [PER WINDOW] of records and the rows' stamps [32 S]
template <int S>
__host__ __device__ inline size_t warp_shared(int per, int cap) {
  return round16((size_t)4 * per * cap) + (size_t)16 * per * WINDOW +
         (size_t)16 * 32 * S;
}

template <int MODE, int G, int S>
__global__ void __launch_bounds__(32 * WARPS, WALK_MIN_BLOCKS)
    lww_walk_kernel(Rows st, Ops ops, Groups gr, int* __restrict__ ok_out,
                    int* __restrict__ dropped, int K, int C, int B,
                    bool vec) {
  constexpr int PER = 32 / G;  // groups a warp walks side by side
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = lane / G, s = lane % G;
  const int cap = gr.cap;
  unsigned char* mine_smem =
      (unsigned char*)smem + warp * warp_shared<S>(PER, cap);
  unsigned* keys = (unsigned*)mine_smem;  // [PER][cap]
  int4* win = (int4*)(mine_smem + round16((size_t)4 * PER * cap));
  int4* stamps = win + PER * WINDOW;  // [32 S]
  int4* my_win = win + part * WINDOW;
  unsigned* my_keys = keys + part * cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) gr.live[gr.parity ^ 1] = 0;
  // items of PER groups from the list of groups with lanes, a warp each
  const int live = gr.live[gr.parity];
  const int items = (live + PER - 1) / PER;
  for (int item = blockIdx.x * WARPS + warp; item < items;
       item += gridDim.x * WARPS) {
    const int at = item * PER + lane;
    const int mine_vk = lane < PER && at < live ? gr.list[at] : -1;
    const int n = mine_vk >= 0 ? gr.count[mine_vk] : 0;
    if (n) gr.count[mine_vk] = 0;
    // the groups whose records are in their bucket, side by side; then
    // each hot one (its bucket overflowed) alone, on the first G threads,
    // its lanes read from the view's op fields 32 at a time (b0: the next
    // to read, B when no hot group is open)
    unsigned todo = __ballot_sync(FULL, n > 0 && n <= cap);
    unsigned hot = __ballot_sync(FULL, n > cap);
    int b0 = B, hot_vk = 0, vk = -1;
    Row<S> row;
    Walk w{false, 0};
    while (todo || hot || b0 < B) {
      int m = 0;
      bool from_bucket = false;
      if (todo) {
        // group `part` of the warp takes the part-th next group
        int src = -1;
        unsigned left = todo;
        for (int q = 0; q < PER && left; ++q) {
          if (q == part) src = __ffs(left) - 1;
          left &= left - 1;
        }
        todo = left;
        const int cnt = __shfl_sync(FULL, n, src < 0 ? 0 : src);
        const int src_vk = __shfl_sync(FULL, mine_vk, src < 0 ? 0 : src);
        m = src < 0 ? 0 : cnt;
        vk = src < 0 ? -1 : src_vk;
        from_bucket = true;
        // the row's loads go out with the records'
        if (vk >= 0)
          row.load(st, (long long)vk * C, C, vec, s, stamps + part * G * S);
        else
          row.clear(s, stamps + part * G * S);
        lane_buckets::lane_order<G>(
            keys, cap, gr.rec + (long long)(vk < 0 ? 0 : vk) * cap, m, 4);
      } else {
        if (b0 >= B) {  // open the next hot group
          const int src = __ffs(hot) - 1;
          hot &= hot - 1;
          hot_vk = __shfl_sync(FULL, mine_vk, src);
          vk = part == 0 ? hot_vk : -1;
          b0 = 0;
          if (part == 0)
            row.load(st, (long long)hot_vk * C, C, vec, s, stamps);
          else
            row.clear(s, stamps + part * G * S);
        }
        const int hv = hot_vk / K, hg = hot_vk - hv * K;
        int cnt = 0;
        while (b0 < B && cnt == 0) {
          const int b = b0 + lane;
          const long long i = (long long)hv * B + b;
          int op = 0, key = 0;
          if (b < B) {
            op = ops.op[i];
            key = ops.key[i];
          }
          const bool hit = is_live(op) && gather_row(key, K) == hg;
          const unsigned hits = __ballot_sync(FULL, hit);
          cnt = __popc(hits);
          if (hit)
            win[__popc(hits & ((1u << lane) - 1u))] =
                record<MODE == MODE_CAPTURED>(ops, i, b, op, key, K);
          b0 += 32;
        }
        __syncwarp();
        m = part == 0 ? cnt : 0;
      }
      const int v = vk >= 0 ? vk / K : 0;
      const auto step = [&](const int4& r, bool active) {
        walk_step<MODE, G, S>(row, r, active, v, B, ok_out, w);
      };
      if (from_bucket) {
        lane_buckets::walk_records<G>(
            gr.rec + (long long)(vk < 0 ? 0 : vk) * cap, my_keys, m, my_win,
            step);
      } else {  // the hot group's records are in the window already
        const int steps = __reduce_max_sync(FULL, m);
        for (int j = 0; j < steps; ++j)
          step(j < m ? my_win[j] : make_int4(0, 0, 0, 0), j < m);
      }
      if (b0 >= B) {  // the walks end (a hot one's when its lanes are read)
        __syncwarp();
        if (vk >= 0) {
          if (w.touched) row.store(st, (long long)vk * C, vec, s);
          if (s == 0 && w.drop) atomicAdd(&dropped[v], w.drop);
        }
        w = Walk{false, 0};
      }
      __syncwarp();
    }
  }
}

// The walk's blocks resident on the card at `bytes` of shared memory,
// asked of the runtime once for each instantiation (a template argument
// of this function), device and size, the shared memory opt-in with it.
template <int MODE, int G, int S>
cudaError_t walk_grid(size_t bytes, long long* grid) {
  static int s_dev = -1;
  static size_t s_bytes = 0;
  static long long s_grid = 0;
  const auto kernel = lww_walk_kernel<MODE, G, S>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != s_dev || bytes != s_bytes) {
    err = allow_shared(kernel, bytes);
    if (err == cudaSuccess)
      err = resident_blocks(kernel, 32 * WARPS, bytes, &s_grid);
    if (err != cudaSuccess) return err;
    s_dev = dev;
    s_bytes = bytes;
  }
  *grid = s_grid;
  return cudaSuccess;
}

template <int MODE, int G, int S>
int launch_walk(const Rows& st, const Ops& o, Groups gr, void* ok_out,
                void* dropped, int V, int K, int C, int B, bool vec,
                cudaStream_t s) {
  const size_t bytes = WARPS * warp_shared<S>(32 / G, gr.cap);
  long long grid = 0;
  cudaError_t err = walk_grid<MODE, G, S>(bytes, &grid);
  if (err != cudaSuccess) return (int)err;
  // at most the blocks the groups could need: the live groups are not
  // known on the host
  const long long items = ((long long)V * K + 32 / G - 1) / (32 / G);
  const long long need = (items + WARPS - 1) / WARPS;
  if (grid > need) grid = need > 0 ? need : 1;
  lww_walk_kernel<MODE, G, S><<<(unsigned)grid, 32 * WARPS, bytes, s>>>(
      st, o, gr, (int*)ok_out, (int*)dropped, K, C, B, vec);
  return (int)cudaGetLastError();
}

// whether the row's fields allow the 16-byte path: C == g s slots, s a
// multiple of 4, the int fields 16-byte aligned and valid 4-byte
bool vector_ok(const Rows& st, int C, int g, int s) {
  const auto al = [](const void* p, size_t a) {
    return ((size_t)p & (a - 1)) == 0;
  };
  return C == g * s && s % 4 == 0 && al(st.elem, 16) && al(st.add_hi, 16) &&
         al(st.add_lo, 16) && al(st.rm_hi, 16) && al(st.rm_lo, 16) &&
         al(st.valid, 4);
}

template <int MODE>
int launch(void* const* state, const void* const* ops, void* ok_out,
           void* dropped, void* const* scratch, int V, int K, int C, int B,
           int cap, int parity, void* stream) {
  if (V <= 0) return (int)cudaSuccess;
  if (V > 65535 || (long long)V * K >= (1LL << 31) || B >= (1 << 21) ||
      C > 512 || cap < 32 || cap > MAX_BUCKET || cap % 32 ||
      (B > 0 && (K <= 0 || C <= 0)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Rows st{(int*)state[0], (int*)state[1], (int*)state[2],
                (int*)state[3], (int*)state[4], (unsigned char*)state[5]};
  const Ops o{(const int*)ops[0], (const int*)ops[1], (const int*)ops[2],
              (const int*)ops[3], (const int*)ops[4], (const int*)ops[5]};
  const Groups gr{(int*)scratch[0], (int4*)scratch[1], (int*)scratch[2],
                  nullptr, (int*)scratch[3], parity & 1, cap};
  const dim3 lanes((unsigned)((B + FILL_THREADS - 1) / FILL_THREADS + (B == 0)),
                   (unsigned)V);
  group_fill_kernel<MODE><<<lanes, FILL_THREADS, 0, s>>>(
      o, B, K, gr, (int*)ok_out, (int*)dropped);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (C <= 64)
    return launch_walk<MODE, 8, 8>(st, o, gr, ok_out, dropped, V, K, C, B,
                                   vector_ok(st, C, 8, 8), s);
  if (C <= 256)
    return launch_walk<MODE, 32, 8>(st, o, gr, ok_out, dropped, V, K, C, B,
                                    vector_ok(st, C, 32, 8), s);
  return launch_walk<MODE, 32, 16>(st, o, gr, ok_out, dropped, V, K, C, B,
                                   vector_ok(st, C, 32, 16), s);
}

}  // namespace

// state: six field pointers (elem, add_hi, add_lo, rm_hi, rm_lo int32;
// valid bool) of [V, K, C], updated in place; ops: six pointers (op, key,
// a0, a1, a2 int32 [V, B]; ok int32 [V, B], null when uncaptured); dropped
// int32 [V] (written); scratch: four buffers, the counts int32 [V K] zero
// on entry (and on return), the buckets int4 [V K cap] (16-byte aligned),
// the list int32 [V K] and its lengths int32 [2], length `parity` (0 or 1,
// alternating from call to call) zero on entry, the other zeroed by the
// walk. cap a multiple of 32 in [32, MAX_BUCKET]; C <= 512, B < 2^21, V
// <= 65,535, V K < 2^31.
// Contiguous on one device. Returns the first CUDA error of the launches.
extern "C" int lww_apply_launch(void* const* state, const void* const* ops,
                                void* dropped, void* const* scratch, int V,
                                int K, int C, int B, int cap, int parity,
                                void* stream) {
  if (ops[5] != nullptr)
    return launch<MODE_CAPTURED>(state, ops, nullptr, dropped, scratch, V, K,
                                 C, B, cap, parity, stream);
  return launch<MODE_APPLY>(state, ops, nullptr, dropped, scratch, V, K, C,
                            B, cap, parity, stream);
}

// The capture mode: as lww_apply_launch uncaptured (ops[5] ignored), and
// ok_out int32 [V, B] (written): each remove lane's containment against
// the row the earlier lanes left, 1 for every other lane.
extern "C" int lww_capture_launch(void* const* state, const void* const* ops,
                                  void* ok_out, void* dropped,
                                  void* const* scratch, int V, int K, int C,
                                  int B, int cap, int parity, void* stream) {
  return launch<MODE_CAPTURE>(state, ops, ok_out, dropped, scratch, V, K, C,
                              B, cap, parity, stream);
}
