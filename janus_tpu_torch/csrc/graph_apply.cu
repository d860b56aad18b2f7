// graph_apply: the 2P2P Graph's sequential apply of vertex and edge ops,
// per view, in place, in three modes: uncaptured (graph_apply_launch,
// mode 0), captured (graph_apply_launch, mode 1) and the capture
// (graph_capture_launch); and, as the same walk over a vertex block alone
// (EDGES = false), the 2P-Set's (tpset_apply_launch, tpset_capture_launch).
//
// Replaces: the lax.scan of janus_tpu/models/graph.py _apply_ops_impl
// (109-181) with its gates _op_gates (51-73) and janus_tpu/ops/setops.py
// row_upsert, vmapped over the views; and, as the capture mode, the scan
// of janus_tpu/models/base.py capture_and_apply (160-186) with
// janus_tpu/models/graph.py prepare_ops (76-86); and the 2P-Set's
// janus_tpu/models/tpset.py _apply_ops_impl (75-109) and prepare_ops
// (43-55), which are the vertex ops of that walk on a graph with no edge
// block: add is av, remove is rv, whose gate with no edges is the elem's
// presence (only codes 1 and 2 are live lanes there; 3 and 4 are no-ops,
// as every other code is). Ops apply in lane order.
// An op reads the row its key gathers (negative keys count from the end,
// then the index is clamped) and changes it only if the normalised key is
// in range. A row is a vertex block of CV slots (v, v_removed, v_valid)
// and an edge block of CE slots (src, dst, e_removed, e_valid).
//
// The gate of a lane is read from its row before the lane applies:
//   rv (op 2, a0 = v): v live (a valid slot holding it with no tombstone)
//     and no live edge incident to it (src == v or dst == v; a self-loop
//     counts);
//   ae (op 3, a0 = src, a1 = dst): both endpoints live;
//   re (op 4, a0 = src, a1 = dst): the edge live;
//   any other code: true.
// Uncaptured, the gate is that; captured, the op's ok; in the capture
// mode the gate is written as the lane's ok (every other lane's ok is 1,
// set by the caller) and the lane applies as captured.
//
//   av (op 1, a0 = v): an upsert of v with a false tombstone, ungated; a
//     vertex already in the row keeps its tombstone.
//   rv, gated: uncaptured, every valid slot holding v is tombstoned;
//     captured, an upsert of v with a tombstone (inserted if absent).
//   ae, gated: an upsert of (src, dst) with a false tombstone.
//   re, gated: uncaptured, every valid slot holding the edge is
//     tombstoned; captured, an upsert of it with a tombstone.
//
// An enabled upsert of an absent key into a full block counts one drop
// (whether or not the key is in range) and changes nothing.
//
// What bounds it on the H100: bytes. The function needs 16 bytes a live
// lane (op, key, a0, a1; 20 with ok), only the op of any other lane, the
// capture's ok written for every lane, and the rows its live lanes touch,
// each read and written once (6 bytes a vertex slot, 10 an edge slot:
// 2,752 bytes a row at CV = 32, CE = 256; the 2P-Set's 12 bytes a live
// lane, 16 with ok, and 6 a slot). Each live lane is one pass over its
// row.
//
// Design: many rows in flight, each walked from registers by a group of
// G threads of a warp (a warp for the Graph and the widest 2P-Set rows,
// a quarter of one for 2P-Set rows of up to 64 slots). Two launches.
// group_fill_kernel, one thread a lane, writes each live lane of a view
// (codes 1-4, or 1-2 for the 2P-Set) as a 16-byte record (lane index, op
// code with its in-range and ok bits, a0, a1) into the bucket of its
// (view, gathered row) group, GROUP_RECORDS records a group, at the place
// a global atomic on the group's count gives it (so in no set order).
// The walk kernel's warps take tiles of 32 consecutive (view, row)
// groups: one load a lane reads the tile's counts and a ballot picks the
// groups with lanes, 32 / G of them walked side by side. A group's
// records go to shared memory (G threads load them together), are put in
// lane order (a rank by lane for each, skipped when they already
// ascend), and the row's slots are loaded into registers (thread s of the
// group holds slots [s S, s S + S) of a block, S = SV or SE a compile-
// time template argument, by 16-byte loads when the block is S G slots
// wide and aligned), so the walk reads no global memory. A hot group (its
// bucket overflowed) is walked alone, from the view's op fields: the warp
// reads them 32 lanes at a time and walks the lanes that gather the row,
// in lane order, as it finds them. Each step of the walk takes one record
// of each group, broadcast from shared memory; a thread's slots holding a
// key, its free slots and their tombstones are bit masks, so the first
// slot holding a key, the first free slot and every gate are one warp
// ballot each, every group reading its own G bits (the first set bit of
// the first thread with any), and an upsert is one thread's register
// write. The edge block is scanned only in steps where some group's op is
// ae or re (or rv for its incident edges), and a captured walk reads no
// gate. A touched row goes back to global memory once, when its walk
// ends, by the same loads' stores. A row no live lane gathers is never
// read. Instantiations by shape: the Graph at CV <= 32 (SV = 1) or <=
// 256 (SV = 8), CE <= 256 (SE = 8), G = 32; the 2P-Set at S = 8 with G =
// 8 (C <= 64) or 32 (C <= 256). Launches on the caller's stream,
// allocates nothing (the caller passes the groups' scratch), does not
// synchronise.
#include <cuda_runtime.h>
#include <limits.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int WARPS = 8;  // warps a block of the walk
// records a group's bucket holds: the longest walk of the consensus and
// store calls measured is 26 lanes; a longer one is read from the ops
constexpr int GROUP_RECORDS = 32;
constexpr int OP_AV = 1, OP_RV = 2, OP_AE = 3, OP_RE = 4;
constexpr int MODE_APPLY = 0, MODE_CAPTURED = 1, MODE_CAPTURE = 2;
// a record's flags: the op code, whether its key is in range, its ok
constexpr int CODE_BITS = 7, IN_RANGE = 8, OK_BIT = 16;
constexpr unsigned FULL = 0xffffffffu;

struct Rows {
  int* v;
  unsigned char* v_removed;
  unsigned char* v_valid;
  int* src;
  int* dst;
  unsigned char* e_removed;
  unsigned char* e_valid;
};

struct Ops {
  const int* op;
  const int* key;
  const int* a0;
  const int* a1;
  const int* ok;  // [V, B] (captured mode) or null
};

// the groups of an apply: count[V * K] (each group's live lanes; zero on
// entry) and rec[V * K, GROUP_RECORDS] (each group's bucket of records)
struct Groups {
  int* count;
  int4* rec;
};

__device__ __forceinline__ bool is_live(int op, bool edges) {
  return op == OP_AV || op == OP_RV ||
         (edges && (op == OP_AE || op == OP_RE));
}

// lane b of view v's record: lane index, flags, a0, a1
template <bool EDGES, bool CAPTURED>
__device__ __forceinline__ int4 record(const Ops& ops, long long i, int b,
                                       int op, int key, int K) {
  const int nk = key < 0 ? key + K : key;
  int flags = op | (nk >= 0 && nk < K ? IN_RANGE : 0);
  if (CAPTURED && ops.ok[i] != 0) flags |= OK_BIT;
  return make_int4(b, flags, ops.a0[i], EDGES ? ops.a1[i] : 0);
}

// one thread a lane (blockIdx.y the view): each live lane's record into
// its group's bucket, at the place the group's count gives it (none past
// the bucket: such a group is walked from the ops)
template <bool EDGES, bool CAPTURED>
__global__ void group_fill_kernel(Ops ops, int B, int K, Groups gr) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x, v = blockIdx.y;
  const long long i = (long long)v * B + b;
  if (b >= B) return;
  const int op = ops.op[i];
  if (!is_live(op, EDGES)) return;
  const int key = ops.key[i];
  const long long vg = (long long)v * K + gather_row(key, K);
  const int at = atomicAdd(&gr.count[vg], 1);
  if (at < GROUP_RECORDS)
    gr.rec[vg * GROUP_RECORDS + at] =
        record<EDGES, CAPTURED>(ops, i, b, op, key, K);
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

// One block of a row (the vertex block, NK = 1 key field; the edge block,
// NK = 2) held in registers by a group of threads: thread s of the group
// holds slots [s S, s S + S), those below the block's width; valid and
// tombstone as bit masks (bit i: slot s S + i), `have` the mask of this
// thread's slots that exist.
template <int NK, int S>
struct Block {
  int k0[S];
  int k1[NK == 2 ? S : 1];
  unsigned valid, rem, have;

  // thread s's slots from the block's first slot `at` of a row of c
  // (`vec`: c == S times the group's threads, each run 4 S-byte aligned);
  // none when `on` is false
  __device__ __forceinline__ void load(const int* f0, const int* f1,
                                       const unsigned char* fr,
                                       const unsigned char* fv, long long at,
                                       int c, bool vec, int s, bool on) {
    const int n = on ? min(max(c - s * S, 0), S) : 0;
    at += (long long)s * S;
    have = (1u << n) - 1u;
    valid = rem = 0;
    if constexpr (S % 4 == 0) {
      if (vec && on) {
#pragma unroll
        for (int j = 0; j < S / 4; ++j) {
          const int4 x = ((const int4*)(f0 + at))[j];
          k0[4 * j] = x.x;
          k0[4 * j + 1] = x.y;
          k0[4 * j + 2] = x.z;
          k0[4 * j + 3] = x.w;
          if constexpr (NK == 2) {
            const int4 y = ((const int4*)(f1 + at))[j];
            k1[4 * j] = y.x;
            k1[4 * j + 1] = y.y;
            k1[4 * j + 2] = y.z;
            k1[4 * j + 3] = y.w;
          }
          valid |= byte_bits(((const unsigned*)(fv + at))[j]) << (4 * j);
          rem |= byte_bits(((const unsigned*)(fr + at))[j]) << (4 * j);
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const bool in = i < n;
      k0[i] = in ? f0[at + i] : 0;
      if constexpr (NK == 2) k1[i] = in ? f1[at + i] : 0;
      valid |= (unsigned)(in && fv[at + i]) << i;
      rem |= (unsigned)(in && fr[at + i]) << i;
    }
  }

  __device__ __forceinline__ void store(int* f0, int* f1, unsigned char* fr,
                                        unsigned char* fv, long long at,
                                        bool vec, int s) const {
    at += (long long)s * S;
    if constexpr (S % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int j = 0; j < S / 4; ++j) {
          ((int4*)(f0 + at))[j] = make_int4(k0[4 * j], k0[4 * j + 1],
                                            k0[4 * j + 2], k0[4 * j + 3]);
          if constexpr (NK == 2)
            ((int4*)(f1 + at))[j] = make_int4(k1[4 * j], k1[4 * j + 1],
                                              k1[4 * j + 2], k1[4 * j + 3]);
          ((unsigned*)(fv + at))[j] = bits_bytes(valid >> (4 * j));
          ((unsigned*)(fr + at))[j] = bits_bytes(rem >> (4 * j));
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if ((have >> i) & 1u) {
        f0[at + i] = k0[i];
        if constexpr (NK == 2) f1[at + i] = k1[i];
        fv[at + i] = (valid >> i) & 1u;
        fr[at + i] = (rem >> i) & 1u;
      }
    }
  }

  // this thread's valid slots holding key (x, y) (y unread when NK == 1)
  __device__ __forceinline__ unsigned holding(int x, int y) const {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      bool hit = k0[i] == x;
      if constexpr (NK == 2) hit = hit && k1[i] == y;
      m |= (unsigned)hit << i;
    }
    return m & valid;
  }

  // this thread's live edges with x at either end
  __device__ __forceinline__ unsigned incident(int x) const {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) m |= (unsigned)(k0[i] == x || k1[i] == x) << i;
    return m & valid & ~rem;
  }

  __device__ __forceinline__ unsigned free_slots() const {
    return have & ~valid;
  }

  // slot i := (x, y), valid, tombstone `tomb`
  __device__ __forceinline__ void put(int i, int x, int y, bool tomb) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j == i) {
        k0[j] = x;
        if constexpr (NK == 2) k1[j] = y;
      }
    }
    valid |= 1u << i;
    rem = tomb ? rem | (1u << i) : rem & ~(1u << i);
  }

  // the upsert of (x, y) with tombstone `tomb` (row_upsert) by thread s
  // of the group: `hold` its slots holding the key, `has` and `free` the
  // group's threads with any (bit s). The first slot holding it keeps its
  // tombstone or takes one; else the first free slot takes the key; else
  // a drop (returned, the same to every thread of the group). Changes the
  // row only `in_range`.
  __device__ __forceinline__ int upsert(unsigned hold, unsigned has,
                                        unsigned free, int x, int y,
                                        bool tomb, bool in_range, int s) {
    if (has) {
      if (tomb && in_range && s == __ffs(has) - 1)
        rem |= hold & (0u - hold);  // its lowest slot
      return 0;
    }
    if (!free) return 1;
    if (in_range && s == __ffs(free) - 1)
      put(__ffs(free_slots()) - 1, x, y, tomb);
    return 0;
  }
};

// a group's row: the vertex block (SV slots a thread) and, with EDGES, the
// edge block (SE a thread), of group vk = view * K + row
template <bool EDGES, int SV, int SE>
struct Row {
  Block<1, SV> vb;
  Block<2, (SE > 0 ? SE : 1)> eb;

  __device__ __forceinline__ void load(const Rows& st, int vk, int CV,
                                       int CE, bool vec_v, bool vec_e, int s,
                                       bool on) {
    vb.load(st.v, nullptr, st.v_removed, st.v_valid, (long long)vk * CV, CV,
            vec_v, s, on);
    if constexpr (EDGES)
      eb.load(st.src, st.dst, st.e_removed, st.e_valid, (long long)vk * CE,
              CE, vec_e, s, on);
  }

  __device__ __forceinline__ void store(const Rows& st, int vk, int CV,
                                        int CE, bool vec_v, bool vec_e,
                                        int s) const {
    vb.store(st.v, nullptr, st.v_removed, st.v_valid, (long long)vk * CV,
             vec_v, s);
    if constexpr (EDGES)
      eb.store(st.src, st.dst, st.e_removed, st.e_valid, (long long)vk * CE,
               vec_e, s);
  }
};

// What a walk carries from lane to lane: whether an in-range lane came
// (the row goes back) and the drops.
struct Walk {
  bool touched;
  int drop;
};

// `steps` steps of the warp's groups, G threads a group: step j walks the
// j-th record in lane order of each group that has one, `m` records in
// shared memory at `rec` (in lane order when `sorted`, else in the order
// `ord` gives), over the group's `row`; `v` the group's view. Every lane
// of the warp calls it, and every ballot is the whole warp's, each group
// reading its own G bits.
template <int MODE, bool EDGES, int G, int SV, int SE>
__device__ __forceinline__ void walk_groups(Row<EDGES, SV, SE>& row,
                                            const int4* rec,
                                            const unsigned char* ord,
                                            bool sorted, int m, int steps,
                                            int v, int B, int* ok_out,
                                            Walk& w) {
  const int lane = threadIdx.x & 31, s = lane % G, base = lane - s;
  constexpr unsigned GROUP = G == 32 ? FULL : (1u << G) - 1u;
  const auto mine = [&](unsigned ballot) { return (ballot >> base) & GROUP; };
  // whether any group of the warp has `p`: with one group a warp its op
  // is the warp's, so no vote is needed
  const auto any = [](bool p) { return G == 32 ? p : __any_sync(FULL, p); };
  for (int j = 0; j < steps; ++j) {
    const bool active = j < m;
    const int4 r = active ? rec[sorted ? j : ord[j]] : make_int4(0, 0, 0, 0);
    const int op = r.y & CODE_BITS;  // 0 past the group's records
    const bool in_range = r.y & IN_RANGE;
    const int x = r.z, y = r.w;
    w.touched |= in_range;
    const bool tomb = op == OP_RV || op == OP_RE;
    const bool on_v = op == OP_AV || op == OP_RV;
    const bool on_e = EDGES && (op == OP_AE || op == OP_RE);
    // this thread's slots holding the op's key in the block it upserts
    // (and the vertex block's x for ae's gate); the group's threads with
    // any (`has`), with a free slot (`free`, read only where no slot holds
    // the key), with a live one (`live`)
    const bool gated = MODE != MODE_CAPTURED;
    const bool need_v = on_v || (gated && op == OP_AE);
    unsigned vhold = 0, vhas = 0, vfree = 0;
    bool vlive = false;
    if (any(need_v)) {
      if (need_v) vhold = row.vb.holding(x, 0);
      vhas = mine(__ballot_sync(FULL, vhold != 0));
      if (gated)
        vlive = mine(__ballot_sync(FULL, (vhold & ~row.vb.rem) != 0)) != 0;
    }
    if (any(on_v && !vhas))
      vfree = mine(__ballot_sync(FULL, row.vb.free_slots() != 0));
    unsigned ehold = 0, ehas = 0, efree = 0;
    bool elive = false;
    if constexpr (EDGES) {
      if (any(on_e)) {
        if (on_e) ehold = row.eb.holding(x, y);
        ehas = mine(__ballot_sync(FULL, ehold != 0));
        if (gated)
          elive = mine(__ballot_sync(FULL, (ehold & ~row.eb.rem) != 0)) != 0;
      }
      if (any(on_e && !ehas))
        efree = mine(__ballot_sync(FULL, row.eb.free_slots() != 0));
    }
    bool gate = true;
    if constexpr (MODE == MODE_CAPTURED) {
      gate = r.y & OK_BIT;
    } else {
      if (op == OP_RV) gate = vlive;
      if constexpr (EDGES) {
        if (any(op == OP_RV && vlive)) {
          const bool inc = mine(__ballot_sync(
              FULL, op == OP_RV && row.eb.incident(x) != 0));
          if (op == OP_RV) gate = vlive && !inc;
        }
        if (any(op == OP_AE && vlive)) {
          const bool ylive = mine(__ballot_sync(
              FULL, op == OP_AE && (row.vb.holding(y, 0) & ~row.vb.rem) != 0));
          if (op == OP_AE) gate = vlive && ylive;
        } else if (op == OP_AE) {
          gate = false;
        }
        if (op == OP_RE) gate = elive;
      }
      // av's gate is true, and its ok the caller's 1
      if (MODE == MODE_CAPTURE && active && op != OP_AV && s == 0)
        ok_out[(long long)v * B + r.x] = gate;
    }
    // av is ungated; each other code applies where its gate holds (no
    // ballot below: a group that skips does not hold the others back)
    if (!active || (op != OP_AV && !gate)) continue;
    if (MODE == MODE_APPLY && tomb) {
      // every valid slot holding the key takes a tombstone
      if (in_range) {
        if (op == OP_RV) row.vb.rem |= vhold;
        else if constexpr (EDGES) row.eb.rem |= ehold;
      }
    } else if (on_v) {
      w.drop += row.vb.upsert(vhold, vhas, vfree, x, 0, tomb, in_range, s);
    } else if constexpr (EDGES) {
      w.drop += row.eb.upsert(ehold, ehas, efree, x, y, tomb, in_range, s);
    }
  }
}

// The blocks an SM a walk's launch bound asks for: bounded by its threads
// alone (or to 5 blocks), ptxas held instantiations to 48 or 64 registers
// (from one edit to the next, different ones) and spilled to a stack
// frame. Bounded so, the Graph's walk takes up to 85 registers (3 blocks
// an SM, as it took unbounded at its fastest), the 2P-Set's up to 64.
template <bool EDGES>
constexpr int WALK_MIN_BLOCKS = EDGES ? 3 : 4;

template <int MODE, bool EDGES, int G, int SV, int SE>
__global__ void __launch_bounds__(32 * WARPS, WALK_MIN_BLOCKS<EDGES>)
    graph_walk_kernel(Rows st, Ops ops, Groups gr, int* __restrict__ ok_out,
                      int* __restrict__ dropped, int V, int K, int CV,
                      int CE, int B, bool vec_v, bool vec_e) {
  constexpr int PER = 32 / G;  // groups a warp walks side by side
  constexpr unsigned GROUP = G == 32 ? FULL : (1u << G) - 1u;
  __shared__ int4 s_rec[WARPS][PER][GROUP_RECORDS];
  __shared__ unsigned char s_ord[WARPS][PER][GROUP_RECORDS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = lane / G, s = lane % G;
  int4* rec = s_rec[warp][part];
  unsigned char* ord = s_ord[warp][part];
  // tiles of 32 groups a warp (in 32 bits: V K < 2^31, and a 64-bit
  // division would be a called routine)
  const int groups = V * K, tiles = (groups + 31) / 32;
  for (int t = blockIdx.x * WARPS + warp; t < tiles; t += gridDim.x * WARPS) {
    const int n = t * 32 + lane < groups ? gr.count[t * 32 + lane] : 0;
    // the groups whose records are in their bucket, PER at a time; then
    // each hot one (its bucket overflowed) alone, on the first G threads,
    // its lanes read from the view's op fields 32 at a time (b0: the next
    // to read, B when no hot group is open)
    unsigned todo = __ballot_sync(FULL, n > 0 && n <= GROUP_RECORDS);
    unsigned hot = __ballot_sync(FULL, n > GROUP_RECORDS);
    int b0 = B, hot_vk = 0, vk = -1;
    Row<EDGES, SV, SE> row;
    Walk w{false, 0};
    while (todo || hot || b0 < B) {
      int m = 0;
      bool sorted = true;
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
        m = src < 0 ? 0 : cnt;
        vk = src < 0 ? -1 : t * 32 + src;
        // the row's loads go out with the records'
        row.load(st, vk, CV, CE, vec_v, vec_e, s, vk >= 0);
        for (int i = s; i < m; i += G)
          rec[i] = gr.rec[(long long)vk * GROUP_RECORDS + i];
        __syncwarp();
        // in lane order unless a later lane's atomic came first; else each
        // record's rank by lane
        bool up = true;
        for (int i = s + 1; i < m; i += G) up &= rec[i].x > rec[i - 1].x;
        sorted = ((__ballot_sync(FULL, !up) >> (part * G)) & GROUP) == 0;
        if (!sorted) {
          for (int i = s; i < m; i += G) {
            const int x = rec[i].x;
            int rank = 0;
            for (int k = 0; k < m; ++k) rank += rec[k].x < x;
            ord[rank] = (unsigned char)i;
          }
        }
        __syncwarp();
      } else {
        if (b0 >= B) {  // open the next hot group
          hot_vk = t * 32 + __ffs(hot) - 1;
          hot &= hot - 1;
          vk = part == 0 ? hot_vk : -1;
          b0 = 0;
          row.load(st, vk, CV, CE, vec_v, vec_e, s, part == 0);
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
          const bool hit = is_live(op, EDGES) && gather_row(key, K) == hg;
          const unsigned hits = __ballot_sync(FULL, hit);
          cnt = __popc(hits);
          if (hit)
            s_rec[warp][0][__popc(hits & ((1u << lane) - 1u))] =
                record<EDGES, MODE == MODE_CAPTURED>(ops, i, b, op, key, K);
          b0 += 32;
        }
        __syncwarp();
        m = part == 0 ? cnt : 0;
      }
      const int steps = __reduce_max_sync(FULL, m);
      walk_groups<MODE, EDGES, G, SV, SE>(row, rec, ord, sorted, m, steps,
                                          vk >= 0 ? vk / K : 0, B, ok_out,
                                          w);
      if (b0 >= B) {  // the walks end (a hot one's when its lanes are read)
        if (vk >= 0) {
          if (w.touched) row.store(st, vk, CV, CE, vec_v, vec_e, s);
          if (s == 0 && w.drop) atomicAdd(&dropped[vk / K], w.drop);
        }
        w = Walk{false, 0};
      }
      __syncwarp();
    }
  }
}

// The grid of one walk launch: as many blocks as are resident on the
// card, at most one a WARPS tiles.
template <typename Kernel>
cudaError_t walk_grid(Kernel kernel, long long groups, long long* grid) {
  cudaError_t err = resident_blocks(kernel, 32 * WARPS, 0, grid);
  const long long tiles = (groups + 31) / 32;
  const long long need = (tiles + WARPS - 1) / WARPS;
  if (*grid > need) *grid = need > 0 ? need : 1;
  return err;
}

template <int MODE, bool EDGES, int G, int SV, int SE>
int launch_walk(const Rows& st, const Ops& o, Groups gr, void* ok_out,
                void* dropped, int V, int K, int CV, int CE, int B,
                bool vec_v, bool vec_e, cudaStream_t s) {
  const auto kernel = graph_walk_kernel<MODE, EDGES, G, SV, SE>;
  long long grid = 0;
  cudaError_t err = walk_grid(kernel, (long long)V * K, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, 32 * WARPS, 0, s>>>(st, o, gr, (int*)ok_out,
                                                (int*)dropped, V, K, CV, CE,
                                                B, vec_v, vec_e);
  return (int)cudaGetLastError();
}

// whether a block's fields allow the 16-byte path: `c` == g s slots (g
// threads a group, s slots a thread), s a multiple of 4, and every
// field's pointer 16-byte aligned (the byte fields 4-byte)
bool vector_ok(int c, int g, int s, const void* k0, const void* k1,
               const void* r, const void* v) {
  const auto al = [](const void* p, size_t a) {
    return p == nullptr || ((size_t)p & (a - 1)) == 0;
  };
  return c == g * s && s % 4 == 0 && al(k0, 16) && al(k1, 16) && al(r, 4) &&
         al(v, 4);
}

// The walk's instantiation for the row's shape: the Graph's rows a warp
// each, the vertex block at SV = 1 (CV <= 32) or 8 (<= 256) slots a
// thread and the edge block at SE = 8 (CE <= 256); the 2P-Set's at 8
// slots a thread, four rows a warp (C <= 64, G = 8 threads a row) or one
// (C <= 256). Returns cudaErrorInvalidValue for a wider row (the wrapper
// refuses those first).
template <int MODE, bool EDGES>
int launch_shape(const Rows& st, const Ops& o, Groups gr, void* ok_out,
                 void* dropped, int V, int K, int CV, int CE, int B,
                 cudaStream_t s) {
  if (CV > 256 || CE > 256 || (!EDGES && CE != 0))
    return (int)cudaErrorInvalidValue;
  if constexpr (EDGES) {
    const bool vv = vector_ok(CV, 32, 8, st.v, nullptr, st.v_removed,
                              st.v_valid);
    const bool ve = vector_ok(CE, 32, 8, st.src, st.dst, st.e_removed,
                              st.e_valid);
    if (CV <= 32)
      return launch_walk<MODE, true, 32, 1, 8>(st, o, gr, ok_out, dropped, V,
                                               K, CV, CE, B, false, ve, s);
    return launch_walk<MODE, true, 32, 8, 8>(st, o, gr, ok_out, dropped, V,
                                             K, CV, CE, B, vv, ve, s);
  } else {
    if (CV <= 64)
      return launch_walk<MODE, false, 8, 8, 0>(
          st, o, gr, ok_out, dropped, V, K, CV, 0, B,
          vector_ok(CV, 8, 8, st.v, nullptr, st.v_removed, st.v_valid), false,
          s);
    return launch_walk<MODE, false, 32, 8, 0>(
        st, o, gr, ok_out, dropped, V, K, CV, 0, B,
        vector_ok(CV, 32, 8, st.v, nullptr, st.v_removed, st.v_valid), false,
        s);
  }
}

template <int MODE, bool EDGES>
int launch(const Rows& st, const Ops& o, void* ok_out, void* dropped,
           void* const* scratch, int V, int K, int CV, int CE, int B,
           void* stream) {
  if (V <= 0 || K <= 0 || B <= 0 || CV + CE <= 0) return (int)cudaSuccess;
  if ((long long)V * K >= (1LL << 31) || V > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Groups gr{(int*)scratch[0], (int4*)scratch[1]};
  const dim3 lanes((unsigned)((B + 255) / 256), (unsigned)V);
  group_fill_kernel<EDGES, MODE == MODE_CAPTURED><<<lanes, 256, 0, s>>>(
      o, B, K, gr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_shape<MODE, EDGES>(st, o, gr, ok_out, dropped, V, K, CV, CE,
                                   B, s);
}

Rows graph_rows(void* const* state) {
  return Rows{(int*)state[0], (unsigned char*)state[1],
              (unsigned char*)state[2], (int*)state[3], (int*)state[4],
              (unsigned char*)state[5], (unsigned char*)state[6]};
}

Ops graph_ops(const void* const* ops) {
  return Ops{(const int*)ops[0], (const int*)ops[1], (const int*)ops[2],
             (const int*)ops[3], (const int*)ops[4]};
}

// the 2P-Set's rows as a vertex block with no edge block, its ops with no a1
Rows tpset_rows(void* const* state) {
  return Rows{(int*)state[0], (unsigned char*)state[1],
              (unsigned char*)state[2], nullptr, nullptr, nullptr, nullptr};
}

Ops tpset_ops(const void* const* ops) {
  return Ops{(const int*)ops[0], (const int*)ops[1], (const int*)ops[2],
             nullptr, (const int*)ops[3]};
}

}  // namespace

// state: seven field pointers (v int32, v_removed, v_valid bool of
// [V, K, CV]; src, dst int32, e_removed, e_valid bool of [V, K, CE]),
// updated in place; ops: five pointers (op, key, a0, a1 int32 [V, B]; ok
// int32 [V, B], null when uncaptured); dropped int32 [V], added to;
// scratch: two buffers, int32 [V * K] zeroed and int32 [V * K, 32, 4]
// (16-byte aligned). CV <= 256, CE <= 256, V <= 65,535, V * K < 2^31.
// Contiguous on one device. Returns the first CUDA
// error of the launches.
extern "C" int graph_apply_launch(void* const* state, const void* const* ops,
                                  void* dropped, void* const* scratch, int V,
                                  int K, int CV, int CE, int B,
                                  void* stream) {
  if (ops[4] != nullptr)
    return launch<MODE_CAPTURED, true>(graph_rows(state), graph_ops(ops),
                                       nullptr, dropped, scratch, V, K, CV,
                                       CE, B, stream);
  return launch<MODE_APPLY, true>(graph_rows(state), graph_ops(ops), nullptr,
                                  dropped, scratch, V, K, CV, CE, B, stream);
}

// The capture mode: ops[4] ignored, and ok_out int32 [V, B], which the
// caller fills with 1, receiving each live lane's gate against the row
// the earlier lanes left.
extern "C" int graph_capture_launch(void* const* state,
                                    const void* const* ops, void* ok_out,
                                    void* dropped, void* const* scratch,
                                    int V, int K, int CV, int CE, int B,
                                    void* stream) {
  return launch<MODE_CAPTURE, true>(graph_rows(state), graph_ops(ops), ok_out,
                                    dropped, scratch, V, K, CV, CE, B,
                                    stream);
}

// The 2P-Set: state three field pointers (elem int32; removed, valid bool)
// of [V, K, C], C <= 256; ops four pointers (op, key, a0 int32 [V, B]; ok
// int32 [V, B], null when uncaptured); otherwise as graph_apply_launch.
extern "C" int tpset_apply_launch(void* const* state, const void* const* ops,
                                  void* dropped, void* const* scratch, int V,
                                  int K, int C, int B, void* stream) {
  if (ops[3] != nullptr)
    return launch<MODE_CAPTURED, false>(tpset_rows(state), tpset_ops(ops),
                                        nullptr, dropped, scratch, V, K, C, 0,
                                        B, stream);
  return launch<MODE_APPLY, false>(tpset_rows(state), tpset_ops(ops), nullptr,
                                   dropped, scratch, V, K, C, 0, B, stream);
}

// The 2P-Set's capture mode: ops[3] ignored; ok_out as for
// graph_capture_launch (a remove's gate is its elem's presence).
extern "C" int tpset_capture_launch(void* const* state,
                                    const void* const* ops, void* ok_out,
                                    void* dropped, void* const* scratch,
                                    int V, int K, int C, int B,
                                    void* stream) {
  return launch<MODE_CAPTURE, false>(tpset_rows(state), tpset_ops(ops),
                                     ok_out, dropped, scratch, V, K, C, 0, B,
                                     stream);
}

// The walk's blocks resident an SM (cudaOccupancyMaxActiveBlocksPerMulti-
// processor) for the uncaptured apply at a row shape (edges: the Graph's
// CV, CE; else the 2P-Set's C = cv), and its threads a block.
extern "C" int graph_walk_occupancy(int edges, int cv, int ce, int* blocks,
                                    int* threads) {
  *threads = 32 * WARPS;
  cudaError_t err;
  if (edges)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks,
        cv <= 32 ? graph_walk_kernel<MODE_APPLY, true, 32, 1, 8>
                 : graph_walk_kernel<MODE_APPLY, true, 32, 8, 8>,
        32 * WARPS, 0);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks,
        cv <= 64 ? graph_walk_kernel<MODE_APPLY, false, 8, 8, 0>
                 : graph_walk_kernel<MODE_APPLY, false, 32, 8, 0>,
        32 * WARPS, 0);
  return (int)err;
}
