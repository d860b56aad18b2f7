// orset_apply: the OR-Set's sequential apply of uncaptured ops, per
// replica, in place; only the rows its ops gather are read.
//
// Replaces: the lax.scan of janus_tpu/models/orset.py _apply_ops_impl,
// vmapped over replicas: uncaptured (has_capture=False), and captured, the
// scan JAX runs for a one-lane captured batch (384-465), where a remove or
// clear does not tombstone in the row but unions the row with its r_cap
// captured tags as dead records (setops.slot_union with the OR-Set's fold:
// the row's slots and the records sorted by tag, stable; a record whose
// predecessor holds the same valid tag is dropped and ORs its tombstone
// into that predecessor; the first C kept, the rest counted as drops, even
// for a key out of range). Ops apply in
// lane order. An op reads the row its key gathers (negative keys count from
// the end, then the index is clamped) and writes it back only if the
// normalised key is in range. add: if a valid slot holds the tag (first
// hit), set its elem; else, when the row is full, count a drop, and insert
// the tag keeping the C smallest tags (the largest, possibly the newcomer,
// falls off). remove: tombstone the valid slots of elem a0; clear: every
// valid slot. Every op with an in-range key leaves its row canonical
// (sorted by tag, stable; invalid slots SENTINEL keys, zero payloads).
//
// What bounds it on the H100: bytes. The function needs 20 bytes per op
// and the rows its ops touch, each read and written once (14 bytes a
// slot). At 64 replicas x 500 keys x 256 slots with 64 ops per replica on
// a hot window of 32 keys that is ~1,350 of the 32,000 rows, ~10 MB, ~3 us
// at 3.35 TB/s; the per-row op chains (each op depends on the row the op
// before it left) are a few ops long.
//
// Design: rows are independent (a scan step touches only row `key`), so
// the lanes are grouped by (replica, gathered row) and only the groups
// with lanes are walked. Two launches (the buckets of lane_buckets.cuh).
// group_fill_kernel, one thread a
// lane, writes each lane the walk needs (an in-range key, or an add,
// remove or clear, which may count a drop on its clamped row; NOOP lanes
// with an in-range key too, since they leave their row canonical) as a
// 16-byte record (lane index with the op code and the in-range bit, a0,
// a1, a2) into the bucket of its group at an atomic count (a warp's lanes
// of one group take one atomic), `cap` records a bucket, and appends each
// group its first lane reaches to a list of the groups with lanes. The
// walk reads only the listed groups. warp_walk_kernel (rows up to
// MAX_WARP_SLOTS): G threads of a warp hold a row in registers, S slots a
// thread (tags, elems, and the tombstone and valid bits as masks); a
// ballot checks that the row ascends in (tag, position), and only a row
// that does not is sorted (through shared memory, by the whole warp).
// The group's records are put in lane order by their (lane, place) keys
// (a warp sort, skipped when the bucket already ascends) and read back a
// WINDOW at a time, the next window's loads in flight while one is
// walked. An add is three ballots: the tag search (the first thread
// holding the tag, its first slot), the full-row test, and the first slot
// above the tag (its insertion point: the row is sorted); an insertion
// shifts the row one slot through the registers, each thread taking its
// predecessor's last slot by one shuffle. remove and clear are each
// thread's own slots. A touched row goes back to global memory once, when
// its walk ends; an untouched row is never written. A group whose bucket
// overflowed (the fill lists it as hot) is walked by a warp of its own
// after the listed groups (its row G S / 32 slots a thread: fewer
// instructions a lane than G threads would take), its lanes
// read from the replica's op fields 32 at a time, the next 32's loads in
// flight while these are walked. block_walk_kernel (the captured mode,
// and rows over MAX_WARP_SLOTS): a block a listed group, the row in shared
// memory, sorted, its replica's lanes scanned in lane order; block-wide
// reductions per op, and the captured remove/clear's union a block sort.
// Instantiations of the warp walk: S = 8 slots a thread, G = 8 (C <= 64:
// four rows a warp), 32 (C <= 256), and S = 16, G = 32 (C <= 512).
// Launches on the caller's stream, allocates nothing (the caller passes
// the groups' scratch), does not synchronise.
#include <cuda_runtime.h>

#include "lane_buckets.cuh"
#include "slot_sort.cuh"

namespace {

using namespace slot_sort;
using lane_buckets::Groups;
using lane_buckets::MAX_BUCKET;
using lane_buckets::WINDOW;

constexpr int WARPS = 4;             // warps a block of the warp walk
constexpr int FILL_THREADS = 256;    // a fill block
constexpr int BLOCK_THREADS = 128;   // a block of the block walk
constexpr int MAX_WARP_SLOTS = 512;  // the widest row the warp walk holds
constexpr int OP_ADD = 1, OP_REMOVE = 2, OP_CLEAR = 3;
// a record's first word: lane << 3 | in range << 2 | the op code (0 for an
// op that only leaves its row canonical)
constexpr int CODE_BITS = 3, IN_RANGE = 4, LANE_SHIFT = 3;
constexpr unsigned FULL = 0xffffffffu;

struct State {
  int* rep;
  int* ctr;
  int* elem;
  unsigned char* removed;
  unsigned char* valid;
};

struct Ops {
  const int* op;
  const int* key;
  const int* a0;
  const int* a1;
  const int* a2;
  // captured mode: [R, B, RC] tags and elements of each remove/clear,
  // SENTINEL rep in unused lanes; null when uncaptured
  const int* rm_rep;
  const int* rm_ctr;
  const int* rm_elem;
  int RC;
};

__device__ __forceinline__ int op_code(int op) {
  return op == OP_ADD || op == OP_REMOVE || op == OP_CLEAR ? op : 0;
}

__device__ __forceinline__ bool in_range_key(int key, int K) {
  const int nk = key < 0 ? key + K : key;
  return nk >= 0 && nk < K;
}

// whether the walk takes a lane: it may change its row or count a drop
__device__ __forceinline__ bool walked(int op, int key, int K) {
  return in_range_key(key, K) || op_code(op) != 0;
}

// lane b's record
__device__ __forceinline__ int4 record(int b, int op, int key, int K, int a0,
                                       int a1, int a2) {
  return make_int4(b << LANE_SHIFT | (in_range_key(key, K) ? IN_RANGE : 0) |
                       op_code(op),
                   a0, a1, a2);
}

// one thread a lane (blockIdx.y the replica): each walked lane's record
// into its group's bucket at the group's count (a warp's lanes of one
// group by one atomic, in lane order); none past the bucket, and none at
// all for the block walk (RECORDS false), where a group past its bucket
// is listed as hot. Zeroes the replica's drops.
template <bool RECORDS>
__global__ void __launch_bounds__(FILL_THREADS)
    group_fill_kernel(Ops ops, int B, int K, Groups gr,
                      int* __restrict__ dropped) {
  const int b = blockIdx.x * FILL_THREADS + threadIdx.x, r = blockIdx.y;
  if (b == 0) dropped[r] = 0;
  const long long i = (long long)r * B + b;
  int op = 0, key = 0;
  if (b < B) {
    op = ops.op[i];
    key = ops.key[i];
  }
  const bool take = b < B && walked(op, key, K);
  const unsigned takers = __ballot_sync(FULL, take);
  if (!take) return;
  const long long vg = (long long)r * K + gather_row(key, K);
  const int at = lane_buckets::claim(gr, takers, vg);
  if (RECORDS && at == gr.cap)  // the first lane past the bucket
    gr.hot[atomicAdd(&gr.live[2 + gr.parity], 1)] = (int)vg;
  if (RECORDS && at < gr.cap)
    gr.rec[vg * gr.cap + at] =
        record(b, op, key, K, ops.a0[i], ops.a1[i], ops.a2[i]);
}

// (rep a, ctr a) < (rep b, ctr b)
__device__ __forceinline__ bool tag_less(int ra, int ca, int rb, int cb) {
  return ra < rb || (ra == rb && ca < cb);
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

// One OR-Set row held by a group of threads: thread s of the group holds
// slots [s S, s S + S) (those below C): tags and elems in registers, the
// tombstone and valid bits and the slots that exist as bit masks. Loaded
// in canonical form (an invalid slot keyed SENTINEL with zero payloads).
template <int S>
struct Row {
  int rep[S], ctr[S], elem[S];
  unsigned rm, valid, have;

  __device__ __forceinline__ void load(const State& st, long long at, int C,
                                       bool vec, int s) {
    const int n = min(max(C - s * S, 0), S);
    at += (long long)s * S;
    have = (1u << n) - 1u;
    rm = valid = 0;
    bool loaded = false;
    if constexpr (S % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int j = 0; j < S / 4; ++j) {
          const int4 a = ((const int4*)(st.rep + at))[j];
          const int4 b = ((const int4*)(st.ctr + at))[j];
          const int4 e = ((const int4*)(st.elem + at))[j];
          rep[4 * j] = a.x;
          rep[4 * j + 1] = a.y;
          rep[4 * j + 2] = a.z;
          rep[4 * j + 3] = a.w;
          ctr[4 * j] = b.x;
          ctr[4 * j + 1] = b.y;
          ctr[4 * j + 2] = b.z;
          ctr[4 * j + 3] = b.w;
          elem[4 * j] = e.x;
          elem[4 * j + 1] = e.y;
          elem[4 * j + 2] = e.z;
          elem[4 * j + 3] = e.w;
          valid |= byte_bits(((const unsigned*)(st.valid + at))[j]) << (4 * j);
          rm |= byte_bits(((const unsigned*)(st.removed + at))[j]) << (4 * j);
        }
        loaded = true;
      }
    }
    if (!loaded) {
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const bool in = i < n;
        rep[i] = in ? st.rep[at + i] : SENT;
        ctr[i] = in ? st.ctr[at + i] : SENT;
        elem[i] = in ? st.elem[at + i] : 0;
        if (in) {
          valid |= (unsigned)(st.valid[at + i] != 0) << i;
          rm |= (unsigned)(st.removed[at + i] != 0) << i;
        }
      }
    }
    valid &= have;
    rm &= valid;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const bool v = (valid >> i) & 1u;
      rep[i] = v ? rep[i] : SENT;
      ctr[i] = v ? ctr[i] : SENT;
      elem[i] = v ? elem[i] : 0;
    }
  }

  // no row: no slot exists
  __device__ __forceinline__ void clear() {
    have = valid = rm = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      rep[i] = ctr[i] = SENT;
      elem[i] = 0;
    }
  }

  __device__ __forceinline__ void store(const State& st, long long at,
                                        bool vec, int s) const {
    at += (long long)s * S;
    if constexpr (S % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int j = 0; j < S / 4; ++j) {
          ((int4*)(st.rep + at))[j] = make_int4(
              rep[4 * j], rep[4 * j + 1], rep[4 * j + 2], rep[4 * j + 3]);
          ((int4*)(st.ctr + at))[j] = make_int4(
              ctr[4 * j], ctr[4 * j + 1], ctr[4 * j + 2], ctr[4 * j + 3]);
          ((int4*)(st.elem + at))[j] = make_int4(
              elem[4 * j], elem[4 * j + 1], elem[4 * j + 2], elem[4 * j + 3]);
          ((unsigned*)(st.valid + at))[j] = bits_bytes(valid >> (4 * j));
          ((unsigned*)(st.removed + at))[j] = bits_bytes(rm >> (4 * j));
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if ((have >> i) & 1u) {
        st.rep[at + i] = rep[i];
        st.ctr[at + i] = ctr[i];
        st.elem[at + i] = elem[i];
        st.valid[at + i] = (valid >> i) & 1u;
        st.removed[at + i] = (rm >> i) & 1u;
      }
    }
  }

  // this thread's slots ascend in (tag, position)
  __device__ __forceinline__ bool ascends() const {
    bool up = true;
#pragma unroll
    for (int i = 1; i < S; ++i)
      up &= !((have >> i) & 1u) || !tag_less(rep[i], ctr[i], rep[i - 1],
                                             ctr[i - 1]);
    return up;
  }

  // this thread's valid slots holding tag (a1, a2)
  __device__ __forceinline__ unsigned holding(int a1, int a2) const {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) m |= (unsigned)(rep[i] == a1 && ctr[i] == a2) << i;
    return m & valid;
  }

  // this thread's slots above tag (a1, a2), or absent (above every tag)
  __device__ __forceinline__ unsigned above(int a1, int a2) const {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) m |= (unsigned)tag_less(a1, a2, rep[i], ctr[i]) << i;
    return (m | ~have) & ((1u << S) - 1u);
  }

  // slot i := elem e
  __device__ __forceinline__ void set_elem(int i, int e) {
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (j == i) elem[j] = e;
  }

  // the tag (a1, a2) with elem a0 into local slot k (k < 0: the row moves
  // up past this thread's slots; k >= S: not this thread's), the slots from
  // k on moving up one, slot 0 taking the predecessor's last slot (p*)
  __device__ __forceinline__ void insert(int k, int a0, int a1, int a2,
                                         int prep, int pctr, int pelem,
                                         unsigned pflags) {
    if (k >= S) return;
#pragma unroll
    for (int i = S - 1; i >= 0; --i) {
      const bool keep = i < k, put = i == k;
      rep[i] = keep ? rep[i] : put ? a1 : i == 0 ? prep : rep[i - 1];
      ctr[i] = keep ? ctr[i] : put ? a2 : i == 0 ? pctr : ctr[i - 1];
      elem[i] = keep ? elem[i] : put ? a0 : i == 0 ? pelem : elem[i - 1];
    }
    const unsigned low = k > 0 ? (1u << k) - 1u : 0u;
    const unsigned pv = pflags & 1u, pr = (pflags >> 1) & 1u;
    const unsigned up_v = valid << 1 | pv, up_r = rm << 1 | pr;
    if (k < 0) {
      valid = up_v & have;
      rm = up_r & have;
    } else {
      const unsigned at = 1u << k, hi = ~(low | at);
      valid = ((valid & low) | at | (up_v & hi)) & have;
      rm = ((rm & low) | (up_r & hi)) & have;
    }
  }
};

// What a walk carries from lane to lane: whether an in-range lane came
// (the row goes back) and the drops.
struct Walk {
  bool touched;
  int drop;
};

// One step of the warp's groups, G threads a group: record r (active:
// the group has a record this step) applied to the group's row. Every
// lane of the warp calls it; every ballot and shuffle is the whole
// warp's, each group reading its own G bits.
template <int G, int S>
__device__ __forceinline__ void walk_step(Row<S>& row, const int4& r,
                                          bool active, Walk& w) {
  const int lane = threadIdx.x & 31, s = lane % G, base = lane - s;
  constexpr unsigned GROUP = G == 32 ? FULL : (1u << G) - 1u;
  const auto mine = [&](unsigned ballot) { return (ballot >> base) & GROUP; };
  const int code = active ? r.x & CODE_BITS : 0;
  const bool in_range = active && (r.x & IN_RANGE);
  const int a0 = r.y, a1 = r.z, a2 = r.w;
  w.touched |= in_range;
  const bool add = code == OP_ADD;
  if (in_range && code == OP_REMOVE) {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) m |= (unsigned)(row.elem[i] == a0) << i;
    row.rm |= m & row.valid;
  } else if (in_range && code == OP_CLEAR) {
    row.rm |= row.valid;
  }
  if (!__any_sync(FULL, add)) return;
  const unsigned hold = add ? row.holding(a1, a2) : 0u;
  const unsigned abv = add ? row.above(a1, a2) : 0u;
  const unsigned has = mine(__ballot_sync(FULL, hold != 0));
  const unsigned gaps = mine(__ballot_sync(FULL, row.valid != row.have));
  const unsigned ups = mine(__ballot_sync(FULL, abv != 0));
  // the insertion point: the first slot above the tag (the row is sorted)
  const int t = ups ? __ffs(ups) - 1 : 0;
  const int first_up = __shfl_sync(FULL, __ffs(abv) - 1, base + t);
  if (add && !has && !gaps) w.drop += 1;
  if (add && in_range && has && s == __ffs(has) - 1)
    row.set_elem(__ffs(hold) - 1, a0);
  const bool ins = add && in_range && !has && ups != 0;
  if (!__any_sync(FULL, ins)) return;
  const int prep = __shfl_up_sync(FULL, row.rep[S - 1], 1);
  const int pctr = __shfl_up_sync(FULL, row.ctr[S - 1], 1);
  const int pelem = __shfl_up_sync(FULL, row.elem[S - 1], 1);
  const unsigned pflags = __shfl_up_sync(
      FULL, (row.valid >> (S - 1) & 1u) | (row.rm >> (S - 1) & 1u) << 1, 1);
  if (ins) row.insert(t * S + first_up - s * S, a0, a1, a2, prep, pctr, pelem,
                      pflags);
}

// The rows of the warp's groups whose slots do not ascend in (tag,
// position) put in that order (a stable sort: what the first in-range
// op's canonicalisation does, and every op's effect commutes with it):
// each such group's slots as records in `area` ([32 S]), sorted by the
// whole warp, a group at a time.
template <int G, int S>
__device__ __forceinline__ void canonical_order(Row<S>& row, int4* area,
                                                int C) {
  const int lane = threadIdx.x & 31, s = lane % G, part = lane / G;
  constexpr unsigned GROUP = G == 32 ? FULL : (1u << G) - 1u;
  bool up = row.ascends();
  const int prep = __shfl_up_sync(FULL, row.rep[S - 1], 1);
  const int pctr = __shfl_up_sync(FULL, row.ctr[S - 1], 1);
  if (s > 0 && (row.have & 1u))
    up &= !tag_less(row.rep[0], row.ctr[0], prep, pctr);
  unsigned bad = __ballot_sync(FULL, !up);
  while (bad) {
    const int q = (__ffs(bad) - 1) / G;
    bad &= ~(GROUP << (q * G));
    int4* a = area + q * G * S;
    if (part == q) {
#pragma unroll
      for (int i = 0; i < S; ++i)
        if ((row.have >> i) & 1u)
          a[s * S + i] = make_int4(
              row.rep[i], row.ctr[i],
              (s * S + i) << 2 | ((row.rm >> i) & 1u) << 1 |
                  ((row.valid >> i) & 1u),
              row.elem[i]);
    }
    __syncwarp();
    int p = 1;
    while (p < C) p <<= 1;
    const LessXYZ less;
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int x = lane; x < (p >> 1); x += 32) {
          const int lo = ((x & ~(j - 1)) << 1) | (x & (j - 1));
          const int hi = j == (k >> 1) ? (lo ^ (k - 1)) : lo + j;
          if (hi < C) {
            const int4 u = a[lo], v = a[hi];
            if (less(v, u)) {
              a[lo] = v;
              a[hi] = u;
            }
          }
        }
        __syncwarp();
      }
    }
    if (part == q) {
      unsigned v = 0, r = 0;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if ((row.have >> i) & 1u) {
          const int4 x = a[s * S + i];
          row.rep[i] = x.x;
          row.ctr[i] = x.y;
          row.elem[i] = x.w;
          v |= (unsigned)(x.z & 1) << i;
          r |= (unsigned)((x.z >> 1) & 1) << i;
        }
      }
      row.valid = v;
      row.rm = r;
    }
    __syncwarp();
  }
}

// A group whose bucket overflowed, walked by the whole warp (its row S
// slots a thread) from the replica's op fields, 32 lanes at a time, the
// next 32's loads in flight while these are walked; win: the warp's
// window ([32] records), area: its row sort's records ([32 S]).
template <int S>
__device__ __forceinline__ void hot_walk(const State& st, const Ops& ops,
                                         int vk, int K, int C, int B,
                                         bool vec, int4* win, int4* area,
                                         int* __restrict__ dropped) {
  const int lane = threadIdx.x & 31, v = vk / K, g = vk - v * K;
  Row<S> row;
  row.load(st, (long long)vk * C, C, vec, lane);
  canonical_order<32, S>(row, area, C);
  Walk w{false, 0};
  int op = 0, key = 0, a0 = 0, a1 = 0, a2 = 0;
  const auto load = [&](int b) {
    if (b < B) {
      const long long i = (long long)v * B + b;
      op = ops.op[i];
      key = ops.key[i];
      a0 = ops.a0[i];
      a1 = ops.a1[i];
      a2 = ops.a2[i];
    }
  };
  load(lane);
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    const bool hit = b < B && walked(op, key, K) && gather_row(key, K) == g;
    const unsigned hits = __ballot_sync(FULL, hit);
    if (hit)
      win[__popc(hits & ((1u << lane) - 1u))] =
          record(b, op, key, K, a0, a1, a2);
    __syncwarp();
    load(b + 32);
    const int cnt = __popc(hits);
    for (int j = 0; j < cnt; ++j) walk_step<32, S>(row, win[j], true, w);
    __syncwarp();
  }
  if (w.touched) row.store(st, (long long)vk * C, vec, lane);
  if (lane == 0 && w.drop) atomicAdd(&dropped[v], w.drop);
}

// The warp walk's blocks an SM its launch bound asks for (so that ptxas
// does not hold it to fewer registers than the row takes).
constexpr int WALK_MIN_BLOCKS = 3;

// shared memory of a warp: its groups' sort keys [PER cap], their windows
// [PER WINDOW] of records and the row sort's records [32 S]
template <int S>
__host__ __device__ inline size_t warp_shared(int per, int cap) {
  return round16((size_t)4 * per * cap) + (size_t)16 * per * WINDOW +
         (size_t)16 * 32 * S;
}

template <int G, int S>
__global__ void __launch_bounds__(32 * WARPS, WALK_MIN_BLOCKS)
    warp_walk_kernel(State st, Ops ops, Groups gr, int* __restrict__ dropped,
                     int K, int C, int B, bool vec, bool vec_hot) {
  constexpr int PER = 32 / G;     // groups a warp walks side by side
  constexpr int SH = G * S / 32;  // a hot row's slots a thread
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = lane / G, s = lane % G;
  const int cap = gr.cap;
  unsigned char* mine_smem =
      (unsigned char*)smem + warp * warp_shared<S>(PER, cap);
  unsigned* keys = (unsigned*)mine_smem;  // [PER][cap]
  int4* win = (int4*)(mine_smem + round16((size_t)4 * PER * cap));
  int4* sort_area = win + PER * WINDOW;  // [32 S]
  int4* my_win = win + part * WINDOW;
  unsigned* my_keys = keys + part * cap;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    gr.live[gr.parity ^ 1] = gr.live[2 + (gr.parity ^ 1)] = 0;
  // items of PER groups from the list of groups with lanes, a warp each
  const int live = gr.live[gr.parity];
  const int items = (live + PER - 1) / PER;
  for (int item = blockIdx.x * WARPS + warp; item < items;
       item += gridDim.x * WARPS) {
    const int at = item * PER + lane;
    const int mine_vk = lane < PER && at < live ? gr.list[at] : -1;
    const int n = mine_vk >= 0 ? gr.count[mine_vk] : 0;
    if (n) gr.count[mine_vk] = 0;
    // the groups whose records are in their bucket, side by side (the
    // hot ones come after the items)
    unsigned todo = __ballot_sync(FULL, n > 0 && n <= cap);
    while (todo) {
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
      const int m = src < 0 ? 0 : cnt;
      const int vk = src < 0 ? -1 : src_vk;
      Row<S> row;
      // the row's loads go out with the records'
      if (vk >= 0)
        row.load(st, (long long)vk * C, C, vec, s);
      else
        row.clear();
      const int4* bucket = gr.rec + (long long)(vk < 0 ? 0 : vk) * cap;
      lane_buckets::lane_order<G>(keys, cap, bucket, m, LANE_SHIFT);
      canonical_order<G, S>(row, sort_area, C);
      Walk w{false, 0};
      lane_buckets::walk_records<G>(bucket, my_keys, m, my_win,
                                    [&](const int4& r, bool active) {
                                      walk_step<G, S>(row, r, active, w);
                                    });
      __syncwarp();
      if (vk >= 0) {
        if (w.touched) row.store(st, (long long)vk * C, vec, s);
        if (s == 0 && w.drop) atomicAdd(&dropped[vk / K], w.drop);
      }
      __syncwarp();
    }
  }
  // each group past its bucket by a warp of its own
  const int hot = gr.live[2 + gr.parity];
  for (int h = blockIdx.x * WARPS + warp; h < hot; h += gridDim.x * WARPS) {
    hot_walk<SH>(st, ops, gr.hot[h], K, C, B, vec_hot, win, sort_area,
                 dropped);
    __syncwarp();
  }
}

// The block walk's blocks an SM its launch bound asks for (registers
// enough that ptxas keeps no stack frame).
constexpr int BLOCK_MIN_BLOCKS = 4;

// one row buffer in shared memory (the block walk)
struct Buf {
  int* rep;
  int* ctr;
  int* elem;
  unsigned char* rm;
  unsigned char* valid;
};

__device__ Buf buf_at(char* base, int c) {
  Buf r;
  r.rep = (int*)base;
  r.ctr = r.rep + c;
  r.elem = r.ctr + c;
  r.rm = (unsigned char*)(r.elem + c);
  r.valid = r.rm + c;
  return r;
}

// The block walk: a block a listed group, the row in shared memory put in
// canonical order (a block sort on (tag, position)), the replica's lanes
// that gather it kept in lane order (a ballot prefix over tiles of
// BLOCK_THREADS lanes) and applied one by one with block-wide reductions;
// an insertion shifts the row into a second buffer. CAPTURED: the
// captured mode, where a remove or clear unions the row with its captured
// tags (a block sort of the row and the records).
template <bool CAPTURED>
__global__ void __launch_bounds__(BLOCK_THREADS, BLOCK_MIN_BLOCKS)
    block_walk_kernel(State st, Ops ops, Groups gr, int* __restrict__ dropped,
                      int K, int C, int B) {
  extern __shared__ int4 smem[];
  const int RC = CAPTURED ? ops.RC : 0;
  int4* rec = smem;                               // [C + RC] sort records
  const size_t row_bytes = (size_t)C * 14;
  char* rows = (char*)(rec + C + RC);
  // buffer c at rows + c * stride: selected by arithmetic, not by an
  // array indexed at run time (which would live in local memory)
  const size_t stride = round16(row_bytes);
  const auto buf = [&](int c) { return buf_at(rows + c * stride, C); };
  int* lanes = (int*)(rows + 2 * stride);  // [BLOCK_THREADS]
  unsigned char* flag = (unsigned char*)(lanes + BLOCK_THREADS);  // [C + RC]
  __shared__ int s_first, s_pos;

  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && tid == 0)
    gr.live[gr.parity ^ 1] = gr.live[2 + (gr.parity ^ 1)] = 0;
  const int live = gr.live[gr.parity];
  for (int item = blockIdx.x; item < live; item += gridDim.x) {
    const int blk = gr.list[item];
    if (tid == 0) gr.count[blk] = 0;
    const int r = blk / K, g = blk - r * K;
    const long long base = (long long)blk * C;

    // canonical order of the raw row: raw payloads staged in buffer 1
    const Buf raw = buf(1), first = buf(0);
    for (int c = tid; c < C; c += BLOCK_THREADS) {
      const bool v = st.valid[base + c];
      rec[c] = make_int4(v ? st.rep[base + c] : SENT,
                         v ? st.ctr[base + c] : SENT, c, 0);
      raw.elem[c] = st.elem[base + c];
      raw.rm[c] = st.removed[base + c];
      raw.valid[c] = v;
    }
    __syncthreads();
    block_sort(rec, C, LessXYZ());
    for (int j = tid; j < C; j += BLOCK_THREADS) {
      const int4 x = rec[j];
      const bool v = raw.valid[x.z];
      first.rep[j] = x.x;
      first.ctr[j] = x.y;
      first.elem[j] = v ? raw.elem[x.z] : 0;
      first.rm[j] = v && raw.rm[x.z];
      first.valid[j] = v;
    }
    __syncthreads();

    int cur = 0, drop = 0;
    bool touched = false;
    for (int b0 = 0; b0 < B; b0 += BLOCK_THREADS) {
      const int b = b0 + tid;
      const bool mine =
          b < B && gather_row(ops.key[(long long)r * B + b], K) == g;
      int nm;
      const int at = block_count_before(mine, &nm);
      if (mine) lanes[at] = b;
      __syncthreads();
      for (int m = 0; m < nm; ++m) {
        const long long o = (long long)r * B + lanes[m];
        const int op = ops.op[o], key = ops.key[o], a0 = ops.a0[o];
        const int a1 = ops.a1[o], a2 = ops.a2[o];
        const bool in_range = in_range_key(key, K);
        const Buf row = buf(cur);
        if (op == OP_ADD) {
          if (tid == 0) {
            s_first = C;
            s_pos = 0;
          }
          __syncthreads();
          bool all_valid = true;
          int not_above = 0;
          for (int j = tid; j < C; j += BLOCK_THREADS) {
            const bool v = row.valid[j];
            all_valid &= v;
            if (v && row.rep[j] == a1 && row.ctr[j] == a2) atomicMin(&s_first, j);
            not_above += row.rep[j] < a1 || (row.rep[j] == a1 && row.ctr[j] <= a2);
          }
          atomicAdd(&s_pos, not_above);
          const bool full = __syncthreads_and(all_valid);
          const int first = s_first, p = s_pos;
          const bool found = first < C;
          drop += !found && full;
          if (in_range) {
            touched = true;
            if (found) {
              if (tid == 0) row.elem[first] = a0;
            } else if (p < C) {
              const Buf nxt = buf(cur ^ 1);
              for (int j = tid; j < C; j += BLOCK_THREADS) {
                if (j == p) {
                  nxt.rep[j] = a1;
                  nxt.ctr[j] = a2;
                  nxt.elem[j] = a0;
                  nxt.rm[j] = 0;
                  nxt.valid[j] = 1;
                } else {
                  const int s = j < p ? j : j - 1;
                  nxt.rep[j] = row.rep[s];
                  nxt.ctr[j] = row.ctr[s];
                  nxt.elem[j] = row.elem[s];
                  nxt.rm[j] = row.rm[s];
                  nxt.valid[j] = row.valid[s];
                }
              }
              cur ^= 1;
            }
          }
        } else if (CAPTURED && (op == OP_REMOVE || op == OP_CLEAR)) {
          // the union of the canonical row with the op's captured tags
          const long long co = o * RC;
          const int n = C + RC;
          for (int j = tid; j < n; j += BLOCK_THREADS) {
            if (j < C) {
              rec[j] = make_int4(row.rep[j], row.ctr[j], j, 0);
            } else {
              const int rr = ops.rm_rep[co + j - C];
              const bool v = rr != SENT;
              rec[j] = make_int4(v ? rr : SENT,
                                 v ? ops.rm_ctr[co + j - C] : SENT, j, 0);
            }
          }
          __syncthreads();
          block_sort(rec, n, LessXYZ());
          // flag bit 0: valid; bit 1: tombstone
          for (int j = tid; j < n; j += BLOCK_THREADS) {
            const int i = rec[j].z;
            flag[j] = i < C ? (row.valid[i] | (row.rm[i] << 1))
                            : ((ops.rm_rep[co + i - C] != SENT) | 2);
          }
          __syncthreads();
          const Buf nxt = buf(cur ^ 1);
          int kept = 0;
          for (int j0 = 0; j0 < n; j0 += BLOCK_THREADS) {
            const int j = j0 + tid;
            bool keep = false, dead = false;
            int elem = 0;
            if (j < n) {
              const int4 x = rec[j];
              const bool v = flag[j] & 1;
              const bool dup = j > 0 && v && (flag[j - 1] & 1) &&
                               rec[j - 1].x == x.x && rec[j - 1].y == x.y;
              const bool next_dup = j + 1 < n && v && (flag[j + 1] & 1) &&
                                    rec[j + 1].x == x.x && rec[j + 1].y == x.y;
              keep = v && !dup;
              dead = (flag[j] & 2) || (next_dup && (flag[j + 1] & 2));
              elem = x.z < C ? row.elem[x.z] : ops.rm_elem[co + x.z - C];
            }
            int nk;
            const int at = kept + block_count_before(keep, &nk);
            if (keep && at < C && in_range) {
              nxt.rep[at] = rec[j].x;
              nxt.ctr[at] = rec[j].y;
              nxt.elem[at] = elem;
              nxt.rm[at] = dead;
              nxt.valid[at] = 1;
            }
            kept += nk;
          }
          drop += kept > C ? kept - C : 0;
          if (in_range) {
            for (int j = kept + tid; j < C; j += BLOCK_THREADS) {
              nxt.rep[j] = SENT;
              nxt.ctr[j] = SENT;
              nxt.elem[j] = 0;
              nxt.rm[j] = 0;
              nxt.valid[j] = 0;
            }
            touched = true;
            cur ^= 1;
          }
        } else if ((op == OP_REMOVE || op == OP_CLEAR) && in_range) {
          touched = true;
          for (int j = tid; j < C; j += BLOCK_THREADS)
            if (row.valid[j] && (op == OP_CLEAR || row.elem[j] == a0))
              row.rm[j] = 1;
        } else if (in_range) {
          touched = true;  // any op leaves its row canonical
        }
        __syncthreads();
      }
    }

    if (touched) {
      const Buf row = buf(cur);
      for (int j = tid; j < C; j += BLOCK_THREADS) {
        st.rep[base + j] = row.rep[j];
        st.ctr[base + j] = row.ctr[j];
        st.elem[base + j] = row.elem[j];
        st.removed[base + j] = row.rm[j];
        st.valid[base + j] = row.valid[j];
      }
    }
    if (tid == 0 && drop) atomicAdd(&dropped[r], drop);
    __syncthreads();
  }
}

// shared memory of a block of the block walk: a 16-byte sort record per
// slot and captured tag, two row buffers, the lane list of a tile, a flag
// byte per record
size_t block_shared(int C, int RC) {
  return sizeof(int4) * (size_t)(C + RC) + 2 * round16((size_t)C * 14) +
         sizeof(int) * BLOCK_THREADS + (size_t)(C + RC);
}

// whether the row's fields allow the 16-byte path: C == g s slots, s a
// multiple of 4, the int fields 16-byte aligned and the bool ones 4-byte
bool vector_ok(const State& st, int C, int g, int s) {
  const auto al = [](const void* p, size_t a) {
    return ((size_t)p & (a - 1)) == 0;
  };
  return C == g * s && s % 4 == 0 && al(st.rep, 16) && al(st.ctr, 16) &&
         al(st.elem, 16) && al(st.removed, 4) && al(st.valid, 4);
}

// The warp walk's blocks resident on the card at `bytes` of shared
// memory, asked of the runtime once for each instantiation (a template
// argument of this function), device and size, the shared memory opt-in
// with it.
template <int G, int S>
cudaError_t walk_grid(size_t bytes, long long* grid) {
  static int s_dev = -1;
  static size_t s_bytes = 0;
  static long long s_grid = 0;
  const auto kernel = warp_walk_kernel<G, S>;
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

template <int G, int S>
int launch_walk(const State& st, const Ops& o, Groups gr, void* dropped,
                int R, int K, int C, int B, cudaStream_t s) {
  const bool vec = vector_ok(st, C, G, S),
             vec_hot = vector_ok(st, C, 32, G * S / 32);
  const size_t bytes = WARPS * warp_shared<S>(32 / G, gr.cap);
  long long grid = 0;
  cudaError_t err = walk_grid<G, S>(bytes, &grid);
  if (err != cudaSuccess) return (int)err;
  // at most the blocks the groups could need: the listed groups are not
  // known on the host
  const long long items = ((long long)R * K + 32 / G - 1) / (32 / G);
  const long long need = (items + WARPS - 1) / WARPS;
  if (grid > need) grid = need > 0 ? need : 1;
  warp_walk_kernel<G, S><<<(unsigned)grid, 32 * WARPS, bytes, s>>>(
      st, o, gr, (int*)dropped, K, C, B, vec, vec_hot);
  return (int)cudaGetLastError();
}

}  // namespace

// state fields [R, K, C] (int32 tags and elem, bool removed and valid),
// updated in place; op fields int32 [R, B]; rm_rep, rm_ctr, rm_elem int32
// [R, B, RC] for captured ops, null (and RC 0) for uncaptured ones; dropped
// int32 [R] (written); scratch: four buffers, the counts int32 [R K] zero
// on entry (and on return), the buckets int4 [R K cap] (16-byte aligned),
// the lists int32 [R K + R B / (cap + 1) + 1] (the groups with lanes, then
// the hot ones) and their lengths int32 [4], lengths `parity` and 2 +
// `parity` (0 or 1, alternating from call to call) zero on entry, the
// other two zeroed by the walk. cap a multiple of 32 in [32, MAX_BUCKET]; B < 2^21, R <= 65,535,
// R K < 2^31; the captured mode and rows over MAX_WARP_SLOTS slots take
// the block walk, whose shared memory (block_shared) must fit a block.
// Contiguous on one device. Returns the first CUDA error of the launches.
extern "C" int orset_apply_launch(void* const* state, const void* const* ops,
                                  const void* const* captured, int RC,
                                  void* dropped, void* const* scratch, int R,
                                  int K, int C, int B, int cap, int parity,
                                  void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  if (R > 65535 || (long long)R * K >= (1LL << 31) || B >= (1 << 21) ||
      cap < 32 || cap > MAX_BUCKET || cap % 32 || B <= 0 || K <= 0 ||
      C <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const State st{(int*)state[0], (int*)state[1], (int*)state[2],
                 (unsigned char*)state[3], (unsigned char*)state[4]};
  const bool cap_mode = captured != nullptr && captured[0] != nullptr;
  const Ops o{(const int*)ops[0], (const int*)ops[1], (const int*)ops[2],
              (const int*)ops[3], (const int*)ops[4],
              cap_mode ? (const int*)captured[0] : nullptr,
              cap_mode ? (const int*)captured[1] : nullptr,
              cap_mode ? (const int*)captured[2] : nullptr,
              cap_mode ? RC : 0};
  const Groups gr{(int*)scratch[0], (int4*)scratch[1], (int*)scratch[2],
                  (int*)scratch[2] + (long long)R * K, (int*)scratch[3],
                  parity & 1, cap};
  const bool block = cap_mode || C > MAX_WARP_SLOTS;
  const dim3 lanes((unsigned)((B + FILL_THREADS - 1) / FILL_THREADS),
                   (unsigned)R);
  if (block)
    group_fill_kernel<false><<<lanes, FILL_THREADS, 0, s>>>(o, B, K, gr,
                                                            (int*)dropped);
  else
    group_fill_kernel<true><<<lanes, FILL_THREADS, 0, s>>>(o, B, K, gr,
                                                           (int*)dropped);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (block) {
    const size_t bytes = block_shared(C, o.RC);
    err = cap_mode ? allow_shared(block_walk_kernel<true>, bytes)
                   : allow_shared(block_walk_kernel<false>, bytes);
    if (err != cudaSuccess) return (int)err;
    const long long groups = (long long)R * K;
    const unsigned grid = (unsigned)(groups < 132LL * 8 ? groups : 132LL * 8);
    if (cap_mode)
      block_walk_kernel<true><<<grid, BLOCK_THREADS, bytes, s>>>(
          st, o, gr, (int*)dropped, K, C, B);
    else
      block_walk_kernel<false><<<grid, BLOCK_THREADS, bytes, s>>>(
          st, o, gr, (int*)dropped, K, C, B);
    return (int)cudaGetLastError();
  }
  if (C <= 64) return launch_walk<8, 8>(st, o, gr, dropped, R, K, C, B, s);
  if (C <= 256) return launch_walk<32, 8>(st, o, gr, dropped, R, K, C, B, s);
  return launch_walk<32, 16>(st, o, gr, dropped, R, K, C, B, s);
}
