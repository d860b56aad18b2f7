// rga_apply: the RGA's sequential apply of insert/delete ops, per replica,
// in place; the lanes of each (replica, document row) walked in lane order.
//
// Replaces: the lax.scan of janus_tpu/models/rga.py _apply_ops_impl
// (120-181), vmapped over replicas, uncaptured (the Lamport counter minted
// at apply) and captured (the counter read from the op's eff_ctr); and, as
// the capture mode (entry point rga_capture_launch), the scan of
// janus_tpu/models/base.py capture_and_apply (160-186) with
// janus_tpu/models/rga.py prepare_ops (90-102), vmapped over the views:
// the uncaptured walk that also writes each lane's minted counter to
// eff_out (0 for a delete or another code). Each op's prepare observes the
// state the earlier lanes left, which is the state the uncaptured mint
// reads, so the two agree lane by lane, a dropped insert's counter (which
// still advances the floor) included. Ops apply in lane
// order. An op reads the row its key gathers (negative keys count from the
// end, then the index is clamped) and writes the row and the document's
// Lamport floor back only if the normalised key is in range. insert: the
// counter is eff_ctr, or max(max over the row of (valid ? id_ctr : 0),
// ctr_floor[k]) + 1 (int32, wrapping); then an upsert of id (ctr, writer):
// into the first valid slot holding the id, par_rep, par_ctr and chr take
// the max with (a1, a2, a0); else into the first invalid slot, a fresh
// live element with parent (a2, a1) and chr a0. delete: an upsert of id
// (a2, a1) that sets dead on the first valid slot holding it, or lands a
// dead placeholder (zero parent and chr) in the first invalid slot. An
// upsert of an absent id into a full row counts one drop (whether or not
// the key is in range) and changes nothing. Every op with an in-range key
// sets ctr_floor[k] to its max with the counter it carries: the minted one
// for an insert, a2 for a delete (each at least 0), 0 for other codes.
// A lane of another code (0, the ring's cleared lanes; 3, unknown) is not
// live: its one effect is that idempotent clamp of the floor at 0, which
// only the first live lane after it can observe.
//
// What bounds it on the H100: bytes. The function needs 28 bytes per live
// op (six fields and eff_ctr), the op and key of every other lane, and
// the rows its ops touch, each read and written once (22 bytes a slot, 4
// of floor). At the rga preset (R=1,024, K=128, C=1,024, 16 insert and
// 16 delete lanes per replica) ops touch at most 18 rows per replica,
// 18,432 rows of 22.5 KB, ~0.83 GB both ways, ~0.25 ms at 3.35 TB/s.
//
// Design: an op touches only the row it gathers, so rows are independent.
// Two launches. fill_kernel, one thread a lane, writes each live lane's
// index into its (view, gathered row) group's bucket at an atomic count
// (a warp's lanes of one group take one atomic, in lane order; a bucket
// holds min(GROUP_LANES, B rounded up to 32) lanes) and keeps each group's
// lowest in-range other lane (atomicMax of B - lane). The walk gives a
// warp (a block of 32 threads) each group with lanes: it puts the bucket
// back in lane order (a rank sort, skipped when it already ascends), loads
// the lanes' fields and the row (22.5 KB at C=1,024, by 16-byte loads
// where the row allows) into shared memory, and walks only the live lanes,
// clamping the floor before the first one past that lowest other lane (or
// at the end). Thread t owns the 4-slot runs 4t + 128j (slots t + 32j
// where a row is not 16-byte aligned): the id search (branch-free, every
// load issued at once) and the first free slot are warp minima
// (__reduce_min_sync) of each thread's own, the upsert the owning
// thread's, so a lane takes no barrier; the uncaptured mint reads a valid
// maximum and free count every thread keeps (reduced at staging, updated
// as slots land). A group whose bucket overflowed reads its view's op
// fields 32 lanes at a time and walks the live lanes that gather it. So
// SafeKV's delta applies (16,384 lanes a view, 0-8,192 live, the rest
// OP_NOOP, most at key 0) walk no no-op lane, and the replay (32 live
// lanes a replica, 18,432 rows of 1,024 slots) keeps 8 rows an SM in
// flight. A warp, not a block, walks a row: a block of 256 threads issues
// each lane's search and barrier across 8 warps (~1.3 µs a lane at
// C = 1,024 on the delta applies), a warp an eighth of the instructions
// and no barrier.
// Launches on the caller's stream, allocates nothing (the caller passes
// the buckets' scratch), does not synchronise.
#include <cuda_runtime.h>
#include <limits.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 256;  // a fill block
constexpr int OP_INSERT = 1, OP_DELETE = 2;
// the most lanes a group's bucket holds (a multiple of 32): the
// rga_consensus delta applies hold 4-64 live lanes a group (a budget of 16
// blocks would hold 128); a group past its bucket reads the op fields
constexpr int GROUP_LANES = 128;
constexpr unsigned FULL = 0xffffffffu;

struct State {
  int* id_ctr;
  int* id_rep;
  int* par_ctr;
  int* par_rep;
  int* chr;
  unsigned char* dead;
  unsigned char* valid;
  int* floor;  // [R, K]
};

struct Ops {
  const int* op;
  const int* key;
  const int* a0;
  const int* a1;
  const int* a2;
  const int* writer;
  const int* eff;  // [R, B] or null (uncaptured)
};

// the buckets: count[R K] (live lanes a group), first[R K] (B - the
// group's lowest in-range other lane, 0: none), both zeroed by the launch;
// lane[R K, cap]
struct Groups {
  int* count;
  int* first;
  int* lane;
  int cap;  // lanes a bucket holds
};

// a bucket's lanes for views of B lanes
int bucket_cap(int B) {
  const int up = (B + 31) / 32 * 32;
  return up < GROUP_LANES ? up : GROUP_LANES;
}

__device__ __forceinline__ bool is_live(int op) {
  return op == OP_INSERT || op == OP_DELETE;
}

__device__ __forceinline__ bool key_in_range(int key, int K) {
  const int nk = key < 0 ? key + K : key;
  return nk >= 0 && nk < K;
}

// ---- the buckets: a warp a (view, row) group ----------------------------

// one op lane's fields
struct Lane {
  int op, key, a0, a1, a2, writer, eff;
};

__device__ __forceinline__ Lane load_lane(const Ops& ops, long long o) {
  return Lane{ops.op[o], ops.key[o],    ops.a0[o],
              ops.a1[o], ops.a2[o],     ops.writer[o],
              ops.eff ? ops.eff[o] : 0};
}

__device__ __forceinline__ Lane shfl_lane(const Lane& l, int src) {
  return Lane{__shfl_sync(FULL, l.op, src),  __shfl_sync(FULL, l.key, src),
              __shfl_sync(FULL, l.a0, src),  __shfl_sync(FULL, l.a1, src),
              __shfl_sync(FULL, l.a2, src),  __shfl_sync(FULL, l.writer, src),
              __shfl_sync(FULL, l.eff, src)};
}

// a staged row in shared memory
struct Row {
  int* id_ctr;
  int* id_rep;
  int* par_ctr;
  int* par_rep;
  int* chr;
  unsigned char* dead;
  unsigned char* valid;
};

// what a group's walk carries from lane to lane, the same in every thread
struct Walk {
  int floor;  // the document's floor as the lanes so far leave it
  int vmax;   // the greatest id_ctr of a valid slot (INT_MIN: none)
  int nfree;  // the row's invalid slots
  int drop;   // drops counted
  bool changed;    // an in-range live lane came: the row goes back
  bool floor_set;  // an in-range lane came: the floor goes back
};

__device__ __forceinline__ int4 ld4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}

__device__ __forceinline__ void st4(int* p, int4 v) {
  *reinterpret_cast<int4*>(p) = v;
}

__device__ __forceinline__ unsigned ld_word(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void st_word(unsigned char* p, unsigned v) {
  *reinterpret_cast<unsigned*>(p) = v;
}

// The group's row (slots [base, base + C) of every field) into shared
// memory by the warp, 4 slots a thread-step by 16-byte loads when `vec`;
// with `mint`, the row's valid maximum and free count into w. Ends in a
// __syncwarp.
__device__ void warp_stage(const State& st, const Row& s, long long base,
                           int C, bool vec, bool mint, Walk& w) {
  const int t = threadIdx.x;
  int vmax = INT_MIN, nfree = 0;
  if (vec) {
#pragma unroll 2
    for (int c = 4 * t; c < C; c += 128) {
      const long long at = base + c;
      const int4 ic = ld4(st.id_ctr + at);
      const unsigned v = ld_word(st.valid + at);
      st4(s.id_ctr + c, ic);
      st4(s.id_rep + c, ld4(st.id_rep + at));
      st4(s.par_ctr + c, ld4(st.par_ctr + at));
      st4(s.par_rep + c, ld4(st.par_rep + at));
      st4(s.chr + c, ld4(st.chr + at));
      st_word(s.dead + c, ld_word(st.dead + at));
      st_word(s.valid + c, v);
      if (mint) {
        const int x[4] = {ic.x, ic.y, ic.z, ic.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if ((v >> (8 * i)) & 0xffu) vmax = max(vmax, x[i]);
          else ++nfree;
        }
      }
    }
  } else {
    for (int c = t; c < C; c += 32) {
      const long long at = base + c;
      const int ic = st.id_ctr[at];
      const unsigned char v = st.valid[at];
      s.id_ctr[c] = ic;
      s.id_rep[c] = st.id_rep[at];
      s.par_ctr[c] = st.par_ctr[at];
      s.par_rep[c] = st.par_rep[at];
      s.chr[c] = st.chr[at];
      s.dead[c] = st.dead[at];
      s.valid[c] = v;
      if (mint) {
        if (v) vmax = max(vmax, ic);
        else ++nfree;
      }
    }
  }
  if (mint) {
    w.vmax = __reduce_max_sync(FULL, vmax);
    w.nfree = __reduce_add_sync(FULL, nfree);
  }
  __syncwarp();
}

// The staged row back to slots [base, base + C) (after a __syncwarp).
__device__ void warp_unstage(const State& st, const Row& s, long long base,
                             int C, bool vec) {
  const int t = threadIdx.x;
  if (vec) {
#pragma unroll 2
    for (int c = 4 * t; c < C; c += 128) {
      const long long at = base + c;
      st4(st.id_ctr + at, ld4(s.id_ctr + c));
      st4(st.id_rep + at, ld4(s.id_rep + c));
      st4(st.par_ctr + at, ld4(s.par_ctr + c));
      st4(st.par_rep + at, ld4(s.par_rep + c));
      st4(st.chr + at, ld4(s.chr + c));
      st_word(st.dead + at, ld_word(s.dead + c));
      st_word(st.valid + at, ld_word(s.valid + c));
    }
  } else {
    for (int c = t; c < C; c += 32) {
      const long long at = base + c;
      st.id_ctr[at] = s.id_ctr[c];
      st.id_rep[at] = s.id_rep[c];
      st.par_ctr[at] = s.par_ctr[c];
      st.par_rep[at] = s.par_rep[c];
      st.chr[at] = s.chr[c];
      st.dead[at] = s.dead[c];
      st.valid[at] = s.valid[c];
    }
  }
}

// The first slot of this thread's holding id (kc, kr) and its first free
// slot (C: none). With `vec` thread t holds the 4-slot runs 4t + 128j
// (one 4-byte and two 16-byte loads a run), else the slots t + 32j; its
// slots ascend either way, no load waits on another, and no slot takes a
// branch (a branch a slot cost ~1 µs a lane at C = 1,024).
__device__ __forceinline__ int2 own_search(const Row& s, int kc, int kr,
                                           int C, bool vec) {
  const int t = threadIdx.x;
  int first = C, free_slot = C;
  if (vec) {
#pragma unroll 4
    for (int c = 4 * t; c < C; c += 128) {
      const unsigned v = ld_word(s.valid + c);
      const int4 x = ld4(s.id_ctr + c), y = ld4(s.id_rep + c);
      const int xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool valid = (v >> (8 * i)) & 0xffu;
        const bool hit = valid & (xs[i] == kc) & (ys[i] == kr);
        first = min(first, hit ? c + i : C);
        free_slot = min(free_slot, valid ? C : c + i);
      }
    }
  } else {
#pragma unroll 4
    for (int c = t; c < C; c += 32) {
      const bool valid = s.valid[c];
      const bool hit = valid & (s.id_ctr[c] == kc) & (s.id_rep[c] == kr);
      first = min(first, hit ? c : C);
      free_slot = min(free_slot, valid ? C : c);
    }
  }
  return make_int2(first, free_slot);
}

// the thread that owns slot c in own_search
__device__ __forceinline__ bool owns(int c, bool vec) {
  return (vec ? (c >> 2) & 31 : c & 31) == (int)threadIdx.x;
}

// One live lane (fields l, lane index b, offset o) applied to the staged
// row by the warp; the floor clamped first when b is past `clamp_after`
// (the group's lowest in-range other lane). Every thread returns the same
// walk state; only slot owners write the row.
template <bool CAPTURE>
__device__ __forceinline__ void warp_apply(const Row& s, const Lane& l,
                                           long long o, int b, int K, int C,
                                           int clamp_after, bool mint,
                                           bool vec,
                                           int* __restrict__ eff_out,
                                           Walk& w) {
  const int t = threadIdx.x;
  if (b > clamp_after) w.floor = max(w.floor, 0);
  const bool is_ins = l.op == OP_INSERT;
  int ctr = 0;
  if (is_ins) {
    if (mint) {
      const int top = w.nfree > 0 ? max(w.vmax, 0) : w.vmax;
      ctr = (int)((unsigned)max(top, w.floor) + 1u);
    } else {
      ctr = l.eff;
    }
  }
  if (CAPTURE && t == 0) eff_out[o] = ctr;
  const int kc = is_ins ? ctr : l.a2;
  const int kr = is_ins ? l.writer : l.a1;
  const int2 mine = own_search(s, kc, kr, C, vec);
  const int f = __reduce_min_sync(FULL, mine.x);
  const int fr = __reduce_min_sync(FULL, mine.y);
  w.drop += f == C && fr == C;
  if (!key_in_range(l.key, K)) return;
  w.changed = true;
  w.floor_set = true;
  w.floor = max(w.floor, is_ins ? max(ctr, 0) : max(l.a2, 0));
  if (f < C) {
    if (owns(f, vec)) {
      if (is_ins) {
        s.par_rep[f] = max(s.par_rep[f], l.a1);
        s.par_ctr[f] = max(s.par_ctr[f], l.a2);
        s.chr[f] = max(s.chr[f], l.a0);
      } else {
        s.dead[f] = 1;
      }
    }
  } else if (fr < C) {
    if (owns(fr, vec)) {
      s.id_ctr[fr] = kc;
      s.id_rep[fr] = kr;
      s.par_rep[fr] = is_ins ? l.a1 : 0;
      s.par_ctr[fr] = is_ins ? l.a2 : 0;
      s.chr[fr] = is_ins ? l.a0 : 0;
      s.dead[fr] = !is_ins;
      s.valid[fr] = 1;
    }
    w.vmax = max(w.vmax, kc);
    --w.nfree;
  }
}

template <bool CAPTURE>
__device__ void bucket_groups(const State& st, const Ops& ops,
                              const Groups& gr, int* __restrict__ eff_out,
                              int* __restrict__ dropped, int R, int K, int C,
                              int B, bool vec) {
  constexpr int PER = GROUP_LANES / 32;  // a bucket's lanes a thread
  extern __shared__ int smem[];
  const Row s{smem,
              smem + C,
              smem + 2 * C,
              smem + 3 * C,
              smem + 4 * C,
              (unsigned char*)(smem + 5 * C),
              (unsigned char*)(smem + 5 * C) + C};
  __shared__ int lanes[GROUP_LANES];
  __shared__ Lane cache[GROUP_LANES];
  const int t = threadIdx.x;
  const bool mint = ops.eff == nullptr;
  for (int g = blockIdx.x; g < R * K; g += gridDim.x) {
    const int n = gr.count[g], neg = gr.first[g];
    if (n == 0 && neg == 0) continue;
    const int r = g / K, row = g - r * K;
    const long long base = (long long)g * C, row0 = (long long)r * B;
    const int clamp_after = neg ? B - neg : B;
    Walk w{st.floor[g], INT_MIN, 0, 0, false, neg != 0};
    if (n > 0 && n <= gr.cap) {
      int x[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = t + 32 * k;
        x[k] = i < n ? gr.lane[(long long)g * gr.cap + i] : INT_MAX;
        if (i < n) lanes[i] = x[k];
      }
      __syncwarp();
      // the atomics placed warps in no set order: rank by lane
      bool down = false;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = t + 32 * k;
        down |= i > 0 && i < n && lanes[i - 1] > x[k];
      }
      if (__any_sync(FULL, down)) {
        int rank[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) rank[k] = 0;
        for (int j = 0; j < n; ++j) {
          const int y = lanes[j];
#pragma unroll
          for (int k = 0; k < PER; ++k) rank[k] += y < x[k];
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (t + 32 * k < n) lanes[rank[k]] = x[k];
        __syncwarp();
      }
      // the lanes' fields and the row, loaded together
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = t + 32 * k;
        if (i < n) cache[i] = load_lane(ops, row0 + lanes[i]);
      }
      warp_stage(st, s, base, C, vec, mint, w);
      for (int i = 0; i < n; ++i) {
        const int b = lanes[i];
        warp_apply<CAPTURE>(s, cache[i], row0 + b, b, K, C, clamp_after,
                            mint, vec, eff_out, w);
      }
    } else if (n > 0) {
      // the bucket overflowed: the view's lanes 32 at a time, in order
      warp_stage(st, s, base, C, vec, mint, w);
      for (int b0 = 0; b0 < B; b0 += 32) {
        const int b = b0 + t;
        Lane mine{};
        bool hit = false;
        if (b < B) {
          mine = load_lane(ops, row0 + b);
          hit = is_live(mine.op) && gather_row(mine.key, K) == row;
        }
        for (unsigned hits = __ballot_sync(FULL, hit); hits;
             hits &= hits - 1) {
          const int j = __ffs(hits) - 1;
          warp_apply<CAPTURE>(s, shfl_lane(mine, j), row0 + b0 + j, b0 + j,
                              K, C, clamp_after, mint, vec, eff_out, w);
        }
      }
    }
    if (neg) w.floor = max(w.floor, 0);
    __syncwarp();
    if (w.changed) warp_unstage(st, s, base, C, vec);
    if (t == 0) {
      if (w.floor_set) st.floor[g] = w.floor;
      if (w.drop) atomicAdd(&dropped[r], w.drop);
    }
    __syncwarp();
  }
}

// One thread a lane of the R B: each live lane's index into its group's
// bucket; each group's lowest in-range other lane; in the capture mode
// every other lane's counter (0).
template <bool CAPTURE>
__global__ void __launch_bounds__(THREADS)
    fill_kernel(Ops ops, long long lanes, int B, int K, Groups gr,
                int* __restrict__ eff_out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool in = i < lanes;
  const int v = in ? (int)(i / B) : 0, b = (int)(i - (long long)v * B);
  const unsigned lane = threadIdx.x & 31;
  int op = 0, key = 0;
  if (in) {
    op = ops.op[i];
    key = ops.key[i];
  }
  const bool live = in && is_live(op);
  const bool clamp = in && !live && key_in_range(key, K);
  const int vg = v * K + gather_row(key, K);
  const unsigned lives = __ballot_sync(FULL, live);
  if (live) {
    // the warp's lanes of one group take one atomic, placed in lane order
    const unsigned peers = __match_any_sync(lives, vg);
    const int leader = __ffs(peers) - 1;
    int at = 0;
    if ((int)lane == leader) at = atomicAdd(&gr.count[vg], __popc(peers));
    at = __shfl_sync(peers, at, leader) +
         __popc(peers & ((1u << lane) - 1u));
    if (at < gr.cap) gr.lane[(long long)vg * gr.cap + at] = b;
  }
  const unsigned clamps = __ballot_sync(FULL, clamp);
  if (clamp) {
    const unsigned peers = __match_any_sync(clamps, vg);
    if ((int)lane == __ffs(peers) - 1) atomicMax(&gr.first[vg], B - b);
  }
  if (CAPTURE && in && !live) eff_out[i] = 0;
}

// The walk, a warp a group. Bounded to 8 blocks an SM (under that ptxas
// spilled at 80 registers).
template <bool CAPTURE>
__global__ void __launch_bounds__(32, 8)
    rga_walk_kernel(State st, Ops ops, Groups gr, int* __restrict__ eff_out,
                    int* __restrict__ dropped, int R, int K, int C, int B,
                    bool vec) {
  bucket_groups<CAPTURE>(st, ops, gr, eff_out, dropped, R, K, C, B, vec);
}

bool aligned(const void* p, size_t a) { return ((size_t)p & (a - 1)) == 0; }

long long scratch_ints(int R, int K, int B) {
  return (long long)R * K * (2 + bucket_cap(B));
}

template <bool CAPTURE>
int launch(void* const* state, void* floor, const void* const* ops,
           void* eff_out, void* dropped, void* scratch, int R, int K, int C,
           int B, void* stream) {
  if (R <= 0 || K <= 0 || B <= 0 || C <= 0) return (int)cudaSuccess;
  const long long groups = (long long)R * K;
  if (scratch == nullptr || groups >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  State st{(int*)state[0], (int*)state[1], (int*)state[2],
           (int*)state[3], (int*)state[4], (unsigned char*)state[5],
           (unsigned char*)state[6], (int*)floor};
  Ops o{(const int*)ops[0], (const int*)ops[1], (const int*)ops[2],
        (const int*)ops[3], (const int*)ops[4], (const int*)ops[5],
        (const int*)ops[6]};
  // 16-byte staging and search: 4-slot runs of every field aligned
  bool vec = C % 4 == 0;
  for (int f = 0; f < 5; ++f) vec = vec && aligned(state[f], 16);
  vec = vec && aligned(state[5], 4) && aligned(state[6], 4);
  const Groups gr{(int*)scratch, (int*)scratch + groups,
                  (int*)scratch + 2 * groups, bucket_cap(B)};
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * 2 * groups, s);
  if (err != cudaSuccess) return (int)err;
  const long long lanes = (long long)R * B;
  fill_kernel<CAPTURE><<<(unsigned)((lanes + THREADS - 1) / THREADS),
                         THREADS, 0, s>>>(o, lanes, B, K, gr,
                                          (int*)eff_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto kernel = rga_walk_kernel<CAPTURE>;
  const size_t bytes = (size_t)C * (5 * sizeof(int) + 2);  // the row
  err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long cap = 132LL * 32;
  kernel<<<(unsigned)(groups < cap ? groups : cap), 32, bytes, s>>>(
      st, o, gr, (int*)eff_out, (int*)dropped, R, K, C, B, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// int32 scratch a call at (R, K, B) needs: the buckets.
extern "C" long long rga_apply_scratch_ints(int R, int K, int B) {
  return scratch_ints(R, K, B);
}

// state: seven field pointers (id_ctr, id_rep, par_ctr, par_rep, chr
// int32; dead, valid bool) of [R, K, C] and ctr_floor int32 [R, K], updated
// in place; ops: seven pointers (op, key, a0, a1, a2, writer, eff_ctr)
// int32 [R, B], eff_ctr null when uncaptured; dropped int32 [R], added to;
// scratch: rga_apply_scratch_ints(R, K, B) int32; R K < 2^31.
// Contiguous on one device. Returns the first CUDA error of the launches.
extern "C" int rga_apply_launch(void* const* state, void* floor,
                                const void* const* ops, void* dropped,
                                void* scratch, int R, int K, int C, int B,
                                void* stream) {
  return launch<false>(state, floor, ops, nullptr, dropped, scratch, R, K, C,
                       B, stream);
}

// The capture mode: as rga_apply_launch with eff_ctr null (uncaptured),
// and eff_out int32 [R, B] receiving every lane's minted counter (0 for a
// lane that is not an insert).
extern "C" int rga_capture_launch(void* const* state, void* floor,
                                  const void* const* ops, void* eff_out,
                                  void* dropped, void* scratch, int R, int K,
                                  int C, int B, void* stream) {
  return launch<true>(state, floor, ops, eff_out, dropped, scratch, R, K, C,
                      B, stream);
}
