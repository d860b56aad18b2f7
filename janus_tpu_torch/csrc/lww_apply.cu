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
// other lane's ok is 1, set by the caller). The upsert folds into the
// first valid slot holding elem (each stamp pair takes the lexicographic
// max with the op's, the slot's on a tie), else fills the first invalid
// slot; an enabled upsert of an absent elem into a full row counts one
// drop (whether or not the key is in range) and changes nothing.
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
// Design: a lane touches only the row it gathers, so rows are independent.
// lane_buckets.cuh groups the live lanes (add or remove) by (view, row);
// then one 32-thread block per (view, row) with lanes stages the row in
// shared memory, puts its lanes in lane order (windows of at most 2,048
// lane indices, bitonic-sorted in shared memory) and walks them: the
// search for the first slot holding elem, the first free slot and the
// containment are warp reductions (each thread holds C / 32 slots), the
// update is one thread's; the next lane's op fields load while a lane is
// walked. No block reads a lane of another row, and a row no live lane
// gathers is never read. Launches on the caller's stream,
// allocates nothing (the caller passes the groups' scratch), does not
// synchronise.
#include <cuda_runtime.h>

#include "lane_buckets.cuh"
#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 32;
constexpr int WCAP = 2048;
constexpr int OP_ADD = 1, OP_REMOVE = 2;
constexpr int MODE_APPLY = 0, MODE_CAPTURED = 1, MODE_CAPTURE = 2;
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

template <int MODE>
__global__ void __launch_bounds__(THREADS)
lww_walk_kernel(Rows st, Ops ops, lane_buckets::Lists lists,
                int* __restrict__ ok_out, int* __restrict__ dropped, int V,
                int K, int C, int B) {
  extern __shared__ int smem[];
  int* elem = smem;
  int* ah = elem + C;
  int* al = ah + C;
  int* rh = al + C;
  int* rl = rh + C;
  int* win = rl + C;  // [WCAP]
  unsigned char* valid = (unsigned char*)(win + WCAP);
  __shared__ int s_count;
  const int tid = threadIdx.x;

  for (long long blk = blockIdx.x; blk < (long long)V * K; blk += gridDim.x) {
    const int v = (int)(blk / K), g = (int)(blk % K);
    const int* start = lists.start + (long long)v * (K + 1);
    const int lo = start[g], n = start[g + 1] - lo;
    if (n == 0) continue;  // uniform across the block
    const long long base = blk * C;
    for (int c = tid; c < C; c += THREADS) {
      elem[c] = st.elem[base + c];
      ah[c] = st.add_hi[base + c];
      al[c] = st.add_lo[base + c];
      rh[c] = st.rm_hi[base + c];
      rl[c] = st.rm_lo[base + c];
      valid[c] = st.valid[base + c];
    }
    __syncthreads();
    bool touched = false;
    int drop = 0;
    auto walk = [&](const int* lanes, int m) {
      if (m == 0) return;
      // the next lane's fields are loaded while this one is walked
      long long o_n = (long long)v * B + lanes[0];
      int op_n = ops.op[o_n], key_n = ops.key[o_n], e_n = ops.a0[o_n];
      int hi_n = ops.a1[o_n], lw_n = ops.a2[o_n];
      int ok_n = MODE == MODE_CAPTURED ? ops.ok[o_n] : 0;
      for (int j = 0; j < m; ++j) {
        const long long o = o_n;
        const int op = op_n, key = key_n, e = e_n, hi = hi_n, lw = lw_n;
        const int ok = ok_n;
        if (j + 1 < m) {
          o_n = (long long)v * B + lanes[j + 1];
          op_n = ops.op[o_n];
          key_n = ops.key[o_n];
          e_n = ops.a0[o_n];
          hi_n = ops.a1[o_n];
          lw_n = ops.a2[o_n];
          if (MODE == MODE_CAPTURED) ok_n = ops.ok[o_n];
        }
        const int nk = key < 0 ? key + K : key;
        const bool in_range = nk >= 0 && nk < K;
        const bool is_add = op == OP_ADD;
        // a thread's slots ascend, so its first hit is its least
        int first = C, free_slot = C;
        bool live = false;
        for (int c = tid; c < C; c += THREADS) {
          if (valid[c]) {
            if (elem[c] == e) {
              if (first == C) first = c;
              live |= (ah[c] != 0 || al[c] != 0) &&
                      ts_after(ah[c], al[c], rh[c], rl[c]);
            }
          } else if (free_slot == C) {
            free_slot = c;
          }
        }
        first = __reduce_min_sync(FULL, first);
        free_slot = __reduce_min_sync(FULL, free_slot);
        const bool contained = __any_sync(FULL, live);
        bool en = is_add;
        if (op == OP_REMOVE) {
          en = MODE == MODE_CAPTURED ? ok != 0 : contained;
          if (MODE == MODE_CAPTURE && tid == 0) ok_out[o] = contained;
        }
        if (en) {
          drop += first == C && free_slot == C;
          if (in_range && tid == 0) {
            const int add_h = is_add ? hi : 0, add_l = is_add ? lw : 0;
            const int rm_h = is_add ? 0 : hi, rm_l = is_add ? 0 : lw;
            if (first < C) {
              if (!ts_after(ah[first], al[first], add_h, add_l)) {
                ah[first] = add_h;
                al[first] = add_l;
              }
              if (!ts_after(rh[first], rl[first], rm_h, rm_l)) {
                rh[first] = rm_h;
                rl[first] = rm_l;
              }
            } else if (free_slot < C) {
              elem[free_slot] = e;
              ah[free_slot] = add_h;
              al[free_slot] = add_l;
              rh[free_slot] = rm_h;
              rl[free_slot] = rm_l;
              valid[free_slot] = 1;
            }
          }
        }
        touched |= in_range;
        __syncwarp();
      }
    };
    lane_buckets::sorted_windows(lists.lanes + (long long)v * B + lo, n, B,
                                 win, WCAP, &s_count, walk);
    if (touched) {
      for (int c = tid; c < C; c += THREADS) {
        st.elem[base + c] = elem[c];
        st.add_hi[base + c] = ah[c];
        st.add_lo[base + c] = al[c];
        st.rm_hi[base + c] = rh[c];
        st.rm_lo[base + c] = rl[c];
        st.valid[base + c] = valid[c];
      }
    }
    if (tid == 0 && drop) atomicAdd(&dropped[v], drop);
    __syncthreads();
  }
}

template <int MODE>
int launch(void* const* state, const void* const* ops, void* ok_out,
           void* dropped, void* const* scratch, int V, int K, int C, int B,
           void* stream) {
  if (V <= 0 || K <= 0 || B <= 0 || C <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const lane_buckets::Lists lists{(int*)scratch[0], (int*)scratch[1],
                                  (int*)scratch[2]};
  const unsigned live = (1u << OP_ADD) | (1u << OP_REMOVE);
  cudaError_t err = lane_buckets::build((const int*)ops[0],
                                        (const int*)ops[1], live, V, K, B,
                                        lists, s);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (size_t)C * (5 * sizeof(int) + 1) + sizeof(int) * WCAP;
  err = allow_shared(lww_walk_kernel<MODE>, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)V * K;
  const long long grid = blocks < 132LL * 64 ? blocks : 132LL * 64;
  const Rows st{(int*)state[0], (int*)state[1], (int*)state[2],
                (int*)state[3], (int*)state[4], (unsigned char*)state[5]};
  const Ops o{(const int*)ops[0], (const int*)ops[1], (const int*)ops[2],
              (const int*)ops[3], (const int*)ops[4], (const int*)ops[5]};
  lww_walk_kernel<MODE><<<(unsigned)grid, THREADS, bytes, s>>>(
      st, o, lists, (int*)ok_out, (int*)dropped, V, K, C, B);
  return (int)cudaGetLastError();
}

}  // namespace

// state: six field pointers (elem, add_hi, add_lo, rm_hi, rm_lo int32;
// valid bool) of [V, K, C], updated in place; ops: six pointers (op, key,
// a0, a1, a2 int32 [V, B]; ok int32 [V, B], null when uncaptured);
// dropped int32 [V], added to; scratch: three int32 buffers, [V, K] zeroed,
// [V, K + 1] and [V, B]. Contiguous on one device. Returns the first CUDA
// error of the launches.
extern "C" int lww_apply_launch(void* const* state, const void* const* ops,
                                void* dropped, void* const* scratch, int V,
                                int K, int C, int B, void* stream) {
  if (ops[5] != nullptr)
    return launch<MODE_CAPTURED>(state, ops, nullptr, dropped, scratch, V, K,
                                 C, B, stream);
  return launch<MODE_APPLY>(state, ops, nullptr, dropped, scratch, V, K, C,
                            B, stream);
}

// The capture mode: as lww_apply_launch uncaptured (ops[5] ignored), and
// ok_out int32 [V, B], which the caller fills with 1, receiving each
// remove lane's containment against the row the earlier lanes left.
extern "C" int lww_capture_launch(void* const* state, const void* const* ops,
                                  void* ok_out, void* dropped,
                                  void* const* scratch, int V, int K, int C,
                                  int B, void* stream) {
  return launch<MODE_CAPTURE>(state, ops, ok_out, dropped, scratch, V, K, C,
                              B, stream);
}
