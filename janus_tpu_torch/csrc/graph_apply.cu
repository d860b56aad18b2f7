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
// Design, as csrc/lww_apply.cu: lane_buckets.cuh groups the live lanes
// (codes 1-4) by (view, row); one 32-thread block per (view, row) with
// lanes stages both blocks of the row in shared memory, puts its lanes in
// lane order (windows of at most 2,048 lane indices) and walks them: the
// first slot holding a key, the first free slot and every gate are warp
// reductions (each thread holds CV / 32 vertex and CE / 32 edge slots), an
// upsert is one thread's write, an uncaptured tombstone each thread's on
// its own slots. A row no live lane gathers is never read. Launches on the
// caller's stream, allocates nothing (the caller passes the groups'
// scratch), does not synchronise.
#include <cuda_runtime.h>

#include "lane_buckets.cuh"
#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 32;
constexpr int WCAP = 2048;
constexpr int OP_AV = 1, OP_RV = 2, OP_AE = 3, OP_RE = 4;
constexpr int MODE_APPLY = 0, MODE_CAPTURED = 1, MODE_CAPTURE = 2;
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

template <int MODE, bool EDGES>
__global__ void __launch_bounds__(THREADS)
graph_walk_kernel(Rows st, Ops ops, lane_buckets::Lists lists,
                  int* __restrict__ ok_out, int* __restrict__ dropped, int V,
                  int K, int CV, int CE, int B) {
  extern __shared__ int smem[];
  int* vk = smem;           // [CV]
  int* src = vk + CV;       // [CE]
  int* dst = src + CE;      // [CE]
  int* win = dst + CE;      // [WCAP]
  unsigned char* vrem = (unsigned char*)(win + WCAP);
  unsigned char* vval = vrem + CV;
  unsigned char* erem = vval + CV;
  unsigned char* evalid = erem + CE;
  __shared__ int s_count;
  const int tid = threadIdx.x;

  for (long long blk = blockIdx.x; blk < (long long)V * K; blk += gridDim.x) {
    const int v = (int)(blk / K), g = (int)(blk % K);
    const int* start = lists.start + (long long)v * (K + 1);
    const int lo = start[g], n = start[g + 1] - lo;
    if (n == 0) continue;  // uniform across the block
    const long long vbase = blk * CV, ebase = blk * CE;
    for (int c = tid; c < CV; c += THREADS) {
      vk[c] = st.v[vbase + c];
      vrem[c] = st.v_removed[vbase + c];
      vval[c] = st.v_valid[vbase + c];
    }
    for (int c = tid; c < CE; c += THREADS) {
      src[c] = st.src[ebase + c];
      dst[c] = st.dst[ebase + c];
      erem[c] = st.e_removed[ebase + c];
      evalid[c] = st.e_valid[ebase + c];
    }
    __syncthreads();
    bool touched = false;
    int drop = 0;
    auto walk = [&](const int* lanes, int m) {
      if (m == 0) return;
      // the next lane's fields are loaded while this one is walked
      long long o_n = (long long)v * B + lanes[0];
      int op_n = ops.op[o_n], key_n = ops.key[o_n];
      int x_n = ops.a0[o_n], y_n = EDGES ? ops.a1[o_n] : 0;
      int ok_n = MODE == MODE_CAPTURED ? ops.ok[o_n] : 0;
      for (int j = 0; j < m; ++j) {
        const long long o = o_n;
        const int op = op_n, key = key_n, x = x_n, y = y_n, ok = ok_n;
        if (j + 1 < m) {
          o_n = (long long)v * B + lanes[j + 1];
          op_n = ops.op[o_n];
          key_n = ops.key[o_n];
          x_n = ops.a0[o_n];
          if (EDGES) y_n = ops.a1[o_n];
          if (MODE == MODE_CAPTURED) ok_n = ops.ok[o_n];
        }
        const int nk = key < 0 ? key + K : key;
        const bool in_range = nk >= 0 && nk < K;
        const bool on_v = op == OP_AV || op == OP_RV;
        // the vertex block: x's first slot, the first free slot, whether x
        // and y are live; a thread's slots ascend, so its first is its least
        int vfirst = CV, vfree = CV;
        bool live_x = false, live_y = false;
        for (int c = tid; c < CV; c += THREADS) {
          if (vval[c]) {
            const bool up = !vrem[c];
            if (vk[c] == x) {
              if (vfirst == CV) vfirst = c;
              live_x |= up;
            }
            if (EDGES) live_y |= up && vk[c] == y;
          } else if (vfree == CV) {
            vfree = c;
          }
        }
        // the edge block: (x, y)'s first slot, the first free slot, the
        // edge's liveness, and a live edge incident to x
        int efirst = CE, efree = CE;
        bool live_e = false, incident = false;
        for (int c = tid; EDGES && c < CE; c += THREADS) {
          if (evalid[c]) {
            const bool up = !erem[c];
            if (src[c] == x && dst[c] == y) {
              if (efirst == CE) efirst = c;
              live_e |= up;
            }
            incident |= up && (src[c] == x || dst[c] == x);
          } else if (efree == CE) {
            efree = c;
          }
        }
        vfirst = __reduce_min_sync(FULL, vfirst);
        vfree = __reduce_min_sync(FULL, vfree);
        live_x = __any_sync(FULL, live_x);
        if (EDGES) {
          efirst = __reduce_min_sync(FULL, efirst);
          efree = __reduce_min_sync(FULL, efree);
          live_y = __any_sync(FULL, live_y);
          live_e = __any_sync(FULL, live_e);
          incident = __any_sync(FULL, incident);
        }
        // without edges only codes 1 and 2 reach here: the edge branches
        // below are compiled out
        bool gate = op == OP_RV   ? live_x && !incident
                    : !EDGES      ? true
                    : op == OP_AE ? live_x && live_y
                    : op == OP_RE ? live_e
                                  : true;
        // av's gate is true, and its ok the caller's 1
        if (MODE == MODE_CAPTURE && tid == 0 && op != OP_AV) ok_out[o] = gate;
        if (MODE == MODE_CAPTURED) gate = ok != 0;
        const bool tomb = op == OP_RV || op == OP_RE;
        // av is ungated; each other code applies where its gate holds
        if (op == OP_AV || gate) {
          if (MODE == MODE_APPLY && tomb) {
            if (in_range && op == OP_RV) {
              for (int c = tid; c < CV; c += THREADS)
                if (vval[c] && vk[c] == x) vrem[c] = 1;
            } else if (EDGES && in_range) {
              for (int c = tid; c < CE; c += THREADS)
                if (evalid[c] && src[c] == x && dst[c] == y) erem[c] = 1;
            }
          } else if (on_v) {
            drop += vfirst == CV && vfree == CV;
            if (in_range && tid == 0) {
              if (vfirst < CV) {
                if (tomb) vrem[vfirst] = 1;
              } else if (vfree < CV) {
                vk[vfree] = x;
                vrem[vfree] = tomb;
                vval[vfree] = 1;
              }
            }
          } else if (EDGES) {
            drop += efirst == CE && efree == CE;
            if (in_range && tid == 0) {
              if (efirst < CE) {
                if (tomb) erem[efirst] = 1;
              } else if (efree < CE) {
                src[efree] = x;
                dst[efree] = y;
                erem[efree] = tomb;
                evalid[efree] = 1;
              }
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
      for (int c = tid; c < CV; c += THREADS) {
        st.v[vbase + c] = vk[c];
        st.v_removed[vbase + c] = vrem[c];
        st.v_valid[vbase + c] = vval[c];
      }
      for (int c = tid; c < CE; c += THREADS) {
        st.src[ebase + c] = src[c];
        st.dst[ebase + c] = dst[c];
        st.e_removed[ebase + c] = erem[c];
        st.e_valid[ebase + c] = evalid[c];
      }
    }
    if (tid == 0 && drop) atomicAdd(&dropped[v], drop);
    __syncthreads();
  }
}

template <int MODE, bool EDGES>
int launch(const Rows& st, const Ops& o, void* ok_out, void* dropped,
           void* const* scratch, int V, int K, int CV, int CE, int B,
           void* stream) {
  if (V <= 0 || K <= 0 || B <= 0 || CV + CE <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const lane_buckets::Lists lists{(int*)scratch[0], (int*)scratch[1],
                                  (int*)scratch[2]};
  const unsigned live =
      (1u << OP_AV) | (1u << OP_RV) |
      (EDGES ? (1u << OP_AE) | (1u << OP_RE) : 0u);
  cudaError_t err =
      lane_buckets::build(o.op, o.key, live, V, K, B, lists, s);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (size_t)CV * (sizeof(int) + 2) +
                       (size_t)CE * (2 * sizeof(int) + 2) +
                       sizeof(int) * WCAP;
  err = allow_shared(graph_walk_kernel<MODE, EDGES>, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)V * K;
  const long long grid = blocks < 132LL * 64 ? blocks : 132LL * 64;
  graph_walk_kernel<MODE, EDGES><<<(unsigned)grid, THREADS, bytes, s>>>(
      st, o, lists, (int*)ok_out, (int*)dropped, V, K, CV, CE, B);
  return (int)cudaGetLastError();
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
// scratch: three int32 buffers, [V, K] zeroed, [V, K + 1] and [V, B].
// Contiguous on one device. Returns the first CUDA error of the launches.
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
// of [V, K, C]; ops four pointers (op, key, a0 int32 [V, B]; ok int32
// [V, B], null when uncaptured); otherwise as graph_apply_launch.
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
