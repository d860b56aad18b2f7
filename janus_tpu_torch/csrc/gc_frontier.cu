// gc_frontier: SafeKV's GC frontier, the recycle of the slots it frees and
// the pack of the round's host outputs, in one block; and the clear of
// the freed ring rows.
//
// Replaces: janus_tpu/runtime/safecrdt.py the GC of SafeKV._tick_device
// and the pack of _step_device, janus_tpu/consensus/dag.py recycle and
// janus_tpu/consensus/tusk.py recycle_commit. With com the committed
// masks and lw the views' last committed waves:
//   lw_q      the quorum-th smallest lw; mask_q = lw >= lw_q (the quorum)
//   com_ref   per slot, the OR of com over the quorum's views
//   view_done com, stable_applied equal com_ref, and prosp_applied equal
//             the certificates but for the origin's own uncertified block
//   q_done    view_done in every quorum view
//   frozen    slot_round + 2 <= the quorum-th smallest node round
//   direct    an even round whose wave no quorum view has evaluated
//   can_gain  scanned from the highest live round down: not frozen, or
//             uncommitted certificates reachable by an anchor at the slot
//             or by descent from a round above that can gain
//   adv       the run of collectible slots from base_round up; new_base =
//             base + adv; dead = slot_round < new_base; lost = a view not
//             done with a dead slot (forced to transfer next round)
// The pack is JAX's int32 vector: pre_round, accepted, own-block commits
// (pre-GC), dead, the round's slots dropped, and with collect_logs the
// transfer mask, the donor, the fresh commits and commit_seq (pre-GC) and
// slot_round (post-GC).
//
// What bounds it on the H100: neither bytes nor operations. It reads and
// writes a few bool[N, W, N] masks (at most 64 KB each) and runs a W-step
// scan; the floor is one launch. The port's plain version was ~150 small
// launches.
//
// Design: one block. The [N, W, N] masks become 64-bit masks over the
// source node in shared memory (N <= 64), the order statistics and the
// scan run on one thread (N and W are small), the per-slot and per-view
// reductions on one thread each. The pack reads the commit state before
// the recycle writes it. slot_round of the DAG and of the commit state
// may be one tensor: both are read before either is written, and the
// writes agree. The second kernel zeroes the dead slots' rows of every
// ring field, reading dead on the device; its blocks return at once when
// no slot died. Launches on the caller's stream, allocates nothing, does
// not synchronise.
#include <climits>

#include <cuda_runtime.h>

#include "dag_masks.cuh"

namespace {

using namespace dag_masks;

constexpr int MAX_W = 32;
constexpr int MAX_FIELDS = 16;

struct Gc {
  // DAG state, recycled in place
  unsigned char *edges, *block_exists, *block_seen, *acks, *cert_exists,
      *cert_seen;
  const int* node_round;
  int *dag_slot_round, *base_round;
  // commit state, recycled in place
  unsigned char* committed;
  int* commit_seq;
  const int *last_wave, *eval_wave;
  int* com_slot_round;
  const unsigned char* com_before;
  // round state, cleared in place
  unsigned char *prosp_applied, *stable_applied, *buffer_filled;
  // the round's other outputs
  const int* pre_round;
  const unsigned char *accepted, *transferred;
  const int* donor;
  const int *drop_p, *drop_s;
  int n_drop_p, n_drop_s;
  // outputs
  unsigned char *lost, *dead;
  int* packed;
};

// x // 2 rounded toward minus infinity, as in JAX and torch (an
// arithmetic shift)
__device__ __forceinline__ int floor_div2(int x) { return x >> 1; }

// the k-th smallest of a[0..n) (one thread)
__device__ int kth_smallest(const int* a, int n, int k) {
  for (int v = 0; v < n; ++v) {
    int less = 0, equal = 0;
    for (int u = 0; u < n; ++u) {
      less += a[u] < a[v];
      equal += a[u] == a[v];
    }
    if (less <= k && k < less + equal) return a[v];
  }
  return a[0];
}

__global__ void gc_kernel(Gc g, int n, int w, int quorum, int collect_logs) {
  extern __shared__ u64 smem[];
  const int nw = n * w;
  u64* com = smem;          // [N*W] committed, per (view, slot)
  u64* before = com + nw;   // [N*W] committed before this round's commit
  u64* stapp = before + nw; // [N*W] stable_applied
  u64* prapp = stapp + nw;  // [N*W] prosp_applied
  __shared__ u64 cert[MAX_W], com_ref[MAX_W];
  __shared__ unsigned view_done[64];
  __shared__ int lw[64], ew[64], nr[64], sr[MAX_W], csr[MAX_W];
  __shared__ int new_base_s, base_s;
  __shared__ unsigned dead_s, cdead_s;

  const int tid = threadIdx.x;
  load_masks(g.committed, nw, n, com);
  load_masks(g.com_before, nw, n, before);
  load_masks(g.stable_applied, nw, n, stapp);
  load_masks(g.prosp_applied, nw, n, prapp);
  load_masks(g.cert_exists, w, n, cert);
  for (int v = tid; v < n; v += blockDim.x) {
    lw[v] = g.last_wave[v];
    ew[v] = g.eval_wave[v];
    nr[v] = g.node_round[v];
  }
  for (int s = tid; s < w; s += blockDim.x) {
    sr[s] = g.dag_slot_round[s];
    csr[s] = g.com_slot_round[s];
  }
  if (tid == 0) base_s = *g.base_round;
  __syncthreads();

  // the GC quorum, and its reference commit set per slot
  __shared__ int lw_q;
  __shared__ u64 mask_q;
  if (tid == 0) {
    lw_q = kth_smallest(lw, n, n - quorum);
    u64 m = 0;
    for (int v = 0; v < n; ++v)
      if (lw[v] >= lw_q) m |= 1ull << v;
    mask_q = m;
  }
  __syncthreads();
  for (int s = tid; s < w; s += blockDim.x) {
    u64 ref = 0;
    for (int v = 0; v < n; ++v)
      if (bit(mask_q, v)) ref |= com[v * w + s];
    com_ref[s] = ref;
  }
  __syncthreads();
  for (int v = tid; v < n; v += blockDim.x) {
    unsigned done = 0;
    for (int s = 0; s < w; ++s) {
      const int i = v * w + s;
      const u64 mism = prapp[i] ^ cert[s];
      const u64 allowed = (1ull << v) & prapp[i] & ~cert[s];
      if (com[i] == com_ref[s] && stapp[i] == com_ref[s] &&
          (mism & ~allowed) == 0)
        done |= 1u << s;
    }
    view_done[v] = done;
  }
  __syncthreads();

  // the frontier: one thread, W slots, N views
  if (tid == 0) {
    const int nr_q = kth_smallest(nr, n, n - quorum);
    int ew_min_q = INT_MAX;
    for (int v = 0; v < n; ++v)
      if (bit(mask_q, v) && ew[v] < ew_min_q) ew_min_q = ew[v];
    unsigned collectible = 0;
    bool can_above = true;
    for (int i = 0; i < w; ++i) {
      const int s = floor_mod(wrap_add(base_s, w - 1 - i), w);
      bool q_done = true;
      for (int v = 0; v < n; ++v)
        if (bit(mask_q, v) && !((view_done[v] >> s) & 1u)) q_done = false;
      const bool frozen = wrap_add(sr[s], 2) <= nr_q;
      const bool any_unc = (cert[s] & ~com_ref[s]) != 0;
      const bool direct = floor_mod(sr[s], 2) == 0 && floor_div2(sr[s]) > ew_min_q;
      const bool can = !frozen || ((direct || can_above) && any_unc);
      can_above = can;
      if (q_done && !can) collectible |= 1u << s;
    }
    int adv = 0;
    while (adv < w &&
           ((collectible >> floor_mod(wrap_add(base_s, adv), w)) & 1u))
      ++adv;
    const int nb = wrap_add(base_s, adv);
    unsigned dead = 0, cdead = 0;
    for (int s = 0; s < w; ++s) {
      if (sr[s] < nb) dead |= 1u << s;
      if (csr[s] < nb) cdead |= 1u << s;
    }
    new_base_s = nb;
    dead_s = dead;
    cdead_s = cdead;
  }
  __syncthreads();
  const unsigned dead = dead_s, cdead = cdead_s;

  // outputs of the pre-GC state
  for (int v = tid; v < n; v += blockDim.x) g.lost[v] = (dead & ~view_done[v]) != 0;
  for (int s = tid; s < w; s += blockDim.x) g.dead[s] = (dead >> s) & 1u;
  int* out = g.packed;
  for (int v = tid; v < n; v += blockDim.x) {
    out[v] = g.pre_round[v];
    out[n + v] = g.accepted[v];
  }
  int* own = out + 2 * n;  // [N, W]
  for (int i = tid; i < nw; i += blockDim.x)
    own[i] = (int)bit(com[i] & ~before[i], i / w);
  int* rec = own + nw;
  for (int s = tid; s < w; s += blockDim.x) rec[s] = (dead >> s) & 1u;
  if (tid == 0) {
    unsigned total = 0;
    for (int i = 0; i < g.n_drop_p; ++i) total += (unsigned)g.drop_p[i];
    for (int i = 0; i < g.n_drop_s; ++i) total += (unsigned)g.drop_s[i];
    rec[w] = (int)total;
  }
  int* logs = rec + w + 1;
  const int nwn = nw * n;
  if (collect_logs) {
    for (int v = tid; v < n; v += blockDim.x) logs[v] = g.transferred[v];
    if (tid == 0) logs[n] = *g.donor;
    int* fresh = logs + n + 1;  // [N, W, N]
    int* seq = fresh + nwn;     // [N, W, N]
    for (int i = tid; i < nwn; i += blockDim.x) {
      fresh[i] = (int)bit(com[i / n] & ~before[i / n], i % n);
      seq[i] = g.commit_seq[i];
    }
  }
  __syncthreads();

  // recycle in place: dag.recycle, tusk.recycle_commit, the round masks
  if (dead | cdead) {
    for (int i = tid; i < w * n * n; i += blockDim.x) {
      if ((dead >> (i / (n * n))) & 1u) {
        g.edges[i] = 0;
        g.acks[i] = 0;
      }
    }
    for (int i = tid; i < nw; i += blockDim.x) {
      if ((dead >> (i / n)) & 1u) {
        g.block_exists[i] = 0;
        g.cert_exists[i] = 0;
        g.buffer_filled[i] = 0;
      }
    }
    for (int i = tid; i < nwn; i += blockDim.x) {
      const int s = (i / n) % w;
      if ((dead >> s) & 1u) {
        g.block_seen[i] = 0;
        g.cert_seen[i] = 0;
        g.prosp_applied[i] = 0;
        g.stable_applied[i] = 0;
      }
      if ((cdead >> s) & 1u) {
        g.committed[i] = 0;
        g.commit_seq[i] = -1;
      }
    }
  }
  for (int s = tid; s < w; s += blockDim.x) {
    g.dag_slot_round[s] = (dead >> s) & 1u ? wrap_add(sr[s], w) : sr[s];
    g.com_slot_round[s] = (cdead >> s) & 1u ? wrap_add(csr[s], w) : csr[s];
  }
  if (tid == 0) *g.base_round = new_base_s;
  if (collect_logs) {
    int* post = logs + n + 1 + 2 * nwn;
    for (int s = tid; s < w; s += blockDim.x)
      post[s] = (dead >> s) & 1u ? wrap_add(sr[s], w) : sr[s];
  }
}

struct Ring {
  int* ptr[MAX_FIELDS];
  long long row[MAX_FIELDS];  // int32 elements per slot (N * B * width)
};

__global__ void clear_ring_kernel(Ring t, const unsigned char* __restrict__ dead,
                                  int w) {
  unsigned mask = 0;
  for (int s = 0; s < w; ++s)
    if (dead[s]) mask |= 1u << s;
  if (mask == 0) return;
  const int f = blockIdx.y;
  const long long row = t.row[f];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int s = 0; s < w; ++s) {
    if (!((mask >> s) & 1u)) continue;
    int* p = t.ptr[f] + (long long)s * row;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < row; i += stride)
      p[i] = 0;
  }
}

}  // namespace

// p: the Gc pointers in struct order (27 of them, see janus_tpu_torch/
// kernels/gc_frontier.py); n_drop_p / n_drop_s: lengths of the two
// dropped-count vectors (0 when absent). N <= 64, W <= 32. Returns the
// launch's CUDA error.
extern "C" int gc_frontier_launch(void* const* p, int n_drop_p, int n_drop_s,
                                  int n, int w, int quorum, int collect_logs,
                                  void* stream) {
  if (n <= 0 || w <= 0) return (int)cudaSuccess;
  if (n > 64 || w > MAX_W) return (int)cudaErrorInvalidValue;
  Gc g;
  int i = 0;
  g.edges = (unsigned char*)p[i++];
  g.block_exists = (unsigned char*)p[i++];
  g.block_seen = (unsigned char*)p[i++];
  g.acks = (unsigned char*)p[i++];
  g.cert_exists = (unsigned char*)p[i++];
  g.cert_seen = (unsigned char*)p[i++];
  g.node_round = (const int*)p[i++];
  g.dag_slot_round = (int*)p[i++];
  g.base_round = (int*)p[i++];
  g.committed = (unsigned char*)p[i++];
  g.commit_seq = (int*)p[i++];
  g.last_wave = (const int*)p[i++];
  g.eval_wave = (const int*)p[i++];
  g.com_slot_round = (int*)p[i++];
  g.com_before = (const unsigned char*)p[i++];
  g.prosp_applied = (unsigned char*)p[i++];
  g.stable_applied = (unsigned char*)p[i++];
  g.buffer_filled = (unsigned char*)p[i++];
  g.pre_round = (const int*)p[i++];
  g.accepted = (const unsigned char*)p[i++];
  g.transferred = (const unsigned char*)p[i++];
  g.donor = (const int*)p[i++];
  g.drop_p = (const int*)p[i++];
  g.drop_s = (const int*)p[i++];
  g.lost = (unsigned char*)p[i++];
  g.dead = (unsigned char*)p[i++];
  g.packed = (int*)p[i++];
  g.n_drop_p = n_drop_p;
  g.n_drop_s = n_drop_s;
  const size_t bytes = sizeof(u64) * 4 * (size_t)n * w;
  cudaError_t err = allow_shared(gc_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  gc_kernel<<<1, 512, bytes, (cudaStream_t)stream>>>(g, n, w, quorum,
                                                     collect_logs);
  return (int)cudaGetLastError();
}

// ring: `nfields` (<= 16) int32 fields [W, row[f]], zeroed in place at
// the slots where dead bool[W] is set. Returns the launch's CUDA error.
extern "C" int gc_clear_ring_launch(void* const* ring, const long long* row,
                                    int nfields, const void* dead, int w,
                                    void* stream) {
  if (nfields <= 0 || w <= 0) return (int)cudaSuccess;
  if (nfields > MAX_FIELDS || w > MAX_W) return (int)cudaErrorInvalidValue;
  Ring t = {};
  long long longest = 1;
  for (int f = 0; f < nfields; ++f) {
    t.ptr[f] = (int*)ring[f];
    t.row[f] = row[f];
    longest = row[f] > longest ? row[f] : longest;
  }
  long long bx = (longest + 1023) / 1024;
  if (bx > 64) bx = 64;
  const dim3 grid((unsigned)bx, (unsigned)nfields);
  clear_ring_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      t, (const unsigned char*)dead, w);
  return (int)cudaGetLastError();
}
