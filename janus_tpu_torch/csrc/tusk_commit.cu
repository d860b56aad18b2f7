// tusk_commit: the Tusk commit rule for every node's view in one launch.
//
// Replaces: janus_tpu/consensus/tusk.py commit_view (vmap over views of
// _commit_one_view: a scan over `steps` waves, each with the completeness
// and _support tests, the back-chain discovery over lb = max(1, W/2)
// earlier waves, the oldest-first chained commits and the anchor commit,
// every reachability a W-1-step _closure). XLA lowers it to nested loops
// of small fused ops; the port's plain version is ~1,000 launches a call.
//
// What bounds it on the H100: neither bytes nor operations. At N nodes and
// a W-round window the inputs are a few N*W*N-byte bool tensors (~2 KB at
// 4 nodes), and the work is a chain of dependent steps, each one 64-bit
// OR per frontier node. The floor is one launch.
//
// Design: one block per view; the view's DAG rows become 64-bit masks in
// shared memory (edges[s][src] over referenced nodes t; certs, seen and
// committed per slot over sources), loaded by all warps with ballots.
// Warp 0 then runs the view's whole commit rule with uniform control flow:
// a closure step ORs the edge masks of the frontier's nodes, two nodes a
// lane, reduced over the warp; a support test is a ballot and a popcount.
// A closure whose result the rule masks away (no anchor, candidate not
// eligible) is skipped. Discovery closures read the
// committed state before the wave, commit closures the running one,
// exactly as the scan does. commit_seq is copied to the output first and
// updated in place at each commit. Leaders come from the murmur3 mix on
// uint32 with the seed constant reduced on the host. base_round is read
// through its device pointer. Launches on the caller's stream, allocates
// nothing, does not synchronise.
#include <cuda_runtime.h>

#include "dag_masks.cuh"

namespace {

using namespace dag_masks;

__device__ __forceinline__ int leader_of(int wave, unsigned seed_c, int n) {
  unsigned x = (unsigned)wave * 2654435761u + seed_c;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (int)(x % (unsigned)n);
}

struct View {
  const u64* edges;  // [W*N] shared by every view
  const u64* certs;  // [W] certificates held
  const u64* seen;   // [W] blocks seen
  u64* com;          // [W] committed
  u64* reach;        // [W] scratch: the last closure
  int w, n, base;
};

// reach := uncommitted held certificates reachable from (anchor_r, src)
// by prev-certificate edges, descending through held uncommitted certs
// (tusk._closure). Called by all 32 lanes of one warp. Each step reads its
// frontier back from reach[] rather than carrying the last step's growth:
// when the int32 round wraps and W does not divide 2^32, a later step can
// land on a slot an earlier step filled, and the scan reads it there too.
__device__ void closure(const View& v, int anchor_r, int src) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int s = lane; s < v.w; s += 32) v.reach[s] = 0;
  __syncwarp();
  const int s0 = floor_mod(anchor_r, v.w);
  if (lane == 0) v.reach[s0] = (1ull << src) & v.certs[s0] & ~v.com[s0];
  __syncwarp();
  for (int j = 0; j < v.w - 1; ++j) {
    const int r = wrap_add(anchor_r, -j);
    const int s = floor_mod(r, v.w);
    const int rp = wrap_add(r, -1);
    const int sp = floor_mod(rp, v.w);
    const u64 frontier = v.reach[s];
    u64 part = 0;
    if (lane < v.n && bit(frontier, lane)) part |= v.edges[s * v.n + lane];
    if (lane + 32 < v.n && bit(frontier, lane + 32))
      part |= v.edges[s * v.n + lane + 32];
    const u64 prev = warp_or(part);  // every lane has read reach[s] here
    if (lane == 0 && r >= 1 && rp >= v.base)
      v.reach[sp] |= prev & v.certs[sp] & ~v.com[sp];
    __syncwarp();
  }
}

// >= quorum seen round-(2wv+1) blocks reference the leader's cert
// (tusk._support).
__device__ bool support(const View& v, int sup_r, int leader, int quorum) {
  const int lane = threadIdx.x & 31;
  const int s = floor_mod(sup_r, v.w);
  const u64* row = v.edges + s * v.n;
  const unsigned lo =
      __ballot_sync(0xffffffffu, lane < v.n && bit(row[lane], leader));
  const unsigned hi = __ballot_sync(
      0xffffffffu, lane + 32 < v.n && bit(row[lane + 32], leader));
  const u64 votes = v.seen[s] & ((u64)lo | ((u64)hi << 32));
  return __popcll(votes) >= quorum;
}

// Commit the closure of (anchor_r, src) with sequence number seq_val.
__device__ void commit(const View& v, int anchor_r, int src, int seq_val,
                       int* __restrict__ seq) {
  closure(v, anchor_r, src);
  for (int s = threadIdx.x & 31; s < v.w; s += 32) {
    u64 m = v.reach[s];
    v.com[s] |= m;
    while (m) {
      seq[s * v.n + __ffsll((long long)m) - 1] = seq_val;
      m &= m - 1;
    }
  }
  __syncwarp();
}

__global__ void tusk_commit_kernel(
    const unsigned char* __restrict__ edges_in,
    const unsigned char* __restrict__ block_seen,
    const unsigned char* __restrict__ cert_seen,
    const int* __restrict__ node_round, const int* __restrict__ base_round,
    const unsigned char* __restrict__ com_in, const int* __restrict__ seq_in,
    const int* __restrict__ lw_in, const int* __restrict__ ew_in,
    const int* __restrict__ cnt_in, unsigned char* __restrict__ com_out,
    int* __restrict__ seq_out, int* __restrict__ lw_out,
    int* __restrict__ ew_out, int* __restrict__ cnt_out, int n, int w,
    int quorum, unsigned seed_c, int steps) {
  extern __shared__ u64 smem[];
  const int lb = w / 2 > 1 ? w / 2 : 1;  // back-chain window in waves
  View v;
  u64* edges = smem;
  u64* certs = edges + w * n;
  u64* seen = certs + w;
  v.com = seen + w;
  v.reach = v.com + w;
  int* chained = (int*)(v.reach + w);  // [lb] per discovery step
  int* ch_leader = chained + lb;
  int* ch_round = ch_leader + lb;
  v.edges = edges;
  v.certs = certs;
  v.seen = seen;
  v.w = w;
  v.n = n;
  v.base = *base_round;

  const int view = blockIdx.x;
  const long long off = (long long)view * w * n;
  load_masks(edges_in, w * n, n, edges);
  load_masks(block_seen + off, w, n, seen);
  load_masks(cert_seen + off, w, n, certs);
  load_masks(com_in + off, w, n, v.com);
  int* seq = seq_out + off;
  for (int i = threadIdx.x; i < w * n; i += blockDim.x) seq[i] = seq_in[off + i];
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int nr = node_round[view];
    int lw = lw_in[view], ew = ew_in[view], cnt = cnt_in[view];
    for (int step = 0; step < steps; ++step) {
      const int wv = wrap_add(ew, 1);
      const int anchor_r = wrap_mul(2, wv);
      const int sup_r = wrap_add(anchor_r, 1);
      const int have_sup = __popcll(certs[floor_mod(sup_r, w)]);
      const bool complete = nr > sup_r || (nr == sup_r && have_sup >= quorum);
      const int l = leader_of(wv, seed_c, n);
      const bool anchor_ok = complete && anchor_r >= v.base &&
                             bit(certs[floor_mod(anchor_r, w)], l) &&
                             support(v, sup_r, l, quorum);

      // back-chain discovery, newest to oldest, against the committed
      // state before this wave (nothing commits until it is done)
      int head_r = anchor_r, head_src = l;
      for (int j = 0; j < lb; ++j) {
        const int wp = wrap_add(wv, -1 - j);
        const int lp = leader_of(wp, seed_c, n);
        const int rp = wrap_mul(2, wp);
        const int sp = floor_mod(rp, w);
        const bool cand = anchor_ok && wp > lw && rp >= v.base &&
                          bit(certs[sp], lp) && !bit(v.com[sp], lp);
        bool ch = false;
        if (cand) {
          closure(v, head_r, head_src);
          ch = bit(v.reach[sp], lp);
        }
        if (ch) {
          head_r = rp;
          head_src = lp;
        }
        __syncwarp();
        if (lane == 0) {
          chained[j] = ch;
          ch_leader[j] = lp;
          ch_round[j] = rp;
        }
      }
      __syncwarp();

      // oldest first: each chained leader commits its closure with its
      // own sequence number, then the wave's anchor
      for (int j = lb - 1; j >= 0; --j) {
        if (chained[j]) {
          commit(v, ch_round[j], ch_leader[j], cnt, seq);
          cnt = wrap_add(cnt, 1);
        }
      }
      if (anchor_ok) {
        commit(v, anchor_r, l, cnt, seq);
        cnt = wrap_add(cnt, 1);
        lw = wv;
      }
      if (complete) ew = wv;
    }
    if (lane == 0) {
      lw_out[view] = lw;
      ew_out[view] = ew;
      cnt_out[view] = cnt;
    }
  }
  __syncthreads();
  store_masks(v.com, w, n, com_out + off);
}

// edge masks, four per-slot masks, three ints per discovery step
size_t shared_bytes(int n, int w) {
  const int lb = w / 2 > 1 ? w / 2 : 1;
  return sizeof(u64) * ((size_t)w * n + 4 * (size_t)w) +
         sizeof(int) * 3 * (size_t)lb;
}

}  // namespace

// edges bool[W,N,N]; block_seen, cert_seen, committed bool[N,W,N];
// commit_seq int32[N,W,N]; node_round, last_wave, eval_wave,
// commit_counter int32[N]; base_round int32[] (read on the device). The
// *_out tensors take the new commit state; every one is written in full.
// All contiguous on one device, N <= 64. Returns the launch's CUDA error.
extern "C" int tusk_commit_launch(
    const void* edges, const void* block_seen, const void* cert_seen,
    const void* node_round, const void* base_round, const void* com_in,
    const void* seq_in, const void* lw_in, const void* ew_in,
    const void* cnt_in, void* com_out, void* seq_out, void* lw_out,
    void* ew_out, void* cnt_out, int n, int w, int quorum, unsigned seed_c,
    int steps, void* stream) {
  if (n <= 0 || w <= 0) return (int)cudaSuccess;
  const size_t bytes = shared_bytes(n, w);
  cudaError_t err = allow_shared(tusk_commit_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  tusk_commit_kernel<<<n, 256, bytes, (cudaStream_t)stream>>>(
      (const unsigned char*)edges, (const unsigned char*)block_seen,
      (const unsigned char*)cert_seen, (const int*)node_round,
      (const int*)base_round, (const unsigned char*)com_in,
      (const int*)seq_in, (const int*)lw_in, (const int*)ew_in,
      (const int*)cnt_in, (unsigned char*)com_out, (int*)seq_out,
      (int*)lw_out, (int*)ew_out, (int*)cnt_out, n, w, quorum, seed_c,
      steps);
  return (int)cudaGetLastError();
}
