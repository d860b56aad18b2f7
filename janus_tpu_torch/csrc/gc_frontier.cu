// gc_frontier: SafeKV's GC frontier, the recycle of the slots it frees,
// the pack of the round's host outputs and the clear of the freed ring
// rows, in one call.
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
// What bounds it on the H100: neither bytes nor operations. It reads a
// few bool[N, W, N] masks (at most 128 KB each), writes the pack and
// clears the dead slots' rows (of the masks and of the ring); the floor
// is one launch.
//
// Design: two kernels, the second launched by programmatic dependent
// launch (it starts while the first runs and waits for its end), so the
// pair costs about one launch. gc_kernel, one block: every global load
// it makes is issued before its first store (each load behind a store
// would cost a round trip to memory), and the [N, W, N] masks become flat
// bit arrays in shared memory (each thread turns 32 bytes, read as two
// 16-byte loads, into one word), from which a row's mask over the source
// node (N <= 64) is a 64-bit window. Every step is spread over the
// block: a view's rank in lw (and in node_round) is a count over the
// other views, a thread a view; com_ref a warp a slot (a lane a view, an
// OR reduction); view_done a warp a view (a lane a slot, a ballot);
// q_done one AND reduction over the quorum's view_done words; the
// per-slot predicates ballots of one warp, put into the scan's order (a
// lane a round) by a ballot, where lane 0 runs the can_gain recurrence
// over W <= 32 register bits; the run from base_round up is a ballot and
// a find-first-zero. gc_kernel writes the
// pack, lost and dead, the dead masks (a control word of the output),
// the recycle of the [W, N] masks and the slot rounds. sweep_kernel then
// recycles the [N, W, N] and [W, N, N] masks a thread an element, copies
// the logs' fresh commits and commit_seq before it clears them, and
// zeroes the dead slots' ring rows: a block a chunk of one field's slot
// row, 16-byte stores where the row allows, the dead slots read once a
// block; its blocks return at once when there is nothing to do. The pack
// reads the commit state before the recycle writes it. slot_round of the
// DAG and of the commit state may be one tensor: both are read before
// either is written, and the writes agree. Launches on the caller's
// stream, allocates nothing, does not synchronise.
#include <climits>

#include <cuda_runtime.h>

#include "dag_masks.cuh"

namespace {

using namespace dag_masks;

constexpr int MAX_W = 32;
constexpr int MAX_FIELDS = 16;
constexpr int GC_THREADS = 512;
constexpr int SWEEP_THREADS = 256;
constexpr int CHUNK = 2048;     // the int32 of a ring row one block clears
// the own blocks' com_before bytes a GC thread reads (N W <= 2,048)
constexpr int OWN = (MAX_N * MAX_W + GC_THREADS - 1) / GC_THREADS;

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
  // outputs: lost bool[N], dead bool[W], the pack, and the control words
  // (the dead and the commit-dead slot masks) the sweep reads
  unsigned char *lost, *dead;
  int* packed;
  unsigned* ctrl;
};

// the ring fields: field f int32 [W, row[f]], its slot rows cleared in
// chunks of CHUNK by blocks [first[f], first[f + 1])
struct Ring {
  int* ptr[MAX_FIELDS];
  long long row[MAX_FIELDS];
  int first[MAX_FIELDS + 1];
};

// the sweep's work: `ring_blocks` ring blocks, then `elem_blocks` of
// SWEEP_THREADS mask elements each
struct Sweep {
  Ring t;
  int nfields, ring_blocks, elem_blocks, n, w, collect_logs;
  const unsigned* ctrl;  // the GC's dead masks
  int* fresh;            // the pack's logs: fresh commits, then seq
};

// x // 2 rounded toward minus infinity, as in JAX and torch (an
// arithmetic shift)
__device__ __forceinline__ int floor_div2(int x) { return x >> 1; }

// the four bool arrays the GC reads whole (committed, stable_applied,
// prosp_applied [N, W, N] and cert_exists [W, N]) into flat bits (bit i
// of an array: element i != 0), a word of each a thread: the loads of a
// round are issued together (two 16-byte loads an array where the word
// is whole and the array aligned, bytes otherwise) before any store
__device__ void mask_bits(const Gc& g, int nwn, int nw, unsigned* b_com,
                          unsigned* b_st, unsigned* b_pr, unsigned* b_cert) {
  const unsigned char* src[4] = {g.committed, g.stable_applied,
                                 g.prosp_applied, g.cert_exists};
  unsigned* dst[4] = {b_com, b_st, b_pr, b_cert};
  const int len[4] = {nwn, nwn, nwn, nw};
  bool vec[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) vec[a] = ((size_t)src[a] & 15) == 0;
  for (int q = threadIdx.x; q < bit_words(nwn); q += blockDim.x) {
    const int at = q << 5;
    uint4 lo[4], hi[4];
    bool whole[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      whole[a] = vec[a] && at + 32 <= len[a];
      lo[a] = hi[a] = make_uint4(0, 0, 0, 0);
      if (whole[a]) {
        const uint4* p = (const uint4*)(src[a] + at);
        lo[a] = __ldg(p);
        hi[a] = __ldg(p + 1);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      unsigned x = nibble(lo[a].x) | nibble(lo[a].y) << 4 |
                   nibble(lo[a].z) << 8 | nibble(lo[a].w) << 12 |
                   nibble(hi[a].x) << 16 | nibble(hi[a].y) << 20 |
                   nibble(hi[a].z) << 24 | nibble(hi[a].w) << 28;
      if (!whole[a])
        for (int k = 0; k < 32 && at + k < len[a]; ++k)
          x |= (unsigned)(src[a][at + k] != 0) << k;
      if (q < bit_words(len[a])) dst[a][q] = x;
    }
  }
}

// the k-th smallest of a[0..n) (n <= 64): thread i < n of the calling
// threads ranks a[i] by a count over a, and a thread whose rank range
// holds k writes the value (every such thread writes the same one)
__device__ __forceinline__ void kth_by_rank(const int* a, int n, int k, int i,
                                            int* out) {
  if (i >= n) return;
  const int x = a[i];
  int less = 0, equal = 0;
  for (int u = 0; u < n; ++u) {
    less += a[u] < x;
    equal += a[u] == x;
  }
  if (less <= k && k < less + equal) *out = x;
}

// the GC (one block of GC_THREADS threads)
__device__ void gc_block(const Gc& g, int n, int w, int quorum,
                         int collect_logs) {
  extern __shared__ unsigned smem[];
  const int nw = n * w, nwn = nw * n;
  const int words = bit_words(nwn);
  unsigned* b_com = smem;            // committed
  unsigned* b_st = b_com + words;    // stable_applied
  unsigned* b_pr = b_st + words;     // prosp_applied
  unsigned* b_cert = b_pr + words;   // cert_exists [W, N]
  __shared__ u64 com_ref[MAX_W], cert[MAX_W];
  __shared__ unsigned view_done[MAX_N];
  __shared__ int lw[MAX_N], ew[MAX_N], nr[MAX_N], sr[MAX_W], csr[MAX_W];
  __shared__ int lw_q, nr_q, base_s, ew_min_s;
  __shared__ unsigned dead_s, cdead_s;
  __shared__ u64 mask_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  // every other global load of the GC first (a store before a load could
  // alias it for the compiler, and each such pair would cost a round trip
  // to memory): the views' and slots' rounds, the pack's inputs, the
  // dropped counts, com_before at the own blocks (OWN a thread)
  int my_lw = 0, my_ew = 0, my_nr = 0, my_sr = 0, my_csr = 0;
  int my_pre = 0, my_acc = 0, my_moved = 0, base = 0, donor = 0;
  if (tid < n) {
    my_lw = g.last_wave[tid];
    my_ew = g.eval_wave[tid];
    my_nr = g.node_round[tid];
    my_pre = g.pre_round[tid];
    my_acc = g.accepted[tid];
    if (collect_logs) my_moved = g.transferred[tid];
  }
  if (tid < w) {
    my_sr = g.dag_slot_round[tid];
    my_csr = g.com_slot_round[tid];
  }
  if (tid == 0) {
    base = *g.base_round;
    if (collect_logs) donor = *g.donor;
  }
  unsigned dropped = 0;
  if (warp == warps - 1) {  // the round's slots dropped, wrapping as int32
    for (int i = lane; i < g.n_drop_p; i += 32) dropped += (unsigned)g.drop_p[i];
    for (int i = lane; i < g.n_drop_s; i += 32) dropped += (unsigned)g.drop_s[i];
  }
  unsigned char before[OWN];
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    before[k] = 0;
    const int i = tid + k * GC_THREADS;
    if (i < nw) before[k] = g.com_before[i * n + i / w];
  }
  mask_bits(g, nwn, nw, b_com, b_st, b_pr, b_cert);
  // then the stores
  int* out = g.packed;
  int* rec = out + 2 * n + nw;
  int* logs = rec + w + 1;
  if (tid < n) {
    lw[tid] = my_lw;
    ew[tid] = my_ew;
    nr[tid] = my_nr;
    out[tid] = my_pre;
    out[n + tid] = my_acc;
    if (collect_logs) logs[tid] = my_moved;
  }
  if (tid < w) {
    sr[tid] = my_sr;
    csr[tid] = my_csr;
  }
  if (tid == 0) {
    base_s = base;
    if (collect_logs) logs[n] = donor;
  }
  if (warp == warps - 1) {
    dropped = __reduce_add_sync(0xffffffffu, dropped);
    if (lane == 0) rec[w] = (int)dropped;
  }
  __syncthreads();

  // the GC quorum's order statistics: a thread a view
  const int k = n - quorum;
  if (tid < MAX_N) kth_by_rank(lw, n, k, tid, &lw_q);
  else if (tid < 2 * MAX_N) kth_by_rank(nr, n, k, tid - MAX_N, &nr_q);
  __syncthreads();

  // the quorum (each warp its own copy), com_ref a warp a slot
  const int v0 = lane, v1 = lane + 32;
  const bool q0 = v0 < n && lw[v0] >= lw_q, q1 = v1 < n && lw[v1] >= lw_q;
  const u64 mask_q = (u64)__ballot_sync(0xffffffffu, q0) |
                     ((u64)__ballot_sync(0xffffffffu, q1) << 32);
  if (warp == 0) {
    const int e = min(q0 ? ew[v0] : INT_MAX, q1 ? ew[v1] : INT_MAX);
    const int m = __reduce_min_sync(0xffffffffu, e);
    if (lane == 0) {
      ew_min_s = m;
      mask_s = mask_q;
    }
  }
  for (int s = warp; s < w; s += warps) {
    u64 ref = 0;
    if (q0) ref |= row_bits(b_com, v0 * w + s, n);
    if (q1) ref |= row_bits(b_com, v1 * w + s, n);
    ref = warp_or(ref);
    if (lane == 0) {
      com_ref[s] = ref;
      cert[s] = row_bits(b_cert, s, n);
    }
  }
  __syncthreads();

  // view_done: a warp a view, a lane a slot
  for (int v = warp; v < n; v += warps) {
    bool done = false;
    if (lane < w) {
      const int r = v * w + lane;
      const u64 ref = com_ref[lane], c = cert[lane];
      const u64 pr = row_bits(b_pr, r, n);
      const u64 allowed = (1ull << v) & pr & ~c;
      done = row_bits(b_com, r, n) == ref && row_bits(b_st, r, n) == ref &&
             ((pr ^ c) & ~allowed) == 0;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, done);
    if (lane == 0) view_done[v] = bits;
  }
  // the own-block commits of the pack: committed[v, s, v] & ~com_before
  int* own = out + 2 * n;
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    const int i = tid + k * GC_THREADS;
    if (i < nw) {
      const int at = i * n + i / w;
      own[i] = (int)(((b_com[at >> 5] >> (at & 31)) & 1u) && !before[k]);
    }
  }
  __syncthreads();

  // the frontier: one warp, a lane a slot
  if (warp == 0) {
    const u64 mq = mask_s;
    const unsigned d0 = v0 < n && bit(mq, v0) ? view_done[v0] : ~0u;
    const unsigned d1 = v1 < n && bit(mq, v1) ? view_done[v1] : ~0u;
    const unsigned q_done = __reduce_and_sync(0xffffffffu, d0 & d1);
    const int base = base_s;
    bool frozen = false, direct = false, any_unc = false;
    if (lane < w) {
      const int r = sr[lane];
      frozen = wrap_add(r, 2) <= nr_q;
      any_unc = (cert[lane] & ~com_ref[lane]) != 0;
      direct = floor_mod(r, 2) == 0 && floor_div2(r) > ew_min_s;
    }
    const unsigned fz = __ballot_sync(0xffffffffu, frozen);
    const unsigned dr = __ballot_sync(0xffffffffu, direct);
    const unsigned un = __ballot_sync(0xffffffffu, any_unc);
    // the scan's order: lane i holds the slot of round base + W - 1 - i
    // (the highest live round first), and lane j that of round base + j;
    // each slot is the floor modulo of its wrapped round, as in JAX
    const bool live = lane < w;
    const int down = live ? floor_mod(wrap_add(base, w - 1 - lane), w) : 0;
    const int up = live ? floor_mod(wrap_add(base, lane), w) : 0;
    const unsigned fz_o = __ballot_sync(0xffffffffu, live && ((fz >> down) & 1u));
    const unsigned dr_o = __ballot_sync(0xffffffffu, live && ((dr >> down) & 1u));
    const unsigned un_o = __ballot_sync(0xffffffffu, live && ((un >> down) & 1u));
    unsigned can_o = 0;
    if (lane == 0) {  // can_gain, over W register bits in the scan's order
      bool can_above = true;
      for (int i = 0; i < w; ++i) {
        const bool c = !((fz_o >> i) & 1u) ||
                       ((((dr_o >> i) & 1u) || can_above) && ((un_o >> i) & 1u));
        can_o |= (unsigned)c << i;
        can_above = c;
      }
    }
    can_o = __shfl_sync(0xffffffffu, can_o, 0);
    const unsigned can = __reduce_or_sync(
        0xffffffffu, live && ((can_o >> lane) & 1u) ? 1u << down : 0u);
    // the run of collectible slots from base_round up
    const unsigned coll = q_done & ~can;
    const unsigned run = __ballot_sync(0xffffffffu, live && ((coll >> up) & 1u));
    const int adv = run == ~0u ? 32 : __ffs(~run) - 1;  // no bit at lane >= w
    const int nb = wrap_add(base, adv);
    const unsigned dead = __ballot_sync(0xffffffffu, lane < w && sr[lane] < nb);
    const unsigned cdead =
        __ballot_sync(0xffffffffu, lane < w && csr[lane] < nb);
    if (lane == 0) {
      dead_s = dead;
      cdead_s = cdead;
      g.ctrl[0] = dead;
      g.ctrl[1] = cdead;
      *g.base_round = nb;
    }
  }
  __syncthreads();
  const unsigned dead = dead_s, cdead = cdead_s;

  // outputs of the pre-GC state, the [W, N] recycle, the slot rounds
  for (int v = tid; v < n; v += blockDim.x)
    g.lost[v] = (dead & ~view_done[v]) != 0;
  for (int s = tid; s < w; s += blockDim.x) {
    const bool d = (dead >> s) & 1u, cd = (cdead >> s) & 1u;
    g.dead[s] = d;
    rec[s] = d;
    const int post = d ? wrap_add(sr[s], w) : sr[s];
    g.dag_slot_round[s] = post;
    g.com_slot_round[s] = cd ? wrap_add(csr[s], w) : csr[s];
    if (collect_logs) logs[n + 1 + 2 * nwn + s] = post;
  }
  if (dead) {
    for (int i = tid; i < nw; i += blockDim.x) {
      if ((dead >> (i / n)) & 1u) {
        g.block_exists[i] = 0;
        g.cert_exists[i] = 0;
        g.buffer_filled[i] = 0;
      }
    }
  }
}

// the logs' inputs at mask element i: committed, com_before, commit_seq
// (none of which the GC writes, so a sweep block may read them before
// it waits for the GC)
struct Logs {
  bool committed, before;
  int seq;
};

__device__ __forceinline__ Logs logs_at(const Gc& g, const Sweep& p, int i) {
  Logs x = {false, false, 0};
  if (p.collect_logs && i >= 0 && i < p.n * p.w * p.n) {
    x.committed = g.committed[i];
    x.before = g.com_before[i];
    x.seq = g.commit_seq[i];
  }
  return x;
}

// the sweep's mask element i (a thread an element): the logs' copies,
// then the [N, W, N] and [W, N, N] recycles of the dead slots
__device__ void sweep_masks(const Gc& g, const Sweep& p, int i, Logs x,
                            unsigned dead, unsigned cdead) {
  const int n = p.n, w = p.w, nwn = n * w * n;
  if (i >= nwn) return;
  const int s = (i / n) % w;       // [N, W, N]
  const int s2 = i / (n * n);      // [W, N, N]
  if (p.collect_logs) {
    p.fresh[i] = (int)(x.committed && !x.before);
    p.fresh[nwn + i] = x.seq;
  }
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
  if ((dead >> s2) & 1u) {
    g.edges[i] = 0;
    g.acks[i] = 0;
  }
}

// the sweep's ring job `job`: chunk c of field f's row at every dead slot
__device__ void sweep_ring(const Ring& t, int nfields, int job,
                           unsigned dead) {
  int f = 0;
  while (f + 1 < nfields && job >= t.first[f + 1]) ++f;
  const long long row = t.row[f];
  const long long lo = (long long)(job - t.first[f]) * CHUNK;
  const int len = (int)(row - lo < CHUNK ? row - lo : CHUNK);
  const bool vec = (row & 3) == 0 && ((size_t)t.ptr[f] & 15) == 0;
  for (unsigned m = dead; m; m &= m - 1) {
    const int s = __ffs(m) - 1;
    int* p = t.ptr[f] + (long long)s * row + lo;
    if (vec) {
      int4* p4 = (int4*)p;
      for (int i = threadIdx.x; i < (len >> 2); i += blockDim.x)
        p4[i] = make_int4(0, 0, 0, 0);
    } else {
      for (int i = threadIdx.x; i < len; i += blockDim.x) p[i] = 0;
    }
  }
}

// the dead masks a sweep block works from: the GC's control words, read
// once a block by its first thread, past L1 (the GC's grid wrote them)
__device__ void sweep_masks_of(const Sweep& p, unsigned* dead,
                               unsigned* cdead) {
  __shared__ unsigned d_s, cd_s;
  if (threadIdx.x == 0) {
    d_s = __ldcg(p.ctrl);
    cd_s = __ldcg(p.ctrl + 1);
  }
  __syncthreads();
  *dead = d_s;
  *cdead = cd_s;
}

__global__ void __launch_bounds__(GC_THREADS)
    gc_kernel(Gc g, int n, int w, int quorum, int collect_logs) {
  // the sweep's blocks may launch now; they wait for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");
  gc_block(g, n, w, quorum, collect_logs);
}

// a block a job, launched behind the GC: a ring chunk, or SWEEP_THREADS
// mask elements, whose logs' inputs are read before the wait (the dead
// masks after it)
__global__ void __launch_bounds__(SWEEP_THREADS) sweep_kernel(Gc g, Sweep p) {
  const int job = blockIdx.x;
  const int i = (job - p.ring_blocks) * SWEEP_THREADS + (int)threadIdx.x;
  const Logs x = logs_at(g, p, i);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  unsigned dead, cdead;
  sweep_masks_of(p, &dead, &cdead);
  if (!(dead | cdead) && !p.collect_logs) return;
  if (job < p.ring_blocks) {
    if (dead) sweep_ring(p.t, p.nfields, job, dead);
  } else {
    sweep_masks(g, p, i, x, dead, cdead);
  }
}

// the ring table of `nfields` fields (addresses, int32 a slot row) and
// their chunks' blocks; returns the ring blocks, or -1 if too many
long long ring_of(Ring* t, const long long* table, int nfields) {
  long long blocks = 0;
  for (int f = 0; f < nfields; ++f) {
    t->ptr[f] = (int*)table[f];
    t->row[f] = table[nfields + f];
    t->first[f] = (int)blocks;
    blocks += (t->row[f] + CHUNK - 1) / CHUNK;
    if (blocks >= (1LL << 30)) return -1;
  }
  t->first[nfields] = (int)blocks;
  return blocks;
}

// the dynamic shared memory of gc_kernel at (N, W): more than 48 KB at
// N 64, W 32, so the kernel is opted in once per device for the most any
// call needs
size_t gc_shared(int n, int w) {
  return sizeof(unsigned) * (3 * (size_t)bit_words(n * w * n) + bit_words(n * w));
}

cudaError_t opt_in() {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  const size_t most = gc_shared(MAX_N, MAX_W);
  err = allow_shared(gc_kernel, most);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// the sweep launched behind the GC by programmatic dependent launch
cudaError_t launch_sweep(const Gc& g, const Sweep& p, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.ring_blocks + p.elem_blocks));
  cfg.blockDim = dim3(SWEEP_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, sweep_kernel, g, p);
}

}  // namespace

// p: the Gc pointers in struct order (28 of them, see janus_tpu_torch/
// kernels/gc_frontier.py: the last is the output buffer's control words);
// ring: `nfields` (<= 16) int32 ring fields [W, ...] as 2 * nfields int64
// (their addresses, then each slot row's int32), or nfields 0 for none;
// n_drop_p / n_drop_s: lengths of the two dropped-count vectors (0 when
// absent). N <= 64, W <= 32. Returns the first CUDA error of the
// launches.
extern "C" int gc_frontier_launch(void* const* p, const long long* ring,
                                  int nfields, int n_drop_p,
                                  int n_drop_s, int n, int w, int quorum,
                                  int collect_logs, void* stream) {
  if (n <= 0 || w <= 0) return (int)cudaSuccess;
  if (n > MAX_N || w > MAX_W || nfields < 0 || nfields > MAX_FIELDS)
    return (int)cudaErrorInvalidValue;
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
  g.ctrl = (unsigned*)p[i++];
  g.n_drop_p = n_drop_p;
  g.n_drop_s = n_drop_s;
  Sweep s = {};
  const long long ring_blocks = ring_of(&s.t, ring, nfields);
  if (ring_blocks < 0) return (int)cudaErrorInvalidValue;
  const int nwn = n * w * n;
  s.nfields = nfields;
  s.ring_blocks = (int)ring_blocks;
  s.elem_blocks = (nwn + SWEEP_THREADS - 1) / SWEEP_THREADS;
  s.n = n;
  s.w = w;
  s.collect_logs = collect_logs;
  s.ctrl = g.ctrl;
  s.fresh = g.packed + 2 * n + n * w + w + 1 + n + 1;
  const size_t bytes = gc_shared(n, w);
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  gc_kernel<<<1, GC_THREADS, bytes, st>>>(g, n, w, quorum, collect_logs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sweep(g, s, st);
}

