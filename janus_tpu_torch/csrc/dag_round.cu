// dag_round: one synchronous DAG protocol round for the whole cluster in
// one launch.
//
// Replaces: janus_tpu/consensus/dag.py round_step, six phases in order:
// create_blocks, deliver_blocks, sign_blocks (with structural_validity),
// form_certificates, deliver_certificates, advance_rounds, under the
// optional crash mask active[N], withhold[W,N] and invalid[W,N]. XLA
// fuses each phase into a few elementwise passes; the port's plain
// version is ~70 launches a call.
//
// What bounds it on the H100: neither bytes nor operations. The state is
// four bool tensors of W*N*N bytes and a few of W*N (~0.6 KB at 4 nodes,
// ~130 KB at 64 nodes and W 8), read once and written once: the floor is
// one launch and a round trip to memory each way.
//
// Design: the round splits by ring slot. Every phase of slot s reads and
// writes only slot s's rows (edges and acks [s], block_seen and cert_seen
// [:, s], block_exists, cert_exists, withhold and invalid [s]), save that
// a creator at slot s references the certificates it holds for the slot
// before, s - 1 (every node creating at s is at a round r = s mod W, so
// its previous round's slot is s - 1 mod W), and that is read from the
// input, which no block writes. So a block a slot, on its own SM, with
// no traffic between blocks. A block reads its rows, a thread a row of N
// bytes (16-byte loads where the row allows, 4-byte or single otherwise),
// every load issued before any store, and packs each into a 64-bit mask
// in shared memory. Its first warp then runs the round from registers,
// lane v holding node v and v + 32: create, deliver blocks, sign (the
// signers of source src are column src of block_seen[:, s] over the
// nodes: a transpose of the block's 64 x 64 bit matrix by five rounds of
// shuffles a 32 x 32 quarter, which beat two ballots a source on an
// H100 at 64 nodes, 5.6 against 6.6 device µs a call), form
// certificates (a ballot over the sources), deliver them, and advance
// each node whose round lies at slot s. The block then writes its rows
// back from the masks, a thread a row. round_step's crash rule is applied
// as it derives it: a crashed node does not create, receive or sign, and
// withhold gains ~active on every slot.
//
// Split mode (SPLIT = true, a template instantiation: no runtime branch
// on the old path) replaces janus_tpu/net/splitnode.py
// SplitSafeKV._round_step, a round for the nodes this process owns: act =
// owned & active; create, sign and certify are masked by act, withhold
// gains ~act, both deliveries reach every node, crashed or not, and a node
// not owned keeps its node_round (a mirror advances only by ingest).
// base_round is read through its device pointer; absent masks are null
// pointers. Launches on the caller's stream, allocates nothing, does not
// synchronise.
#include <cuda_runtime.h>

#include "dag_masks.cuh"

namespace {

using namespace dag_masks;

constexpr unsigned FULL = 0xffffffffu;

// a block's rows: N each of edges[s], acks[s], block_seen[:, s],
// cert_seen[:, s] and cert_seen[:, s - 1], then one each of
// block_exists[s], cert_exists[s], withhold[s], invalid[s], active and
// owned (an absent one reads as zeros)
enum { EDGES, ACKS, BSEEN, CSEEN, CPREV, N_BIG };
enum { BEXIST, CEXIST, WITHHOLD, INVALID, ACTIVE, OWNED, N_SMALL };

struct DagIn {
  const unsigned char *edges, *acks, *block_seen, *cert_seen;
  const unsigned char* small[N_SMALL];  // [W, N] or [N]; null when absent
  const int *node_round, *slot_round, *base_round;
};

struct DagOut {
  unsigned char *edges, *acks, *block_seen, *cert_seen, *block_exists,
      *cert_exists;
  int* node_round;
};

// the signers of sources lane and lane + 32: columns of the n x n bit
// matrix whose row t is rows[t] (lane t holds rows t and t + 32), a
// 32 x 32 quarter at a time
__device__ __forceinline__ void columns(const u64 (&rows)[2], int n,
                                        u64 (&col)[2]) {
  const unsigned a = transpose32((unsigned)rows[0]);
  const unsigned c = n > 32 ? transpose32((unsigned)rows[1]) : 0u;
  col[0] = (u64)a | (u64)c << 32;
  col[1] = n > 32 ? (u64)transpose32((unsigned)(rows[0] >> 32)) |
                        (u64)transpose32((unsigned)(rows[1] >> 32)) << 32
                  : 0ull;
}

template <bool SPLIT>
__global__ void __launch_bounds__(5 * MAX_N + 32)
    dag_round_kernel(DagIn in, DagOut out, int n, int w, int quorum) {
  __shared__ u64 big[N_BIG][MAX_N];
  __shared__ u64 small[N_SMALL];
  __shared__ int nr_s[MAX_N];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int sp = s == 0 ? w - 1 : s - 1;  // the slot before

  // every load first: thread t < 5N a row of the big masks, the next
  // N_SMALL threads a row of the small ones; a node's round; the frontier
  // and the slot's round
  const int a = tid / n, v = tid - a * n;
  const long long wn = (long long)w * n;
  const unsigned char* p = nullptr;
  if (a == EDGES) p = in.edges + ((long long)s * n + v) * n;
  else if (a == ACKS) p = in.acks + ((long long)s * n + v) * n;
  else if (a == BSEEN) p = in.block_seen + (v * wn + (long long)s * n);
  else if (a == CSEEN) p = in.cert_seen + (v * wn + (long long)s * n);
  else if (a == CPREV) p = in.cert_seen + (v * wn + (long long)sp * n);
  const int k = tid - N_BIG * n;
  if (k >= 0 && k < N_SMALL) {
    const unsigned char* q = k == BEXIST ? in.small[BEXIST]
                             : k == CEXIST ? in.small[CEXIST]
                             : k == WITHHOLD ? in.small[WITHHOLD]
                             : k == INVALID ? in.small[INVALID]
                             : k == ACTIVE ? in.small[ACTIVE]
                                           : in.small[OWNED];
    p = q && k < ACTIVE ? q + (long long)s * n : q;
  }
  const u64 row = p ? load_row(p, n) : 0;
  const int r = tid < n ? in.node_round[tid] : 0;
  const int base = *in.base_round;
  const int sr = in.slot_round[s];
  if (a < N_BIG) big[a][v] = row;
  if (k >= 0 && k < N_SMALL) small[k] = row;
  if (tid < n) nr_s[tid] = r;
  __syncthreads();

  // the round, by the first warp
  if (tid < 32) {
    const int lane = tid;
    const int vs[2] = {lane, lane + 32};
    const u64 active = in.small[ACTIVE] ? small[ACTIVE] : low_mask(n);
    const u64 act = SPLIT ? active & small[OWNED] : active;
    const u64 dm = SPLIT ? low_mask(n) : act;  // who receives
    const u64 bex = small[BEXIST];
    int rv[2];
    bool fresh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rv[h] = vs[h] < n ? nr_s[vs[h]] : 0;
      fresh[h] = vs[h] < n && floor_mod(rv[h], w) == s && bit(act, vs[h]) &&
                 !bit(bex, vs[h]) && rv[h] < wrap_add(base, w) &&
                 rv[h] >= base;
    }
    const u64 bex2 = bex | (u64)__ballot_sync(FULL, fresh[0]) |
                     ((u64)__ballot_sync(FULL, fresh[1]) << 32);
    // create and deliver blocks: node v's block_seen row, source v's
    // edges and acks rows
    u64 bs[2], e[2], ack[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = vs[h] < n ? vs[h] : 0;
      bs[h] = vs[h] < n ? big[BSEEN][x] | (bit(dm, x) ? bex2 : 0ull) : 0;
      e[h] = big[EDGES][x];
      ack[h] = big[ACKS][x];
      if (fresh[h]) {
        if (rv[h] > 0) e[h] |= big[CPREV][x];
        ack[h] |= 1ull << x;
      }
    }
    // sign: every live node acks each valid block it has seen
    u64 sig[2];
    columns(bs, n, sig);
    const u64 inv = small[INVALID];
    bool formed[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool valid = vs[h] < n &&
                         (sr == 0 || __popcll(e[h]) >= quorum) &&
                         !bit(inv, vs[h]);
      if (valid) ack[h] |= sig[h] & act;
      formed[h] = vs[h] < n && __popcll(ack[h]) >= quorum;
    }
    // form certificates at quorum acks, unless withheld (a crashed
    // creator cannot aggregate its certificate; in split mode neither can
    // one this process does not own); the creator holds its own, live
    // nodes (split mode: every node) receive them all
    const u64 wh = small[WITHHOLD] |
                   (SPLIT || in.small[ACTIVE] ? ~act & low_mask(n) : 0ull);
    const u64 cex2 = small[CEXIST] |
                     (((u64)__ballot_sync(FULL, formed[0]) |
                       ((u64)__ballot_sync(FULL, formed[1]) << 32)) & ~wh);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = vs[h];
      if (x >= n) continue;
      const u64 cs = big[CSEEN][x] | (cex2 & (bit(dm, x) ? ~0ull : 1ull << x));
      big[EDGES][x] = e[h];
      big[ACKS][x] = ack[h];
      big[BSEEN][x] = bs[h];
      big[CSEEN][x] = cs;
      // advance past round r with quorum certificates of round r, inside
      // the window; a node below the frontier fast-forwards to it
      if (floor_mod(rv[h], w) == s) {
        const bool ready = __popcll(cs) >= quorum &&
                           wrap_add(rv[h], 1) < wrap_add(base, w);
        const int next = wrap_add(rv[h], ready ? 1 : 0);
        out.node_round[x] = SPLIT && !bit(small[OWNED], x)
                                ? rv[h] : (next > base ? next : base);
      }
    }
    if (lane == 0) {
      small[BEXIST] = bex2;
      small[CEXIST] = cex2;
    }
  }
  __syncthreads();

  // the slot's rows back, a thread a row
  if (a < CPREV) {
    unsigned char* q =
        a == EDGES ? out.edges + ((long long)s * n + v) * n
        : a == ACKS ? out.acks + ((long long)s * n + v) * n
        : a == BSEEN ? out.block_seen + (v * wn + (long long)s * n)
                     : out.cert_seen + (v * wn + (long long)s * n);
    store_row(q, n, big[a][v]);
  } else if (k == BEXIST || k == CEXIST) {
    store_row((k == BEXIST ? out.block_exists : out.cert_exists) +
                  (long long)s * n, n, small[k]);
  }
}

}  // namespace

// p: 20 pointers in the order of janus_tpu_torch/kernels/dag_round.py:
// the inputs edges, block_exists, block_seen, acks, cert_exists,
// cert_seen, node_round, slot_round, base_round, active, withhold,
// invalid, owned, then the outputs in the inputs' first seven's order.
// State tensors as in janus_tpu_torch/consensus/dag.py: edges, acks
// bool[W,N,N]; block_seen, cert_seen bool[N,W,N]; block_exists,
// cert_exists bool[W,N]; node_round int32[N]; slot_round int32[W];
// base_round int32[] (read on the device). active bool[N], withhold and
// invalid bool[W,N] may be null; owned bool[N] non-null selects the split
// mode. The outputs are written in full and alias no input. All
// contiguous on one device, N <= 64. Returns the launch's CUDA error.
extern "C" int dag_round_launch(void* const* p, int n, int w, int quorum,
                                void* stream) {
  if (n <= 0 || w <= 0) return (int)cudaSuccess;
  if (n > MAX_N) return (int)cudaErrorInvalidValue;
  DagIn in;
  in.edges = (const unsigned char*)p[0];
  in.small[BEXIST] = (const unsigned char*)p[1];
  in.block_seen = (const unsigned char*)p[2];
  in.acks = (const unsigned char*)p[3];
  in.small[CEXIST] = (const unsigned char*)p[4];
  in.cert_seen = (const unsigned char*)p[5];
  in.node_round = (const int*)p[6];
  in.slot_round = (const int*)p[7];
  in.base_round = (const int*)p[8];
  in.small[ACTIVE] = (const unsigned char*)p[9];
  in.small[WITHHOLD] = (const unsigned char*)p[10];
  in.small[INVALID] = (const unsigned char*)p[11];
  in.small[OWNED] = (const unsigned char*)p[12];
  const DagOut out = {(unsigned char*)p[13], (unsigned char*)p[16],
                      (unsigned char*)p[15], (unsigned char*)p[18],
                      (unsigned char*)p[14], (unsigned char*)p[17],
                      (int*)p[19]};
  const int threads = (N_BIG * n + N_SMALL + 31) / 32 * 32;
  auto kernel = in.small[OWNED] ? dag_round_kernel<true>
                                : dag_round_kernel<false>;
  kernel<<<w, threads, 0, (cudaStream_t)stream>>>(in, out, n, w, quorum);
  return (int)cudaGetLastError();
}
