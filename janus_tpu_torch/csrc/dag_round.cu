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
// four bool tensors of W*N*N bytes and a few of W*N (~0.6 KB at 4 nodes);
// each phase is one pass over it. The floor is one launch.
//
// Design: a single block holds the cluster's state in shared memory as
// 64-bit masks: edges[s][src] and acks[s][src] over nodes,
// block_seen[v][s] and cert_seen[v][s] over sources, block_exists,
// cert_exists, withhold and invalid per slot over sources, and active
// over nodes. The phases run in order, separated by barriers, each as one
// block-strided pass. round_step's crash rule is applied as it derives
// it: a crashed node does not create, receive or sign, and withhold gains
// ~active on every slot. Creation ORs its block bit into block_exists
// with a shared atomic (two nodes may share a slot). Quorum tests are
// popcounts. Every output is written in full from shared memory.
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

struct DagIn {
  const unsigned char *edges, *block_exists, *block_seen, *acks,
      *cert_exists, *cert_seen;
  const int *node_round, *slot_round, *base_round;
  const unsigned char *active, *withhold, *invalid;  // null when absent
  const unsigned char* owned;  // split mode only
};

struct DagOut {
  unsigned char *edges, *block_exists, *block_seen, *acks, *cert_exists,
      *cert_seen;
  int* node_round;
};

template <bool SPLIT>
__global__ void dag_round_kernel(DagIn in, DagOut out, int n, int w,
                                 int quorum) {
  extern __shared__ u64 smem[];
  const int wn = w * n;
  u64* edges = smem;      // [W*N]  (s, src) -> referenced nodes
  u64* acks = edges + wn; // [W*N]  (s, src) -> signers
  u64* bseen = acks + wn; // [N*W]  (v, s) -> sources
  u64* cseen = bseen + wn;
  u64* bexist = cseen + wn;  // [W] over sources
  u64* cexist = bexist + w;
  u64* withhold = cexist + w;
  u64* invalid = withhold + w;
  u64* active = invalid + w;  // [1] over nodes
  u64* owned = active + 1;     // [1] over nodes, split mode only
  const int tid = threadIdx.x, nt = blockDim.x;

  load_masks(in.edges, wn, n, edges);
  load_masks(in.acks, wn, n, acks);
  load_masks(in.block_seen, wn, n, bseen);
  load_masks(in.cert_seen, wn, n, cseen);
  load_masks(in.block_exists, w, n, bexist);
  load_masks(in.cert_exists, w, n, cexist);
  if (in.withhold) load_masks(in.withhold, w, n, withhold);
  else for (int s = tid; s < w; s += nt) withhold[s] = 0;
  if (in.invalid) load_masks(in.invalid, w, n, invalid);
  else for (int s = tid; s < w; s += nt) invalid[s] = 0;
  if (in.active) load_masks(in.active, 1, n, active);
  else if (tid == 0) active[0] = low_mask(n);
  if (SPLIT) load_masks(in.owned, 1, n, owned);
  const int base = *in.base_round;
  __syncthreads();
  const u64 act = SPLIT ? active[0] & owned[0] : active[0];
  // a crashed creator cannot aggregate its certificate; in split mode
  // neither can one this process does not own
  if (SPLIT || in.active)
    for (int s = tid; s < w; s += nt) withhold[s] |= ~act & low_mask(n);

  // create: node v at round r makes block (r, v) once, inside the window,
  // referencing the certificates it holds for round r-1
  for (int v = tid; v < n; v += nt) {
    const int r = in.node_round[v];
    const int s = floor_mod(r, w);
    const bool fresh = bit(act, v) && !bit(bexist[s], v) &&
                       r < wrap_add(base, w) && r >= base;
    if (fresh) {
      const int sp = floor_mod(wrap_add(r, -1), w);
      if (r > 0) edges[s * n + v] |= cseen[v * w + sp];
      atomicOr(&bexist[s], 1ull << v);
      bseen[v * w + s] |= 1ull << v;
      acks[s * n + v] |= 1ull << v;
    }
  }
  __syncthreads();
  // deliver blocks to every live node (split mode: to every node)
  for (int i = tid; i < wn; i += nt)
    if (SPLIT || bit(act, i / w)) bseen[i] |= bexist[i % w];
  __syncthreads();
  // sign: every live node acks each structurally valid block it has seen
  for (int i = tid; i < wn; i += nt) {
    const int s = i / n, src = i % n;
    const bool valid = (in.slot_round[s] == 0 || __popcll(edges[i]) >= quorum)
                       && !bit(invalid[s], src);
    if (!valid) continue;
    u64 signers = 0;
    for (int t = 0; t < n; ++t)
      if (bit(bseen[t * w + s], src)) signers |= 1ull << t;
    acks[i] |= signers & act;
  }
  __syncthreads();
  // form certificates at quorum acks, unless withheld
  for (int s = tid; s < w; s += nt) {
    u64 formed = 0;
    for (int src = 0; src < n; ++src)
      if (__popcll(acks[s * n + src]) >= quorum) formed |= 1ull << src;
    cexist[s] |= formed & ~withhold[s];
  }
  __syncthreads();
  // the creator holds its own certificate; live nodes (split mode: every
  // node) receive them all
  for (int i = tid; i < wn; i += nt) {
    const int v = i / w, s = i % w;
    cseen[i] |= (cexist[s] & (1ull << v)) |
                (SPLIT || bit(act, v) ? cexist[s] : 0ull);
  }
  __syncthreads();
  // advance past round r with quorum certificates of round r, inside the
  // window; a node below the frontier fast-forwards to it
  for (int v = tid; v < n; v += nt) {
    const int r = in.node_round[v];
    const int have = __popcll(cseen[v * w + floor_mod(r, w)]);
    const bool ready = have >= quorum && wrap_add(r, 1) < wrap_add(base, w);
    const int next = wrap_add(r, ready ? 1 : 0);
    out.node_round[v] = SPLIT && !bit(owned[0], v) ? r
                        : (next > base ? next : base);
  }
  store_masks(edges, wn, n, out.edges);
  store_masks(acks, wn, n, out.acks);
  store_masks(bseen, wn, n, out.block_seen);
  store_masks(cseen, wn, n, out.cert_seen);
  store_masks(bexist, w, n, out.block_exists);
  store_masks(cexist, w, n, out.cert_exists);
}

}  // namespace

// State tensors as in janus_tpu_torch/consensus/dag.py: edges, acks
// bool[W,N,N]; block_seen, cert_seen bool[N,W,N]; block_exists,
// cert_exists bool[W,N]; node_round int32[N]; slot_round int32[W];
// base_round int32[] (read on the device). active bool[N], withhold and
// invalid bool[W,N] may be null; owned bool[N] non-null selects the split
// mode. The *_out tensors are written in full. All contiguous on one
// device, N <= 64. Returns the launch's CUDA error.
extern "C" int dag_round_launch(
    const void* edges, const void* block_exists, const void* block_seen,
    const void* acks, const void* cert_exists, const void* cert_seen,
    const void* node_round, const void* slot_round, const void* base_round,
    const void* active, const void* withhold, const void* invalid,
    const void* owned, void* edges_out, void* block_exists_out,
    void* block_seen_out, void* acks_out, void* cert_exists_out,
    void* cert_seen_out, void* node_round_out, int n, int w, int quorum, void* stream) {
  if (n <= 0 || w <= 0) return (int)cudaSuccess;
  const DagIn in = {
      (const unsigned char*)edges,       (const unsigned char*)block_exists,
      (const unsigned char*)block_seen,  (const unsigned char*)acks,
      (const unsigned char*)cert_exists, (const unsigned char*)cert_seen,
      (const int*)node_round,            (const int*)slot_round,
      (const int*)base_round,            (const unsigned char*)active,
      (const unsigned char*)withhold,    (const unsigned char*)invalid,
      (const unsigned char*)owned};
  const DagOut out = {
      (unsigned char*)edges_out,       (unsigned char*)block_exists_out,
      (unsigned char*)block_seen_out,  (unsigned char*)acks_out,
      (unsigned char*)cert_exists_out, (unsigned char*)cert_seen_out,
      (int*)node_round_out};
  const bool split = owned != nullptr;
  const size_t bytes =
      sizeof(u64) * (4 * (size_t)w * n + 4 * (size_t)w + (split ? 2 : 1));
  auto kernel = split ? dag_round_kernel<true> : dag_round_kernel<false>;
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 512, bytes, (cudaStream_t)stream>>>(in, out, n, w, quorum);
  return (int)cudaGetLastError();
}
