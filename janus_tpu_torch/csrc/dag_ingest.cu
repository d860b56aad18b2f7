// dag_ingest: merge a batch of DAG messages received over the wire into
// the DAG state, and the op payloads of fresh blocks into SafeKV's ring,
// in one launch, in place.
//
// Replaces: janus_tpu/consensus/dag.py ingest_batch (ingest_block,
// ingest_signature, ingest_certificate over it) and the payload writes of
// janus_tpu/net/splitnode.py SplitNode._ingest (ops_buffer and
// buffer_filled at [r % W, src]). The host keeps what is host work in
// JAX too: the wire counters, the first-copy-wins dedupe of blocks and the
// conversion to int32; it packs the batch into one int32 upload:
//
//   blocks    m rows of (r, src, edge words[ew])   edge t is bit t % 32 of
//                                                  word t / 32
//   sigs      s rows of (r, src, signer)
//   certs     c rows of (r, src)
//   seen_by   v node ids
//   payloads  p rows of (block index, the block's payload in field order)
//
// Semantics, as JAX's: a message lands only where its slot owns its round
// (ok = slot_round[r % W] == r). Every write stores true and never false,
// so each bool field only gains true and two threads writing one cell
// store the same byte. A block's edges are first-write-wins: they land
// where ok and the block did not exist before the batch (fresh), read from
// a copy of block_exists taken before any write. node_round[src] takes the
// max of every block's round, ok or not. Index rules are JAX's: a scatter
// index in [-N, 0) counts from the end and one still out of range is
// dropped; the gather behind fresh clamps. The payload of a listed block
// is written whether or not it is ok (JAX's .at[].set), with
// buffer_filled set.
//
// What bounds it on the H100: the launch. A step ingests at most N*W
// blocks and N*N*W signatures (a few KB); payloads are the block's op
// rows (B lanes of every field).
//
// Design: block 0 stages block_exists in shared memory, then walks the
// blocks (one thread a block); every block walks the signatures and
// certificates and, grid-strided, the payload elements. Launches on the
// caller's stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include "dag_masks.cuh"

namespace {

using dag_masks::floor_mod;

constexpr int kMaxFields = 16;

struct DagState {
  unsigned char *edges, *block_exists, *block_seen, *acks, *cert_exists,
      *cert_seen;
  int* node_round;
  const int* slot_round;
};

struct Ring {
  int* field[kMaxFields];
  long long per_block[kMaxFields];  // int32 elements of one (slot, source)
  int num_fields;
  unsigned char* filled;  // null when no payload is written
};

struct Batch {
  const int *blocks, *sigs, *certs, *seen, *payloads;
  int m, s, c, v, p, ew;
  long long row;  // int32 elements of one payload row, its index included
};

// JAX's scatter index: [-n, 0) counts from the end, the rest of what lies
// outside [0, n) is dropped (returns -1)
__device__ __forceinline__ int scatter_at(int i, int n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// JAX's gather index: as the scatter's, then clamped into [0, n)
__device__ __forceinline__ int gather_at(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ bool owns(const DagState& st, int r, int w,
                                     int* slot) {
  *slot = floor_mod(r, w);
  return st.slot_round[*slot] == r;
}

__global__ void dag_ingest_kernel(DagState st, Batch in, Ring ring, int n,
                                  int w) {
  extern __shared__ unsigned char before[];  // block_exists before the batch
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long gid = (long long)blockIdx.x * nt + tid;
  const long long gstride = (long long)gridDim.x * nt;

  if (blockIdx.x == 0 && in.m > 0) {
    for (int i = tid; i < w * n; i += nt) before[i] = st.block_exists[i];
    __syncthreads();
    for (int k = tid; k < in.m; k += nt) {
      const int* b = in.blocks + (long long)k * (2 + in.ew);
      const int r = b[0];
      int s;
      const bool ok = owns(st, r, w, &s);
      const int src = scatter_at(b[1], n);
      if (src < 0) continue;
      atomicMax(&st.node_round[src], r);
      if (!ok) continue;
      const bool fresh = !before[s * n + gather_at(b[1], n)];
      st.block_exists[s * n + src] = 1;
      if (fresh) {
        unsigned char* row = st.edges + ((long long)s * n + src) * n;
        for (int t = 0; t < n; ++t)
          if ((((unsigned)b[2 + (t >> 5)]) >> (t & 31)) & 1u) row[t] = 1;
      }
      for (int j = 0; j < in.v; ++j) {
        const int node = scatter_at(in.seen[j], n);
        if (node >= 0)
          st.block_seen[((long long)node * w + s) * n + src] = 1;
      }
    }
  }
  for (long long k = gid; k < in.s; k += gstride) {
    const int* g = in.sigs + 3 * k;
    int s;
    const int src = scatter_at(g[1], n), signer = scatter_at(g[2], n);
    if (owns(st, g[0], w, &s) && src >= 0 && signer >= 0)
      st.acks[((long long)s * n + src) * n + signer] = 1;
  }
  for (long long k = gid; k < in.c; k += gstride) {
    const int* g = in.certs + 2 * k;
    int s;
    const int src = scatter_at(g[1], n);
    if (!owns(st, g[0], w, &s) || src < 0) continue;
    st.cert_exists[s * n + src] = 1;
    for (int j = 0; j < in.v; ++j) {
      const int node = scatter_at(in.seen[j], n);
      if (node >= 0) st.cert_seen[((long long)node * w + s) * n + src] = 1;
    }
  }
  // payload element e of row j: field f at its offset within the row
  const long long data = in.row - 1;
  for (long long i = gid; i < (long long)in.p * data; i += gstride) {
    const long long j = i / data;
    long long e = i - j * data;
    const int* pay = in.payloads + j * in.row;
    const int* b = in.blocks + (long long)pay[0] * (2 + in.ew);
    const int src = scatter_at(b[1], n);
    if (src < 0) continue;
    const long long cell = (long long)floor_mod(b[0], w) * n + src;
    if (e == 0) ring.filled[cell] = 1;
    const int value = pay[1 + e];
    int f = 0;
    while (e >= ring.per_block[f]) e -= ring.per_block[f++];
    ring.field[f][cell * ring.per_block[f] + e] = value;
  }
}

}  // namespace

// State tensors as in janus_tpu_torch/consensus/dag.py (edges, acks
// bool[W,N,N]; block_exists, cert_exists bool[W,N]; block_seen,
// cert_seen bool[N,W,N]; node_round, slot_round int32), updated in place.
// msgs: the packed int32 batch above, ew = ceil(N / 32). fields: the
// ring's int32 tensors [W, N, per_block[f]] in payload order, filled its
// bool[W, N] (null and num_fields 0 when p = 0). All contiguous on one
// device. Returns the launch's CUDA error.
extern "C" int dag_ingest_launch(
    void* edges, void* block_exists, void* block_seen, void* acks,
    void* cert_exists, void* cert_seen, void* node_round,
    const void* slot_round, const void* msgs, int m, int s, int c, int v,
    int p, void* const* fields, const long long* per_block, int num_fields,
    void* filled, int n, int w, void* stream) {
  if (n <= 0 || w <= 0 || (m == 0 && s == 0 && c == 0))
    return (int)cudaSuccess;
  if (num_fields > kMaxFields || (p > 0 && (num_fields == 0 || !filled)))
    return (int)cudaErrorInvalidValue;
  const DagState st = {
      (unsigned char*)edges,       (unsigned char*)block_exists,
      (unsigned char*)block_seen,  (unsigned char*)acks,
      (unsigned char*)cert_exists, (unsigned char*)cert_seen,
      (int*)node_round,            (const int*)slot_round};
  Ring ring = {};
  long long row = 1;
  for (int f = 0; f < num_fields; ++f) {
    ring.field[f] = (int*)fields[f];
    ring.per_block[f] = per_block[f];
    row += per_block[f];
  }
  ring.num_fields = num_fields;
  ring.filled = (unsigned char*)filled;
  const int ew = (n + 31) / 32;
  Batch in;
  in.blocks = (const int*)msgs;
  in.sigs = in.blocks + (long long)m * (2 + ew);
  in.certs = in.sigs + 3LL * s;
  in.seen = in.certs + 2LL * c;
  in.payloads = in.seen + v;
  in.m = m; in.s = s; in.c = c; in.v = v; in.p = p; in.ew = ew;
  in.row = row;
  const int threads = 256;
  const long long work = (long long)p * (row - 1) + s + c;
  long long grid = (work + threads * 4LL - 1) / (threads * 4LL);
  grid = grid < 1 ? 1 : (grid > 528 ? 528 : grid);
  const size_t bytes = (size_t)w * n;
  cudaError_t err = dag_masks::allow_shared(dag_ingest_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dag_ingest_kernel<<<(unsigned)grid, threads, bytes, (cudaStream_t)stream>>>(
      st, in, ring, n, w);
  return (int)cudaGetLastError();
}
