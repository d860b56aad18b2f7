// causal_closure: SafeKV's predecessor-completeness gate for every view in
// one launch.
//
// Replaces: janus_tpu/runtime/safecrdt.py SafeKV._causal_closure, a
// W-iteration lax.fori_loop. Each iteration, from the whole previous
// iterate (Jacobi): prev_applied = roll(applied, 1, slot axis), set to all
// true on the slot holding base_round; a held, unapplied certificate
// (v, s, src) becomes applied when every node its block references is in
// prev_applied[v, s]. The port's plain version is ~80 launches a call.
//
// What bounds it on the H100: neither bytes nor operations. The inputs are
// bool[W,N,N] edges and two bool[N,W,N] tensors (~0.5 KB at 4 nodes);
// the work is W dependent iterations of N*W mask tests per view. The
// floor is one launch.
//
// Design: one block per view. Edge rows, held certificates and the applied
// state become 64-bit masks in shared memory. Each iteration, one thread
// per (slot, source) pair tests its block against the previous iterate
// and ORs its bit into a second buffer that starts as a copy of it; the
// buffers swap, so every test reads the previous iterate as the scan
// does. An iteration that adds nothing is a fixpoint, and the remaining
// iterations are skipped (they would add nothing either). base_round is
// read through its device pointer. Launches on the caller's stream,
// allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include "dag_masks.cuh"

namespace {

using namespace dag_masks;

__global__ void causal_closure_kernel(
    const unsigned char* __restrict__ edges_in,
    const unsigned char* __restrict__ cert_seen,
    const unsigned char* __restrict__ applied_in,
    const int* __restrict__ slot_round, const int* __restrict__ base_round,
    unsigned char* __restrict__ applied_out, int n, int w) {
  extern __shared__ u64 smem[];
  u64* edges = smem;            // [W*N]
  u64* certs = edges + w * n;   // [W]
  u64* buf[2] = {certs + w, certs + 2 * w};  // [W] each: the iterates

  const long long off = (long long)blockIdx.x * w * n;
  load_masks(edges_in, w * n, n, edges);
  load_masks(cert_seen + off, w, n, certs);
  load_masks(applied_in + off, w, n, buf[0]);
  const int base = *base_round;
  __syncthreads();

  int cur = 0;
  for (int it = 0; it < w; ++it) {
    const u64* a = buf[cur];
    u64* next = buf[cur ^ 1];
    for (int s = threadIdx.x; s < w; s += blockDim.x) next[s] = a[s];
    __syncthreads();
    bool grew = false;
    for (int i = threadIdx.x; i < w * n; i += blockDim.x) {
      const int s = i / n, src = i % n;
      const u64 prev = slot_round[s] == base ? ~0ull : a[s == 0 ? w - 1 : s - 1];
      if (bit(certs[s] & ~a[s], src) && (edges[i] & ~prev) == 0) {
        atomicOr(&next[s], 1ull << src);
        grew = true;
      }
    }
    if (!__syncthreads_or(grew)) break;
    cur ^= 1;
  }
  store_masks(buf[cur], w, n, applied_out + off);
}

}  // namespace

// edges bool[W,N,N]; cert_seen, applied, applied_out bool[N,W,N];
// slot_round int32[W]; base_round int32[] (read on the device). All
// contiguous on one device, N <= 64. Returns the launch's CUDA error.
extern "C" int causal_closure_launch(const void* edges, const void* cert_seen,
                                     const void* applied,
                                     const void* slot_round,
                                     const void* base_round, void* applied_out,
                                     int n, int w, void* stream) {
  if (n <= 0 || w <= 0) return (int)cudaSuccess;
  const size_t bytes = sizeof(u64) * ((size_t)w * n + 3 * (size_t)w);
  cudaError_t err = allow_shared(causal_closure_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  int threads = ((w * n + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  causal_closure_kernel<<<n, threads, bytes, (cudaStream_t)stream>>>(
      (const unsigned char*)edges, (const unsigned char*)cert_seen,
      (const unsigned char*)applied, (const int*)slot_round,
      (const int*)base_round, (unsigned char*)applied_out, n, w);
  return (int)cudaGetLastError();
}
