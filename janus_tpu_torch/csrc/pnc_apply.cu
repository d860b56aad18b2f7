// pnc_apply: the PN-Counter batched apply as a hand kernel for Hopper.
//
// Replaces: janus_tpu/models/pncounter.py apply_ops (int32 scatter-add of
// a0 into P for op 1 or N for op 2 at [key, writer], no-ops masked),
// batched over the replica axis by janus_tpu/runtime/store.py
// apply_replica_ops and, per view, by SafeKV's _delta_apply and
// _submit_device. XLA lowers it to a scatter-add.
//
// What bounds it on the H100: the op fields (four int32 per op) are read
// once, coalesced; each op then does one scattered 4-byte read-modify-write
// of the state. At the fast-path geometry (R=256, B=1024) that is 4 MB of
// streaming reads plus 262,144 scattered atomics, a few microseconds of
// memory traffic, so launch latency dominates.
//
// Design: one thread per op (grid-stride), neighbouring threads on
// neighbouring op lanes so the field loads coalesce. Duplicate (key,
// writer) pairs in one batch accumulate through atomicAdd on int, which
// wraps modulo 2^32 exactly like JAX's int32 scatter-add; nothing is
// widened. The index rule is JAX's: an index in [-size, 0) counts from the
// end, anything still out of range is dropped, so the kernel never writes
// out of bounds. Launches on the caller's stream, allocates nothing, does
// not synchronise.
#include <cuda_runtime.h>

namespace {

__global__ void pnc_apply_kernel(int* __restrict__ p, int* __restrict__ n,
                                 const int* __restrict__ op,
                                 const int* __restrict__ key,
                                 const int* __restrict__ a0,
                                 const int* __restrict__ writer,
                                 int num_keys, int num_writers,
                                 long long batch, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int o = op[i];
    if (o != 1 && o != 2) continue;
    int k = key[i];
    int w = writer[i];
    if (k < 0) k += num_keys;
    if (w < 0) w += num_writers;
    if (k < 0 || k >= num_keys || w < 0 || w >= num_writers) continue;
    const long long r = i / batch;
    int* dst = (o == 1) ? p : n;
    atomicAdd(dst + (r * num_keys + k) * num_writers + w, a0[i]);
  }
}

}  // namespace

// p, n: int32[R, K, W]; op, key, a0, writer: int32[R, B]; all contiguous
// on one device. Returns cudaGetLastError() after the launch.
extern "C" int pnc_apply_launch(void* p, void* n, const void* op,
                                const void* key, const void* a0,
                                const void* writer, long long replicas,
                                int num_keys, int num_writers,
                                long long batch, void* stream) {
  const long long total = replicas * batch;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  pnc_apply_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int*)p, (int*)n, (const int*)op, (const int*)key, (const int*)a0,
      (const int*)writer, num_keys, num_writers, batch, total);
  return (int)cudaGetLastError();
}
