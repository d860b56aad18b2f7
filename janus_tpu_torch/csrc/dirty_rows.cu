// dirty_rows: the per-replica dirty-row mask of delta anti-entropy as a
// hand kernel for Hopper.
//
// Replaces: janus_tpu/models/base.py op_dirty_rows (bool[K] zeros
// .at[key].max(op != OP_NOOP)), vmapped over the replica axis by
// runtime/store.py apply_replica_ops_delta, and the OR of a batch's rows
// into the running [R, K] mask (store.py _apply_and_track, fused_tick).
// JAX's scatter rule holds: a negative key counts from the end, a key
// still out of range is dropped; a no-op marks nothing.
//
// What bounds it on the H100: bytes. The op and key fields are read once
// (8 bytes per op) and one byte is stored for each distinct (replica, key)
// a live op marks, at most R*B; the mask is never read. At the mixed_delta
// geometry (R=64, B=64, K=500) that is 32,768 bytes plus at most 4,096,
// far below what one launch costs, so the launch itself is the floor.
//
// Design: one thread per op. A live op stores 1 into mask[r, key]; racing
// stores of the same key write the same byte, so no atomics are needed.
// The kernel only sets bytes: the wrapper hands it a zeroed mask for a
// fresh batch, or the caller's running mask to OR into in place. Launches
// on the caller's stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

namespace {

__global__ void dirty_rows_kernel(const int* __restrict__ op,
                                  const int* __restrict__ key,
                                  unsigned char* __restrict__ mask,
                                  long long ops, int batch, int num_keys) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < ops; i += stride) {
    if (op[i] == 0) continue;
    int k = key[i];
    if (k < 0) k += num_keys;
    if (k < 0 || k >= num_keys) continue;
    mask[(i / batch) * num_keys + k] = 1;
  }
}

}  // namespace

// op, key: int32[rows, batch]; mask: bool[rows, num_keys]; contiguous on
// one device. Sets mask[r, key] for every live op of row r. Returns the
// launch's CUDA error.
extern "C" int dirty_rows_launch(const void* op, const void* key, void* mask,
                                 long long rows, int batch, int num_keys,
                                 void* stream) {
  const long long ops = rows * batch;
  if (ops <= 0 || num_keys <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (ops + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  dirty_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)op, (const int*)key, (unsigned char*)mask, ops, batch,
      num_keys);
  return (int)cudaGetLastError();
}
