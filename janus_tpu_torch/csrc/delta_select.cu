// delta_select: the dirty-slab selection of delta anti-entropy as a hand
// kernel for Hopper.
//
// Replaces: janus_tpu/runtime/store.py converge_delta's selection
// (store.py:108-112, 124): the union over the replica axis of the
// bool[R, K] dirty mask, its int32 count, the stable dirty-first row order
// (argsort(~dirty_u, stable=True): dirty rows in key order, then clean
// rows in key order; JAX cuts it to the budget D) and overflowed = count
// > D. JAX picks its full-converge fallback with lax.cond on the device;
// here the choice is a number in device memory, n_join = count, or K on
// overflow, which the row-list join kernels read: no host sync.
//
// What bounds it on the H100: bytes. The mask is read once (R*K bytes)
// and, when the caller consumes it, written once as zeros; the order is
// K int32. At the mixed_delta geometry that is 32,000 + 32,000 + 2,000
// bytes: a launch's cost, not the memory's.
//
// Design: one block of 1024 threads. Pass 1: thread t ORs key k = t +
// i*1024 over the R replicas (neighbouring threads read neighbouring
// bytes of each replica row), zeroes those bytes when asked, keeps the
// union flag in `uni` and counts. Pass 2 walks the keys in chunks of 1024
// with the same key-to-thread map: a ballot prefix count gives each key the
// number of dirty keys before it, so a dirty key lands at that number and
// a clean one at count + (its clean rank). Thread 0 writes count,
// overflowed, n_join and adds count and overflowed into the caller's
// running sums when given. Launches on the caller's stream, allocates
// nothing, does not synchronise.
#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) delta_select_kernel(
    unsigned char* __restrict__ dirty, long long replicas, int num_keys,
    int budget, int clear, unsigned char* __restrict__ uni,
    int* __restrict__ order, int* __restrict__ count_out,
    unsigned char* __restrict__ overflow_out, int* __restrict__ n_join,
    int* __restrict__ acc_count, int* __restrict__ acc_overflow) {
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  int mine = 0;
  for (int k = threadIdx.x; k < num_keys; k += blockDim.x) {
    unsigned char u = 0;
    for (long long r = 0; r < replicas; ++r) u |= dirty[r * num_keys + k];
    if (clear)
      for (long long r = 0; r < replicas; ++r) dirty[r * num_keys + k] = 0;
    uni[k] = u != 0;
    mine += u != 0;
  }
  atomicAdd(&total, mine);
  __syncthreads();
  const int count = total;

  int carry = 0;  // dirty keys in the chunks before this one
  for (int base = 0; base < num_keys; base += blockDim.x) {
    const int k = base + threadIdx.x;
    const bool u = k < num_keys && uni[k];  // this thread wrote uni[k]
    int chunk;
    const int before = carry + slot_sort::block_count_before(u, &chunk);
    if (k < num_keys) order[u ? before : count + (k - before)] = k;
    carry += chunk;
  }
  if (threadIdx.x == 0) {
    const bool over = count > budget;
    *count_out = count;
    *overflow_out = over;
    *n_join = over ? num_keys : count;
    if (acc_count) *acc_count += count;
    if (acc_overflow) *acc_overflow += over;
  }
}

}  // namespace

// dirty: bool[replicas, num_keys] (zeroed in place when `clear`); uni:
// bool[num_keys] scratch; order: int32[num_keys]; count, n_join: int32[];
// overflowed: bool[]; acc_count, acc_overflow: int32[] or null. Contiguous
// on one device. Returns the launch's CUDA error.
extern "C" int delta_select_launch(void* dirty, long long replicas,
                                   int num_keys, int budget, int clear,
                                   void* uni, void* order, void* count,
                                   void* overflowed, void* n_join,
                                   void* acc_count, void* acc_overflow,
                                   void* stream) {
  delta_select_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (unsigned char*)dirty, replicas, num_keys, budget, clear,
      (unsigned char*)uni, (int*)order, (int*)count,
      (unsigned char*)overflowed, (int*)n_join, (int*)acc_count,
      (int*)acc_overflow);
  return (int)cudaGetLastError();
}
