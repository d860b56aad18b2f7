// state_transfer: SafeKV's crash/lag recovery, in place.
//
// Replaces: janus_tpu/runtime/safecrdt.py SafeKV._state_transfer. A view
// needs a transfer when it fell below the GC frontier (node_round < base),
// when its commit cursor lags the quorum-th best by more than the repair
// window (last_wave < lw_q - max(2, W/4), lw_q the quorum-th smallest
// last_wave, int32 arithmetic wrapping), or when last round's GC forced
// it. Every needy view then adopts the donor's row (the first argmax of
// last_wave) of every state leaf: both type states, the DAG views, the
// commit state and both applied masks. JAX rewrites every leaf with a
// select; so did the port's plain version, every round.
//
// What bounds it on the H100: bytes, and only when a view needs a
// transfer: each needy view's rows of every leaf, read from the donor and
// written once. In the common round nothing moves, and the floor is the
// two launches.
//
// Design: two kernels, because the decision reads last_wave and
// node_round, which the copy rewrites. The first is one block: the order
// statistic and the argmax over N <= 64 views, need[N] and donor written
// to the device. The second walks a table of leaves, one grid row per
// leaf: each block reads need and donor, returns at once when no view but
// the donor needs a transfer (the donor's own copy is the identity), and
// else copies the donor's row into each needy view's row in 16-, 4- or
// 1-byte units. Zero-size leaves are not in the table. The decision stays
// on the device. Launches on the caller's stream, allocates nothing, does
// not synchronise.
#include <climits>

#include <cuda_runtime.h>

#include "dag_masks.cuh"

namespace {

using namespace dag_masks;

constexpr int MAX_LEAVES = 48;

struct Leaves {
  unsigned char* ptr[MAX_LEAVES];
  long long row_bytes[MAX_LEAVES];  // bytes of one view's row
};

__global__ void need_kernel(const int* __restrict__ last_wave,
                            const int* __restrict__ node_round,
                            const int* __restrict__ base_round,
                            const unsigned char* __restrict__ force,
                            unsigned char* __restrict__ need,
                            int* __restrict__ donor, int n, int quorum,
                            int lag_max) {
  __shared__ int lw[64];
  __shared__ int lw_q;
  for (int v = threadIdx.x; v < n; v += blockDim.x) lw[v] = last_wave[v];
  __syncthreads();
  // the (n - quorum)-th smallest: the value whose sorted position range
  // [less, less + equal) holds it
  const int k = n - quorum;
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    int less = 0, equal = 0;
    for (int u = 0; u < n; ++u) {
      less += lw[u] < lw[v];
      equal += lw[u] == lw[v];
    }
    if (less <= k && k < less + equal) lw_q = lw[v];
  }
  __syncthreads();
  const int base = *base_round;
  const int floor_lw = (int)((unsigned)lw_q - (unsigned)lag_max);
  for (int v = threadIdx.x; v < n; v += blockDim.x)
    need[v] = node_round[v] < base || lw[v] < floor_lw || force[v];
  if (threadIdx.x == 0) {
    int best = 0;
    for (int v = 1; v < n; ++v)
      if (lw[v] > lw[best]) best = v;
    *donor = best;
  }
}

__global__ void adopt_kernel(Leaves t, const unsigned char* __restrict__ need,
                             const int* __restrict__ donor, int n) {
  const int d = *donor;
  u64 mask = 0;
  for (int v = 0; v < n; ++v)
    if (v != d && need[v]) mask |= 1ull << v;
  if (mask == 0) return;
  const int leaf = blockIdx.y;
  unsigned char* base = t.ptr[leaf];
  const long long row = t.row_bytes[leaf];
  const int unit = (row % 16 == 0 && ((size_t)base % 16) == 0)  ? 16
                   : (row % 4 == 0 && ((size_t)base % 4) == 0) ? 4
                                                               : 1;
  const long long units = row / unit;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int v = 0; v < n; ++v) {
    if (!bit(mask, v)) continue;
    const unsigned char* src = base + (long long)d * row;
    unsigned char* dst = base + (long long)v * row;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < units; i += stride) {
      if (unit == 16)
        ((int4*)dst)[i] = ((const int4*)src)[i];
      else if (unit == 4)
        ((int*)dst)[i] = ((const int*)src)[i];
      else
        dst[i] = src[i];
    }
  }
}

}  // namespace

// last_wave, node_round int32[N]; base_round int32[]; force bool[N]; need
// bool[N] and donor int32[] (written); leaves: `nleaves` (<= 48) pointers
// to tensors whose leading axis is the N views, each view's row
// `row_bytes` bytes (> 0), updated in place. All contiguous on one device,
// N <= 64. Returns the first CUDA error of the two launches.
extern "C" int state_transfer_launch(const void* last_wave,
                                     const void* node_round,
                                     const void* base_round, const void* force,
                                     void* need, void* donor,
                                     void* const* leaves,
                                     const long long* row_bytes, int nleaves,
                                     int n, int quorum, int lag_max,
                                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n > 64 || nleaves < 0 || nleaves > MAX_LEAVES)
    return (int)cudaErrorInvalidValue;
  need_kernel<<<1, 64, 0, (cudaStream_t)stream>>>(
      (const int*)last_wave, (const int*)node_round, (const int*)base_round,
      (const unsigned char*)force, (unsigned char*)need, (int*)donor, n,
      quorum, lag_max);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nleaves == 0) return (int)err;
  Leaves t = {};
  long long longest = 1;
  for (int i = 0; i < nleaves; ++i) {
    t.ptr[i] = (unsigned char*)leaves[i];
    t.row_bytes[i] = row_bytes[i];
    longest = row_bytes[i] > longest ? row_bytes[i] : longest;
  }
  long long bx = (longest / 16 + 255) / 256;
  if (bx < 1) bx = 1;
  if (bx > 128) bx = 128;
  const dim3 grid((unsigned)bx, (unsigned)nleaves);
  adopt_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      t, (const unsigned char*)need, (const int*)donor, n);
  return (int)cudaGetLastError();
}
