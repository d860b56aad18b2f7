// block_select: SafeKV's delta-apply selection and gather, for every view.
//
// Replaces: janus_tpu/runtime/safecrdt.py SafeKV._delta_apply's selection
// and gather (vmapped over the views), with janus_tpu/consensus/tusk.py
// order_key folded in. Per view v, over the W*N blocks j = (slot s,
// source src):
//   key[j]  = (slot_round[s] - base) * N + src            (prospective)
//           = seq[v, j] * W * N + (slot_round[s] - base) * N + src
//                                                         (commit order)
//   k[j]    = ready[v, j] && !applied[v, j] ? key[j] : INT32_MAX
//   idx     = the A smallest k in stable order (argsort, first A)
//   chosen  = k[idx] < INT32_MAX
//   batch   = ring rows idx, field by field, the op of unchosen lanes
//             OP_NOOP (0); applied[v, idx] |= chosen, in place.
// All key arithmetic wraps as int32, as in JAX.
//
// What bounds it on the H100: bytes, in the gather: V * A * B op records
// of every ring field. The selection is a few KB per view.
//
// Design: two kernels. The first runs one block per view: the keys go to
// shared memory, and each thread ranks its blocks by counting the keys
// that sort before them (W*N <= 1,024 keys, so a count beats a sort); the
// block at rank p < A is idx[p]. It then ORs its selection into applied,
// which it alone reads and writes. The second gathers the ring rows with
// a grid-stride loop over the output lanes of every field. Launches on
// the caller's stream, allocates nothing, does not synchronise.
#include <climits>

#include <cuda_runtime.h>

#include "dag_masks.cuh"

namespace {

using namespace dag_masks;

constexpr int MAX_FIELDS = 16;
constexpr int MAX_KEYS = 1024;

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

struct Fields {
  const int* src[MAX_FIELDS];
  int* dst[MAX_FIELDS];
  long long row[MAX_FIELDS];  // int32 elements per ring row (B * width)
};

__global__ void select_kernel(const unsigned char* __restrict__ ready,
                              unsigned char* __restrict__ applied,
                              const int* __restrict__ seq,
                              const int* __restrict__ slot_round,
                              const int* __restrict__ base_round,
                              int* __restrict__ idx,
                              unsigned char* __restrict__ chosen, int n, int w,
                              int a) {
  __shared__ int keys[MAX_KEYS];
  const int v = blockIdx.x;
  const int wn = w * n;
  const long long off = (long long)v * wn;
  const int base = *base_round;
  for (int j = threadIdx.x; j < wn; j += blockDim.x) {
    const int s = j / n, src = j % n;
    int key = wrap_add(wrap_mul(wrap_sub(slot_round[s], base), n), src);
    if (seq != nullptr) key = wrap_add(wrap_mul(seq[off + j], wn), key);
    keys[j] = ready[off + j] && !applied[off + j] ? key : INT_MAX;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < wn; j += blockDim.x) {
    const int kj = keys[j];
    int rank = 0;
    for (int i = 0; i < wn; ++i) {
      const int ki = keys[i];
      rank += ki < kj || (ki == kj && i < j);
    }
    if (rank < a) {
      const bool pick = kj < INT_MAX;
      idx[(long long)v * a + rank] = j;
      chosen[(long long)v * a + rank] = pick;
      if (pick) applied[off + j] = 1;
    }
  }
}

// t.src[f]: ring [W*N, row]; t.dst[f]: batch [V*A, row]; field op_field's
// unchosen lanes are written as 0 (OP_NOOP)
__global__ void gather_kernel(Fields t, int nfields, int op_field,
                              const int* __restrict__ idx,
                              const unsigned char* __restrict__ chosen,
                              long long rows_out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int f = 0; f < nfields; ++f) {
    const long long row = t.row[f];
    const long long total = rows_out * row;
    const int* src = t.src[f];
    int* dst = t.dst[f];
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
      const long long p = i / row;
      const long long e = i - p * row;
      const int x = src[(long long)idx[p] * row + e];
      dst[i] = (f == op_field && !chosen[p]) ? 0 : x;
    }
  }
}

}  // namespace

// ready, applied bool[V, W, N] (applied updated in place); seq int32[V, W,
// N] or null (prospective order); slot_round int32[W]; base_round int32[]
// (read on the device); idx int32[V, A] and chosen bool[V, A] (outputs);
// src: `nfields` (<= 16) ring fields int32 [W, N, row[f]]; dst: the
// batches int32 [V, A, row[f]]; op_field: the index of the op field. All
// contiguous on one device, W * N <= 1,024. Returns the first CUDA error
// of the two launches.
extern "C" int block_select_launch(
    const void* ready, void* applied, const void* seq, const void* slot_round,
    const void* base_round, void* idx, void* chosen, const void* const* src,
    const void* const* dst, const long long* row, int nfields, int op_field,
    int v, int n, int w, int a, void* stream) {
  if (v <= 0 || a <= 0) return (int)cudaSuccess;
  if (w * n > MAX_KEYS || a > w * n || nfields < 0 || nfields > MAX_FIELDS)
    return (int)cudaErrorInvalidValue;
  int threads = ((w * n + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  select_kernel<<<v, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)ready, (unsigned char*)applied, (const int*)seq,
      (const int*)slot_round, (const int*)base_round, (int*)idx,
      (unsigned char*)chosen, n, w, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Fields t = {};
  long long longest = 1;
  for (int f = 0; f < nfields; ++f) {
    t.src[f] = (const int*)src[f];
    t.dst[f] = (int*)dst[f];
    t.row[f] = row[f];
    longest = row[f] > longest ? row[f] : longest;
  }
  const long long rows_out = (long long)v * a;
  long long blocks = (rows_out * longest + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 2048) blocks = 2048;
  gather_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
      t, nfields, op_field, (const int*)idx, (const unsigned char*)chosen,
      rows_out);
  return (int)cudaGetLastError();
}
