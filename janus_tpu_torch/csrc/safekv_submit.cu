// safekv_submit: SafeKV's submit around the type's capture, as two entry
// points of one source.
//
// Replaces: janus_tpu/runtime/safecrdt.py SafeKV._submit_device (its
// accept mask, the masked op batch and the ring write; the type's capture
// and origin apply run between the two entry points, through the type's
// own kernels). The port's plain version cloned the whole [W, N, B, ...]
// ring of every field each round to write one row per view.
//
//   accept  accepted[v] = block (r_v, v) not made, its slot not yet
//           buffered, base <= r_v < base + W, and active[v]; the op batch
//           with rejected views' lanes zeroed, written to a separate
//           [N, B] buffer (the caller's batch is never written); and a
//           copy of node_round, the slot each batch boards, which later
//           phases of the round change in place.
//   board   writes every field of the captured batch into ring row
//           [slot_of(r_v), v] of each accepted view, in place, and sets
//           buffer_filled[s, v] and prosp_applied[v, s, v].
//
// What bounds it on the H100: bytes. Each entry point moves the op batch
// once (N * B * fields int32) and reads a few bytes of DAG state per view.
//
// Design: a grid-stride loop over the batch's lanes; each thread decides
// its view's acceptance from the view's DAG bits (a few cached bytes), so
// the mask needs no second pass. Board runs one grid row per view and
// returns at once for a rejected view. Round arithmetic wraps as int32
// and the slot is the floor modulo (csrc/dag_masks.cuh). Launches on the
// caller's stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include "dag_masks.cuh"

namespace {

using namespace dag_masks;

constexpr int MAX_FIELDS = 16;

// src[f] / dst[f]: field f's int32 rows of `row[f]` elements per view
struct Fields {
  const int* src[MAX_FIELDS];
  int* dst[MAX_FIELDS];
  long long row[MAX_FIELDS];
};

__device__ __forceinline__ bool accepted_of(
    int v, const unsigned char* block_exists,
    const unsigned char* buffer_filled, const int* node_round, int base,
    const unsigned char* active, int n, int w) {
  const int r = node_round[v];
  const int s = floor_mod(r, w);
  return !block_exists[s * n + v] && !buffer_filled[s * n + v] && r >= base &&
         r < wrap_add(base, w) && (active == nullptr || active[v]);
}

__global__ void accept_kernel(Fields t, int nfields,
                              const unsigned char* __restrict__ block_exists,
                              const unsigned char* __restrict__ buffer_filled,
                              const int* __restrict__ node_round,
                              const int* __restrict__ base_round,
                              const unsigned char* __restrict__ active,
                              unsigned char* __restrict__ accepted,
                              int* __restrict__ pre_round, int n, int w,
                              long long b) {
  const int base = *base_round;
  const long long total = (long long)n * b;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int v = (int)(i / b);
    const bool ok = accepted_of(v, block_exists, buffer_filled, node_round,
                                base, active, n, w);
    for (int f = 0; f < nfields; ++f) t.dst[f][i] = ok ? t.src[f][i] : 0;
  }
  if (blockIdx.x == 0) {
    for (int v = threadIdx.x; v < n; v += blockDim.x) {
      accepted[v] = accepted_of(v, block_exists, buffer_filled, node_round,
                                base, active, n, w);
      pre_round[v] = node_round[v];
    }
  }
}

// t.src[f]: the captured batch [N, row]; t.dst[f]: the ring [W, N, row]
__global__ void board_kernel(Fields t, int nfields,
                             const unsigned char* __restrict__ accepted,
                             const int* __restrict__ pre_round,
                             unsigned char* __restrict__ buffer_filled,
                             unsigned char* __restrict__ prosp_applied, int n,
                             int w) {
  const int v = blockIdx.y;
  if (!accepted[v]) return;
  const int s = floor_mod(pre_round[v], w);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int f = 0; f < nfields; ++f) {
    const long long row = t.row[f];
    const int* src = t.src[f] + (long long)v * row;
    int* dst = t.dst[f] + ((long long)s * n + v) * row;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < row; j += stride)
      dst[j] = src[j];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    buffer_filled[s * n + v] = 1;
    prosp_applied[((long long)v * w + s) * n + v] = 1;
  }
}

Fields fields_of(const void* const* src, const void* const* dst,
                 const long long* row, int nfields) {
  Fields t = {};
  for (int f = 0; f < nfields; ++f) {
    t.src[f] = (const int*)src[f];
    t.dst[f] = (int*)dst[f];
    t.row[f] = row[f];
  }
  return t;
}

}  // namespace

// src, dst: `nfields` (<= 16) int32 [N, B] batches (the caller's fields,
// and the accepted-op buffers); block_exists, buffer_filled bool[W, N];
// node_round int32[N]; base_round int32[] (read on the device); active
// bool[N] or null; accepted bool[N] and pre_round int32[N] (outputs). All
// contiguous on one device. Returns the launch's CUDA error.
extern "C" int safekv_accept_launch(const void* const* src,
                                    const void* const* dst, int nfields,
                                    const void* block_exists,
                                    const void* buffer_filled,
                                    const void* node_round,
                                    const void* base_round, const void* active,
                                    void* accepted, void* pre_round, int n,
                                    int w, long long b, void* stream) {
  if (n <= 0 || nfields < 0 || nfields > MAX_FIELDS)
    return (int)cudaErrorInvalidValue;
  long long rows[MAX_FIELDS];
  for (int f = 0; f < nfields; ++f) rows[f] = b;
  const Fields t = fields_of(src, dst, rows, nfields);
  const int threads = 256;
  long long blocks = ((long long)n * b + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 1024) blocks = 1024;
  accept_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      t, nfields, (const unsigned char*)block_exists,
      (const unsigned char*)buffer_filled, (const int*)node_round,
      (const int*)base_round, (const unsigned char*)active,
      (unsigned char*)accepted, (int*)pre_round, n, w, b);
  return (int)cudaGetLastError();
}

// src: `nfields` (<= 16) captured int32 fields [N, row[f]]; dst: the ring
// fields [W, N, row[f]], written in place; accepted bool[N]; pre_round
// int32[N]; buffer_filled bool[W, N] and prosp_applied bool[N, W, N], set
// in place. Returns the launch's CUDA error.
extern "C" int safekv_board_launch(const void* const* src,
                                   const void* const* dst,
                                   const long long* row, int nfields,
                                   const void* accepted, const void* pre_round,
                                   void* buffer_filled, void* prosp_applied,
                                   int n, int w, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nfields < 0 || nfields > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  const Fields t = fields_of(src, dst, row, nfields);
  long long longest = 1;
  for (int f = 0; f < nfields; ++f) longest = row[f] > longest ? row[f] : longest;
  const int threads = 256;
  long long bx = (longest + threads * 4 - 1) / (threads * 4);
  if (bx > 64) bx = 64;
  const dim3 grid((unsigned)bx, (unsigned)n);
  board_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      t, nfields, (const unsigned char*)accepted, (const int*)pre_round,
      (unsigned char*)buffer_filled, (unsigned char*)prosp_applied, n, w);
  return (int)cudaGetLastError();
}
