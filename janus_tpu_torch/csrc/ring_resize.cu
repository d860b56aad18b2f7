// ring_resize: SafeKV's op ring resized along its block axis, [W, N, B(,
// width)] -> [W, N, B'(, width)], for every field of the ring in one launch.
//
// Replaces janus_tpu/runtime/safecrdt.py SafeKV.resize_block (744-795): the
// grow's jnp.pad of axis 2, and the shrink's host fetch of op[:, :, B':] with
// its check that no tail lane is live (op != OP_NOOP) before the slice. Here
// the check is reduced on the card to one int32 flag, so the host reads 4
// bytes where the JAX package fetched the whole tail.
//
// Layout: a field is W * N rows ("rows"), each a contiguous run of B * width
// int32 in the old ring and B' * width in the new one (width 1 for the six op
// fields, the extra's width for a capture extra). One block copies one
// (row, field): new[j] = j < B * width ? old[j] : 0 over j < B' * width,
// coalesced on both sides, no division per element. On a shrink the block
// of the flag field (the op field) also reads op's tail lanes [B', B) of its
// row and stores 1 into *flag if one is not OP_NOOP (every writer stores the
// same value; the wrapper zeroes the flag first).
//
// Bound on the H100 by bytes: the kept prefix of every field read once (and
// op's tail on a shrink), the new ring written once: ~47 MB for the OR-Set
// ring of the adaptive presets (W 8, N 16, B 5,120, 72 bytes a lane), ~0.03
// ms at 3.35 TB/s. A row is thousands of int32, so a block streams it with
// 256 threads; rows x fields blocks fill the card.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_FIELDS = 16;
constexpr int THREADS = 256;

struct Table {
  const int* src[MAX_FIELDS];
  int* dst[MAX_FIELDS];
  long long width[MAX_FIELDS];
};

__global__ void __launch_bounds__(THREADS)
resize_kernel(Table t, long long rows, int old_b, int new_b, int flag_field,
              int* __restrict__ flag) {
  const int f = blockIdx.y;
  const long long width = t.width[f];
  const long long old_row = (long long)old_b * width;
  const long long new_row = (long long)new_b * width;
  const long long keep = old_row < new_row ? old_row : new_row;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const int* __restrict__ src = t.src[f] + row * old_row;
    int* __restrict__ dst = t.dst[f] + row * new_row;
    for (long long j = threadIdx.x; j < keep; j += THREADS) dst[j] = src[j];
    for (long long j = keep + threadIdx.x; j < new_row; j += THREADS)
      dst[j] = 0;
    if (f == flag_field && new_b < old_b) {
      int live = 0;
      for (long long j = new_row + threadIdx.x; j < old_row; j += THREADS)
        live |= src[j] != 0;  // OP_NOOP is 0
      if (live) *flag = 1;
    }
  }
}

}  // namespace

// src / dst: nfields pointers to int32 rings of rows * old_b * width[f] and
// rows * new_b * width[f] elements; flag_field: the index of the op field
// whose tail is checked on a shrink (-1: none); flag: int32[1], zeroed by
// the caller. Returns the launch's CUDA error.
extern "C" int ring_resize_launch(void* const* src, void* const* dst,
                                  const long long* width, int nfields,
                                  long long rows, int old_b, int new_b,
                                  int flag_field, void* flag, void* stream) {
  if (nfields <= 0 || rows <= 0) return (int)cudaSuccess;
  if (nfields > MAX_FIELDS || old_b <= 0 || new_b <= 0)
    return (int)cudaErrorInvalidValue;
  Table t = {};
  for (int f = 0; f < nfields; ++f) {
    t.src[f] = (const int*)src[f];
    t.dst[f] = (int*)dst[f];
    t.width[f] = width[f];
  }
  const long long bx = rows < 65535 ? rows : 65535;
  const dim3 grid((unsigned)bx, (unsigned)nfields);
  resize_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      t, rows, old_b, new_b, flag_field, (int*)flag);
  return (int)cudaGetLastError();
}
