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
// fields, the extra's width for a capture extra): new[j] = j < B * width ?
// old[j] : 0 over j < B' * width. On a shrink the flag field (the op field)
// also has its tail lanes [B', B) of each row read, and 1 is stored into
// *flag if one is not OP_NOOP (every writer stores the same value; the
// launch zeroes the flag first, by a 4-byte memset on the stream; a grow,
// which checks nothing, has its first block write the 0).
//
// Bound on the H100 by bytes: the kept prefix of every field read once (and
// op's tail on a shrink), the new ring written once: ~48.5 MB for the
// OR-Set ring of the adaptive presets (W 8, N 16, B 5,120 halved, 72 bytes
// a lane), ~0.0145 ms at 3.35 TB/s.
//
// Design: the work is cut into chunks of CHUNK int32 of one row of one
// field (a row's span: its new length, or for the flag field on a shrink
// its old one, tail included), numbered field by field, so that every
// chunk is the same size whatever the field's width and the grid holds
// many more chunks than the card has SMs (2,048 for that ring). A block
// takes chunks grid-stride; each thread moves 4 int4 of a chunk, its
// loads all issued before its stores. A run of a chunk (the copy, the
// zeros, the tail check) is moved by 16-byte loads and stores between a
// scalar head (up to the first 16-byte boundary) and a scalar tail, when
// its source and destination share their alignment (a row of a multiple
// of 4 int32, as the adaptive presets' B are); else by scalar loads.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int MAX_FIELDS = 16;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;                     // int4 a thread a chunk
constexpr int CHUNK = 4 * THREADS * UNROLL;  // int32 a chunk

struct Table {
  const int* src[MAX_FIELDS];
  int* dst[MAX_FIELDS];
  long long old_row[MAX_FIELDS];  // int32 a row, old ring
  long long new_row[MAX_FIELDS];  // int32 a row, new ring
  long long span[MAX_FIELDS];     // int32 of a row the chunks cover
  long long chunks[MAX_FIELDS];   // chunks a row
  long long before[MAX_FIELDS + 1];  // chunks of the fields before
  int nfields;
};

__device__ __forceinline__ int head_of(const int* p, long long n) {
  const int h = (int)(((16 - ((uintptr_t)p & 15)) & 15) >> 2);
  return n < h ? (int)n : h;
}

// dst[j] = src[j] for j in [a, b)
__device__ void copy_run(const int* __restrict__ src, int* __restrict__ dst,
                         long long a, long long b) {
  if (b <= a) return;
  const int tid = threadIdx.x;
  if ((((uintptr_t)(src + a)) ^ ((uintptr_t)(dst + a))) & 15) {
    for (long long j = a + tid; j < b; j += THREADS) dst[j] = src[j];
    return;
  }
  const int h = head_of(dst + a, b - a);
  if (tid < h) dst[a + tid] = src[a + tid];
  const long long body = a + h, n4 = (b - body) >> 2;
  const int4* s4 = reinterpret_cast<const int4*>(src + body);
  int4* d4 = reinterpret_cast<int4*>(dst + body);
  for (long long q0 = 0; q0 < n4; q0 += THREADS * UNROLL) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long q = q0 + tid + u * THREADS;
      if (q < n4) v[u] = s4[q];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long q = q0 + tid + u * THREADS;
      if (q < n4) d4[q] = v[u];
    }
  }
  const long long tail = body + 4 * n4;
  if (tail + tid < b) dst[tail + tid] = src[tail + tid];
}

// dst[j] = 0 for j in [a, b)
__device__ void zero_run(int* __restrict__ dst, long long a, long long b) {
  if (b <= a) return;
  const int tid = threadIdx.x;
  const int h = head_of(dst + a, b - a);
  if (tid < h) dst[a + tid] = 0;
  const long long body = a + h, n4 = (b - body) >> 2;
  int4* d4 = reinterpret_cast<int4*>(dst + body);
  for (long long q = tid; q < n4; q += THREADS) d4[q] = make_int4(0, 0, 0, 0);
  const long long tail = body + 4 * n4;
  if (tail + tid < b) dst[tail + tid] = 0;
}

// whether src[j] != 0 for some j in [a, b) among this thread's
__device__ bool live_run(const int* __restrict__ src, long long a,
                         long long b) {
  if (b <= a) return false;
  const int tid = threadIdx.x;
  const int h = head_of(src + a, b - a);
  bool live = tid < h && src[a + tid] != 0;
  const long long body = a + h, n4 = (b - body) >> 2;
  const int4* s4 = reinterpret_cast<const int4*>(src + body);
  for (long long q = tid; q < n4; q += THREADS) {
    const int4 x = s4[q];
    live |= (x.x | x.y | x.z | x.w) != 0;
  }
  const long long tail = body + 4 * n4;
  return live || (tail + tid < b && src[tail + tid] != 0);
}

__global__ void __launch_bounds__(THREADS)
    resize_kernel(Table t, int flag_field, bool zero_flag,
                  int* __restrict__ flag) {
  const long long total = t.before[t.nfields];
  // a grow checks no tail: the flag is 0, and no block writes another value
  if (zero_flag && blockIdx.x == 0 && threadIdx.x == 0) *flag = 0;
  for (long long c = blockIdx.x; c < total; c += gridDim.x) {
    int f = 0;
    while (c >= t.before[f + 1]) ++f;
    const long long k = c - t.before[f];
    const long long row = k / t.chunks[f];
    const long long lo = (k - row * t.chunks[f]) * CHUNK;
    const long long hi = min(lo + CHUNK, t.span[f]);
    const long long old_row = t.old_row[f], new_row = t.new_row[f];
    const long long keep = min(old_row, new_row);
    const int* src = t.src[f] + row * old_row;
    int* dst = t.dst[f] + row * new_row;
    copy_run(src, dst, lo, min(hi, keep));
    zero_run(dst, max(lo, keep), min(hi, new_row));
    if (f == flag_field && live_run(src, max(lo, new_row), min(hi, old_row)))
      *flag = 1;  // OP_NOOP is 0
  }
}

}  // namespace

// table: 3 * nfields int64, the fields' source pointers (int32 rings of
// rows * old_b * width[f]), their destination pointers (rows * new_b *
// width[f]) and their widths; flag_field: the index of the op field whose
// tail is checked on a shrink (-1: none); flag: int32[1], zeroed here (by
// a 4-byte memset before a shrink's launch, by the kernel on a grow).
// Returns the first CUDA error of the memset and the launch.
extern "C" int ring_resize_launch(const long long* table, int nfields,
                                  long long rows, int old_b, int new_b,
                                  int flag_field, void* flag, void* stream) {
  if (nfields > MAX_FIELDS || nfields < 0 || old_b <= 0 || new_b <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool shrink = new_b < old_b && flag_field >= 0;
  if (shrink || nfields == 0 || rows <= 0) {
    const cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
    if (err != cudaSuccess || nfields == 0 || rows <= 0) return (int)err;
  }
  Table t = {};
  t.nfields = nfields;
  for (int f = 0; f < nfields; ++f) {
    const long long width = table[2 * nfields + f];
    t.src[f] = (const int*)table[f];
    t.dst[f] = (int*)table[nfields + f];
    t.old_row[f] = old_b * width;
    t.new_row[f] = new_b * width;
    t.span[f] = f == flag_field && new_b < old_b ? t.old_row[f]
                                                 : t.new_row[f];
    t.chunks[f] = (t.span[f] + CHUNK - 1) / CHUNK;
    t.before[f + 1] = t.before[f] + rows * t.chunks[f];
  }
  const long long total = t.before[nfields];
  const long long grid =
      total < 1 ? 1 : (total < 132LL * 64 ? total : 132LL * 64);
  resize_kernel<<<(unsigned)grid, THREADS, 0, s>>>(t, flag_field, !shrink,
                                                   (int*)flag);
  return (int)cudaGetLastError();
}
