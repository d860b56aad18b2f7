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
//           buffer (the caller's batch is never written); and a copy of
//           node_round, the slot each batch boards, which later phases of
//           the round change in place.
//   board   writes every field of the captured batch into ring row
//           [slot_of(r_v), v] of each accepted view, in place, and sets
//           buffer_filled[s, v] and prosp_applied[v, s, v].
//
// What bounds it on the H100: bytes. Each entry point moves the op batch
// once (N * B * fields int32) and reads a few bytes of DAG state per view.
//
// Design: both kernels run a block a (view, slice of CHUNK int32 of the
// view's row) in blockIdx.x and a field in blockIdx.y, enough blocks to
// fill the card at B of a thousand and more. An accept block decides its
// view's acceptance once, into shared memory, and writes a rejected
// view's lanes as zeros without reading the batch; a board block returns
// without writing for a rejected view. The decision's loads go out
// together (a warp reads the view's bits at every slot), and a board
// block loads its slice of an aligned row beside them, so each kernel
// waits on memory about twice. Moves are 16-byte loads and stores where
// the source and the destination share their alignment (a scalar head up
// to it and a scalar tail), scalar otherwise: a batch may be a view at
// any int32 offset of a larger tensor, and a row of odd length puts every
// other view's row off the 16-byte grid. No 64-bit division. Round
// arithmetic wraps as int32 and the slot is the floor modulo
// (csrc/dag_masks.cuh). Launches on the caller's stream, allocates
// nothing, does not synchronise.
#include <cuda_runtime.h>

#include "dag_masks.cuh"

namespace {

using namespace dag_masks;

constexpr int MAX_FIELDS = 16;
constexpr int THREADS = 256;
constexpr int CHUNK = 1024;  // the int32 of a row one block moves
static_assert(CHUNK % (4 * THREADS) == 0, "a whole int4 a thread");

struct Accept {
  const int* src[MAX_FIELDS];  // the caller's batch fields, int32 [N, B]
  int* out;                    // field f's accepted ops at out + f * stride
  long long stride;
  const unsigned char *block_exists, *buffer_filled, *active;
  const int *node_round, *base_round;
  unsigned char* accepted;
  int* pre_round;
  int n, w, b, slices;
};

// src[f]: the captured batch [N, row[f]]; dst[f]: the ring [W, N, row[f]];
// slices[f]: the CHUNK slices of a row of field f (at least one)
struct Board {
  const int* src[MAX_FIELDS];
  int* dst[MAX_FIELDS];
  long long row[MAX_FIELDS];
  int slices[MAX_FIELDS];
  const unsigned char* accepted;
  const int* pre_round;
  unsigned char *buffer_filled, *prosp_applied;
  int nfields, n, w, most;  // most: the slices of the longest row
};

// len int32 from src to dst (zeros, unread, if `zero`) by the block:
// 16-byte moves between a scalar head and tail when both ends share
// their alignment
__device__ __forceinline__ void move(int* __restrict__ dst,
                                     const int* __restrict__ src, int len,
                                     bool zero) {
  int head = len;
  if (zero || ((((size_t)dst ^ (size_t)src) & 15) == 0))
    head = min(len, (int)(((16 - ((size_t)dst & 15)) & 15) >> 2));
  const int body = (len - head) >> 2;
  for (int i = threadIdx.x; i < head; i += THREADS) dst[i] = zero ? 0 : src[i];
  int4* d4 = (int4*)(dst + head);
  const int4* s4 = (const int4*)(src + head);
  for (int i = threadIdx.x; i < body; i += THREADS)
    d4[i] = zero ? make_int4(0, 0, 0, 0) : s4[i];
  for (int i = head + 4 * body + threadIdx.x; i < len; i += THREADS)
    dst[i] = zero ? 0 : src[i];
}

// the accept of view v by the block's first warp, every load of the
// decision issued at once: the view's round, the base, active, and the
// view's block_exists and buffer_filled at every slot (W <= 32; above,
// lane 0 reads its slot's after the round)
__device__ __forceinline__ bool accepted_of(const Accept& a, int v, int* r_out) {
  const int lane = threadIdx.x;
  const int r = a.node_round[v], base = *a.base_round;
  const bool act = a.active == nullptr || a.active[v];
  bool taken = false;
  if (a.w <= 32 && lane < a.w)
    taken = a.block_exists[lane * a.n + v] || a.buffer_filled[lane * a.n + v];
  const unsigned busy = __ballot_sync(0xffffffffu, taken);
  const int s = floor_mod(r, a.w);
  const bool blocked =
      a.w <= 32 ? (busy >> s) & 1u
                : a.block_exists[s * a.n + v] || a.buffer_filled[s * a.n + v];
  *r_out = r;
  return !blocked && r >= base && r < wrap_add(base, a.w) && act;
}

__global__ void __launch_bounds__(THREADS) accept_kernel(Accept a) {
  __shared__ bool ok_s;
  const int v = blockIdx.x / a.slices, z = blockIdx.x - v * a.slices;
  const int f = blockIdx.y;
  if (threadIdx.x < 32) {
    int r;
    const bool ok = accepted_of(a, v, &r);
    if (threadIdx.x == 0) {
      ok_s = ok;
      if (z == 0 && f == 0) {
        a.accepted[v] = ok;
        a.pre_round[v] = r;
      }
    }
  }
  __syncthreads();
  const int lo = z * CHUNK;
  const long long at = (long long)v * a.b + lo;
  move(a.out + f * a.stride + at, a.src[f] + at, min(CHUNK, a.b - lo), !ok_s);
}

// a board block: a row whose length is a multiple of 4, with both
// fields' bases 16-byte aligned, has its slice loaded at once beside the
// view's accepted flag and round (the ring row's address waits for the
// round); any other row is moved after them
__global__ void __launch_bounds__(THREADS) board_kernel(Board t) {
  constexpr int PER = CHUNK / 4 / THREADS;  // int4 a thread
  const int v = blockIdx.x / t.most, z = blockIdx.x - v * t.most;
  const int f = blockIdx.y;
  const bool mine = f < t.nfields && z < t.slices[f];
  const long long row = mine ? t.row[f] : 0, lo = (long long)z * CHUNK;
  const int len = (int)(row - lo < CHUNK ? row - lo : CHUNK);
  const bool fast = mine && (row & 3) == 0 &&
                    (((size_t)t.src[f] | (size_t)t.dst[f]) & 15) == 0;
  int4 x[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS;
    x[k] = fast && i < (len >> 2)
               ? ((const int4*)(t.src[f] + (long long)v * row + lo))[i]
               : make_int4(0, 0, 0, 0);
  }
  if (!t.accepted[v]) return;
  const int s = floor_mod(t.pre_round[v], t.w);
  if (mine) {
    int* dst = t.dst[f] + ((long long)s * t.n + v) * row + lo;
    if (fast) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = threadIdx.x + k * THREADS;
        if (i < (len >> 2)) ((int4*)dst)[i] = x[k];
      }
    } else {
      move(dst, t.src[f] + (long long)v * row + lo, len, false);
    }
  }
  if (z == 0 && f == 0 && threadIdx.x == 0) {
    t.buffer_filled[s * t.n + v] = 1;
    t.prosp_applied[((long long)v * t.w + s) * t.n + v] = 1;
  }
}

}  // namespace

// src: `nfields` (<= 16) int32 [N, B] batches (the caller's fields), at
// any int32 offset; out: the output buffer, field f's accepted ops int32
// [N, B] at out + f * stride (int32); block_exists, buffer_filled bool[W,
// N]; node_round int32[N]; base_round int32[] (read on the device);
// active bool[N] or null; accepted bool[N] and pre_round int32[N]
// (outputs). All contiguous on one device. Returns the launch's CUDA
// error.
extern "C" int safekv_accept_launch(const long long* src, int nfields,
                                    void* out, long long stride,
                                    const void* block_exists,
                                    const void* buffer_filled,
                                    const void* node_round,
                                    const void* base_round, const void* active,
                                    void* accepted, void* pre_round, int n,
                                    int w, int b, void* stream) {
  if (n <= 0 || nfields <= 0 || nfields > MAX_FIELDS || b < 0)
    return (int)cudaErrorInvalidValue;
  Accept a = {};
  for (int f = 0; f < nfields; ++f) a.src[f] = (const int*)src[f];
  a.out = (int*)out;
  a.stride = stride;
  a.block_exists = (const unsigned char*)block_exists;
  a.buffer_filled = (const unsigned char*)buffer_filled;
  a.active = (const unsigned char*)active;
  a.node_round = (const int*)node_round;
  a.base_round = (const int*)base_round;
  a.accepted = (unsigned char*)accepted;
  a.pre_round = (int*)pre_round;
  a.n = n;
  a.w = w;
  a.b = b;
  a.slices = b > 0 ? (b + CHUNK - 1) / CHUNK : 1;
  if ((long long)n * a.slices >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(n * a.slices), (unsigned)nfields);
  accept_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// src: `nfields` (<= 16) captured int32 fields [N, row[f]] (per call);
// ring: 2 * nfields int64, the ring fields' addresses [W, N, row[f]]
// (written in place) and then their slot rows' int32 (N * row[f], as
// gc_frontier's ring table); accepted bool[N]; pre_round
// int32[N]; buffer_filled bool[W, N] and prosp_applied bool[N, W, N], set
// in place. Returns the launch's CUDA error.
extern "C" int safekv_board_launch(const long long* src,
                                   const long long* ring, int nfields,
                                   const void* accepted, const void* pre_round,
                                   void* buffer_filled, void* prosp_applied,
                                   int n, int w, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nfields < 0 || nfields > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  Board t = {};
  long long most = 1;
  for (int f = 0; f < nfields; ++f) {
    t.src[f] = (const int*)src[f];
    t.dst[f] = (int*)ring[f];
    t.row[f] = ring[nfields + f] / n;
    const long long slices =
        t.row[f] > 0 ? (t.row[f] + CHUNK - 1) / CHUNK : 1;
    if (slices >= (1LL << 31) / n) return (int)cudaErrorInvalidValue;
    t.slices[f] = (int)slices;
    most = slices > most ? slices : most;
  }
  t.accepted = (const unsigned char*)accepted;
  t.pre_round = (const int*)pre_round;
  t.buffer_filled = (unsigned char*)buffer_filled;
  t.prosp_applied = (unsigned char*)prosp_applied;
  t.nfields = nfields;
  t.n = n;
  t.w = w;
  t.most = (int)most;
  const dim3 grid((unsigned)(n * most), (unsigned)(nfields > 0 ? nfields : 1));
  board_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
