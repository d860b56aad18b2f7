// orset_compact: the OR-Set's compaction of tombstoned slots, one row per
// block, behind the GC fence's counter watermark.
//
// Replaces: janus_tpu/models/orset.py compact (503-532) and compact_fence
// (538-568), vmapped over the views. Two entry points:
// - orset_watermark: wm = min over the live ring's lanes of (op == OP_ADD ?
//   a2 : SENTINEL), written to wm[0] on the device (never read by the host).
//   Blocks take grid-stride shares and write their minima to scratch; the
//   last block to finish (a ticket counter it resets to 0) reduces them.
// - orset_compact: per row, keep = valid & (!removed | protect | tag_ctr >=
//   wm), protect and wm each optional; the kept slots move to the front in
//   their order (a stable partition) with removed & keep, the rest are
//   filled canonically (SENTINEL tags, elem 0, removed and valid false).
//
// What bounds it on the H100: bytes. The watermark reads the ring's op and
// a2 once (at harness preset orset, 8 x 16 x 5,120 lanes: 5.2 MB); the
// compaction reads and writes each slot once (14 bytes a slot; at preset
// orset 16 views x 1,000 keys x 64 slots, 14.3 MB each way per state).
// Two states and the ring: ~62 MB, ~19 us at 3.35 TB/s.
//
// Design: the compaction stages its row in shared memory (so the output
// may alias the input), takes the keep flags a tile of THREADS slots at a
// time and places each kept slot by a ballot prefix count. Launches on the
// caller's stream, allocate nothing, do not synchronise.
#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 128;
constexpr int WM_THREADS = 256;
constexpr int WM_BLOCKS = 264;
constexpr int OP_ADD = 1;

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the block's minimum of v, to every thread
__device__ int block_min(int v) {
  __shared__ int part[WM_THREADS / 32];
  __shared__ int total;
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = SENT;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = min(m, part[w]);
    total = m;
  }
  __syncthreads();
  const int out = total;
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(WM_THREADS)
watermark_kernel(const int* __restrict__ op, const int* __restrict__ a2,
                 long long n, int* partial, unsigned* ticket, int* wm) {
  __shared__ bool last;
  int m = SENT;
  for (long long i = (long long)blockIdx.x * WM_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * WM_THREADS)
    if (op[i] == OP_ADD) m = min(m, a2[i]);
  m = block_min(m);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = m;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  int r = SENT;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += WM_THREADS)
    r = min(r, ((volatile int*)partial)[b]);
  r = block_min(r);
  if (threadIdx.x == 0) {
    *wm = r;
    *ticket = 0;  // ready for the next launch
  }
}

struct Fields {
  int* tag_rep;
  int* tag_ctr;
  int* elem;
  unsigned char* removed;
  unsigned char* valid;
};

__global__ void __launch_bounds__(THREADS)
compact_kernel(Fields in, Fields out, const unsigned char* protect,
               const int* wm, long long rows, int C) {
  extern __shared__ int smem[];
  int* rep = smem;
  int* ctr = rep + C;
  int* elem = ctr + C;
  unsigned char* removed = (unsigned char*)(elem + C);
  unsigned char* valid = removed + C;
  unsigned char* pin = valid + C;
  const int tid = threadIdx.x;
  const bool use_wm = wm != nullptr;
  const int w = use_wm ? *wm : 0;

  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * C;
    for (int c = tid; c < C; c += THREADS) {
      rep[c] = in.tag_rep[base + c];
      ctr[c] = in.tag_ctr[base + c];
      elem[c] = in.elem[base + c];
      removed[c] = in.removed[base + c];
      valid[c] = in.valid[base + c];
      pin[c] = protect ? protect[base + c] : 0;
    }
    __syncthreads();
    int kept = 0;
    for (int c0 = 0; c0 < C; c0 += THREADS) {
      const int c = c0 + tid;
      const bool k = c < C && valid[c] &&
                     (!removed[c] || pin[c] || (use_wm && ctr[c] >= w));
      int n;
      const int at = block_count_before(k, &n);
      if (k) {
        const long long o = base + kept + at;
        out.tag_rep[o] = rep[c];
        out.tag_ctr[o] = ctr[c];
        out.elem[o] = elem[c];
        out.removed[o] = removed[c] != 0;
        out.valid[o] = 1;
      }
      kept += n;
    }
    for (int s = kept + tid; s < C; s += THREADS) {
      const long long o = base + s;
      out.tag_rep[o] = SENT;
      out.tag_ctr[o] = SENT;
      out.elem[o] = 0;
      out.removed[o] = 0;
      out.valid[o] = 0;
    }
    __syncthreads();
  }
}

Fields fields_of(void* const* p) {
  return Fields{(int*)p[0], (int*)p[1], (int*)p[2], (unsigned char*)p[3],
                (unsigned char*)p[4]};
}

}  // namespace

// op, a2: int32 [n], the live ring's lanes; partial: int32 scratch
// [orset_watermark_blocks()]; ticket: a uint32 that is 0 (left 0); wm:
// int32 [1]. Contiguous on one device. Returns the launch's CUDA error.
extern "C" int orset_watermark_launch(const void* op, const void* a2,
                                      long long n, void* partial,
                                      void* ticket, void* wm, void* stream) {
  long long blocks = (n + WM_THREADS - 1) / WM_THREADS;
  blocks = blocks < 1 ? 1 : (blocks > WM_BLOCKS ? WM_BLOCKS : blocks);
  watermark_kernel<<<(unsigned)blocks, WM_THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const int*)op, (const int*)a2, n, (int*)partial, (unsigned*)ticket,
      (int*)wm);
  return (int)cudaGetLastError();
}

extern "C" int orset_watermark_blocks() { return WM_BLOCKS; }

// in, out: five field pointers (tag_rep, tag_ctr, elem int32; removed,
// valid bool) of [rows, C]; out may equal in. protect: bool [rows, C] or
// null; wm: int32 [1] on the device, or null. Contiguous on one device.
// Returns the launch's CUDA error.
extern "C" int orset_compact_launch(void* const* in, void* const* out,
                                    const void* protect, const void* wm,
                                    long long rows, int C, void* stream) {
  if (rows <= 0 || C <= 0) return (int)cudaSuccess;
  const size_t bytes = (size_t)C * (3 * sizeof(int) + 3);
  cudaError_t err = allow_shared(compact_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = rows < 132LL * 64 ? rows : 132LL * 64;
  compact_kernel<<<(unsigned)grid, THREADS, bytes, (cudaStream_t)stream>>>(
      fields_of(in), fields_of(out), (const unsigned char*)protect,
      (const int*)wm, rows, C);
  return (int)cudaGetLastError();
}
