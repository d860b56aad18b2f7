// orset_compact: the OR-Set's compaction of tombstoned slots behind the
// GC fence's counter watermark, a warp a row.
//
// Replaces: janus_tpu/models/orset.py compact (503-532) and compact_fence
// (538-568), vmapped over the views. Three entry points:
// - orset_watermark: wm = min over the live ring's lanes of (op == OP_ADD ?
//   a2 : SENTINEL), written to wm[0] on the device (never read by the host).
//   Blocks take grid-stride shares (QUADS steps of four lanes a thread,
//   op and a2 each one 16-byte load a step) and write their minima to
//   scratch; the last block to finish (a ticket counter it resets to 0)
//   reduces them.
// - orset_compact: per row, keep = valid & (!removed | protect | tag_ctr >=
//   wm), protect and wm each optional; the kept slots move to the front in
//   their order (a stable partition) with removed & keep, the rest are
//   filled canonically (SENTINEL tags, elem 0, removed and valid false).
// - orset_compact_fences: one GC advance, in place: the watermark, then
//   one compaction grid over the rows of every state given (SafeKV's
//   prospective and stable), launched by programmatic dependent launch.
//
// What bounds it on the H100: bytes. The watermark reads the ring's op and
// a2 once (at harness preset orset, 8 x 16 x 5,120 lanes: 5.2 MB); the
// compaction reads each slot once (14 bytes a slot; at preset orset 16
// views x 1,000 keys x 64 slots, 14.3 MB a state) and writes the rows it
// changes (in a preset orset run, none after its first advance).
//
// Design: a warp a row. A row of C <= 256 slots is held in registers, K
// = 1, 2, 4 or 8 slots a lane (lane L holds slots [L K, L K + K), read by
// K-int and K-byte vector loads where the row and the pointers allow);
// a slot's place among the kept is the count of kept slots of the lower
// lanes (a ballot a register slot, popcounts under the lane mask) and of
// its own lower slots. In place, a row that compacting would leave bit for
// bit as it is (every kept slot already at its place, every other slot
// the canonical fill) is not written; a fresh output gets every row. A
// longer row is read whole into shared memory by its warp, 32 slots a
// step, before any of it is written (the output may alias the input).
// In the fused call the watermark grid leaves a minimum a block and no
// ticket; the compaction's warps read their rows while it runs, and only
// a row with a valid, removed, unpinned slot (whose keep test reads the
// watermark) waits for it (griddepcontrol.wait) and reduces the minima:
// the others are compacted, or left, at once. Launches on the caller's
// stream, allocate nothing, do not synchronise.
#include <cuda_runtime.h>

#include "dag_masks.cuh"
#include "slot_sort.cuh"

namespace {

using slot_sort::SENT;
using slot_sort::allow_shared;
using dag_masks::nibble;

constexpr int WM_THREADS = 256;
constexpr int WM_BLOCKS = 1024;
constexpr int QUADS = 4;  // four-lane steps a watermark thread has in flight
constexpr int OP_ADD = 1;
constexpr int WARPS = 8;           // rows a block of the register kernel
constexpr int MAX_K = 8;           // slots a lane: rows up to 32 * MAX_K
constexpr int LONG_WARPS = 4;      // rows a block of the staged kernel
constexpr int MAX_STATES = 4;
constexpr unsigned FULL = 0xffffffffu;
// flags: write only changed rows; wait for the watermark's grid; the row
// and the pointers allow vector loads
enum { IN_PLACE = 1, WAIT = 2, VEC = 4 };

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(FULL, v, o));
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

// the minimum of (op == OP_ADD ? a2 : SENT) over n lanes: each block's
// into partial[block]; with a ticket, the last block to finish (taking
// the ticket, which it resets to 0) reduces them into wm[0]
__global__ void __launch_bounds__(WM_THREADS)
watermark_kernel(const int* __restrict__ op, const int* __restrict__ a2,
                 long long n, int* partial, unsigned* ticket, int* wm) {
  // a compaction launched behind this grid may start its loads now
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ bool last;
  int m = SENT;
  // QUADS steps of four lanes a thread, op and a2 each one 16-byte load
  // a step where both allow, every load issued before the first min
  const bool vec = (((size_t)op | (size_t)a2) & 15) == 0;
  const long long quads = vec ? n >> 2 : 0;
  const long long step = (long long)gridDim.x * WM_THREADS;
  const long long first = (long long)blockIdx.x * WM_THREADS + threadIdx.x;
  for (long long i0 = first; i0 < quads; i0 += QUADS * step) {
    int4 o[QUADS], a[QUADS];
#pragma unroll
    for (int k = 0; k < QUADS; ++k) {
      const long long i = i0 + k * step;
      o[k] = i < quads ? __ldg((const int4*)op + i) : make_int4(0, 0, 0, 0);
      a[k] = i < quads ? __ldg((const int4*)a2 + i) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < QUADS; ++k)
      m = min(m, min(min(o[k].x == OP_ADD ? a[k].x : SENT,
                         o[k].y == OP_ADD ? a[k].y : SENT),
                     min(o[k].z == OP_ADD ? a[k].z : SENT,
                         o[k].w == OP_ADD ? a[k].w : SENT)));
  }
  for (long long i = 4 * quads + first; i < n; i += step) {
    const int o = __ldg(op + i), a = __ldg(a2 + i);
    m = min(m, o == OP_ADD ? a : SENT);
  }
  m = block_min(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
  if (!ticket) return;
  if (threadIdx.x == 0) {
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
  int* rep;
  int* ctr;
  int* elem;
  unsigned char* removed;
  unsigned char* valid;
};

// up to MAX_STATES states of [rows, C] slots, their rows numbered one
// after the other: state s holds rows [first[s], first[s + 1])
struct Table {
  Fields f[MAX_STATES];
  long long first[MAX_STATES + 1];
  int states;
};

// row g's state (selects over the parameters: no array of them is
// indexed at run time), its fields and its first slot
__device__ __forceinline__ void row_of(const Table& in, const Table& out,
                                       long long g, int C, Fields* src,
                                       Fields* dst, long long* at) {
  *src = in.f[0];
  *dst = out.f[0];
  long long first = 0;
#pragma unroll
  for (int s = 1; s < MAX_STATES; ++s)
    if (s < in.states && g >= in.first[s]) {
      *src = in.f[s];
      *dst = out.f[s];
      first = in.first[s];
    }
  *at = (g - first) * C;
}

// K int32 from p (m of them in the row), by vector loads where allowed
template <int K>
__device__ __forceinline__ void load_ints(const int* p, int m, bool vec,
                                          int (&x)[K]) {
  if (vec && m == K) {
    if constexpr (K == 1) {
      x[0] = __ldg(p);
    } else if constexpr (K == 2) {
      const int2 v = __ldg((const int2*)p);
      x[0] = v.x;
      x[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < K; i += 4) {
        const int4 v = __ldg((const int4*)(p + i));
        x[i] = v.x;
        x[i + 1] = v.y;
        x[i + 2] = v.z;
        x[i + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = i < m ? __ldg(p + i) : 0;
  }
}

// bit i: byte i of p (m of them in the row) is not zero
template <int K>
__device__ __forceinline__ unsigned load_bits(const unsigned char* p, int m,
                                              bool vec) {
  if (vec && m == K) {
    if constexpr (K == 1) {
      return __ldg(p) != 0;
    } else if constexpr (K == 2) {
      return nibble(__ldg((const unsigned short*)p));
    } else if constexpr (K == 4) {
      return nibble(__ldg((const unsigned*)p));
    } else {
      const uint2 v = __ldg((const uint2*)p);
      return nibble(v.x) | nibble(v.y) << 4;
    }
  }
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (i < m && __ldg(p + i)) bits |= 1u << i;
  return bits;
}

__device__ __forceinline__ void put(const Fields& o, long long at, int rep,
                                    int ctr, int elem, bool removed,
                                    bool valid) {
  o.rep[at] = rep;
  o.ctr[at] = ctr;
  o.elem[at] = elem;
  o.removed[at] = removed;
  o.valid[at] = valid;
}

// the watermark, to every lane of the calling warp: after waiting for
// the grid that computes it when `flags` says so, wm[0], or with `parts`
// the least of wm[0, parts) (the watermark grid's minima a block)
__device__ __forceinline__ int watermark(const int* wm, int parts,
                                         int flags) {
  if (flags & WAIT) asm volatile("griddepcontrol.wait;" ::: "memory");
  if (!parts) return wm ? __ldcg(wm) : 0;
  int m = SENT;
  for (int b = threadIdx.x & 31; b < parts; b += 32)
    m = min(m, __ldcg(wm + b));
  return warp_min(m);
}

// one row of C <= 32 K slots in a lane's registers (lane L: slots
// [L K, L K + K)), where it goes, and its place
template <int K>
struct Row {
  int rep[K], ctr[K], elem[K];
  unsigned rm, val, pin;
  Fields dst;
  long long at;
};

template <int K>
__device__ __forceinline__ void load_row(Row<K>& x, const Table& in,
                                         const Table& out,
                                         const unsigned char* protect,
                                         long long g, int C, int c0, int m,
                                         bool vec) {
  Fields src;
  row_of(in, out, g, C, &src, &x.dst, &x.at);
  const long long at = x.at + c0;
  load_ints<K>(src.rep + at, m, vec, x.rep);
  load_ints<K>(src.ctr + at, m, vec, x.ctr);
  load_ints<K>(src.elem + at, m, vec, x.elem);
  x.rm = load_bits<K>(src.removed + at, m, vec);
  x.val = load_bits<K>(src.valid + at, m, vec);
  x.pin = protect ? load_bits<K>(protect + at, m, vec) : 0u;
}

// the row's kept slots to the front, the canonical fill behind them; not
// written when in place and the row would not change
template <int K>
__device__ __forceinline__ void compact_row(const Row<K>& x, bool use_wm,
                                            int w, int c0, int m,
                                            bool in_place) {
  const int lane = threadIdx.x & 31;
  const unsigned live = x.val & (~x.rm | x.pin);
  unsigned keep = 0;
#pragma unroll
  for (int i = 0; i < K; ++i)
    if ((live >> i & 1u) || (use_wm && (x.val >> i & 1u) && x.ctr[i] >= w))
      keep |= 1u << i;
  // kept slots of the lower lanes, and of the row
  const unsigned lower = (1u << lane) - 1u;
  int before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const unsigned b = __ballot_sync(FULL, keep >> i & 1u);
    before += __popc(b & lower);
    total += __popc(b);
  }
  bool same = true;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i >= m) continue;
    if (keep >> i & 1u)
      same &= before + __popc(keep & ((1u << i) - 1u)) == c0 + i;
    else
      same &= !(x.val >> i & 1u) && !(x.rm >> i & 1u) && x.rep[i] == SENT &&
              x.ctr[i] == SENT && x.elem[i] == 0;
  }
  if (in_place && __all_sync(FULL, same)) return;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (keep >> i & 1u)
      put(x.dst, x.at + before + __popc(keep & ((1u << i) - 1u)), x.rep[i],
          x.ctr[i], x.elem[i], x.rm >> i & 1u, true);
    if (i < m && c0 + i >= total)
      put(x.dst, x.at + c0 + i, SENT, SENT, 0, false, false);
  }
}

// a warp a row of C <= 32 K slots, from registers
template <int K>
__global__ void __launch_bounds__(WARPS * 32, 4)
    warp_kernel(Table in, Table out, const unsigned char* protect,
                const int* wm, int parts, long long rows, int C, int flags) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int c0 = lane * K;
  const int m = max(0, min(K, C - c0));
  if (g >= rows) return;  // the whole warp
  Row<K> x;
  load_row(x, in, out, protect, g, C, c0, m, flags & VEC);
  // only a row with a valid, removed, unpinned slot needs the watermark;
  // the others neither wait for it nor read it
  const bool needs =
      wm && __any_sync(FULL, (x.val & x.rm & ~x.pin) != 0);
  const int w = needs ? watermark(wm, parts, flags) : 0;
  compact_row(x, needs, w, c0, m, flags & IN_PLACE);
}

// the int32 a warp of the staged kernel holds in shared memory: three
// int32 a slot, and a byte of flags (removed, valid, protect)
__host__ __device__ __forceinline__ long long staged_ints(int C) {
  return 3LL * C + (C + 3) / 4;
}

// a warp a row of any length, read whole into shared memory first
__global__ void __launch_bounds__(LONG_WARPS * 32)
    staged_kernel(Table in, Table out, const unsigned char* protect,
                  const int* wm, int parts, long long rows, int C,
                  int flags) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * (blockDim.x >> 5) + wid;
  int* rep = smem + wid * staged_ints(C);
  int* ctr = rep + C;
  int* elem = ctr + C;
  unsigned char* fl = (unsigned char*)(elem + C);
  Fields src, dst;
  long long at = 0;
  if (g < rows) {
    row_of(in, out, g, C, &src, &dst, &at);
    for (int c = lane; c < C; c += 32) {
      rep[c] = __ldg(src.rep + at + c);
      ctr[c] = __ldg(src.ctr + at + c);
      elem[c] = __ldg(src.elem + at + c);
      fl[c] = (__ldg(src.removed + at + c) != 0) |
              (__ldg(src.valid + at + c) != 0) << 1 |
              (protect && __ldg(protect + at + c) != 0) << 2;
    }
  }
  if (g >= rows) return;  // the whole warp
  const int w = watermark(wm, parts, flags);
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  auto keep_of = [&](int c) {
    const unsigned x = fl[c];
    return (x & 2u) && (!(x & 1u) || (x & 4u) || (wm && ctr[c] >= w));
  };
  int kept = 0;
  bool same = true;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const bool k = c < C && keep_of(c);
    const unsigned b = __ballot_sync(FULL, k);
    if (c < C)
      same &= k ? kept + __popc(b & lower) == c
                : (fl[c] & 3u) == 0 && rep[c] == SENT && ctr[c] == SENT &&
                      elem[c] == 0;
    kept += __popc(b);
  }
  if ((flags & IN_PLACE) && __all_sync(FULL, same)) return;
  int placed = 0;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const bool k = c < C && keep_of(c);
    const unsigned b = __ballot_sync(FULL, k);
    if (k)
      put(dst, at + placed + __popc(b & lower), rep[c], ctr[c], elem[c],
          fl[c] & 1u, true);
    placed += __popc(b);
  }
  for (int c = kept + lane; c < C; c += 32)
    put(dst, at + c, SENT, SENT, 0, false, false);
}

Fields fields_of(void* const* p) {
  return Fields{(int*)p[0], (int*)p[1], (int*)p[2], (unsigned char*)p[3],
                (unsigned char*)p[4]};
}

// slots a lane of the register kernel at C (0: the staged kernel)
int lane_slots(int C) {
  for (int k = 1; k <= MAX_K; k *= 2)
    if (C <= 32 * k) return k;
  return 0;
}

// the staged kernel's rows a block at C, within the card's shared memory
int staged_warps(int C) {
  const long long per = 4 * staged_ints(C);
  const long long fit = 232448 / per;
  return (int)(fit < 1 ? 1 : fit > LONG_WARPS ? LONG_WARPS : fit);
}

bool aligned(const void* p, int bytes) { return ((size_t)p & (bytes - 1)) == 0; }

typedef void (*Compact)(Table, Table, const unsigned char*, const int*,
                        int, long long, int, int);

// the compaction of `rows` rows of C slots from in to out, by
// programmatic dependent launch behind the stream's last kernel when
// `wait` (that kernel computes the watermark: wm[0], or the least of
// wm[0, parts))
cudaError_t launch_compact(const Table& in, const Table& out,
                           const unsigned char* protect, const int* wm,
                           int parts, long long rows, int C, bool wait,
                           cudaStream_t stream) {
  int flags = wait ? WAIT : 0;
  bool in_place = true;
  for (int s = 0; s < in.states; ++s) {
    const Fields &a = in.f[s], &b = out.f[s];
    in_place &= a.rep == b.rep && a.ctr == b.ctr && a.elem == b.elem &&
                a.removed == b.removed && a.valid == b.valid;
  }
  if (in_place) flags |= IN_PLACE;
  const int k = lane_slots(C);
  bool vec = k > 0 && C % k == 0 && (!protect || aligned(protect, k));
  for (int s = 0; s < in.states; ++s) {
    const Fields& a = in.f[s];
    vec &= aligned(a.rep, 4 * k) && aligned(a.ctr, 4 * k) &&
           aligned(a.elem, 4 * k) && aligned(a.removed, k) &&
           aligned(a.valid, k);
  }
  if (vec) flags |= VEC;
  const Compact kernel =
      k == 1 ? warp_kernel<1> : k == 2 ? warp_kernel<2>
      : k == 4 ? warp_kernel<4> : k == 8 ? warp_kernel<8> : staged_kernel;
  const int warps = k ? WARPS : staged_warps(C);
  const size_t bytes = k ? 0 : 4 * (size_t)staged_ints(C) * warps;
  if (bytes) {
    const cudaError_t err = allow_shared(staged_kernel, bytes);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + warps - 1) / warps));
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = wait ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, in, out, protect, wm, parts, rows,
                            C, flags);
}

// the watermark grid's blocks for n lanes: QUADS four-lane steps a
// thread, at most WM_BLOCKS
int watermark_blocks(long long n) {
  const long long per = 4LL * QUADS * WM_THREADS;
  const long long blocks = (n + per - 1) / per;
  return (int)(blocks < 1 ? 1 : blocks > WM_BLOCKS ? WM_BLOCKS : blocks);
}

// the watermark grid; a null ticket leaves the block minima in partial
cudaError_t launch_watermark(const int* op, const int* a2, long long n,
                             int* partial, unsigned* ticket, int* wm,
                             cudaStream_t stream) {
  watermark_kernel<<<watermark_blocks(n), WM_THREADS, 0, stream>>>(
      op, a2, n, partial, ticket, wm);
  return cudaGetLastError();
}

}  // namespace

// op, a2: int32 [n], the live ring's lanes; partial: int32 scratch
// [orset_watermark_blocks()]; ticket: a uint32 that is 0 (left 0); wm:
// int32 [1]. Contiguous on one device. Returns the launch's CUDA error.
extern "C" int orset_watermark_launch(const void* op, const void* a2,
                                      long long n, void* partial,
                                      void* ticket, void* wm, void* stream) {
  return (int)launch_watermark((const int*)op, (const int*)a2, n,
                               (int*)partial, (unsigned*)ticket, (int*)wm,
                               (cudaStream_t)stream);
}

extern "C" int orset_watermark_blocks() { return WM_BLOCKS; }

// in, out: five field pointers (tag_rep, tag_ctr, elem int32; removed,
// valid bool) of [rows, C]; out may equal in (in place: only the rows
// that change are written). protect: bool [rows, C] or null; wm: int32
// [1] on the device, or null. Contiguous on one device. Returns the
// launch's CUDA error.
extern "C" int orset_compact_launch(void* const* in, void* const* out,
                                    const void* protect, const void* wm,
                                    long long rows, int C, void* stream) {
  if (rows <= 0 || C <= 0) return (int)cudaSuccess;
  Table ti = {}, to = {};
  ti.f[0] = fields_of(in);
  to.f[0] = fields_of(out);
  ti.first[1] = to.first[1] = rows;
  ti.states = to.states = 1;
  return (int)launch_compact(ti, to, (const unsigned char*)protect,
                             (const int*)wm, 0, rows, C, false,
                             (cudaStream_t)stream);
}

// One GC advance, in place. fields: five field pointers a state (as
// orset_compact_launch's), `states` (<= 4) states of rows[s] rows of C
// slots; op, a2: int32 [lanes], the live ring's; scratch: int32
// [orset_watermark_blocks()], the watermark grid's block minima, which
// each compaction block reduces. Returns the first CUDA error of the two
// launches.
extern "C" int orset_compact_fences_launch(void* const* fields,
                                           const long long* rows, int states,
                                           const void* op, const void* a2,
                                           long long lanes, void* scratch,
                                           int C, void* stream) {
  if (states < 0 || states > MAX_STATES) return (int)cudaErrorInvalidValue;
  Table t = {};
  t.states = states;
  for (int s = 0; s < states; ++s) {
    t.f[s] = fields_of(fields + 5 * s);
    t.first[s + 1] = t.first[s] + rows[s];
  }
  const cudaStream_t st = (cudaStream_t)stream;
  int* parts = (int*)scratch;
  cudaError_t err = launch_watermark((const int*)op, (const int*)a2, lanes,
                                     parts, nullptr, nullptr, st);
  if (err != cudaSuccess || t.first[states] <= 0 || C <= 0) return (int)err;
  return (int)launch_compact(t, t, nullptr, parts, watermark_blocks(lanes),
                             t.first[states], C, true, st);
}
