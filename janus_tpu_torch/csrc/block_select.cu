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
// of every ring field, each read once and written once. The selection is
// a few KB per view.
//
// Design: two kernels, the second launched by programmatic dependent
// launch: its blocks start while the first runs and wait for it
// (griddepcontrol), so the pair costs about one launch. select_kernel, a
// block a view (one thread a key), ranks the view's keys: the selectable
// ones (below INT32_MAX) are listed in index order by a block prefix
// count and each is ranked among them by a count of the keys that sort
// before it; a key that is not selectable ranks after all of them, in
// index order. The block writes idx and chosen for ranks below A and ORs
// the choice into `applied`, which only it reads and writes.
// gather_kernel copies the ring rows field by field: a block a slice of
// CHUNK int32 of one output row, or, for rows under CHUNK, a block
// several rows (up to MAX_ROWS, CHUNK int32 in all), reading each row's
// index and choice once; 16-byte loads and stores where the field's rows
// and both bases allow (int32 otherwise), no 64-bit division; the op field
// of an unchosen row written as zeros, unread. Launches on the caller's
// stream, allocates nothing, does not synchronise.
#include <climits>

#include <cuda_runtime.h>

#include "dag_masks.cuh"

namespace {

using namespace dag_masks;

constexpr int MAX_FIELDS = 16;
constexpr int MAX_KEYS = 1024;
constexpr int THREADS = 256;   // a gather block
constexpr int CHUNK = 4096;    // the int32 a gather block copies, at most
constexpr int MAX_ROWS = 64;   // the output rows a gather block copies

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// the ring fields: src[f] int32 [W*N, row[f]]; the batch of field f at
// out + dst[f], int32 [V*A, row[f]]; field f's gather blocks are
// [first[f], first[f + 1]), each `rows[f]` output rows or (rows[f] 1) a
// slice of CHUNK int32 of one row, `slices[f]` a row
struct Table {
  const int* src[MAX_FIELDS];
  long long row[MAX_FIELDS];
  long long dst[MAX_FIELDS];
  int rows[MAX_FIELDS];
  int slices[MAX_FIELDS];
  int first[MAX_FIELDS + 1];
};

struct Select {
  const unsigned char* ready;
  unsigned char* applied;
  const int* seq;
  const int* slot_round;
  const int* base_round;
  int* idx;                // [V, A]
  unsigned char* chosen;   // [V, A]
  int n, w, a;
};

// select: a block a view, a thread a key (blockDim a multiple of 32, at
// least W N): ranks the keys, writes idx, chosen and the view's applied
__global__ void __launch_bounds__(MAX_KEYS) select_kernel(Select s) {
  __shared__ int2 cand[MAX_KEYS];
  __shared__ int warp_n[MAX_KEYS / 32];
  // the gather's blocks may launch now; they wait for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");
  const int v = blockIdx.x, wn = s.w * s.n, j = threadIdx.x;
  const long long off = (long long)v * wn;
  const int lane = j & 31, warp = j >> 5;
  int key = INT_MAX;
  if (j < wn) {
    const int slot = j / s.n, src = j - slot * s.n;
    key = wrap_add(wrap_mul(wrap_sub(s.slot_round[slot], *s.base_round), s.n),
                   src);
    if (s.seq != nullptr) key = wrap_add(wrap_mul(s.seq[off + j], wn), key);
    if (!s.ready[off + j] || s.applied[off + j]) key = INT_MAX;
  }
  // the selectable keys listed in index order
  const bool pick = key < INT_MAX;
  const unsigned ballot = __ballot_sync(0xffffffffu, pick);
  if (lane == 0) warp_n[warp] = __popc(ballot);
  __syncthreads();
  int before = __popc(ballot & ((1u << lane) - 1u)), m = 0;
  for (int q = 0; q < (int)(blockDim.x >> 5); ++q) {
    const int c = warp_n[q];
    before += q < warp ? c : 0;
    m += c;
  }
  if (pick) cand[before] = make_int2(key, j);
  __syncthreads();
  if (j >= wn) return;
  int rank;
  if (pick) {
    rank = 0;
    for (int i = 0; i < m; ++i) {
      const int2 c = cand[i];
      rank += c.x < key || (c.x == key && c.y < j);
    }
  } else {
    rank = m + j - before;  // after every selectable key, in index order
  }
  if (rank < s.a) {
    s.idx[(long long)v * s.a + rank] = j;
    s.chosen[(long long)v * s.a + rank] = pick;
    if (pick) s.applied[off + j] = 1;
  }
}

// the gather: block b of field f (after the select kernel's end)
__global__ void __launch_bounds__(THREADS)
    gather_kernel(Select s, Table t, int* __restrict__ out, int nfields,
                  int op_field, int va) {
  __shared__ int s_j[MAX_ROWS];
  __shared__ bool s_pick[MAX_ROWS];
  int f = 0;
  while (f + 1 < nfields && (int)blockIdx.x >= t.first[f + 1]) ++f;
  const int local = blockIdx.x - t.first[f];
  const long long row = t.row[f];
  const int* __restrict__ ring = t.src[f];
  int* __restrict__ batch = out + t.dst[f];
  const bool vec = (row & 3) == 0 &&
                   (((size_t)ring | (size_t)batch) & 15) == 0;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (t.rows[f] == 1) {  // a slice of one row
    const int slices = t.slices[f];
    const int p = local / slices, z = local - p * slices;
    const int j = s.idx[p];
    const bool zero = f == op_field && !s.chosen[p];
    const long long lo = (long long)z * CHUNK;
    const int n = (int)(row - lo < CHUNK ? row - lo : CHUNK);
    int* __restrict__ dst = batch + (long long)p * row + lo;
    const int* __restrict__ src = ring + (long long)j * row + lo;
    if (vec) {
      int4* d4 = (int4*)dst;
      const int4* s4 = (const int4*)src;
      const int n4 = n >> 2;
      constexpr int UNROLL = CHUNK / 4 / THREADS;
      int4 x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = threadIdx.x + u * THREADS;
        x[u] = zero || i >= n4 ? make_int4(0, 0, 0, 0) : s4[i];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = threadIdx.x + u * THREADS;
        if (i < n4) d4[i] = x[u];
      }
    } else {
      for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = zero ? 0 : src[i];
    }
    return;
  }
  // several whole rows: their indices and choices read once
  const int p0 = local * t.rows[f];
  const int nr = min(t.rows[f], va - p0);
  if ((int)threadIdx.x < nr) {
    s_j[threadIdx.x] = s.idx[p0 + threadIdx.x];
    s_pick[threadIdx.x] = s.chosen[p0 + threadIdx.x];
  }
  __syncthreads();
  const bool op = f == op_field;
  if (vec) {
    const int n4 = (int)(row >> 2), total = nr * n4;
    for (int u = threadIdx.x; u < total; u += THREADS) {
      const int r = u / n4, i = u - r * n4;
      const int4* src = (const int4*)(ring + (long long)s_j[r] * row);
      int4* dst = (int4*)(batch + (long long)(p0 + r) * row);
      dst[i] = op && !s_pick[r] ? make_int4(0, 0, 0, 0) : src[i];
    }
  } else {
    const int n = (int)row, total = nr * n;
    for (int u = threadIdx.x; u < total; u += THREADS) {
      const int r = u / n, i = u - r * n;
      batch[(long long)(p0 + r) * row + i] =
          op && !s_pick[r] ? 0 : ring[(long long)s_j[r] * row + i];
    }
  }
}

}  // namespace

// ready, applied bool[V, W, N] (applied updated in place); seq int32[V, W,
// N] or null (prospective order); slot_round int32[W]; base_round int32[]
// (read on the device); out: one buffer holding every field's batch int32
// [V, A, row[f]] at its offset (in int32) and idx int32[V, A] and chosen
// bool[V, A] (outputs) at `idx_at` and `chosen_at` bytes; table: the
// `nfields` (<= 16) ring fields int32 [W, N, row[f]], 3 * nfields int64
// (the fields' addresses, their rows' int32, their batches' offsets);
// op_field: the index of the op field. All contiguous on one device, W * N
// <= 1,024, A <= W * N. Returns the first CUDA error of the launches.
extern "C" int block_select_launch(
    const void* ready, void* applied, const void* seq, const void* slot_round,
    const void* base_round, void* out, long long idx_at, long long chosen_at,
    const long long* table, int nfields, int op_field, int v, int n, int w,
    int a, void* stream) {
  if (v <= 0 || a <= 0) return (int)cudaSuccess;
  if (w * n > MAX_KEYS || a > w * n || nfields <= 0 ||
      nfields > MAX_FIELDS || op_field < 0 || op_field >= nfields)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  char* base = (char*)out;
  const Select s{(const unsigned char*)ready, (unsigned char*)applied,
                 (const int*)seq, (const int*)slot_round,
                 (const int*)base_round, (int*)(base + idx_at),
                 (unsigned char*)(base + chosen_at), n, w, a};
  const long long va = (long long)v * a;
  Table t = {};
  long long blocks = 0;
  for (int f = 0; f < nfields; ++f) {
    t.src[f] = (const int*)table[f];
    t.row[f] = table[nfields + f];
    t.dst[f] = table[2 * nfields + f];
    const long long row = t.row[f] > 0 ? t.row[f] : 1;
    const long long rows = row >= CHUNK ? 1 : (CHUNK / row < MAX_ROWS ?
                                               CHUNK / row : MAX_ROWS);
    const long long slices = (row + CHUNK - 1) / CHUNK;
    t.rows[f] = (int)rows;
    t.slices[f] = (int)slices;
    t.first[f] = (int)blocks;
    blocks += rows == 1 ? va * slices : (va + rows - 1) / rows;
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  }
  t.first[nfields] = (int)blocks;
  const int threads = ((w * n + 31) / 32) * 32;
  select_kernel<<<v, threads, 0, st>>>(s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gather_kernel, s, t, (int*)out,
                                 nfields, op_field, (int)va);
}
