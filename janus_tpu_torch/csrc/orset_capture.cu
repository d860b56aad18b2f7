// orset_capture: batched effect capture of OR-Set remove/clear ops, spread
// over the whole card.
//
// Replaces: janus_tpu/models/orset.py prepare_ops_batch, vmapped over the
// views. A remove (matching elem a0) or a clear at lane i captures (1) the
// first min(r_cap, C) selected tags of the pre-batch row its key gathers,
// in row order, padded with SENTINEL tags, (2) the first r_cap matching
// adds of lanes j < i whose raw key equals its raw key, in (a1, a2, lane)
// order, where an add counts only if its a1 is not SENTINEL, padded the
// same way; and outputs the first r_cap of (1) ++ (2) sorted stably by tag.
// Every other lane captures SENTINEL tags with elem 0.
//
// What bounds it on the H100: neither bytes nor operations at the path's
// shapes. It reads 20 bytes per op lane and, per remove/clear lane, one C-
// slot row (a gathered row, L2-resident: the state is 4 x 100 x 64 slots)
// and its key's earlier adds, and writes 12 x r_cap bytes per lane, ~2.6
// MB at 4 views x 8192 lanes (~0.8 us at 3.35 TB/s); what it waits on is
// the latency of those dependent reads, so the design keeps many of them
// in flight at once.
//
// Design: four launches on the caller's stream, one wrapper call. Adds are
// bucketed by the row their key gathers (modulo MAX_BUCKETS): a counting
// sort over tiles of TILE lanes, stable by lane.
// 1. count_kernel, a block per (tile, view): the tile's valid adds per
//    bucket and each bucket's last lane in the tile, into [V, T, NB]
//    scratch; tile 0 also clears the view's unsorted flags.
// 2. place_kernel, the same grid: each block derives every bucket's first
//    slot for its tile (the adds of the buckets before it and of its
//    earlier tiles, a block scan) and the bucket's last add in earlier
//    tiles, then places its adds as (a1, a2, lane, key) records and their
//    elems, its warps in turn so the order is the lanes'; an add whose tag
//    is below its predecessor's in the bucket flags the bucket unsorted.
// 3. order_kernel, a block per (32 buckets, view): each flagged bucket is
//    block-sorted by (a1, a2, lane) in place and its elems regathered.
//    Tags minted by one TagMinter ascend with lane, so a view of minted
//    tags flags none and its blocks exit at once.
// 4. capture_kernel, a block of CAP_WARPS warps per (32 lanes, view): a
//    warp captures one remove/clear lane at a time, lane r of the warp
//    holding entry r of each prefix (r_cap <= 32, so no per-thread array):
//    the row scan reads 32 slots a step, selects by ballot and hands the
//    r-th selected slot to lane r by a shuffle; the walk of the bucket
//    does the same for matching adds, and stops at the first lane >= i
//    when the bucket is in lane order (else it skips those lanes). A
//    state prefix out of tag order (a non-canonical row) is ranked and
//    permuted across the lanes; then each entry's place in the stable
//    merge of the two sorted prefixes (ties to the state's entry) comes
//    from a binary search of the other prefix by shuffles, and the entries
//    placed below r_cap are written.
// Scratch is the wrapper's (orset_capture_scratch_ints). Allocates
// nothing, does not synchronise.
#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int TILE = 256;          // lanes a block of count_ and place_kernel
constexpr int MAX_BUCKETS = 1024;  // buckets a view, at most
constexpr int CAP_WARPS = 4;       // warps a block of capture_kernel
constexpr int ORDER_THREADS = 256;
constexpr int MAX_RCAP = 32;
constexpr int OP_ADD = 1, OP_REMOVE = 2, OP_CLEAR = 3;
constexpr unsigned FULL = 0xffffffffu;

struct Ops {
  const int* op;
  const int* key;
  const int* a0;
  const int* a1;
  const int* a2;
};

struct Rows {
  const int* rep;
  const int* ctr;
  const int* elem;
  const unsigned char* valid;
};

// the view's bucketed adds and their index, carved from the scratch
struct Buckets {
  int4* rec;       // [V * B] (a1, a2, lane, key), by bucket, lane order
  int* elem;       // [V * B] the records' a0
  int* hist;       // [V, T, NB] adds of a bucket in a tile
  int* last;       // [V, T, NB] last lane of a bucket in a tile, or -1
  int* start;      // [V, NB + 1] first record of a bucket
  int* unsorted;   // [V, NB] a bucket's tags descend somewhere
};

__device__ __forceinline__ bool tag_less(int r0, int c0, int r1, int c1) {
  return r0 < r1 || (r0 == r1 && c0 < c1);
}

__device__ __forceinline__ bool valid_add(const Ops& ops, long long at) {
  return ops.op[at] == OP_ADD && ops.a1[at] != SENT;
}

// position of the n-th (from 0) set bit of m, which has more than n
__device__ __forceinline__ int nth_set(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const unsigned low = m & ((1u << s) - 1u);
    const int c = __popc(low);
    if (n >= c) {
      n -= c;
      m >>= s;
      pos += s;
    } else {
      m = low;
    }
  }
  return pos;
}

__global__ void __launch_bounds__(TILE)
count_kernel(Ops ops, Buckets bk, int B, int K, int NB, int T) {
  extern __shared__ int sh[];
  int* cnt = sh;       // [NB]
  int* lst = sh + NB;  // [NB]
  const int t = blockIdx.x, v = blockIdx.y;
  for (int b = threadIdx.x; b < NB; b += TILE) {
    cnt[b] = 0;
    lst[b] = -1;
    if (t == 0) bk.unsorted[(long long)v * NB + b] = 0;
  }
  __syncthreads();
  const int lane = t * TILE + threadIdx.x;
  const long long at = (long long)v * B + lane;
  if (lane < B && valid_add(ops, at)) {
    const int b = gather_row(ops.key[at], K) % NB;
    atomicAdd(&cnt[b], 1);
    atomicMax(&lst[b], lane);
  }
  __syncthreads();
  const long long base = ((long long)v * T + t) * NB;
  for (int b = threadIdx.x; b < NB; b += TILE) {
    bk.hist[base + b] = cnt[b];
    bk.last[base + b] = lst[b];
  }
}

__global__ void __launch_bounds__(TILE)
place_kernel(Ops ops, Buckets bk, int B, int K, int NB, int T) {
  extern __shared__ int sh[];
  int* first = sh;          // [NB] the bucket's first record (view-wide)
  int* slot = sh + NB;      // [NB] the tile's next record of the bucket
  int* pred = sh + 2 * NB;  // [NB] the bucket's last lane placed so far
  const int t = blockIdx.x, v = blockIdx.y;
  for (int b = threadIdx.x; b < NB; b += TILE) {
    int total = 0, before = 0, lst = -1;
    for (int u = 0; u < T; ++u) {
      const long long at = ((long long)v * T + u) * NB + b;
      const int h = bk.hist[at];
      if (u < t) {
        before += h;
        lst = max(lst, bk.last[at]);
      }
      total += h;
    }
    first[b] = total;
    slot[b] = before;
    pred[b] = lst;
  }
  __syncthreads();
  const int n = block_exclusive_scan(first, NB);
  for (int b = threadIdx.x; b < NB; b += TILE) {
    slot[b] += first[b];
    if (t == 0) bk.start[(long long)v * (NB + 1) + b] = first[b];
  }
  if (t == 0 && threadIdx.x == 0) bk.start[(long long)v * (NB + 1) + NB] = n;
  __syncthreads();

  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int lane = t * TILE + threadIdx.x;
  const long long at = (long long)v * B + lane;
  const bool add = lane < B && valid_add(ops, at);
  const int b = add ? gather_row(ops.key[at], K) % NB : -1;
  int pos = 0, before = -1;
  for (int w = 0; w < TILE / 32; ++w) {  // the warps in lane order
    if (warp == w) {
      const unsigned peers = __match_any_sync(FULL, b);
      const unsigned lower = peers & ((1u << l) - 1u);
      if (add) {
        pos = slot[b] + __popc(lower);
        before = lower ? lane - l + 31 - __clz(lower) : pred[b];
      }
      __syncwarp();
      if (add && (peers >> l) == 1u) {  // the peers' last lane
        slot[b] += __popc(peers);
        pred[b] = lane;
      }
    }
    __syncthreads();
  }
  if (!add) return;
  const long long vb = (long long)v * B;
  const int a1 = ops.a1[at], a2 = ops.a2[at];
  bk.rec[vb + pos] = make_int4(a1, a2, lane, ops.key[at]);
  bk.elem[vb + pos] = ops.a0[at];
  if (before >= 0 &&
      tag_less(a1, a2, ops.a1[vb + before], ops.a2[vb + before]))
    bk.unsorted[(long long)v * NB + b] = 1;
}

__global__ void __launch_bounds__(ORDER_THREADS)
order_kernel(Ops ops, Buckets bk, int B, int NB) {
  __shared__ unsigned flagged;
  const int v = blockIdx.y, b0 = blockIdx.x * 32;
  if (threadIdx.x < 32) {
    const int b = b0 + threadIdx.x;
    const unsigned m =
        __ballot_sync(FULL, b < NB && bk.unsorted[(long long)v * NB + b]);
    if (threadIdx.x == 0) flagged = m;
  }
  __syncthreads();
  const long long vb = (long long)v * B;
  for (unsigned m = flagged; m; m &= m - 1) {
    const int b = b0 + __ffs(m) - 1;
    const int lo = bk.start[(long long)v * (NB + 1) + b];
    const int hi = bk.start[(long long)v * (NB + 1) + b + 1];
    block_sort(bk.rec + vb + lo, hi - lo, LessXYZ());  // (a1, a2, lane)
    for (int p = lo + threadIdx.x; p < hi; p += ORDER_THREADS)
      bk.elem[vb + p] = ops.a0[vb + bk.rec[vb + p].z];
  }
}

// #{q < n : L_q < x} (strict) or #{q < n : L_q <= x}, where lane q of the
// warp holds L_q, the L_q ascend, n <= 32; every lane asks its own x
__device__ __forceinline__ int count_below(int lr, int lc, int n, int xr,
                                           int xc, bool strict) {
  int c = 0;
#pragma unroll
  for (int s = 32; s > 0; s >>= 1) {
    const int q = c + s - 1;
    const int qr = __shfl_sync(FULL, lr, q & 31);
    const int qc = __shfl_sync(FULL, lc, q & 31);
    const bool below =
        strict ? tag_less(qr, qc, xr, xc) : !tag_less(xr, xc, qr, qc);
    if (q < n && below) c += s;
  }
  return c;
}

// the capture of lane i of view v by one warp
__device__ void capture_lane(const Ops& ops, const Rows& st, const Buckets& bk,
                             int* __restrict__ out_rep,
                             int* __restrict__ out_ctr,
                             int* __restrict__ out_elem, int v, int i, int op,
                             int key, int a0, int B, int K, int C, int R,
                             int NB) {
  const int l = threadIdx.x & 31;
  const bool by_elem = op == OP_REMOVE;
  const int row = gather_row(key, K);
  const int b = row % NB;
  const long long sb = (long long)v * (NB + 1) + b;
  const int lo = bk.start[sb], hi = bk.start[sb + 1];
  const bool lane_order = !bk.unsorted[(long long)v * NB + b];
  const int ns = R < C ? R : C;  // width of the state prefix

  // (1) selected tags of the gathered row, in row order: lane r < ns
  // holds entry r
  int sr = SENT, sc = SENT, se = 0;
  const long long rb = ((long long)v * K + row) * C;
  int cnt = 0;
  for (int c0 = 0; c0 < C && cnt < ns; c0 += 64) {
    int xr[2], xc[2], xe[2];
    bool sel[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // two steps' loads in flight
      const int c = c0 + 32 * h + l;
      sel[h] = false;
      xr[h] = xc[h] = xe[h] = 0;
      if (c < C) {
        const bool ok = st.valid[rb + c];
        xe[h] = st.elem[rb + c];
        xr[h] = st.rep[rb + c];
        xc[h] = st.ctr[rb + c];
        sel[h] = ok && (!by_elem || xe[h] == a0);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned m = __ballot_sync(FULL, sel[h]);
      const int k = l - cnt;
      const bool take = k >= 0 && k < __popc(m) && l < ns;
      const int src = take ? nth_set(m, k) : 0;
      const int r = __shfl_sync(FULL, xr[h], src);
      const int c = __shfl_sync(FULL, xc[h], src);
      const int e = __shfl_sync(FULL, xe[h], src);
      if (take) {
        sr = r;
        sc = c;
        se = e;
      }
      cnt += __popc(m);
    }
  }

  // (2) matching adds of earlier lanes of the same raw key, tag order:
  // lane r < R holds entry r
  int br = SENT, bc = SENT, be = 0;
  const long long vb = (long long)v * B;
  int nb = 0;
  for (int p0 = lo; p0 < hi && nb < R; p0 += 32) {
    const int p = p0 + l;
    bool hit = false, past = false;
    int4 x = make_int4(0, 0, 0, 0);
    int e = 0;
    if (p < hi) {
      x = bk.rec[vb + p];
      e = bk.elem[vb + p];
      past = x.z >= i;
      hit = !past && x.w == key && (!by_elem || e == a0);
    }
    unsigned m = __ballot_sync(FULL, hit);
    const unsigned late = __ballot_sync(FULL, past);
    const bool stop = lane_order && late;
    if (stop) m &= (late & (0u - late)) - 1u;  // before the first late lane
    const int k = l - nb;
    const bool take = k >= 0 && k < __popc(m) && l < R;
    const int src = take ? nth_set(m, k) : 0;
    const int r = __shfl_sync(FULL, x.x, src);
    const int c = __shfl_sync(FULL, x.y, src);
    const int ee = __shfl_sync(FULL, e, src);
    if (take) {
      br = r;
      bc = c;
      be = ee;
    }
    nb += __popc(m);
    if (stop) break;
  }

  // (3) the state prefix in tag order (stably, if it is not), then the
  // stable merge of the two, first R out
  const int pr = __shfl_up_sync(FULL, sr, 1), pc = __shfl_up_sync(FULL, sc, 1);
  if (__any_sync(FULL, l > 0 && l < ns && tag_less(sr, sc, pr, pc))) {
    int rank = 0;
    for (int q = 0; q < ns; ++q) {
      const int qr = __shfl_sync(FULL, sr, q), qc = __shfl_sync(FULL, sc, q);
      rank += tag_less(qr, qc, sr, sc) || (qr == sr && qc == sc && q < l);
    }
    int nr = sr, nc = sc, ne = se;
    for (int q = 0; q < ns; ++q) {
      const int qr = __shfl_sync(FULL, sr, q), qc = __shfl_sync(FULL, sc, q);
      const int qe = __shfl_sync(FULL, se, q), qk = __shfl_sync(FULL, rank, q);
      if (qk == l) {
        nr = qr;
        nc = qc;
        ne = qe;
      }
    }
    sr = nr;
    sc = nc;
    se = ne;
  }
  const int at_s = l + count_below(br, bc, R, sr, sc, true);
  const int at_b = l + count_below(sr, sc, ns, br, bc, false);
  const long long out = (vb + i) * R;
  if (l < ns && at_s < R) {
    out_rep[out + at_s] = sr;
    out_ctr[out + at_s] = sc;
    out_elem[out + at_s] = se;
  }
  if (l < R && at_b < R) {
    out_rep[out + at_b] = br;
    out_ctr[out + at_b] = bc;
    out_elem[out + at_b] = be;
  }
}

__global__ void __launch_bounds__(32 * CAP_WARPS)
capture_kernel(Ops ops, Rows st, Buckets bk, int* __restrict__ out_rep,
               int* __restrict__ out_ctr, int* __restrict__ out_elem, int B,
               int K, int C, int R, int NB) {
  __shared__ int s_op[32], s_key[32], s_a0[32];
  __shared__ unsigned s_tomb;
  const int v = blockIdx.y, lane0 = blockIdx.x * 32;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const long long vb = (long long)v * B;
  if (warp == 0) {
    const bool in = lane0 + l < B;
    const long long at = vb + lane0 + l;
    const int op = in ? ops.op[at] : 0;
    s_op[l] = op;
    s_key[l] = in ? ops.key[at] : 0;
    s_a0[l] = in ? ops.a0[at] : 0;
    const unsigned m =
        __ballot_sync(FULL, in && (op == OP_REMOVE || op == OP_CLEAR));
    if (l == 0) s_tomb = m;
  }
  __syncthreads();
  const unsigned tomb = s_tomb;
  const int lanes = min(32, B - lane0);
  const long long out = (vb + lane0) * R;
  for (int j = threadIdx.x; j < lanes * R; j += 32 * CAP_WARPS) {
    if ((tomb >> (j / R)) & 1u) continue;  // a capturing lane
    out_rep[out + j] = SENT;
    out_ctr[out + j] = SENT;
    out_elem[out + j] = 0;
  }
  const int n = __popc(tomb);
  for (int q = warp; q < n; q += CAP_WARPS) {
    const int j = nth_set(tomb, q);
    capture_lane(ops, st, bk, out_rep, out_ctr, out_elem, v, lane0 + j,
                 s_op[j], s_key[j], s_a0[j], B, K, C, R, NB);
  }
}

int buckets_of(int K) { return K < MAX_BUCKETS ? K : MAX_BUCKETS; }

int tiles_of(int B) { return (B + TILE - 1) / TILE; }

}  // namespace

// int32 entries of the scratch a call needs (V views of B lanes, K keys).
extern "C" long long orset_capture_scratch_ints(int V, int B, int K) {
  const long long nb = buckets_of(K), vv = V;
  return vv * (5LL * B + 2 * tiles_of(B) * nb + 2 * nb + 1);
}

// op fields int32 [V, B]; state rows [V, K, C] (int32 tags and elem, bool
// valid); outputs int32 [V, B, R]; scratch int32
// [orset_capture_scratch_ints(V, B, K)], 16-byte aligned. Contiguous on one
// device, 1 <= R <= 32. Four launches; returns the first CUDA error.
extern "C" int orset_capture_launch(const void* op, const void* key,
                                    const void* a0, const void* a1,
                                    const void* a2, const void* rep,
                                    const void* ctr, const void* elem,
                                    const void* valid, void* out_rep,
                                    void* out_ctr, void* out_elem,
                                    void* scratch, int V, int B, int K, int C,
                                    int R, void* stream) {
  if (V <= 0 || B <= 0 || R <= 0) return (int)cudaSuccess;
  if (R > MAX_RCAP || K <= 0) return (int)cudaErrorInvalidValue;
  const int NB = buckets_of(K), T = tiles_of(B);
  const long long vb = (long long)V * B, vt = (long long)V * T * NB;
  Buckets bk;
  bk.rec = (int4*)scratch;
  bk.elem = (int*)(bk.rec + vb);
  bk.hist = bk.elem + vb;
  bk.last = bk.hist + vt;
  bk.start = bk.last + vt;
  bk.unsorted = bk.start + (long long)V * (NB + 1);
  Ops ops{(const int*)op, (const int*)key, (const int*)a0, (const int*)a1,
          (const int*)a2};
  Rows st{(const int*)rep, (const int*)ctr, (const int*)elem,
          (const unsigned char*)valid};
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 tiles(T, V);
  count_kernel<<<tiles, TILE, 2 * sizeof(int) * NB, s>>>(ops, bk, B, K, NB,
                                                         T);
  place_kernel<<<tiles, TILE, 3 * sizeof(int) * NB, s>>>(ops, bk, B, K, NB,
                                                         T);
  order_kernel<<<dim3((NB + 31) / 32, V), ORDER_THREADS, 0, s>>>(ops, bk, B,
                                                                 NB);
  capture_kernel<<<dim3((B + 31) / 32, V), 32 * CAP_WARPS, 0, s>>>(
      ops, st, bk, (int*)out_rep, (int*)out_ctr, (int*)out_elem, B, K, C, R,
      NB);
  return (int)cudaGetLastError();
}
