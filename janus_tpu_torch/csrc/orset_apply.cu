// orset_apply: the OR-Set's sequential apply of uncaptured ops, per
// replica, in place; one block per (replica, key row).
//
// Replaces: the lax.scan of janus_tpu/models/orset.py _apply_ops_impl,
// vmapped over replicas: uncaptured (has_capture=False), and captured, the
// scan JAX runs for a one-lane captured batch (384-465), where a remove or
// clear does not tombstone in the row but unions the row with its r_cap
// captured tags as dead records (setops.slot_union with the OR-Set's fold:
// the row's slots and the records sorted by tag, stable; a record whose
// predecessor holds the same valid tag is dropped and ORs its tombstone
// into that predecessor; the first C kept, the rest counted as drops, even
// for a key out of range). Ops apply in
// lane order. An op reads the row its key gathers (negative keys count from
// the end, then the index is clamped) and writes it back only if the
// normalised key is in range. add: if a valid slot holds the tag (first
// hit), set its elem; else, when the row is full, count a drop, and insert
// the tag keeping the C smallest tags (the largest, possibly the newcomer,
// falls off). remove: tombstone the valid slots of elem a0; clear: every
// valid slot. Every op with an in-range key leaves its row canonical
// (sorted by tag, stable; invalid slots SENTINEL keys, zero payloads).
//
// What bounds it on the H100: the function needs 20 bytes per op and the
// rows its ops touch, each read and written once (14 bytes a slot). At 64
// replicas x 500 keys x 256 slots with 64 ops per replica on a hot window
// of 32 keys that is ~1,350 of the 32,000 rows, ~10 MB, ~3 us at
// 3.35 TB/s; the per-row op chains (each op depends on the row the op
// before it left) are a few ops long. This design reads all 114.7 MB of
// the state, since a block sorts its row before it knows whether an op
// hits it: skipping untouched rows is the next step toward the bound.
//
// Design: a scan touches only row `key`, so rows are independent: one
// block per (replica, row), 128 threads, the row in shared memory. The row
// is first put in canonical order (slot_sort::block_sort on (tag,
// position), which is what the first in-range op's canonicalisation does:
// every op's effect commutes with a stable reordering of the row); an
// untouched row is never written back. The block walks its replica's op
// lanes a tile at a time, keeps the lanes whose key gathers its row in
// lane order (a ballot prefix), and applies them one by one: the tag
// search and the full-row test are block reductions, the insertion point
// of a new tag is the count of tags not above it (the row is sorted), and
// an insertion shifts the row into a second buffer. Launches on the
// caller's stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 128;
constexpr int OP_ADD = 1, OP_REMOVE = 2, OP_CLEAR = 3;

struct State {
  int* rep;
  int* ctr;
  int* elem;
  unsigned char* removed;
  unsigned char* valid;
};

struct Ops {
  const int* op;
  const int* key;
  const int* a0;
  const int* a1;
  const int* a2;
  // captured mode: [R, B, RC] tags and elements of each remove/clear,
  // SENTINEL rep in unused lanes; null when uncaptured
  const int* rm_rep;
  const int* rm_ctr;
  const int* rm_elem;
  int RC;
};

// one row buffer in shared memory
struct Row {
  int* rep;
  int* ctr;
  int* elem;
  unsigned char* rm;
  unsigned char* valid;
};

__device__ Row row_at(char* base, int c) {
  Row r;
  r.rep = (int*)base;
  r.ctr = r.rep + c;
  r.elem = r.ctr + c;
  r.rm = (unsigned char*)(r.elem + c);
  r.valid = r.rm + c;
  return r;
}

// CAPTURED: the captured mode (a separate instantiation, so the uncaptured
// apply is unchanged)
template <bool CAPTURED>
__global__ void __launch_bounds__(THREADS)
orset_apply_kernel(State st, Ops ops, int* __restrict__ dropped, int R, int K,
                   int C, int B) {
  extern __shared__ int4 smem[];
  const int RC = CAPTURED ? ops.RC : 0;
  int4* rec = smem;                               // [C + RC] sort records
  const size_t row_bytes = (size_t)C * 14;
  char* rows = (char*)(rec + C + RC);
  Row buf[2] = {row_at(rows, C), row_at(rows + ((row_bytes + 15) / 16) * 16, C)};
  int* lanes = (int*)(rows + 2 * ((row_bytes + 15) / 16) * 16);  // [THREADS]
  unsigned char* flag = (unsigned char*)(lanes + THREADS);       // [C + RC]
  __shared__ int s_first, s_pos;

  const int tid = threadIdx.x;
  for (long long blk = blockIdx.x; blk < (long long)R * K; blk += gridDim.x) {
    const int r = (int)(blk / K), g = (int)(blk % K);
    const long long base = blk * C;

    // canonical order of the raw row: raw payloads staged in buf[1]
    for (int c = tid; c < C; c += THREADS) {
      const bool v = st.valid[base + c];
      rec[c] = make_int4(v ? st.rep[base + c] : SENT,
                         v ? st.ctr[base + c] : SENT, c, 0);
      buf[1].elem[c] = st.elem[base + c];
      buf[1].rm[c] = st.removed[base + c];
      buf[1].valid[c] = v;
    }
    __syncthreads();
    block_sort(rec, C, LessXYZ());
    for (int j = tid; j < C; j += THREADS) {
      const int4 x = rec[j];
      const bool v = buf[1].valid[x.z];
      buf[0].rep[j] = x.x;
      buf[0].ctr[j] = x.y;
      buf[0].elem[j] = v ? buf[1].elem[x.z] : 0;
      buf[0].rm[j] = v && buf[1].rm[x.z];
      buf[0].valid[j] = v;
    }
    __syncthreads();

    int cur = 0, drop = 0;
    bool touched = false;
    for (int b0 = 0; b0 < B; b0 += THREADS) {
      const int b = b0 + tid;
      const bool mine =
          b < B && gather_row(ops.key[(long long)r * B + b], K) == g;
      int nm;
      const int at = block_count_before(mine, &nm);
      if (mine) lanes[at] = b;
      __syncthreads();
      for (int m = 0; m < nm; ++m) {
        const long long o = (long long)r * B + lanes[m];
        const int op = ops.op[o], key = ops.key[o], a0 = ops.a0[o];
        const int a1 = ops.a1[o], a2 = ops.a2[o];
        const int nk = key < 0 ? key + K : key;
        const bool in_range = nk >= 0 && nk < K;
        const Row row = buf[cur];
        if (op == OP_ADD) {
          if (tid == 0) {
            s_first = C;
            s_pos = 0;
          }
          __syncthreads();
          bool all_valid = true;
          int not_above = 0;
          for (int j = tid; j < C; j += THREADS) {
            const bool v = row.valid[j];
            all_valid &= v;
            if (v && row.rep[j] == a1 && row.ctr[j] == a2) atomicMin(&s_first, j);
            not_above += row.rep[j] < a1 || (row.rep[j] == a1 && row.ctr[j] <= a2);
          }
          atomicAdd(&s_pos, not_above);
          const bool full = __syncthreads_and(all_valid);
          const int first = s_first, p = s_pos;
          const bool found = first < C;
          drop += !found && full;
          if (in_range) {
            touched = true;
            if (found) {
              if (tid == 0) row.elem[first] = a0;
            } else if (p < C) {
              const Row nxt = buf[cur ^ 1];
              for (int j = tid; j < C; j += THREADS) {
                if (j == p) {
                  nxt.rep[j] = a1;
                  nxt.ctr[j] = a2;
                  nxt.elem[j] = a0;
                  nxt.rm[j] = 0;
                  nxt.valid[j] = 1;
                } else {
                  const int s = j < p ? j : j - 1;
                  nxt.rep[j] = row.rep[s];
                  nxt.ctr[j] = row.ctr[s];
                  nxt.elem[j] = row.elem[s];
                  nxt.rm[j] = row.rm[s];
                  nxt.valid[j] = row.valid[s];
                }
              }
              cur ^= 1;
            }
          }
        } else if (CAPTURED && (op == OP_REMOVE || op == OP_CLEAR)) {
          // the union of the canonical row with the op's captured tags
          const long long co = o * RC;
          const int n = C + RC;
          for (int j = tid; j < n; j += THREADS) {
            if (j < C) {
              rec[j] = make_int4(row.rep[j], row.ctr[j], j, 0);
            } else {
              const int rr = ops.rm_rep[co + j - C];
              const bool v = rr != SENT;
              rec[j] = make_int4(v ? rr : SENT,
                                 v ? ops.rm_ctr[co + j - C] : SENT, j, 0);
            }
          }
          __syncthreads();
          block_sort(rec, n, LessXYZ());
          // flag bit 0: valid; bit 1: tombstone
          for (int j = tid; j < n; j += THREADS) {
            const int i = rec[j].z;
            flag[j] = i < C ? (row.valid[i] | (row.rm[i] << 1))
                            : ((ops.rm_rep[co + i - C] != SENT) | 2);
          }
          __syncthreads();
          const Row nxt = buf[cur ^ 1];
          int kept = 0;
          for (int j0 = 0; j0 < n; j0 += THREADS) {
            const int j = j0 + tid;
            bool keep = false, dead = false;
            int elem = 0;
            if (j < n) {
              const int4 x = rec[j];
              const bool v = flag[j] & 1;
              const bool dup = j > 0 && v && (flag[j - 1] & 1) &&
                               rec[j - 1].x == x.x && rec[j - 1].y == x.y;
              const bool next_dup = j + 1 < n && v && (flag[j + 1] & 1) &&
                                    rec[j + 1].x == x.x && rec[j + 1].y == x.y;
              keep = v && !dup;
              dead = (flag[j] & 2) || (next_dup && (flag[j + 1] & 2));
              elem = x.z < C ? row.elem[x.z] : ops.rm_elem[co + x.z - C];
            }
            int nk;
            const int at = kept + block_count_before(keep, &nk);
            if (keep && at < C && in_range) {
              nxt.rep[at] = rec[j].x;
              nxt.ctr[at] = rec[j].y;
              nxt.elem[at] = elem;
              nxt.rm[at] = dead;
              nxt.valid[at] = 1;
            }
            kept += nk;
          }
          drop += kept > C ? kept - C : 0;
          if (in_range) {
            for (int j = kept + tid; j < C; j += THREADS) {
              nxt.rep[j] = SENT;
              nxt.ctr[j] = SENT;
              nxt.elem[j] = 0;
              nxt.rm[j] = 0;
              nxt.valid[j] = 0;
            }
            touched = true;
            cur ^= 1;
          }
        } else if ((op == OP_REMOVE || op == OP_CLEAR) && in_range) {
          touched = true;
          for (int j = tid; j < C; j += THREADS)
            if (row.valid[j] && (op == OP_CLEAR || row.elem[j] == a0))
              row.rm[j] = 1;
        } else if (in_range) {
          touched = true;  // any op leaves its row canonical
        }
        __syncthreads();
      }
    }

    if (touched) {
      const Row row = buf[cur];
      for (int j = tid; j < C; j += THREADS) {
        st.rep[base + j] = row.rep[j];
        st.ctr[base + j] = row.ctr[j];
        st.elem[base + j] = row.elem[j];
        st.removed[base + j] = row.rm[j];
        st.valid[base + j] = row.valid[j];
      }
    }
    if (tid == 0 && drop) atomicAdd(&dropped[r], drop);
    __syncthreads();
  }
}

}  // namespace

// state fields [R, K, C] (int32 tags and elem, bool removed and valid),
// updated in place; op fields int32 [R, B]; rm_rep, rm_ctr, rm_elem int32
// [R, B, RC] for captured ops, null (and RC 0) for uncaptured ones; dropped
// int32 [R], added to. Contiguous on one device. Returns the launch's CUDA
// error.
extern "C" int orset_apply_launch(void* rep, void* ctr, void* elem,
                                  void* removed, void* valid, const void* op,
                                  const void* key, const void* a0,
                                  const void* a1, const void* a2,
                                  const void* rm_rep, const void* rm_ctr,
                                  const void* rm_elem, int RC,
                                  void* dropped, int R, int K, int C, int B,
                                  void* stream) {
  if (R <= 0 || K <= 0 || B <= 0) return (int)cudaSuccess;
  if (!rm_rep) RC = 0;
  const size_t row_bytes = (((size_t)C * 14 + 15) / 16) * 16;
  const size_t bytes = sizeof(int4) * (size_t)(C + RC) + 2 * row_bytes +
                       sizeof(int) * THREADS + (rm_rep ? (size_t)(C + RC) : 0);
  cudaError_t err = rm_rep ? allow_shared(orset_apply_kernel<true>, bytes)
                           : allow_shared(orset_apply_kernel<false>, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)R * K;
  const long long grid = blocks < 132LL * 256 ? blocks : 132LL * 256;
  State st{(int*)rep, (int*)ctr, (int*)elem, (unsigned char*)removed,
           (unsigned char*)valid};
  Ops ops{(const int*)op, (const int*)key, (const int*)a0, (const int*)a1,
          (const int*)a2, (const int*)rm_rep, (const int*)rm_ctr,
          (const int*)rm_elem, RC};
  if (rm_rep)
    orset_apply_kernel<true>
        <<<(unsigned)grid, THREADS, bytes, (cudaStream_t)stream>>>(
            st, ops, (int*)dropped, R, K, C, B);
  else
    orset_apply_kernel<false>
        <<<(unsigned)grid, THREADS, bytes, (cudaStream_t)stream>>>(
            st, ops, (int*)dropped, R, K, C, B);
  return (int)cudaGetLastError();
}
