// rga_apply: the RGA's sequential apply of insert/delete ops, per replica,
// in place; one block per (replica, document row).
//
// Replaces: the lax.scan of janus_tpu/models/rga.py _apply_ops_impl,
// vmapped over replicas, uncaptured (the Lamport counter minted at apply)
// and captured (the counter read from the op's eff_ctr); and, as the
// capture mode (entry point rga_capture_launch), the scan of
// janus_tpu/models/base.py capture_and_apply (160-186) with
// janus_tpu/models/rga.py prepare_ops (90-102), vmapped over the views:
// the uncaptured walk that also writes each lane's minted counter to
// eff_out (0 for a delete or another code). Each op's prepare observes the
// state the earlier lanes left, which is the state the uncaptured mint
// reads, so the two agree lane by lane, a dropped insert's counter (which
// still advances the floor) included. Ops apply in lane
// order. An op reads the row its key gathers (negative keys count from the
// end, then the index is clamped) and writes the row and the document's
// Lamport floor back only if the normalised key is in range. insert: the
// counter is eff_ctr, or max(max over the row of (valid ? id_ctr : 0),
// ctr_floor[k]) + 1 (int32, wrapping); then an upsert of id (ctr, writer):
// into the first valid slot holding the id, par_rep, par_ctr and chr take
// the max with (a1, a2, a0); else into the first invalid slot, a fresh
// live element with parent (a2, a1) and chr a0. delete: an upsert of id
// (a2, a1) that sets dead on the first valid slot holding it, or lands a
// dead placeholder (zero parent and chr) in the first invalid slot. An
// upsert of an absent id into a full row counts one drop (whether or not
// the key is in range) and changes nothing. Every op with an in-range key
// sets ctr_floor[k] to its max with the counter it carries: the minted one
// for an insert, a2 for a delete (each at least 0), 0 for other codes.
//
// What bounds it on the H100: bytes. The function needs 28 bytes per op
// (six fields and eff_ctr) and the rows its ops touch, each read and
// written once (22 bytes a slot, 4 of floor). At the rga preset (R=1,024,
// K=128, C=1,024, 16 insert and 16 delete lanes per replica) ops touch at
// most 18 rows per replica, 18,432 rows of 22.5 KB, ~0.83 GB both ways,
// ~0.25 ms at 3.35 TB/s. Each op is a few passes over its row.
//
// Design: an op touches only the row it gathers, so rows are independent:
// one block per (replica, row), 256 threads, grid-stride. The block walks
// its replica's op lanes a tile at a time and keeps the lanes whose key
// gathers its row, in lane order (a ballot prefix); a row no op gathers
// is never read. At its first lane the block stages the row (22.5 KB at
// C=1,024) and its floor in shared memory, applies the lanes one by one
// (the row max, the id search and the first free slot are block
// reductions by shared atomics; the update is one thread's), and writes
// the row back if an in-range op touched it. Launches on the caller's
// stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>
#include <limits.h>

#include "slot_sort.cuh"

namespace {

using namespace slot_sort;

constexpr int THREADS = 256;
constexpr int OP_INSERT = 1, OP_DELETE = 2;

struct State {
  int* id_ctr;
  int* id_rep;
  int* par_ctr;
  int* par_rep;
  int* chr;
  unsigned char* dead;
  unsigned char* valid;
  int* floor;  // [R, K]
};

struct Ops {
  const int* op;
  const int* key;
  const int* a0;
  const int* a1;
  const int* a2;
  const int* writer;
  const int* eff;  // [R, B] or null (uncaptured)
};

// CAPTURE: the capture mode, writing each lane's minted counter to
// eff_out [R, B] (a separate instantiation, so the apply is unchanged)
template <bool CAPTURE>
__global__ void __launch_bounds__(THREADS)
rga_apply_kernel(State st, Ops ops, int* __restrict__ eff_out,
                 int* __restrict__ dropped, int R, int K, int C, int B) {
  extern __shared__ int smem[];
  int* id_ctr = smem;
  int* id_rep = id_ctr + C;
  int* par_ctr = id_rep + C;
  int* par_rep = par_ctr + C;
  int* chr = par_rep + C;
  int* lanes = chr + C;  // [THREADS]
  unsigned char* dead = (unsigned char*)(lanes + THREADS);
  unsigned char* valid = dead + C;
  __shared__ int s_max, s_first, s_free, s_floor;

  const int tid = threadIdx.x;
  for (long long blk = blockIdx.x; blk < (long long)R * K; blk += gridDim.x) {
    const int r = (int)(blk / K), g = (int)(blk % K);
    const long long base = blk * C;
    bool staged = false, touched = false;
    int drop = 0;
    for (int b0 = 0; b0 < B; b0 += THREADS) {
      const int b = b0 + tid;
      const bool mine =
          b < B && gather_row(ops.key[(long long)r * B + b], K) == g;
      int nm;
      const int at = block_count_before(mine, &nm);
      if (mine) lanes[at] = b;
      if (nm > 0 && !staged) {
        for (int c = tid; c < C; c += THREADS) {
          id_ctr[c] = st.id_ctr[base + c];
          id_rep[c] = st.id_rep[base + c];
          par_ctr[c] = st.par_ctr[base + c];
          par_rep[c] = st.par_rep[base + c];
          chr[c] = st.chr[base + c];
          dead[c] = st.dead[base + c];
          valid[c] = st.valid[base + c];
        }
        if (tid == 0) s_floor = st.floor[blk];
        staged = true;
      }
      __syncthreads();
      for (int m = 0; m < nm; ++m) {
        const long long o = (long long)r * B + lanes[m];
        const int op = ops.op[o], key = ops.key[o], a0 = ops.a0[o];
        const int a1 = ops.a1[o], a2 = ops.a2[o], wr = ops.writer[o];
        const int nk = key < 0 ? key + K : key;
        const bool in_range = nk >= 0 && nk < K;
        const bool en = op != 0;
        const bool is_ins = en && op == OP_INSERT;
        const bool is_del = en && op == OP_DELETE;
        int ctr = 0;
        if (is_ins) {
          if (ops.eff) {
            ctr = ops.eff[o];
          } else {
            if (tid == 0) s_max = INT_MIN;
            __syncthreads();
            int mx = INT_MIN;
            for (int c = tid; c < C; c += THREADS)
              mx = max(mx, valid[c] ? id_ctr[c] : 0);
            atomicMax(&s_max, mx);
            __syncthreads();
            ctr = (int)((unsigned)max(s_max, s_floor) + 1u);
          }
        }
        if (CAPTURE && tid == 0) eff_out[o] = ctr;
        if (is_ins || is_del) {
          const int kc = is_ins ? ctr : a2, kr = is_ins ? wr : a1;
          if (tid == 0) {
            s_first = C;
            s_free = C;
          }
          __syncthreads();
          // a thread's slots ascend, so its first hit is its least
          int first = C, free_slot = C;
          for (int c = tid; c < C; c += THREADS) {
            if (valid[c]) {
              if (first == C && id_ctr[c] == kc && id_rep[c] == kr) first = c;
            } else if (free_slot == C) {
              free_slot = c;
            }
          }
          if (first < C) atomicMin(&s_first, first);
          if (free_slot < C) atomicMin(&s_free, free_slot);
          __syncthreads();
          const int f = s_first, fr = s_free;
          drop += f == C && fr == C;
          if (in_range && tid == 0) {
            if (f < C) {
              if (is_ins) {
                par_rep[f] = max(par_rep[f], a1);
                par_ctr[f] = max(par_ctr[f], a2);
                chr[f] = max(chr[f], a0);
              } else {
                dead[f] = 1;
              }
            } else if (fr < C) {
              id_ctr[fr] = kc;
              id_rep[fr] = kr;
              par_rep[fr] = is_ins ? a1 : 0;
              par_ctr[fr] = is_ins ? a2 : 0;
              chr[fr] = is_ins ? a0 : 0;
              dead[fr] = is_del;
              valid[fr] = 1;
            }
          }
        }
        if (in_range) {
          touched = true;
          const int seen = is_ins ? max(ctr, 0) : (is_del ? max(a2, 0) : 0);
          if (tid == 0) s_floor = max(s_floor, seen);
        }
        __syncthreads();
      }
    }
    if (touched) {
      for (int c = tid; c < C; c += THREADS) {
        st.id_ctr[base + c] = id_ctr[c];
        st.id_rep[base + c] = id_rep[c];
        st.par_ctr[base + c] = par_ctr[c];
        st.par_rep[base + c] = par_rep[c];
        st.chr[base + c] = chr[c];
        st.dead[base + c] = dead[c];
        st.valid[base + c] = valid[c];
      }
      if (tid == 0) st.floor[blk] = s_floor;
    }
    if (tid == 0 && drop) atomicAdd(&dropped[r], drop);
    __syncthreads();
  }
}

}  // namespace

namespace {

template <bool CAPTURE>
int launch(void* const* state, void* floor, const void* const* ops,
           void* eff_out, void* dropped, int R, int K, int C, int B,
           void* stream) {
  if (R <= 0 || K <= 0 || B <= 0 || C <= 0) return (int)cudaSuccess;
  const size_t bytes = (size_t)C * (5 * sizeof(int) + 2) +
                       sizeof(int) * THREADS;
  cudaError_t err = allow_shared(rga_apply_kernel<CAPTURE>, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)R * K;
  const long long grid = blocks < 132LL * 256 ? blocks : 132LL * 256;
  State st{(int*)state[0], (int*)state[1], (int*)state[2],
           (int*)state[3], (int*)state[4], (unsigned char*)state[5],
           (unsigned char*)state[6], (int*)floor};
  Ops o{(const int*)ops[0], (const int*)ops[1], (const int*)ops[2],
        (const int*)ops[3], (const int*)ops[4], (const int*)ops[5],
        (const int*)ops[6]};
  rga_apply_kernel<CAPTURE>
      <<<(unsigned)grid, THREADS, bytes, (cudaStream_t)stream>>>(
          st, o, (int*)eff_out, (int*)dropped, R, K, C, B);
  return (int)cudaGetLastError();
}

}  // namespace

// state: seven field pointers (id_ctr, id_rep, par_ctr, par_rep, chr
// int32; dead, valid bool) of [R, K, C] and ctr_floor int32 [R, K], updated
// in place; ops: seven pointers (op, key, a0, a1, a2, writer, eff_ctr)
// int32 [R, B], eff_ctr null when uncaptured; dropped int32 [R], added to.
// Contiguous on one device. Returns the launch's CUDA error.
extern "C" int rga_apply_launch(void* const* state, void* floor,
                                const void* const* ops, void* dropped, int R,
                                int K, int C, int B, void* stream) {
  return launch<false>(state, floor, ops, nullptr, dropped, R, K, C, B,
                       stream);
}

// The capture mode: as rga_apply_launch with eff_ctr null (uncaptured),
// and eff_out int32 [R, B] receiving every lane's minted counter (0 for a
// lane that is not an insert).
extern "C" int rga_capture_launch(void* const* state, void* floor,
                                  const void* const* ops, void* eff_out,
                                  void* dropped, int R, int K, int C, int B,
                                  void* stream) {
  return launch<true>(state, floor, ops, eff_out, dropped, R, K, C, B,
                      stream);
}
