// mvr_frontier: the MVRegister's causal frontier of one row's entries, for
// one warp, shared by mvr_merge.cu and mvr_apply.cu.
//
// Replaces the core of janus_tpu/models/mvregister.py merge_with_stats
// (143-181) with lattice.clock_leq / clock_dominates (41-68): given n
// entries (val, valid, clock[W]) in shared memory,
//   1. drop every entry whose clock is strictly dominated by a valid
//      entry's (<= in every lane, < in one);
//   2. drop every exact (val, clock) twin of an earlier valid entry;
//   3. order the kept entries by (val, clock lanes 0..W-1), signed;
//   4. cut to `cap` slots; the caller writes the rest as (SENTINEL, zero
//      clock, invalid) and counts kept - cap as the overflow.
// Kept entries are distinct after step 2 (of two equal valid entries the
// later is dropped, and the earlier goes too only with its twin), so
// their order is total and equals JAX's stable lax.sort on (rank, val,
// lanes): rank 0 for kept entries first, and the dropped ones, all equal
// keys, after.
//
// Work: n^2 W compares for steps 1-2 and as many for the ranks of step 3;
// lane i of the warp owns entries i, i + 32, ... Clock rows sit `ld` ints
// apart, ld odd, so the 32 lanes reading 32 entries' lane w hit 32 banks;
// the entry compared against is a broadcast.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

namespace mvr {

constexpr int SENT = INT_MAX;
constexpr unsigned FULL = 0xffffffffu;

// The row stride of a clock of W lanes in shared memory: odd.
__host__ __device__ inline int clock_ld(int w) { return w | 1; }

// One warp: keep[i] (scratch, n bytes) and inv[p] = the entry at output
// slot p for p < min(kept, cap). Returns the kept count to every lane.
// Every lane of the warp calls it; ends in __syncwarp().
__device__ inline int frontier(const int* val, const unsigned char* valid,
                               const int* clock, int ld, int n, int w,
                               int cap, unsigned char* keep, int* inv) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < n; i += 32) {
    bool k = valid[i];
    const int* ci = clock + i * ld;
    for (int j = 0; k && j < n; ++j) {
      if (j == i || !valid[j]) continue;
      const int* cj = clock + j * ld;
      bool le = true, ge = true;
      for (int q = 0; q < w && (le || ge); ++q) {
        le &= ci[q] <= cj[q];
        ge &= ci[q] >= cj[q];
      }
      if (le && !ge) k = false;  // strictly dominated by a valid entry
      else if (le && ge && j < i && val[j] == val[i]) k = false;  // a twin
    }
    keep[i] = k;
  }
  __syncwarp();
  int kept = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    kept += __popc(__ballot_sync(FULL, i < n && keep[i]));
  }
  for (int i = lane; i < n; i += 32) {
    if (!keep[i]) continue;
    const int* ci = clock + i * ld;
    int r = 0;
    for (int j = 0; j < n; ++j) {
      if (j == i || !keep[j]) continue;
      bool less = val[j] < val[i];
      if (val[j] == val[i]) {
        const int* cj = clock + j * ld;
        int q = 0;
        while (q < w && cj[q] == ci[q]) ++q;
        less = q < w && cj[q] < ci[q];
      }
      r += less;
    }
    if (r < cap) inv[r] = i;
  }
  __syncwarp();
  return kept;
}

}  // namespace mvr
