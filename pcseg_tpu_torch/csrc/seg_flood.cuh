// Segmented OR-flood of packed bit-planes: the row and column passes that
// the closure-epoch kernel (epoch_word.cu) and the packed flood
// (flood_packed.cu) share.
//
// State: N planes of [H, W] 32-bit words; bit j of a word is an independent
// flood. One round spreads every set bit through its whole run of gate bits
// along the row, then along the column (a run is cut by a cleared gate
// bit). A cell outside the gate keeps no bit after a round, but the bit it
// held when the round began spreads into the runs on both of its sides, as
// the JAX kernel's fwd|bwd scans do. Rounds repeat to the fixed point or a
// cap without a host sync: the column pass of round r raises flags[r] when
// any word differs from the round's start, and both passes of round r+1
// return at once when flags[r] is clear (a fixed point is stable, so the
// no-op launches give the same words as stopping).
//
// The scans compose per-cell steps acc = (acc & g) | v. A run of cells
// composes to acc_out = (acc_in & A) | V with A the AND of its gates and V
// its result from acc_in = 0, so a row (column) splits into chunks that are
// summarised in parallel, their carries combined, and rescanned. A forward
// scan followed by a backward scan over its output gives every cell the OR
// of its whole run. Rows are split across the 32 lanes of a warp and
// columns into kSegs segments, so a VGA batch keeps tens of thousands of
// threads in flight instead of one per row or column.

#pragma once

#include <cuda_runtime.h>

namespace seg_flood {

constexpr int kScanThreads = 128;  // 4 rows per block in the row pass
constexpr int kSegs = 8;           // row segments per column
constexpr unsigned kFull = 0xffffffffu;

// One warp per row: lane l owns a contiguous chunk; carries combine by
// warp shuffles. The forward pass stores the round's start words.
__global__ void flood_rows(const unsigned* __restrict__ gate,
                           unsigned* __restrict__ reach,
                           unsigned* __restrict__ start,
                           const int* __restrict__ flags, int round, int rows,
                           int W) {
  if (round > 0 && flags[round - 1] == 0) return;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  const size_t base = (size_t)row * W;
  const int chunk = (W + 31) >> 5;
  const int c0 = min(W, lane * chunk);
  const int c1 = min(W, c0 + chunk);

  unsigned A = ~0u, V = 0u;
  for (int c = c0; c < c1; ++c) {
    const unsigned g = gate[base + c];
    const unsigned v = reach[base + c];
    start[base + c] = v;
    V = (V & g) | v;
    A &= g;
  }
  for (int d = 1; d < 32; d <<= 1) {  // inclusive scan, left to right
    const unsigned Ap = __shfl_up_sync(kFull, A, d);
    const unsigned Vp = __shfl_up_sync(kFull, V, d);
    if (lane >= d) {
      V = (Vp & A) | V;
      A &= Ap;
    }
  }
  unsigned acc = __shfl_up_sync(kFull, V, 1);
  if (lane == 0) acc = 0u;
  for (int c = c0; c < c1; ++c) {
    acc = (acc & gate[base + c]) | reach[base + c];
    reach[base + c] = acc;
  }

  // backward over the forward result: every cell gets its whole run
  A = ~0u;
  V = 0u;
  for (int c = c1 - 1; c >= c0; --c) {
    const unsigned g = gate[base + c];
    V = (V & g) | reach[base + c];
    A &= g;
  }
  for (int d = 1; d < 32; d <<= 1) {  // inclusive scan, right to left
    const unsigned Ap = __shfl_down_sync(kFull, A, d);
    const unsigned Vp = __shfl_down_sync(kFull, V, d);
    if (lane + d < 32) {
      V = (Vp & A) | V;
      A &= Ap;
    }
  }
  acc = __shfl_down_sync(kFull, V, 1);
  if (lane == 31) acc = 0u;
  for (int c = c1 - 1; c >= c0; --c) {
    const unsigned g = gate[base + c];
    acc = (acc & g) | reach[base + c];
    reach[base + c] = acc & g;
  }
}

// Blocks of 32 columns x kSegs row segments: a warp reads 32 neighbouring
// columns (coalesced); segment carries combine in shared memory. Raises
// flags[round] when a word differs from the round's start.
__global__ void flood_cols(const unsigned* __restrict__ gate,
                           unsigned* __restrict__ reach,
                           const unsigned* __restrict__ start, int* flags,
                           int round, int N, int H, int W) {
  if (round > 0 && flags[round - 1] == 0) return;  // uniform across the grid
  __shared__ unsigned sA[kSegs][32];
  __shared__ unsigned sV[kSegs][32];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int t = blockIdx.x * 32 + tx;
  const bool valid = t < N * W;
  const int n = valid ? t / W : 0;
  const int c = valid ? t - n * W : 0;
  const size_t base = (size_t)n * H * W + c;
  const int seg = (H + kSegs - 1) / kSegs;
  const int r0 = valid ? min(H, ty * seg) : 0;
  const int r1 = valid ? min(H, r0 + seg) : 0;

  unsigned A = ~0u, V = 0u;
  for (int r = r0; r < r1; ++r) {
    const size_t i = base + (size_t)r * W;
    const unsigned g = gate[i];
    V = (V & g) | reach[i];
    A &= g;
  }
  sA[ty][tx] = A;
  sV[ty][tx] = V;
  __syncthreads();
  unsigned acc = 0u;
  for (int k = 0; k < ty; ++k) acc = (acc & sA[k][tx]) | sV[k][tx];
  __syncthreads();
  for (int r = r0; r < r1; ++r) {
    const size_t i = base + (size_t)r * W;
    acc = (acc & gate[i]) | reach[i];
    reach[i] = acc;
  }

  A = ~0u;
  V = 0u;
  for (int r = r1 - 1; r >= r0; --r) {
    const size_t i = base + (size_t)r * W;
    const unsigned g = gate[i];
    V = (V & g) | reach[i];
    A &= g;
  }
  sA[ty][tx] = A;
  sV[ty][tx] = V;
  __syncthreads();
  acc = 0u;
  for (int k = kSegs - 1; k > ty; --k) acc = (acc & sA[k][tx]) | sV[k][tx];
  bool changed = false;
  for (int r = r1 - 1; r >= r0; --r) {
    const size_t i = base + (size_t)r * W;
    const unsigned g = gate[i];
    acc = (acc & g) | reach[i];
    reach[i] = acc & g;
    changed |= (acc & g) != start[i];
  }
  // every writer stores the same value
  if (changed) flags[round] = 1;
}

// max(rounds, 1) rounds over N planes of [H, W] on stream s: the first
// round always runs, as in the JAX flood. `start` is scratch of the
// state's size; `flags` holds max(rounds, 1) ints zeroed by the caller.
inline cudaError_t flood_rounds(const unsigned* gate, unsigned* reach,
                                unsigned* start, int* flags, int rounds,
                                int N, int H, int W, cudaStream_t s) {
  const int rows_per_block = kScanThreads / 32;
  const int row_blocks = (N * H + rows_per_block - 1) / rows_per_block;
  const int col_blocks = (N * W + 31) / 32;
  const int n_rounds = rounds < 1 ? 1 : rounds;
  for (int r = 0; r < n_rounds; ++r) {
    flood_rows<<<row_blocks, kScanThreads, 0, s>>>(gate, reach, start, flags,
                                                   r, N * H, W);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flood_cols<<<col_blocks, dim3(32, kSegs), 0, s>>>(gate, reach, start,
                                                      flags, r, N, H, W);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace seg_flood
