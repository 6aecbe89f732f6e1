// Gated connected-component labelling on [B, H, W] grids, for sm_90a.
//
// Replaces the TPU kernel pcseg_tpu/ops/connectivity.py::_ccl_pallas.
// Each round, in the order the JAX kernel uses:
//   1. row segmented min-scan, forward then backward, runs cut where gate
//      bit (0,-1) is clear (the edge to the left neighbour);
//   2. column segmented min-scan, runs cut where gate bit (-1,0) is clear;
//   3. for each window offset o in order, a Jacobi min-exchange:
//      lab[p] = min(lab[p], lab[p + off_o]) where gate bit o of p is set,
//      every offset reading the labels as the previous offset left them.
// Rounds stop at the fixed point or after `rounds` rounds. A forward scan
// followed by a backward scan over its output gives the minimum of the
// whole run at every cell, which is what the JAX kernel's
// min(forward, backward) gives.
//
// What bounds it on this card: bytes and launch count, not arithmetic (a
// round is a few integer compares per cell). A round reads and writes the
// label grid about ten times (rows, columns, eight offsets), 1.2 MB per
// VGA frame each, and costs ten launches. The design keeps a round to
// those ten launches, and stops without a host sync: the last offset pass
// of round r raises flags[r] when any label changed, and every kernel of
// round r+1 returns at once when flags[r] is clear. Running the remaining
// launches as no-ops gives the same labels as stopping at the fixed point,
// because the fixed point is stable. Rows are split across the 32 lanes
// of a warp and columns into 8 segments, so a VGA batch keeps tens of
// thousands of threads in flight instead of one per row or column
// (latency, not bandwidth, bound a sequential walk).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 rows per block in the row pass
constexpr int kSegs = 8;       // row segments per column
constexpr unsigned kFull = 0xffffffffu;

// The scans compose per-cell steps acc = reset ? l : min(acc, l). A run
// of cells composes to acc_out = R ? M : min(acc_in, M) (R: some cell of
// the run resets; M: its result from acc_in = +inf), so a row (column)
// splits into chunks that are summarised in parallel, their carries
// combined, and rescanned.
__device__ __forceinline__ void min_step(int& R, int& M, bool reset, int l) {
  M = reset ? l : min(M, l);
  R |= reset;
}

// One warp per row: lane l owns a contiguous chunk; carries combine by
// warp shuffles. The forward pass stores the round's start labels.
__global__ void ccl_rows(const int* __restrict__ gate, int* __restrict__ lab,
                         int* __restrict__ start,
                         const int* __restrict__ flags, int round, int rows,
                         int W, int o_row) {
  if (round > 0 && flags[round - 1] == 0) return;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  const size_t base = (size_t)row * W;
  const int chunk = (W + 31) >> 5;
  const int c0 = min(W, lane * chunk);
  const int c1 = min(W, c0 + chunk);

  int R = 0;
  int M = INT_MAX;
  for (int c = c0; c < c1; ++c) {
    const int l = lab[base + c];
    start[base + c] = l;
    min_step(R, M, c == 0 || !((gate[base + c] >> o_row) & 1), l);
  }
  for (int d = 1; d < 32; d <<= 1) {  // inclusive scan, left to right
    const int Rp = __shfl_up_sync(kFull, R, d);
    const int Mp = __shfl_up_sync(kFull, M, d);
    if (lane >= d) {
      M = R ? M : min(Mp, M);
      R |= Rp;
    }
  }
  int acc = __shfl_up_sync(kFull, M, 1);
  if (lane == 0) acc = INT_MAX;
  for (int c = c0; c < c1; ++c) {
    const int l = lab[base + c];
    const bool reset = c == 0 || !((gate[base + c] >> o_row) & 1);
    acc = reset ? l : min(acc, l);
    lab[base + c] = acc;
  }

  // backward: the edge to the right neighbour is that neighbour's bit
  R = 0;
  M = INT_MAX;
  for (int c = c1 - 1; c >= c0; --c) {
    min_step(R, M, c == W - 1 || !((gate[base + c + 1] >> o_row) & 1),
             lab[base + c]);
  }
  for (int d = 1; d < 32; d <<= 1) {  // inclusive scan, right to left
    const int Rp = __shfl_down_sync(kFull, R, d);
    const int Mp = __shfl_down_sync(kFull, M, d);
    if (lane + d < 32) {
      M = R ? M : min(Mp, M);
      R |= Rp;
    }
  }
  acc = __shfl_down_sync(kFull, M, 1);
  if (lane == 31) acc = INT_MAX;
  for (int c = c1 - 1; c >= c0; --c) {
    const int l = lab[base + c];
    const bool reset = c == W - 1 || !((gate[base + c + 1] >> o_row) & 1);
    acc = reset ? l : min(acc, l);
    lab[base + c] = acc;
  }
}

// Blocks of 32 columns x kSegs row segments: a warp reads 32 neighbouring
// columns (coalesced); segment carries combine in shared memory.
__global__ void ccl_cols(const int* __restrict__ gate, int* __restrict__ lab,
                         const int* __restrict__ flags, int round, int B,
                         int H, int W, int o_col) {
  if (round > 0 && flags[round - 1] == 0) return;  // uniform across the grid
  __shared__ int sR[kSegs][32];
  __shared__ int sM[kSegs][32];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int t = blockIdx.x * 32 + tx;
  const bool valid = t < B * W;
  const int b = valid ? t / W : 0;
  const int c = valid ? t - b * W : 0;
  const size_t base = (size_t)b * H * W + c;
  const int seg = (H + kSegs - 1) / kSegs;
  const int r0 = valid ? min(H, ty * seg) : 0;
  const int r1 = valid ? min(H, r0 + seg) : 0;

  int R = 0;
  int M = INT_MAX;
  for (int r = r0; r < r1; ++r) {
    const size_t i = base + (size_t)r * W;
    min_step(R, M, r == 0 || !((gate[i] >> o_col) & 1), lab[i]);
  }
  sR[ty][tx] = R;
  sM[ty][tx] = M;
  __syncthreads();
  int acc = INT_MAX;
  for (int k = 0; k < ty; ++k) acc = sR[k][tx] ? sM[k][tx] : min(acc, sM[k][tx]);
  __syncthreads();
  for (int r = r0; r < r1; ++r) {
    const size_t i = base + (size_t)r * W;
    const int l = lab[i];
    acc = (r == 0 || !((gate[i] >> o_col) & 1)) ? l : min(acc, l);
    lab[i] = acc;
  }

  R = 0;
  M = INT_MAX;
  for (int r = r1 - 1; r >= r0; --r) {
    const size_t i = base + (size_t)r * W;
    min_step(R, M, r == H - 1 || !((gate[i + W] >> o_col) & 1), lab[i]);
  }
  sR[ty][tx] = R;
  sM[ty][tx] = M;
  __syncthreads();
  acc = INT_MAX;
  for (int k = kSegs - 1; k > ty; --k)
    acc = sR[k][tx] ? sM[k][tx] : min(acc, sM[k][tx]);
  for (int r = r1 - 1; r >= r0; --r) {
    const size_t i = base + (size_t)r * W;
    const int l = lab[i];
    acc = (r == H - 1 || !((gate[i + W] >> o_col) & 1)) ? l : min(acc, l);
    lab[i] = acc;
  }
}

__global__ void ccl_offset(const int* __restrict__ gate,
                           const int* __restrict__ src, int* __restrict__ dst,
                           const int* __restrict__ start, int* flags,
                           int round, int B, int H, int W, int o, int dr,
                           int dc, int last) {
  if (round > 0 && flags[round - 1] == 0) return;
  const size_t hw = (size_t)H * W;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)B * hw) return;
  const size_t b = t / hw;
  const int p = (int)(t - b * hw);
  const int r = p / W;
  const int c = p - r * W;
  int v = src[t];
  if ((gate[t] >> o) & 1) {
    const int rr = r + dr;
    const int cc = c + dc;
    if (rr >= 0 && rr < H && cc >= 0 && cc < W) {
      v = min(v, src[b * hw + (size_t)rr * W + cc]);
    }
  }
  dst[t] = v;
  // labels only decrease, so "differs from the round's start" == changed;
  // every writer stores the same value
  if (last && v != start[t]) flags[round] = 1;
}

}  // namespace

#define PCSEG_CHECK_LAUNCH()                     \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// gate, labels: [B, H, W] int32 on the device. `labels` holds the initial
// labels and receives the result; tmp and start are [B, H, W] int32
// scratch; flags is int32[rounds], zeroed by the caller. offsets is a HOST
// array of n_off (dr, dc) pairs; n_off must be even so the ping-pong of the
// offset passes ends in `labels`.
extern "C" int ccl_gated_launch(const int* gate, int* labels, int* tmp,
                                int* start, int* flags, const int* offsets,
                                int n_off, int o_row, int o_col, int B, int H,
                                int W, int rounds, void* stream) {
  if (n_off <= 0 || n_off > 32 || (n_off & 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = B * H * W;
  const int row_blocks = (B * H + kThreads / 32 - 1) / (kThreads / 32);
  const int col_blocks = (B * W + 31) / 32;
  const int px_blocks = (n + kThreads - 1) / kThreads;
  for (int r = 0; r < rounds; ++r) {
    ccl_rows<<<row_blocks, kThreads, 0, s>>>(gate, labels, start, flags, r,
                                             B * H, W, o_row);
    PCSEG_CHECK_LAUNCH();
    ccl_cols<<<col_blocks, dim3(32, kSegs), 0, s>>>(gate, labels, flags, r,
                                                    B, H, W, o_col);
    PCSEG_CHECK_LAUNCH();
    int* src = labels;
    int* dst = tmp;
    for (int o = 0; o < n_off; ++o) {
      ccl_offset<<<px_blocks, kThreads, 0, s>>>(
          gate, src, dst, start, flags, r, B, H, W, o, offsets[2 * o],
          offsets[2 * o + 1], o == n_off - 1);
      PCSEG_CHECK_LAUNCH();
      int* t = src;
      src = dst;
      dst = t;
    }
  }
  return (int)cudaGetLastError();
}
