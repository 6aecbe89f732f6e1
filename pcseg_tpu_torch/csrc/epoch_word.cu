// One closure epoch of the batched planar grower, for sm_90a.
//
// Replaces the TPU kernel pcseg_tpu/models/planar_batched.py::
// _epoch_kernel_batched (entered by _epoch_kernel_call, driven by
// run_word_epochs). Up to 32 region slots ride in the bits of one 32-bit
// member word per pixel. Per frame:
//   1. prelude (one thread per pixel, slot tables in shared memory): the
//      claim rank (min slot rank over the pixel's member bits), the gate
//      word (bit k: |plane_k . p| < tau, eligible, claim >= rank_k, slot k
//      alive, inside the Chebyshev box around anchor_k; member bits always
//      pass) and the anchor one-hot word, which seeds the flood;
//   2. flood: per bit, OR-spread of the reached set through whole runs of
//      gate bits, rows then columns, to the fixed point or `rounds` rounds;
//   3. claims + per-block partials: each reached cell keeps the bits of
//      the min-rank slot; per slot, each block sums its cells' count and
//      the 10 plane-fit moments (f32 products, f64 sums) and takes the min
//      64-bit key (seed rank << 32 | col-major index);
//   4. finalize: per slot, the partials summed in block order.
//
// What bounds it on this card: bytes and launch count, not arithmetic. A
// flood round reads the gate and reach words and writes reach (1.2 MB
// each per VGA frame) and costs two launches; an epoch runs up to 64
// rounds. The design stops early without a host sync: the column pass of
// round r raises flags[r] when any word changed, and both passes of round
// r+1 return at once when flags[r] is clear (the fixed point is stable, so
// the no-op launches give the same words as stopping). A forward scan
// followed by a backward scan over its output gives every cell the OR of
// its whole run; rows are split across the 32 lanes of a warp and columns
// into 8 segments, so a VGA batch keeps tens of thousands of threads in
// flight instead of one per row or column (latency, not bandwidth, bound
// a sequential walk). The
// reductions are deterministic (fixed per-thread order, warp shuffles,
// warps in order, blocks in order; no float atomics): a plane that moved
// in its last bits from run to run would flip tau-band knife edges in
// later epochs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 32;
constexpr int kInfRank = 1 << 30;
constexpr int kBigLin = 1 << 30;
constexpr long long kInfKey = ((long long)kInfRank << 32) | kBigLin;
constexpr int kScanThreads = 128;  // 4 rows per block in the row pass
constexpr int kSegs = 8;           // row segments per column
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;  // pixels per thread in the claims pass

__global__ void epoch_prelude(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const int* __restrict__ elig,
    const unsigned* __restrict__ word_in, const int* __restrict__ srank,
    const int* __restrict__ alive, const float* __restrict__ plane,
    const int* __restrict__ anchor_r, const int* __restrict__ anchor_c,
    const int* __restrict__ radius, unsigned* __restrict__ gate,
    unsigned* __restrict__ reach, int H, int W, int K, float tau) {
  __shared__ float s_plane[kMaxSlots][4];
  __shared__ int s_rank[kMaxSlots];
  __shared__ int s_alive[kMaxSlots];
  __shared__ int s_ar[kMaxSlots];
  __shared__ int s_ac[kMaxSlots];
  const int b = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_rank[k] = srank[b * K + k];
    s_alive[k] = alive[b * K + k];
    s_ar[k] = anchor_r[b * K + k];
    s_ac[k] = anchor_c[b * K + k];
    for (int i = 0; i < 4; ++i) s_plane[k][i] = plane[(b * K + k) * 4 + i];
  }
  __syncthreads();
  const int hw = H * W;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const size_t idx = (size_t)b * hw + p;
  const int r = p / W;
  const int c = p - r * W;
  const unsigned word = word_in[idx];
  int claim = kInfRank;
  for (int k = 0; k < K; ++k)
    if ((word >> k) & 1u) claim = min(claim, s_rank[k]);
  const float x = px[idx];
  const float y = py[idx];
  const float z = pz[idx];
  const bool e = elig[idx] != 0;
  const int rad = radius[b];
  unsigned g = 0;
  unsigned a = 0;
  for (int k = 0; k < K; ++k) {
    // ((x*a + y*b) + z*c) + d, each step rounded (built without FMA
    // contraction, as the plain version evaluates it)
    const float dist = fabsf(x * s_plane[k][0] + y * s_plane[k][1]
                             + z * s_plane[k][2] + s_plane[k][3]);
    const bool inbox = abs(r - s_ar[k]) <= rad && abs(c - s_ac[k]) <= rad;
    bool gk = (dist < tau) && e && (claim >= s_rank[k]) && (s_alive[k] != 0)
              && inbox;
    gk = gk || ((word >> k) & 1u);
    if (gk) {
      g |= 1u << k;
      if (r == s_ar[k] && c == s_ac[k]) a |= 1u << k;
    }
  }
  gate[idx] = g;
  reach[idx] = a;
}

// The scans compose per-cell steps acc = (acc & g) | v. A run of cells
// composes to acc_out = (acc_in & A) | V with A the AND of its gates and
// V its result from acc_in = 0, so a row (column) splits into chunks that
// are summarised in parallel, their carries combined, and rescanned.

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
    acc = (acc & gate[base + c]) | reach[base + c];
    reach[base + c] = acc;
  }
}

// Blocks of 32 columns x kSegs row segments: a warp reads 32 neighbouring
// columns (coalesced); segment carries combine in shared memory. Raises
// flags[round] when a word differs from the round's start.
__global__ void flood_cols(const unsigned* __restrict__ gate,
                           unsigned* __restrict__ reach,
                           const unsigned* __restrict__ start, int* flags,
                           int round, int B, int H, int W) {
  if (round > 0 && flags[round - 1] == 0) return;  // uniform across the grid
  __shared__ unsigned sA[kSegs][32];
  __shared__ unsigned sV[kSegs][32];
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
    acc = (acc & gate[i]) | reach[i];
    reach[i] = acc;
    changed |= acc != start[i];
  }
  // every writer stores the same value
  if (changed) flags[round] = 1;
}

__global__ void epoch_claims_partials(
    unsigned* __restrict__ word, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ pz,
    const int* __restrict__ rank, const int* __restrict__ srank,
    double* __restrict__ part_mom, int* __restrict__ part_cnt,
    long long* __restrict__ part_key, int H, int W, int K, int nblk) {
  __shared__ int s_rank[kMaxSlots];
  __shared__ unsigned s_mask;
  __shared__ double s_mom[kWarps][10];
  __shared__ int s_cnt[kWarps];
  __shared__ long long s_key[kWarps];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int k = tid; k < K; k += blockDim.x) s_rank[k] = srank[b * K + k];
  if (tid == 0) s_mask = 0;
  __syncthreads();

  const int hw = H * W;
  unsigned wv[kPix];
  float qx[kPix], qy[kPix], qz[kPix];
  long long key0[kPix];
  unsigned local_mask = 0;
  for (int i = 0; i < kPix; ++i) {
    const int p = blockIdx.x * (kThreads * kPix) + i * kThreads + tid;
    wv[i] = 0;
    qx[i] = qy[i] = qz[i] = 0.f;
    key0[i] = kInfKey;
    if (p >= hw) continue;
    const size_t idx = (size_t)b * hw + p;
    const unsigned reached = word[idx];
    int best = kInfRank;
    for (int k = 0; k < K; ++k)
      if ((reached >> k) & 1u) best = min(best, s_rank[k]);
    unsigned nw = 0;
    if (best < kInfRank)
      for (int k = 0; k < K; ++k)
        if (((reached >> k) & 1u) && s_rank[k] == best) nw |= 1u << k;
    word[idx] = nw;
    wv[i] = nw;
    local_mask |= nw;
    if (nw) {
      const int r = p / W;
      const int c = p - r * W;
      qx[i] = px[idx];
      qy[i] = py[idx];
      qz[i] = pz[idx];
      key0[i] = ((long long)rank[idx] << 32) | (unsigned)(c * H + r);
    }
  }
  if (local_mask) atomicOr(&s_mask, local_mask);
  __syncthreads();
  const unsigned mask = s_mask;

  for (int k = 0; k < K; ++k) {
    const size_t slot = ((size_t)b * nblk + blockIdx.x) * K + k;
    if (!((mask >> k) & 1u)) {
      if (tid == 0) {
        for (int m = 0; m < 10; ++m) part_mom[slot * 10 + m] = 0.0;
        part_cnt[slot] = 0;
        part_key[slot] = kInfKey;
      }
      continue;
    }
    double m[10];
    for (int j = 0; j < 10; ++j) m[j] = 0.0;
    int cnt = 0;
    long long key = kInfKey;
    for (int i = 0; i < kPix; ++i) {
      if (!((wv[i] >> k) & 1u)) continue;
      const float x = qx[i], y = qy[i], z = qz[i];
      m[0] += (double)(x * x);
      m[1] += (double)(x * y);
      m[2] += (double)(x * z);
      m[3] += (double)(y * y);
      m[4] += (double)(y * z);
      m[5] += (double)(z * z);
      m[6] += (double)x;
      m[7] += (double)y;
      m[8] += (double)z;
      m[9] += 1.0;
      cnt += 1;
      key = min(key, key0[i]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      for (int j = 0; j < 10; ++j)
        m[j] += __shfl_down_sync(0xffffffffu, m[j], off);
      cnt += __shfl_down_sync(0xffffffffu, cnt, off);
      key = min(key, (long long)__shfl_down_sync(0xffffffffu, key, off));
    }
    if (lane == 0) {
      for (int j = 0; j < 10; ++j) s_mom[warp][j] = m[j];
      s_cnt[warp] = cnt;
      s_key[warp] = key;
    }
    __syncthreads();
    if (tid == 0) {
      double acc[10];
      for (int j = 0; j < 10; ++j) acc[j] = 0.0;
      int c_acc = 0;
      long long k_acc = kInfKey;
      for (int w = 0; w < kWarps; ++w) {
        for (int j = 0; j < 10; ++j) acc[j] += s_mom[w][j];
        c_acc += s_cnt[w];
        k_acc = min(k_acc, s_key[w]);
      }
      for (int j = 0; j < 10; ++j) part_mom[slot * 10 + j] = acc[j];
      part_cnt[slot] = c_acc;
      part_key[slot] = k_acc;
    }
    __syncthreads();
  }
}

__global__ void epoch_finalize(const double* __restrict__ part_mom,
                               const int* __restrict__ part_cnt,
                               const long long* __restrict__ part_key,
                               int* __restrict__ cnt, int* __restrict__ mrank,
                               int* __restrict__ alin, float* __restrict__ mom,
                               int K, int nblk) {
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  if (k >= K) return;
  double s[10];
  for (int j = 0; j < 10; ++j) s[j] = 0.0;
  int c = 0;
  long long key = kInfKey;
  for (int blk = 0; blk < nblk; ++blk) {
    const size_t slot = ((size_t)b * nblk + blk) * K + k;
    for (int j = 0; j < 10; ++j) s[j] += part_mom[slot * 10 + j];
    c += part_cnt[slot];
    key = min(key, part_key[slot]);
  }
  const int o = b * K + k;
  for (int j = 0; j < 10; ++j) mom[o * 10 + j] = (float)s[j];
  cnt[o] = c;
  mrank[o] = (int)(key >> 32);
  alin[o] = (int)(key & 0xffffffffLL);
}

}  // namespace

#define PCSEG_CHECK_LAUNCH()                     \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// Pixels one block of the claims pass covers; the caller sizes the
// partial buffers with it: nblk = ceil(H*W / epoch_word_pixels_per_block()).
extern "C" int epoch_word_pixels_per_block() { return kThreads * kPix; }

// All arrays live on the device. Frames: px/py/pz f32, rank/elig/word_in
// int32 [B, H, W]; slot tables srank/alive/anchor_r/anchor_c int32 [B, K],
// plane f32 [B, K, 4], radius int32 [B]. Outputs: word_out int32 [B, H, W]
// (also the flood state), cnt/mrank/alin int32 [B, K], mom f32 [B, K, 10].
// Scratch: gate/start int32 [B, H, W], flags int32[rounds] zeroed by the
// caller, part_mom f64 [B, nblk, K, 10], part_cnt int32 and part_key int64
// [B, nblk, K].
extern "C" int epoch_word_launch(
    const float* px, const float* py, const float* pz, const int* rank,
    const int* elig, const int* word_in, const int* srank, const int* alive,
    const float* plane, const int* anchor_r, const int* anchor_c,
    const int* radius, int* word_out, int* gate, int* start, int* flags,
    double* part_mom, int* part_cnt, long long* part_key, int* cnt,
    int* mrank, int* alin, float* mom, int B, int H, int W, int K, float tau,
    int rounds, void* stream) {
  if (K <= 0 || K > kMaxSlots) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int hw = H * W;
  unsigned* ugate = reinterpret_cast<unsigned*>(gate);
  unsigned* ureach = reinterpret_cast<unsigned*>(word_out);
  unsigned* ustart = reinterpret_cast<unsigned*>(start);

  epoch_prelude<<<dim3((hw + kThreads - 1) / kThreads, B), kThreads, 0, s>>>(
      px, py, pz, elig, reinterpret_cast<const unsigned*>(word_in), srank,
      alive, plane, anchor_r, anchor_c, radius, ugate, ureach, H, W, K, tau);
  PCSEG_CHECK_LAUNCH();
  const int rows_per_block = kScanThreads / 32;
  const int row_blocks = (B * H + rows_per_block - 1) / rows_per_block;
  const int col_blocks = (B * W + 31) / 32;
  for (int r = 0; r < rounds; ++r) {
    flood_rows<<<row_blocks, kScanThreads, 0, s>>>(ugate, ureach, ustart,
                                                   flags, r, B * H, W);
    PCSEG_CHECK_LAUNCH();
    flood_cols<<<col_blocks, dim3(32, kSegs), 0, s>>>(ugate, ureach, ustart,
                                                      flags, r, B, H, W);
    PCSEG_CHECK_LAUNCH();
  }
  const int nblk = (hw + kThreads * kPix - 1) / (kThreads * kPix);
  epoch_claims_partials<<<dim3(nblk, B), kThreads, 0, s>>>(
      ureach, px, py, pz, rank, srank, part_mom, part_cnt, part_key, H, W, K,
      nblk);
  PCSEG_CHECK_LAUNCH();
  epoch_finalize<<<B, kMaxSlots, 0, s>>>(part_mom, part_cnt, part_key, cnt,
                                         mrank, alin, mom, K, nblk);
  return (int)cudaGetLastError();
}
