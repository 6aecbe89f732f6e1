// One closure epoch of the batched planar grower, for sm_90a, in one
// persistent cooperative launch.
//
// Replaces the TPU kernel pcseg_tpu/models/planar_batched.py::
// _epoch_kernel_batched (entered by _epoch_kernel_call, driven by
// run_word_epochs). Up to 32 region slots ride in the bits of one 32-bit
// member word per pixel. Per frame, each phase over the whole grid and a
// grid sync between phases:
//   1. prelude (one thread per pixel, the frame's slot tables in shared
//      memory): the claim rank (min slot rank over the pixel's member
//      bits), the gate word (bit k: |plane_k . p| < tau, eligible, claim >=
//      rank_k, slot k alive, inside the Chebyshev box around anchor_k;
//      member bits always pass) and the anchor one-hot word, which seeds
//      the flood;
//   2. flood (seg_flood.cuh): per bit, OR-spread of the reached set through
//      whole runs of gate bits, rows then columns, to the fixed point or
//      `rounds` rounds, each frame stopping on its own;
//   3. claims + partials: each reached cell keeps the bits of the min-rank
//      slot; per slot, each 256-thread group sums its 1024 cells' count and
//      the 10 plane-fit moments (f32 products, f64 sums) and takes the min
//      64-bit key (seed rank * 2^32 + col-major index), four groups per
//      block on their own barriers;
//   4. finalize (a warp per frame, slot and field): per slot, the
//      partials summed in their fixed order.
//
// What bounds it on this card (H100, tools/kernel_phases.py, first-epoch
// inputs of a VGA batch of 8): the flood's rounds, ~27 us each
// (seg_flood.cuh), then the claims (~90 us: per slot present in a 1024-cell
// block, a warp-shuffle tree of 12 f64/int sums) and the prelude (~53 us,
// ~50 with no slot alive: the latency of its loads, a 1024-pixel tile per
// block at a time); its bytes (each input read and each output written
// once) would take 20 us at HBM rate. The design runs the whole epoch in
// one launch, with no launch per flood round; keeps the flood state (gate
// and word, 20 MB for a VGA batch of 8) in L2 across rounds; builds the
// gate from per-frame ballot tables so a pixel tests only its candidate
// slots; and stages the claimed cells in shared memory so the slot loop
// keeps only its sums in registers. The reductions are deterministic and do not
// depend on the grid's size (fixed per-thread order, warp shuffles, warps
// in order, partials of fixed 1024-cell blocks summed in order; no float
// atomics): a plane that moved in its last bits from run to run would flip
// tau-band knife edges in later epochs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_flood.cuh"

namespace {

namespace cg = cooperative_groups;
using seg_flood::kFull;
using seg_flood::kWarps;

constexpr int kMaxSlots = 32;
constexpr int kInfRank = 1 << 30;
constexpr int kBigLin = 1 << 30;
// (rank, col-major index) as one key whose minimum is the lexicographic one:
// rank * 2^32 + index, with 0 <= index < 2^30. Ranks may be negative (the
// temporal seeds rank -1, -2, ...), so no left shift of a signed value;
// key >> 32 (arithmetic) gives the rank back, the low word the index.
__host__ __device__ constexpr long long claim_key(int rank, int index) {
  return (long long)rank * 4294967296LL + (long long)index;
}
constexpr long long kInfKey = claim_key(kInfRank, kBigLin);
constexpr int kGroup = 256;  // threads of a claims group
constexpr int kGroups = seg_flood::kThreads / kGroup;
constexpr int kGroupWarps = kGroup / 32;
constexpr int kPix = 4;  // pixels per thread in the claims pass
constexpr int kCells = kGroup * kPix;  // cells of one partial
constexpr int kGroupSmem = kCells * 24;  // a group's staged cells, bytes
// the prelude tabulates its box and anchor words per row and column when
// H + W is at most this (128 KB of tables), else tests them per pixel in
// the in-place kernel
constexpr int kTableLines = 16384;

struct EpochArgs {
  const float* px;
  const float* py;
  const float* pz;
  const int* rank;
  const int* elig;
  const unsigned* word_in;
  const int* srank;
  const int* alive;
  const float* plane;
  const int* anchor_r;
  const int* anchor_c;
  const int* radius;
  unsigned* word;  // the flood state, then the new member word
  unsigned* gate;
  int* flags;
  int* rounds_run;
  double* part_mom;
  int* part_cnt;
  long long* part_key;
  int* cnt;
  int* mrank;
  int* alin;
  float* mom;
  int B, H, W, K, nblk, rounds, tables;
  float tau;
  seg_flood::Plan plan;
};

// Per frame, each block first tabulates in shared memory, by ballots over
// the slots (lane k = slot k), the words box_r[H] / box_c[W] (bit k: the
// row / column lies within the radius of anchor_k's) and eq_r / eq_c (bit
// k: it is anchor_k's row / column); past kTableLines (only in the
// in-place kernel) a pixel tests the anchors itself. A pixel's candidate
// slots are then box_r & box_c & alive (and its claim rank test), and only
// those compute the plane distance.
template <bool kStaged>
__device__ void prelude(const EpochArgs& a, unsigned* smem) {
  __shared__ float s_plane[kMaxSlots][4];
  __shared__ int s_rank[kMaxSlots];
  __shared__ int s_ar[kMaxSlots];
  __shared__ int s_ac[kMaxSlots];
  __shared__ unsigned s_alive;
  const int H = a.H, W = a.W, K = a.K;
  const int hw = H * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned kmask = K == 32 ? ~0u : (1u << K) - 1;
  const bool tables = kStaged || a.tables;
  unsigned* box_r = smem;
  unsigned* eq_r = box_r + H;
  unsigned* box_c = eq_r + H;
  unsigned* eq_c = box_c + W;
  const int tiles = (hw + blockDim.x - 1) / blockDim.x;
  int loaded = -1;
  for (int item = blockIdx.x; item < a.B * tiles; item += gridDim.x) {
    const int b = item / tiles;  // uniform in the block
    if (b != loaded) {
      __syncthreads();
      const bool slot = lane < K;
      const int o = b * K + (slot ? lane : 0);
      const int ar = a.anchor_r[o], ac = a.anchor_c[o], rad = a.radius[b];
      if (warp == 0) {
        s_rank[lane] = slot ? a.srank[o] : 0;
        s_ar[lane] = ar;
        s_ac[lane] = ac;
        for (int i = 0; i < 4; ++i) s_plane[lane][i] = a.plane[o * 4 + i];
        const unsigned alive = __ballot_sync(kFull, slot && a.alive[o]);
        if (lane == 0) s_alive = alive;
      }
      for (int r = warp; tables && r < H; r += kWarps) {
        const unsigned box = __ballot_sync(kFull, slot && abs(r - ar) <= rad);
        const unsigned eq = __ballot_sync(kFull, slot && r == ar);
        if (lane == 0) {
          box_r[r] = box;
          eq_r[r] = eq;
        }
      }
      for (int c = warp; tables && c < W; c += kWarps) {
        const unsigned box = __ballot_sync(kFull, slot && abs(c - ac) <= rad);
        const unsigned eq = __ballot_sync(kFull, slot && c == ac);
        if (lane == 0) {
          box_c[c] = box;
          eq_c[c] = eq;
        }
      }
      __syncthreads();
      loaded = b;
    }
    const int p = (item - b * tiles) * blockDim.x + threadIdx.x;
    if (p >= hw) continue;
    const size_t idx = (size_t)b * hw + p;
    const int r = p / W;
    const int c = p - r * W;
    const unsigned word = a.word_in[idx] & kmask;
    const float x = a.px[idx];
    const float y = a.py[idx];
    const float z = a.pz[idx];
    const bool e = a.elig[idx] != 0;
    int claim = kInfRank;
    for (unsigned m = word; m; m &= m - 1)
      claim = min(claim, s_rank[__ffs(m) - 1]);
    // bit k: the pixel lies in anchor_k's box / is anchor_k
    unsigned box = 0u, eq = 0u;
    if (tables) {
      box = box_r[r] & box_c[c];
      eq = eq_r[r] & eq_c[c];
    } else {
      const int rad = a.radius[b];
      for (int k = 0; k < K; ++k) {
        const int dr = r - s_ar[k], dc = c - s_ac[k];
        box |= (unsigned)(abs(dr) <= rad && abs(dc) <= rad) << k;
        eq |= (unsigned)(dr == 0 && dc == 0) << k;
      }
    }
    // member bits always pass; the others need eligible, alive, in the box,
    // claim >= rank_k and |plane_k . p| < tau
    unsigned cand = e ? box & s_alive & ~word : 0u;
    unsigned g = word;
    for (unsigned m = cand; m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      // ((x*a + y*b) + z*c) + d, each step rounded (built without FMA
      // contraction, as the plain version evaluates it)
      const float dist = fabsf(x * s_plane[k][0] + y * s_plane[k][1]
                               + z * s_plane[k][2] + s_plane[k][3]);
      if (dist < a.tau && claim >= s_rank[k]) g |= 1u << k;
    }
    a.gate[idx] = g;
    a.word[idx] = g & eq;
  }
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < a.B; i += blockDim.x) a.flags[i] = 0;
}

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "r"(kGroup) : "memory");
}

// Claims and per-slot partials of the 1024-cell block `blk` of frame `b`
// for every item (b, blk), four groups of 256 threads per block. A thread
// stages its cells' new word, point and key in shared memory (24 bytes a
// cell, kGroupSmem per group), so the loop over the slots present in the
// block keeps only its sums in registers; the slots absent from it get
// their empty partials from all threads at once.
__device__ void claims_partials(const EpochArgs& a, unsigned* smem) {
  __shared__ int s_rank[kGroups][kMaxSlots];
  __shared__ unsigned s_mask[kGroups];
  __shared__ double s_mom[kGroups][kGroupWarps][10];
  __shared__ int s_cnt[kGroups][kGroupWarps];
  __shared__ long long s_key[kGroups][kGroupWarps];
  const int grp = threadIdx.x / kGroup;
  const int tid = threadIdx.x % kGroup;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hw = a.H * a.W;
  const int K = a.K;
  const int n = a.nblk;
  long long* c_key = reinterpret_cast<long long*>(
      reinterpret_cast<char*>(smem) + grp * kGroupSmem);
  float* c_x = reinterpret_cast<float*>(c_key + kCells);
  float* c_y = c_x + kCells;
  float* c_z = c_y + kCells;
  unsigned* c_w = reinterpret_cast<unsigned*>(c_z + kCells);
  int loaded = -1;
  for (int item = blockIdx.x * kGroups + grp; item < a.B * n;
       item += gridDim.x * kGroups) {
    const int b = item / n;  // uniform in the group
    const int blk = item - b * n;
    group_sync(grp);  // the group's last item is done with its tables
    if (b != loaded) {
      for (int k = tid; k < K; k += kGroup)
        s_rank[grp][k] = a.srank[b * K + k];
      loaded = b;
    }
    if (tid == 0) s_mask[grp] = 0;
    group_sync(grp);

    unsigned local_mask = 0;
    for (int i = 0; i < kPix; ++i) {
      const int cell = i * kGroup + tid;
      const int p = blk * kCells + cell;
      unsigned nw = 0;
      if (p < hw) {
        const size_t idx = (size_t)b * hw + p;
        const unsigned reached = __ldcg(a.word + idx);
        int best = kInfRank;
        for (unsigned m = reached; m; m &= m - 1)
          best = min(best, s_rank[grp][__ffs(m) - 1]);
        if (best < kInfRank)
          for (unsigned m = reached; m; m &= m - 1)
            if (s_rank[grp][__ffs(m) - 1] == best) nw |= m & (~m + 1);
        a.word[idx] = nw;
        if (nw) {
          const int r = p / a.W;
          const int c = p - r * a.W;
          c_x[cell] = a.px[idx];
          c_y[cell] = a.py[idx];
          c_z[cell] = a.pz[idx];
          c_key[cell] = claim_key(a.rank[idx], c * a.H + r);
        }
      }
      c_w[cell] = nw;
      local_mask |= nw;
    }
    if (local_mask) atomicOr(&s_mask[grp], local_mask);
    group_sync(grp);
    const unsigned mask = s_mask[grp];

    for (int t = tid; t < K * 12; t += kGroup) {
      const int k = t / 12;
      const int f = t - k * 12;
      if ((mask >> k) & 1u) continue;
      const size_t slot = (size_t)b * K + k;  // partials [B, K, field, nblk]
      if (f < 10)
        a.part_mom[(slot * 10 + f) * n + blk] = 0.0;
      else if (f == 10)
        a.part_cnt[slot * n + blk] = 0;
      else
        a.part_key[slot * n + blk] = kInfKey;
    }
    for (unsigned mm = mask; mm; mm &= mm - 1) {
      const int k = __ffs(mm) - 1;
      const size_t slot = (size_t)b * K + k;
      double m[10];
      for (int j = 0; j < 10; ++j) m[j] = 0.0;
      int cnt = 0;
      long long key = kInfKey;
      unsigned mine = 0;  // this thread's cells of slot k, bit i for cell i
      for (int i = 0; i < kPix; ++i)
        mine |= ((c_w[i * kGroup + tid] >> k) & 1u) << i;
      for (int i = 0; i < kPix; ++i) {
        const int cell = i * kGroup + tid;
        if (!((mine >> i) & 1u)) continue;
        const float x = c_x[cell], y = c_y[cell], z = c_z[cell];
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
        key = min(key, c_key[cell]);
      }
      // a warp without cells of slot k has the empty sums already
      if (__any_sync(kFull, mine)) {
        for (int off = 16; off > 0; off >>= 1) {
          for (int j = 0; j < 10; ++j)
            m[j] += __shfl_down_sync(kFull, m[j], off);
          cnt += __shfl_down_sync(kFull, cnt, off);
          key = min(key, (long long)__shfl_down_sync(kFull, key, off));
        }
      }
      if (lane == 0) {
        for (int j = 0; j < 10; ++j) s_mom[grp][warp][j] = m[j];
        s_cnt[grp][warp] = cnt;
        s_key[grp][warp] = key;
      }
      group_sync(grp);
      if (tid < 12) {  // warps in order, one field a thread
        if (tid < 10) {
          double acc = 0.0;
          for (int w = 0; w < kGroupWarps; ++w) acc += s_mom[grp][w][tid];
          a.part_mom[(slot * 10 + tid) * n + blk] = acc;
        } else if (tid == 10) {
          int c_acc = 0;
          for (int w = 0; w < kGroupWarps; ++w) c_acc += s_cnt[grp][w];
          a.part_cnt[slot * n + blk] = c_acc;
        } else {
          long long k_acc = kInfKey;
          for (int w = 0; w < kGroupWarps; ++w)
            k_acc = min(k_acc, s_key[grp][w]);
          a.part_key[slot * n + blk] = k_acc;
        }
      }
      group_sync(grp);
    }
  }
}

// One warp per (frame, slot, field): the 10 moments, the count and the key.
// A moment sums its partials in block order, 32 loaded at a time and
// broadcast lane by lane, so every lane adds them in that order.
__device__ void finalize(const EpochArgs& a) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int n = a.nblk;
  for (int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       w < a.B * a.K * 12; w += warps) {
    const int slot = w / 12;
    const int f = w - slot * 12;
    if (f < 10) {
      const double* src = a.part_mom + ((size_t)slot * 10 + f) * n;
      double s = 0.0;
      for (int c = 0; c < n; c += 32) {
        const double v = c + lane < n ? __ldcg(src + c + lane) : 0.0;
        const int m = min(32, n - c);
        for (int i = 0; i < m; ++i) s += __shfl_sync(seg_flood::kFull, v, i);
      }
      if (lane == 0) a.mom[slot * 10 + f] = (float)s;
    } else if (f == 10) {
      int c = 0;
      for (int i = lane; i < n; i += 32)
        c += __ldcg(a.part_cnt + (size_t)slot * n + i);
      for (int off = 16; off > 0; off >>= 1)
        c += __shfl_down_sync(seg_flood::kFull, c, off);
      if (lane == 0) a.cnt[slot] = c;
    } else {
      long long key = kInfKey;
      for (int i = lane; i < n; i += 32)
        key = min(key, __ldcg(a.part_key + (size_t)slot * n + i));
      for (int off = 16; off > 0; off >>= 1)
        key = min(key, (long long)__shfl_down_sync(seg_flood::kFull, key,
                                                    off));
      if (lane == 0) {
        a.mrank[slot] = (int)(key >> 32);
        a.alin[slot] = (int)(key & 0xffffffffLL);
      }
    }
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(seg_flood::kThreads, 1)
    epoch_word_kernel(EpochArgs a) {
  extern __shared__ unsigned smem[];
  cg::grid_group grid = cg::this_grid();
  prelude<kStaged>(a, smem);
  grid.sync();
  seg_flood::flood<kStaged>(grid, a.plan, smem, a.gate, a.word, a.word,
                            a.flags, a.rounds_run, a.rounds, a.B);
  claims_partials(a, smem);
  grid.sync();
  finalize(a);
}

seg_flood::Launch g_launch;

}  // namespace

// Cells one partial of the claims pass covers; the caller sizes the
// partial buffers with it: nblk = ceil(H*W / epoch_word_pixels_per_block()).
extern "C" int epoch_word_pixels_per_block() { return kCells; }

// All arrays live on the device. Frames: px/py/pz f32, rank/elig/word_in
// int32 [B, H, W]; slot tables srank/alive/anchor_r/anchor_c int32 [B, K],
// plane f32 [B, K, 4], radius int32 [B]. Outputs: word_out int32 [B, H, W]
// (also the flood state), cnt/mrank/alin int32 [B, K], mom f32 [B, K, 10],
// rounds_run int32 [B] (the flood rounds each frame ran; may be null).
// Scratch: gate int32 [B, H, W], flags int32 [3 * B], part_mom f64
// [B, K, 10, nblk], part_cnt int32 and part_key int64 [B, K, nblk]; none
// needs initialising. One cooperative launch; returns its CUDA error (for
// example cudaErrorCooperativeLaunchTooLarge), never falling back.
extern "C" int epoch_word_launch(
    const float* px, const float* py, const float* pz, const int* rank,
    const int* elig, const int* word_in, const int* srank, const int* alive,
    const float* plane, const int* anchor_r, const int* anchor_c,
    const int* radius, int* word_out, int* gate, int* flags, int* rounds_run,
    double* part_mom, int* part_cnt, long long* part_key, int* cnt,
    int* mrank, int* alin, float* mom, int B, int H, int W, int K, float tau,
    int rounds, void* stream) {
  if (K <= 0 || K > kMaxSlots || B <= 0) return (int)cudaErrorInvalidValue;
  // dynamic shared memory for the prelude's tables and the staged cells
  const bool tables = (long long)H + W <= kTableLines;
  const size_t table_bytes = 2 * ((size_t)H + W) * sizeof(unsigned);
  const size_t cells = (size_t)kGroups * kGroupSmem;
  cudaError_t e = seg_flood::prepare(
      epoch_word_kernel<true>, epoch_word_kernel<false>, H, W,
      tables && table_bytes > cells ? table_bytes : cells, !tables,
      &g_launch);
  if (e != cudaSuccess) return (int)e;
  EpochArgs a{px, py, pz, rank, elig,
              reinterpret_cast<const unsigned*>(word_in), srank, alive,
              plane, anchor_r, anchor_c, radius,
              reinterpret_cast<unsigned*>(word_out),
              reinterpret_cast<unsigned*>(gate), flags, rounds_run,
              part_mom, part_cnt, part_key, cnt, mrank, alin, mom,
              B, H, W, K, (H * W + kCells - 1) / kCells,
              rounds, tables, tau, g_launch.plan};
  e = seg_flood::launch(g_launch, &a, (cudaStream_t)stream);
  return (int)e;
}
