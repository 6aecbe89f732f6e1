// Segmented OR-flood of packed bit-planes, run to its fixed point inside one
// persistent cooperative launch: the flood that the closure-epoch kernel
// (epoch_word.cu) and the packed flood (flood_packed.cu) share. The gated
// CCL (ccl_gated.cu) shares the launch plan (make_plan, prepare, launch),
// the flag rotation (begin_round) and the row scheduling (for_rows).
//
// State: N planes of [H, W] 32-bit words; bit j of a word is an independent
// flood. One round spreads every set bit through its whole run of gate bits
// along the row (row pass), then along the column (column pass); a run is
// cut by a cleared gate bit. A cell outside the gate keeps no bit after a
// pass, but the bit it held when the pass began spreads into the runs on
// both of its sides, as the JAX kernel's fwd|bwd scans do. The first round
// always runs; rounds repeat until a round changes nothing or `rounds`
// rounds have run. Nothing else propagates: a round is exactly one row pass
// and one column pass, so the words are the plain version's also when the
// cap binds.
//
// What bounds it on this card (H100, tools/kernel_phases.py): for one or
// two planes, the latency of a round: a row pass (~5 us, a warp's
// dependent scans over one row), a grid sync (1.1 us with 132 blocks), a
// column pass (~8 us, a block's scans over one strip) and a grid sync,
// ~14 us in all. For a VGA batch (8 planes for B1, 16 for B3 at 64
// slots), the bytes through L2: a pass reads the gate and reach words and
// writes reach, 3.7 MB per plane, and 16 planes take ~45 us a round. The
// gate and reach of such a batch (20 and 39 MB) fit the 50 MB L2, so no
// round after the first goes to HBM. The AND/OR arithmetic never bounds it.
// The design:
// - One launch per call (cudaLaunchCooperativeKernel, one 1024-thread block
//   per SM): blocks walk the row and the column work items grid-stride and
//   a grid sync follows each pass, so no launch is spent per round and none
//   after the fixed point.
// - The stop test is on the device and per plane. A pass raises its
//   plane's flag when it writes a word that differs from the one it read.
//   After any pass every set bit lies inside the gate, and from then on a
//   pass only adds bits. So a round whose output equals its input had its
//   input inside the gate, and then neither pass changed a word; and a
//   round in which no pass changed a word left the words as they were. The
//   flags thus say exactly whether a round changed the plane, with no copy
//   of the round's start; a pass reads its plane's flag before storing it,
//   so the rows of a plane do not all store to one word. A plane whose
//   last round changed nothing is skipped, and the loop ends when no plane
//   changed. Rounds at a fixed point change nothing, so this per-plane
//   stop gives the words of the plain version's whole-stack stop. The
//   flags rotate over three buffers:
//   round r writes buffer r % 3, reads round r - 1's, and clears round
//   r + 1's, which round r - 1 was the last to read; so no clear races with
//   a read, and only buffer 0 is zeroed before the first round.
// - Row pass: one warp per row, neighbouring rows on neighbouring SMs. The
//   warp stages the row's gate and reach words in shared memory with
//   coalesced loads (lane l loads columns l, l + 32, ..., eight in flight);
//   each lane then scans its own chunk of ceil(W / 32) neighbouring columns
//   (chunks at an odd stride, so the 32 lanes hit 32 banks), and the chunk
//   carries combine with a 5-step shuffle scan. The
//   forward rescan also summarises the chunk for the backward scan, so a
//   word is read from L2 once per pass and from shared memory once per
//   direction.
// - Column pass: one block per strip of 32 columns of a plane; warp s owns
//   the s-th of 32 row segments and lane c one column, so every global load
//   and store is a coalesced 128-byte row of the strip. Each thread stages
//   its own segment in shared memory (2 x H x 32 words for the strip: 123
//   KB at VGA, opt-in dynamic shared memory), and the segment carries
//   combine with one shuffle scan per direction across the 32 segments.
// - Shapes past shared memory: a row wider than a warp's staging area
//   (~27,000 columns on an H100) or a strip taller than shared memory
//   (~870 rows) is scanned in place in global memory, the same scans on
//   the same words (make_plan), by a second instance of the caller's
//   kernel (flood<false>, chosen by prepare); inside the staged instance
//   that branch made ptxas spill and slowed every VGA round. The flood
//   keeps every shape, the largest at a cost in uncoalesced row loads or
//   column-pass L2 traffic.
//
// The scans compose per-cell steps acc = (acc & g) | v. A run of cells
// composes to acc_out = (acc_in & A) | V with A the AND of its gates and V
// its result from acc_in = 0, so a row (column) splits into chunks that are
// summarised in parallel, their carries combined, and rescanned. A forward
// scan followed by a backward scan over its output gives every cell the OR
// of its whole run.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace seg_flood {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;  // one block per SM
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;  // loads a thread keeps in flight
constexpr unsigned kFull = 0xffffffffu;

// The shared-memory layout of a launch, fixed by the plane shape.
struct Plan {
  int H, W;
  int chunk;      // columns per lane in the row pass, ceil(W / 32)
  int stride;     // words per lane chunk in shared memory (odd)
  unsigned magic;  // c / chunk == __umulhi(c, magic) for c < W (chunk even)
  int row_warps;  // warps that take rows, each staging 2 * 32 * stride words
  int seg;        // rows per warp in the column pass, ceil(H / 32)
  int row_staged;  // a row fits in a warp's staging area
  int col_staged;  // a column strip fits in shared memory
  size_t smem;    // dynamic shared memory bytes
};

// Plan for [H, W] planes with at least `min_smem` bytes of dynamic shared
// memory (for the caller's other phases), within `max_smem` bytes; a row
// or a column strip that does not fit is scanned in place. A staged column
// strip holds `strip_words` words per row (the flood's: gate and reach of
// 32 columns). An error only when `min_smem` itself does not fit.
inline cudaError_t make_plan(int H, int W, size_t min_smem, size_t max_smem,
                             Plan* pl, int strip_words = 2 * 32) {
  if (H <= 0 || W <= 0 || min_smem > max_smem) return cudaErrorInvalidValue;
  pl->H = H;
  pl->W = W;
  pl->chunk = (W + 31) / 32;
  pl->stride = pl->chunk | 1;
  // ceil(2^32 / chunk): exact division while c * chunk < 2^32; only the
  // padded layout (even chunk, so chunk >= 2) divides
  pl->magic = pl->chunk > 1 ? 0xffffffffu / pl->chunk + 1 : 0u;
  pl->seg = (H + kWarps - 1) / kWarps;
  const size_t col = (size_t)strip_words * H * sizeof(unsigned);
  const size_t row = 2 * 32 * (size_t)pl->stride * sizeof(unsigned);
  pl->row_staged = row <= max_smem;
  pl->col_staged = col <= max_smem;
  size_t smem = min_smem;
  if (pl->row_staged) {
    const size_t rows = kWarps * row < max_smem ? kWarps * row : max_smem;
    if (rows > smem) smem = rows;
  }
  if (pl->col_staged && col > smem) smem = col;
  pl->smem = smem;
  pl->row_warps = kWarps;
  if (pl->row_staged && (int)(smem / row) < kWarps)
    pl->row_warps = (int)(smem / row);
  return cudaSuccess;
}

// One launch configuration per library, computed on first use and again
// only when the device, the plane shape or the strip width changes.
struct Launch {
  int dev = -1, H = 0, W = 0, strip = 0;
  int blocks = 0;
  const void* kernel = nullptr;
  Plan plan;
};

// Fill `c` on the current device: the plan, the kernel (`staged` when the
// plan stages every row and strip and the caller's other phases allow it,
// else `in_place`), its opt-in dynamic shared memory, and the grid of as
// many blocks as can be co-resident (a cooperative launch needs them all
// resident at once). `strip_words` as for make_plan.
template <typename Kernel>
inline cudaError_t prepare(Kernel staged, Kernel in_place, int H, int W,
                           size_t min_smem, bool need_in_place, Launch* c,
                           int strip_words = 2 * 32) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (c->dev == dev && c->H == H && c->W == W && c->strip == strip_words)
    return cudaSuccess;
  int optin, sms, coop;
  if ((e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) ||
      (e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)))
    return e;
  if (!coop) return cudaErrorNotSupported;
  Kernel kernel = need_in_place ? in_place : staged;
  Plan pl;
  for (;;) {
    cudaFuncAttributes fa;
    if ((e = cudaFuncGetAttributes(&fa, kernel)) ||
        (e = make_plan(H, W, min_smem, (size_t)optin - fa.sharedSizeBytes,
                       &pl, strip_words)))
      return e;
    if (kernel == in_place || (pl.row_staged && pl.col_staged)) break;
    kernel = in_place;  // plan again with its own static shared memory
  }
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)pl.smem)))
    return e;
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, pl.smem)))
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  c->dev = dev;
  c->H = H;
  c->W = W;
  c->strip = strip_words;
  c->blocks = per_sm * sms;
  c->kernel = (const void*)kernel;
  c->plan = pl;
  return cudaSuccess;
}

// Cooperative launch of the prepared kernel on `args`.
template <typename Args>
inline cudaError_t launch(const Launch& c, Args* args, cudaStream_t s) {
  void* params[] = {args};
  return cudaLaunchCooperativeKernel(c.kernel, dim3(c.blocks),
                                     dim3(kThreads), params, c.plan.smem, s);
}

// Start of round r of a loop to the fixed point over N planes, each with
// a flag in three rotating buffers of N ints (see the header comment):
// `cur` is the buffer round r raises, `last` the one round r - 1 raised.
// Returns false, uniformly over the grid, when round r - 1 changed no
// plane; otherwise block 0 clears round r + 1's buffer and records r + 1 in
// rounds_run (when not null) for each plane that runs round r.
__device__ __forceinline__ bool begin_round(int r, int N, int* flags,
                                            int* rounds_run, int** cur,
                                            const int** last) {
  *cur = flags + (r % 3) * N;
  *last = flags + ((r + 2) % 3) * N;
  if (r > 0) {  // every block reads the same flags: a uniform stop
    int any = 0;
    for (int p = threadIdx.x; p < N; p += blockDim.x)
      any |= __ldcg(*last + p);
    if (!__syncthreads_or(any)) return false;
  }
  if (blockIdx.x == 0) {
    int* next = flags + ((r + 1) % 3) * N;
    for (int p = threadIdx.x; p < N; p += blockDim.x) {
      next[p] = 0;
      if (rounds_run && (r == 0 || __ldcg(*last + p))) rounds_run[p] = r + 1;
    }
  }
  return true;
}

// fn(row) for each of `rows` rows, one warp per row: neighbouring rows on
// neighbouring SMs, the plan's row_warps warps of each block. fn ends with
// a __syncwarp where it reuses a warp's staging area.
template <typename Fn>
__device__ __forceinline__ void for_rows(const Plan& pl, long long rows,
                                         Fn fn) {
  const int warp = threadIdx.x >> 5;
  if (warp >= pl.row_warps) return;
  const long long step = (long long)gridDim.x * pl.row_warps;
  for (long long row = (long long)warp * gridDim.x + blockIdx.x; row < rows;
       row += step)
    fn(row);
}

// A word of the flood state: from shared memory, or from L2 (words written
// by other blocks are read after a grid sync, past the non-coherent L1).
template <bool kShared>
__device__ __forceinline__ unsigned load(const unsigned* p) {
  if constexpr (kShared)
    return *p;
  else
    return __ldcg(p);
}

// Row pass over one row: `in` the words read (the sources in round 0),
// `out` the words written. kStaged: the warp stages the row in sg/sv, its
// staging area; otherwise each lane scans its chunk in place (a row wider
// than the staging area).
template <bool kStaged>
__device__ __forceinline__ void row_pass(const Plan& pl, const unsigned* gate,
                         const unsigned* in, unsigned* out, int* flag,
                         unsigned* sg, unsigned* sv) {
  const int lane = threadIdx.x & 31;
  const int W = pl.W, chunk = pl.chunk, pad = pl.stride - pl.chunk;
  // staging slot of column c: its lane's chunk at an odd stride
  auto slot = [&](int c) {
    return pad ? c + (int)__umulhi((unsigned)c, pl.magic) : c;
  };
  if constexpr (kStaged) {
    for (int c0 = lane; c0 < W; c0 += 32 * kBatch) {
      unsigned gb[kBatch], vb[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int c = c0 + 32 * j;
        gb[j] = c < W ? __ldcg(gate + c) : 0u;
        vb[j] = c < W ? __ldcg(in + c) : 0u;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int c = c0 + 32 * j;
        if (c < W) {
          sg[slot(c)] = gb[j];
          sv[slot(c)] = vb[j];
        }
      }
    }
    __syncwarp();
  }
  const int n = max(0, min(W - lane * chunk, chunk));
  // this lane's chunk: the gate, the words the pass reads and those it
  // writes (the same staged words, or `in` and `out` in place)
  const unsigned* g = kStaged ? sg + lane * pl.stride : gate + lane * chunk;
  const unsigned* vi = kStaged ? sv + lane * pl.stride : in + lane * chunk;
  unsigned* v = kStaged ? sv + lane * pl.stride : out + lane * chunk;

  unsigned A = ~0u, V = 0u;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const unsigned gi = load<kStaged>(g + i);
    V = (V & gi) | load<kStaged>(vi + i);
    A &= gi;
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
  // forward rescan; the backward scan's chunk summary is the OR of each
  // forward word masked by the gates before it in the chunk
  bool changed = false;
  unsigned before = ~0u;
  A = ~0u;
  V = 0u;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const unsigned gi = load<kStaged>(g + i), wi = load<kStaged>(vi + i);
    acc = (acc & gi) | wi;
    changed |= acc != wi;
    v[i] = acc;
    V |= acc & before;
    before &= gi;
    A &= gi;
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
#pragma unroll 4
  for (int i = n - 1; i >= 0; --i) {
    const unsigned gi = load<kStaged>(g + i), fi = load<kStaged>(v + i);
    acc = (acc & gi) | fi;
    const unsigned o = acc & gi;
    changed |= o != fi;
    v[i] = o;
  }
  if constexpr (kStaged) {
    __syncwarp();
#pragma unroll 4
    for (int c = lane; c < W; c += 32) out[c] = sv[slot(c)];
  }
  // many rows of a plane change in a round: store the flag only once
  if (__any_sync(kFull, changed) && lane == 0 && !__ldcg(flag)) *flag = 1;
}

// The carry into this thread's segment: the exclusive scan of the 32
// segment summaries (A, V) of its column, top down (or bottom up).
__device__ unsigned segment_carry(unsigned A, unsigned V, bool up,
                                  unsigned (*sA)[33], unsigned (*sV)[33]) {
  const int lane = threadIdx.x & 31;
  const int seg = threadIdx.x >> 5;
  sA[seg][lane] = A;
  sV[seg][lane] = V;
  __syncthreads();
  // warp `seg` scans column `seg`, one segment per lane
  unsigned a = sA[lane][seg], v = sV[lane][seg], carry;
  if (!up) {
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned ap = __shfl_up_sync(kFull, a, d);
      const unsigned vp = __shfl_up_sync(kFull, v, d);
      if (lane >= d) {
        v = (vp & a) | v;
        a &= ap;
      }
    }
    carry = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) carry = 0u;
  } else {
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned ap = __shfl_down_sync(kFull, a, d);
      const unsigned vp = __shfl_down_sync(kFull, v, d);
      if (lane + d < 32) {
        v = (vp & a) | v;
        a &= ap;
      }
    }
    carry = __shfl_down_sync(kFull, v, 1);
    if (lane == 31) carry = 0u;
  }
  __syncthreads();
  sV[lane][seg] = carry;
  __syncthreads();
  return sV[seg][lane];
}

// Column pass over the strip of `ncols` <= 32 columns whose first word is
// gate[0] / reach[0] (row stride W). kStaged: the strip is staged in
// shared memory (row stride 32); otherwise each thread scans its segment
// in place (a strip taller than shared memory holds), and a lane past the
// strip's last column touches no word.
template <bool kStaged>
__device__ __forceinline__ void col_pass(const Plan& pl, const unsigned* gate,
                                         unsigned* reach, int ncols, int* flag,
                                         unsigned* smem, unsigned (*sA)[33],
                                         unsigned (*sV)[33]) {
  const int lane = threadIdx.x & 31;
  const int seg = threadIdx.x >> 5;
  const int W = pl.W;
  const bool valid = lane < ncols;
  const bool mine = kStaged || valid;  // the cells this thread may touch
  const int r0 = min(pl.H, seg * pl.seg);
  const int r1 = min(pl.H, r0 + pl.seg);
  const unsigned* sg = kStaged ? smem : gate;
  unsigned* sv = kStaged ? smem + pl.H * 32 : reach;
  // cell r of this thread's column: staged (row stride 32) or in place
  auto at = [&](int r) {
    if constexpr (kStaged)
      return r * 32 + lane;
    else
      return (size_t)r * W + lane;
  };

  unsigned A = ~0u, V = 0u;
  for (int q = r0; q < r1; q += kBatch) {
    unsigned gb[kBatch], vb[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool in = valid && q + j < r1;
      const size_t i = (size_t)(q + j) * W + lane;
      gb[j] = in ? __ldcg(gate + i) : 0u;
      vb[j] = in ? __ldcg(reach + i) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (q + j < r1) {
        if constexpr (kStaged) {
          smem[at(q + j)] = gb[j];
          sv[at(q + j)] = vb[j];
        }
        V = (V & gb[j]) | vb[j];
        A &= gb[j];
      }
    }
  }
  unsigned acc = segment_carry(A, V, false, sA, sV);
  bool changed = false;
  unsigned before = ~0u;
  V = 0u;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const unsigned g = mine ? load<kStaged>(sg + at(r)) : 0u;
    const unsigned v = mine ? load<kStaged>(sv + at(r)) : 0u;
    acc = (acc & g) | v;
    changed |= acc != v;
    if (mine) sv[at(r)] = acc;
    V |= acc & before;
    before &= g;
  }
  acc = segment_carry(A, V, true, sA, sV);
#pragma unroll 4
  for (int r = r1 - 1; r >= r0; --r) {
    const unsigned g = mine ? load<kStaged>(sg + at(r)) : 0u;
    const unsigned f = mine ? load<kStaged>(sv + at(r)) : 0u;
    acc = (acc & g) | f;
    const unsigned o = acc & g;
    changed |= o != f;
    if (valid) reach[(size_t)r * W + lane] = o;
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) *flag = 1;
}

// Flood N planes to the fixed point or `rounds` rounds (at least one).
// Round 0's row pass reads `src`, every later pass reads `reach`; the words
// are left in `reach` (src may equal reach). `flags`: 3 x N ints whose
// first N are zero and ordered before this call by a grid sync;
// `rounds_run` (N ints, or null) receives the rounds each plane ran. Every
// block of the grid calls this; it returns after a grid sync. kStaged:
// every row and every column strip is staged in shared memory (the plan's
// row_staged and col_staged); otherwise each pass takes the staged or the
// in-place scan the plan gives it. The two are separate kernels, so the
// in-place scans' registers never weigh on the staged rounds.
template <bool kStaged>
__device__ void flood(cg::grid_group& grid, const Plan& pl, unsigned* smem,
                      const unsigned* gate, const unsigned* src,
                      unsigned* reach, int* flags, int* rounds_run,
                      int rounds, int N) {
  __shared__ unsigned sA[kWarps][33];
  __shared__ unsigned sV[kWarps][33];
  const int H = pl.H, W = pl.W;
  const size_t hw = (size_t)H * W;
  const int cap = rounds < 1 ? 1 : rounds;
  const int warp = threadIdx.x >> 5;
  const int strips = (W + 31) / 32;
  const long long rows = (long long)N * H;
  unsigned* sg = smem + (size_t)warp * 2 * 32 * pl.stride;
  unsigned* sv = sg + 32 * pl.stride;

  for (int r = 0; r < cap; ++r) {
    int* cur;
    const int* last;
    if (!begin_round(r, N, flags, rounds_run, &cur, &last)) break;

    const unsigned* in = r == 0 ? src : reach;
    for_rows(pl, rows, [&](long long row) {
      const int p = (int)(row / H);
      if (r > 0 && !__ldcg(last + p)) return;  // uniform in the warp
      const size_t off = (size_t)row * W;
      if (kStaged || pl.row_staged)
        row_pass<true>(pl, gate + off, in + off, reach + off, cur + p, sg,
                       sv);
      else
        row_pass<false>(pl, gate + off, in + off, reach + off, cur + p, sg,
                        sv);
      __syncwarp();  // the staging area is reused by the next row
    });
    grid.sync();

    for (int item = blockIdx.x; item < N * strips; item += gridDim.x) {
      const int p = item / strips;
      if (r > 0 && !__ldcg(last + p)) continue;  // uniform in the block
      const int c0 = (item - p * strips) * 32;
      const size_t off = p * hw + c0;
      if (kStaged || pl.col_staged)
        col_pass<true>(pl, gate + off, reach + off, min(32, W - c0), cur + p,
                       smem, sA, sV);
      else
        col_pass<false>(pl, gate + off, reach + off, min(32, W - c0),
                        cur + p, smem, sA, sV);
    }
    grid.sync();
  }
}

}  // namespace seg_flood
