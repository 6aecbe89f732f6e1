// Gated connected-component labelling on [B, H, W] grids, for sm_90a, in one
// persistent cooperative launch.
//
// Replaces the TPU kernel pcseg_tpu/ops/connectivity.py::_ccl_pallas.
// Each round, in the order the JAX kernel uses:
//   1. row pass: segmented min-scan forward then backward, runs cut where
//      gate bit o_row (the edge to the left neighbour) is clear;
//   2. column pass: the same down the columns, cut where bit o_col (the
//      edge to the cell above) is clear;
//   3. for each window offset o in order, a Jacobi min-exchange:
//      lab[p] = min(lab[p], lab[p + off_o]) where gate bit o of p is set,
//      every cell reading the labels as the previous offset left them.
// The first round always runs; rounds repeat until a round changes nothing
// or `rounds` rounds have run. A forward scan followed by a backward scan
// over its output gives every cell the minimum of its whole run, which is
// what the JAX kernel's min(forward, backward) gives. Nothing else
// propagates (no union-find, no local fixed points), so the labels are the
// plain version's also when the cap binds.
//
// What bounds it on this card: the latency of a round's passes and the
// bytes they move through L2, not arithmetic (a round is a few integer
// compares per cell). The gate and two label buffers of a VGA batch of 8
// (29.5 MB) stay in the 50 MB L2 across rounds. The design:
// - One launch per call (cudaLaunchCooperativeKernel, one 1024-thread block
//   per SM, seg_flood::prepare): a grid sync after each pass, and the stop
//   test per frame on the device (seg_flood::begin_round's three rotating
//   flag buffers), so no launch is spent per round and none after a
//   frame's fixed point.
// - No copy of a round's start. Every pass writes minima of labels it read,
//   so labels only decrease: a round's output equals its input exactly when
//   no pass wrote a label that differs from the one it read at that cell.
//   Each pass raises its frame's flag on such a write (reading the flag
//   before storing it), so the flags say exactly whether the round changed
//   the frame. Rounds at a fixed point change nothing, so this per-frame
//   stop gives the plain version's labels.
// - Row pass as the flood's (seg_flood.cuh): a warp per row, neighbouring
//   rows on neighbouring SMs, the row staged in shared memory by coalesced
//   loads, each lane scanning a chunk at an odd stride, chunk carries by a
//   5-step shuffle scan of the min monoid: a run composes to
//   acc_out = R ? M : min(acc_in, M) (R: some cell of the run resets; M: its
//   result from acc_in = +inf). The forward rescan also summarises the
//   chunk for the backward scan, so a label is read from L2 once per pass.
// - Column pass and offsets fused: a block owns a strip of sw columns of a
//   frame (32, or as many more as let the strips of a batch fill the grid
//   in one wave: 40 for a VGA batch of 8 on 132 SMs, where 32 took two
//   waves and cost 70 us a pass instead of 35), and stages it with hl
//   halo columns on its left and hr on its
//   right (hl, hr: the sums over the offsets of each one's reach to that
//   side; 3 and 3 for the 3x3 window) in shared memory, from the row pass's
//   output. It scans every staged column (the halo ones redundantly: a
//   column's scan depends on that column alone), runs the ordered offset
//   steps on the strip, each a Jacobi step from one label array of the
//   strip to another, and writes only its own sw columns. The gate is
//   staged as byte planes (one byte a cell for up to 8 offsets), so the two
//   label arrays and the gate of a VGA strip take 164 KB; holding each step's
//   new labels in registers instead spilled to local memory, which the 56 KB
//   of L1 left beside shared memory does not hold. Halo columns are read as
//   the row pass left them, so the pass reads one label buffer and writes the
//   other; the two swap every round, and the launcher orders them so that the
//   last round writes the caller's. A frame that stops had a round that
//   changed nothing, which left both buffers equal, so its labels are in the
//   caller's buffer too. One round is 2 grid syncs and about two passes of
//   label traffic.
// - Shapes past shared memory: a row wider than a warp's staging area, a
//   strip taller than shared memory holds, or halos too wide (the 5x5
//   window's 15 columns and 3 gate bytes a cell at VGA), take a
//   second instance of the kernel (kStaged = false, chosen by
//   seg_flood::prepare): rows staged or in place as they fit, the column
//   scan of 32-column strips in place in global memory, then each offset as
//   its own pass with a grid sync, ping-ponging between the two buffers and
//   back (the count of offsets is even). The same scans and steps on the
//   same labels.

#include <cuda_runtime.h>
#include <limits.h>

#include "seg_flood.cuh"

namespace {

namespace cg = cooperative_groups;
using seg_flood::kBatch;
using seg_flood::kFull;
using seg_flood::kThreads;

constexpr int kMaxOffsets = 32;  // bits of the gate word
// rows a thread of the fused pass loads at once when it stages its strip;
// 8, as the row pass does, made ptxas spill in the staged instance
constexpr int kStage = 4;

struct CclArgs {
  const int* gate;
  const int* src;  // the initial labels, read by round 0's row pass
  int* p0;         // label buffers: the staged instance's round r reads
  int* p1;         // p[r % 2] and writes p[(r + 1) % 2]; the other keeps p0
  int* flags;
  int* rounds_run;
  int B, rounds, n_off, o_row, o_col, hl, hr;
  int sw;          // own columns of a staged strip
  int gate_bytes;  // bytes of the gate word the staged strip keeps a cell
  int offs[2 * kMaxOffsets];  // (dr, dc) per offset
  seg_flood::Plan plan;
};

template <bool kShared, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kShared)
    return *p;
  else
    return __ldcg(p);
}

// Row pass over one row: `in` the labels read (the initial ones in round
// 0), `out` the labels written (may equal `in`). kStaged: the warp stages
// the row in sg/sv, its staging area; otherwise each lane scans its chunk in
// place (a row wider than the staging area).
template <bool kStaged>
__device__ __forceinline__ void row_pass(const seg_flood::Plan& pl,
                                         const int* gate, const int* in,
                                         int* out, int o_row, int* flag,
                                         int* sg, int* sv) {
  const int lane = threadIdx.x & 31;
  const int W = pl.W, chunk = pl.chunk, pad = pl.stride - pl.chunk;
  auto slot = [&](int c) {
    return pad ? c + (int)__umulhi((unsigned)c, pl.magic) : c;
  };
  auto cut = [&](int g) { return !((g >> o_row) & 1); };
  if constexpr (kStaged) {
    for (int c0 = lane; c0 < W; c0 += 32 * kBatch) {
      int gb[kBatch], lb[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int c = c0 + 32 * j;
        gb[j] = c < W ? __ldcg(gate + c) : 0;
        lb[j] = c < W ? __ldcg(in + c) : 0;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int c = c0 + 32 * j;
        if (c < W) {
          sg[slot(c)] = gb[j];
          sv[slot(c)] = lb[j];
        }
      }
    }
    __syncwarp();
  }
  const int c0 = lane * chunk;
  const int n = max(0, min(W - c0, chunk));
  const int* g = kStaged ? sg + lane * pl.stride : gate + c0;
  const int* li = kStaged ? sv + lane * pl.stride : in + c0;
  int* l = kStaged ? sv + lane * pl.stride : out + c0;
  // the gate of the cell after the chunk (its bit o_row is the edge to the
  // chunk's last cell); 0, a cut, past the row's end
  const int g_after =
      c0 + n < W ? (kStaged ? sg[slot(c0 + n)] : __ldcg(gate + c0 + n)) : 0;

  int R = 0, M = INT_MAX;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const bool reset = c0 + i == 0 || cut(ld<kStaged>(g + i));
    const int v = ld<kStaged>(li + i);
    M = reset ? v : min(M, v);
    R |= reset;
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
  // forward rescan; the backward scan's chunk summary is the min of the
  // forward labels up to the chunk's first cut to the right
  bool changed = false, before = true;
  int Mb = INT_MAX;
  int gi = n > 0 ? ld<kStaged>(g) : 0;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const int gn = i + 1 < n ? ld<kStaged>(g + i + 1) : g_after;
    const int v = ld<kStaged>(li + i);
    acc = (c0 + i == 0 || cut(gi)) ? v : min(acc, v);
    changed |= acc != v;
    l[i] = acc;
    if (before) Mb = min(Mb, acc);
    before = before && !cut(gn);
    gi = gn;
  }
  R = !before;
  M = Mb;
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
  int gn = g_after;
#pragma unroll 4
  for (int i = n - 1; i >= 0; --i) {
    const int f = ld<kStaged>(l + i);
    acc = cut(gn) ? f : min(acc, f);
    changed |= acc != f;
    l[i] = acc;
    gn = ld<kStaged>(g + i);
  }
  if constexpr (kStaged) {
    __syncwarp();
#pragma unroll 4
    for (int c = lane; c < W; c += 32) out[c] = sv[slot(c)];
  }
  // many rows of a frame change in a round: store the flag only once
  if (__any_sync(kFull, changed) && lane == 0 && !__ldcg(flag)) *flag = 1;
}

// The carry into this thread's column segment: the exclusive scan of the
// segment summaries (R, M) of its column, top down (or bottom up with
// `up`). Thread t < nseg * S holds segment t / S of column t % S; tR and tM
// hold kThreads ints each. Needs nseg <= 32 (S >= 32).
__device__ int segment_carry(int R, int M, bool up, int S, int nseg, int* tR,
                             int* tM) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t < nseg * S) {
    tR[t] = R;
    tM[t] = M;
  }
  __syncthreads();
  // warp w scans columns w, w + 32, ..., one segment per lane
  for (int c = t >> 5; c < S; c += kThreads / 32) {
    const bool in = lane < nseg;
    int r = in ? tR[lane * S + c] : 0;
    int m = in ? tM[lane * S + c] : INT_MAX;
    int x;
    if (!up) {
      for (int d = 1; d < 32; d <<= 1) {
        const int rp = __shfl_up_sync(kFull, r, d);
        const int mp = __shfl_up_sync(kFull, m, d);
        if (lane >= d) {
          m = r ? m : min(mp, m);
          r |= rp;
        }
      }
      x = __shfl_up_sync(kFull, m, 1);
      if (lane == 0) x = INT_MAX;
    } else {
      for (int d = 1; d < 32; d <<= 1) {
        const int rp = __shfl_down_sync(kFull, r, d);
        const int mp = __shfl_down_sync(kFull, m, d);
        if (lane + d < 32) {
          m = r ? m : min(mp, m);
          r |= rp;
        }
      }
      x = __shfl_down_sync(kFull, m, 1);
      if (lane == 31) x = INT_MAX;
    }
    if (in) tM[lane * S + c] = x;
  }
  __syncthreads();
  return t < nseg * S ? tM[t] : INT_MAX;
}

// Column pass over a strip of S >= 32 columns whose first gate and label
// are g[0] and l[0] (row stride `pitch`): forward then backward segmented
// min-scan, runs cut where `bit` of the gate (bit o_col of the gate word:
// the edge to the cell above) is clear.
// kShared: the strip is in shared memory; otherwise in global memory, and
// columns at or past `ncols` are left alone. Thread t < nseg * S (nseg =
// kThreads / S) scans column t % S over the rows of segment t / S. Returns
// whether this thread changed a label of an `own` column.
template <bool kShared, typename G>
__device__ bool col_scan(const G* g, int* l, size_t pitch, int H, int S,
                         int ncols, bool own, int bit, int* tR, int* tM) {
  const int t = threadIdx.x;
  const int nseg = kThreads / S;
  const int len = (H + nseg - 1) / nseg;
  const int seg = t / S;
  const int c = t - seg * S;
  const bool valid = seg < nseg && c < ncols;
  const int r0 = valid ? min(H, seg * len) : 0;
  const int r1 = valid ? min(H, r0 + len) : 0;
  auto at = [&](int r) { return (size_t)r * pitch + c; };
  auto cut = [&](int gw) { return !((gw >> bit) & 1); };

  int R = 0, M = INT_MAX;
  for (int r = r0; r < r1; ++r) {
    const bool reset = r == 0 || cut(ld<kShared>(g + at(r)));
    const int v = ld<kShared>(l + at(r));
    M = reset ? v : min(M, v);
    R |= reset;
  }
  int acc = segment_carry(R, M, false, S, nseg, tR, tM);
  // forward rescan, summarising the segment for the backward scan
  bool changed = false, before = true;
  int Mb = INT_MAX;
  int gi = r0 < r1 ? (int)ld<kShared>(g + at(r0)) : 0;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const int gn = r + 1 < H ? (int)ld<kShared>(g + at(r + 1)) : 0;
    const int v = ld<kShared>(l + at(r));
    acc = (r == 0 || cut(gi)) ? v : min(acc, v);
    changed |= acc != v;
    l[at(r)] = acc;
    if (before) Mb = min(Mb, acc);
    before = before && !cut(gn);
    gi = gn;
  }
  acc = segment_carry(!before, Mb, true, S, nseg, tR, tM);
  int gn = valid && r1 < H ? (int)ld<kShared>(g + at(r1)) : 0;
#pragma unroll 4
  for (int r = r1 - 1; r >= r0; --r) {
    const int f = ld<kShared>(l + at(r));
    acc = cut(gn) ? f : min(acc, f);
    changed |= acc != f;
    l[at(r)] = acc;
    gn = ld<kShared>(g + at(r));
  }
  return own && changed;
}

// Staged instance: the column pass and the offset steps of the strip of
// frame-local columns [c0, c0 + sw), from `lab` (the row pass's output) to
// `out`; gate, lab and out point at the frame's first cell. Shared memory:
// two label arrays of the strip, then a.gate_bytes byte planes of its gate
// (plane j holds bits 8j..8j+7). Returns whether this thread changed a
// label of the strip's own columns.
__device__ bool fused_strip(const CclArgs& a, const int* gate, const int* lab,
                            int* out, int c0, int* smem, int* tR, int* tM) {
  const int H = a.plan.H, W = a.plan.W;
  const int sw = a.sw;
  const int S = sw + a.hl + a.hr;
  const int SH = S * H;
  const int cb = c0 - a.hl;  // the frame column of strip column 0
  const int nseg = kThreads / S;
  const int t = threadIdx.x;
  const int seg = t / S;
  const int c = t - seg * S;
  int* sl = smem;
  int* sl2 = smem + SH;
  unsigned char* sg = reinterpret_cast<unsigned char*>(smem + 2 * SH);

  // stage: thread t takes strip column c and rows seg, seg + nseg, ...;
  // columns outside the frame hold no edge and the largest label
  if (seg < nseg) {
    const int gc = cb + c;
    const bool in = gc >= 0 && gc < W;
    for (int r = seg; r < H; r += kStage * nseg) {
      int gb[kStage], lb[kStage];
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int rr = r + j * nseg;
        const bool ok = in && rr < H;
        gb[j] = ok ? __ldcg(gate + (size_t)rr * W + gc) : 0;
        lb[j] = ok ? __ldcg(lab + (size_t)rr * W + gc) : INT_MAX;
      }
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int rr = r + j * nseg;
        if (rr < H) {
          sl[rr * S + c] = lb[j];
          for (int k = 0; k < a.gate_bytes; ++k)
            sg[k * SH + rr * S + c] = (unsigned char)(gb[j] >> (8 * k));
        }
      }
    }
  }
  __syncthreads();
  const bool own = seg < nseg && c >= a.hl && c < a.hl + sw && cb + c < W;
  bool changed = col_scan<true>(sg + (a.o_col >> 3) * SH, sl, S, H, S, S,
                                own, a.o_col & 7, tR, tM);
  __syncthreads();

  // the offset steps, each from one label array to the other over this
  // thread's column segment (the column scan's cells); an even count, so
  // the labels end in sl
  const int len = (H + nseg - 1) / nseg;
  const int r0 = seg < nseg ? min(H, seg * len) : H;
  const int r1 = min(H, r0 + len);
  int* src = sl;
  int* dst = sl2;
  for (int o = 0; o < a.n_off; ++o) {
    const int dr = a.offs[2 * o], dc = a.offs[2 * o + 1];
    const unsigned char* gp = sg + (o >> 3) * SH;
    const int bit = o & 7;
    const int cc = c + dc;
    const bool col_in = cc >= 0 && cc < S;
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const int v = src[r * S + c];
      const int rr = r + dr;
      int w = v;
      if (((gp[r * S + c] >> bit) & 1) && col_in && rr >= 0 && rr < H)
        w = min(v, src[rr * S + cc]);
      changed |= own && w != v;
      dst[r * S + c] = w;
    }
    __syncthreads();
    int* tmp = src;
    src = dst;
    dst = tmp;
  }

  // own columns out, in the staging's order
  if (own)
    for (int r = seg; r < H; r += nseg)
      out[(size_t)r * W + cb + c] = sl[r * S + c];
  return changed;
}

// Other instance: offset o as its own pass over every cell of the frames
// still running, from src to dst.
__device__ void offset_pass(const CclArgs& a, int o, const int* src,
                            int* dst, int* cur, const int* last, int r) {
  const int H = a.plan.H, W = a.plan.W;
  const size_t hw = (size_t)H * W;
  const int dr = a.offs[2 * o], dc = a.offs[2 * o + 1];
  for (int f = 0; f < a.B; ++f) {
    if (r > 0 && !__ldcg(last + f)) continue;  // uniform in the grid
    const size_t base = f * hw;
    bool changed = false;
    for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < hw;
         i += (size_t)gridDim.x * kThreads) {
      const int row = (int)(i / W);
      const int col = (int)(i - (size_t)row * W);
      const int v = __ldcg(src + base + i);
      int w = v;
      const int rr = row + dr, cc = col + dc;
      if (((__ldcg(a.gate + base + i) >> o) & 1) && rr >= 0 && rr < H &&
          cc >= 0 && cc < W)
        w = min(v, __ldcg(src + base + (size_t)rr * W + cc));
      changed |= w != v;
      dst[base + i] = w;
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0 && !__ldcg(cur + f))
      cur[f] = 1;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
    ccl_gated_kernel(const __grid_constant__ CclArgs a) {
  extern __shared__ int smem[];
  __shared__ int tR[kThreads];
  __shared__ int tM[kThreads];
  cg::grid_group grid = cg::this_grid();
  const seg_flood::Plan& pl = a.plan;
  const int H = pl.H, W = pl.W;
  const size_t hw = (size_t)H * W;
  const int sw = kStaged ? a.sw : 32;
  const int strips = (W + sw - 1) / sw;
  const int cap = a.rounds < 1 ? 1 : a.rounds;
  const int warp = threadIdx.x >> 5;
  int* sg = smem + (size_t)warp * 2 * 32 * pl.stride;
  int* sv = sg + 32 * pl.stride;

  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < a.B; i += blockDim.x) a.flags[i] = 0;
  grid.sync();
  for (int r = 0; r < cap; ++r) {
    int* cur;
    const int* last;
    if (!seg_flood::begin_round(r, a.B, a.flags, a.rounds_run, &cur, &last))
      break;
    int* p = kStaged && (r & 1) ? a.p1 : a.p0;
    int* q = kStaged && (r & 1) ? a.p0 : a.p1;
    const int* in = r == 0 ? a.src : p;

    seg_flood::for_rows(pl, (long long)a.B * H, [&](long long row) {
      const int f = (int)(row / H);
      if (r > 0 && !__ldcg(last + f)) return;  // uniform in the warp
      const size_t off = (size_t)row * W;
      if (kStaged || pl.row_staged)
        row_pass<true>(pl, a.gate + off, in + off, p + off, a.o_row, cur + f,
                       sg, sv);
      else
        row_pass<false>(pl, a.gate + off, in + off, p + off, a.o_row,
                        cur + f, sg, sv);
      __syncwarp();  // the staging area is reused by the next row
    });
    grid.sync();

    for (int item = blockIdx.x; item < a.B * strips; item += gridDim.x) {
      const int f = item / strips;
      if (r > 0 && !__ldcg(last + f)) continue;  // uniform in the block
      const int c0 = (item - f * strips) * sw;
      const size_t off = f * hw;
      bool changed;
      if constexpr (kStaged)
        changed = fused_strip(a, a.gate + off, p + off, q + off, c0, smem, tR,
                              tM);
      else
        changed = col_scan<false>(a.gate + off + c0, p + off + c0, W, H, 32,
                                  min(32, W - c0), true, a.o_col, tR, tM);
      if (__syncthreads_or(changed) && threadIdx.x == 0 && !__ldcg(cur + f))
        cur[f] = 1;
    }
    if constexpr (!kStaged) {
      grid.sync();
      // an even count of steps: the labels end in p, where they began
      for (int o = 0; o < a.n_off; ++o) {
        offset_pass(a, o, o & 1 ? q : p, o & 1 ? p : q, cur, last, r);
        if (o + 1 < a.n_off) grid.sync();
      }
    }
    grid.sync();
  }
}

seg_flood::Launch g_launch;

}  // namespace

// gate, labels0: [B, H, W] int32 on the device (bit o of gate = the edge to
// offset o passes; the initial labels). labels receives the result; tmp is
// [B, H, W] int32 scratch; flags int32 [3 * B] scratch, uninitialised;
// rounds_run int32 [B], the rounds each frame ran, or null. offsets is a
// HOST array of n_off (dr, dc) pairs, n_off even and at most 32; o_row and
// o_col index the offsets (0, -1) and (-1, 0). One cooperative launch;
// returns its CUDA error (for example cudaErrorCooperativeLaunchTooLarge),
// never falling back.
extern "C" int ccl_gated_launch(const int* gate, const int* labels0,
                                int* labels, int* tmp, int* flags,
                                int* rounds_run, const int* offsets,
                                int n_off, int o_row, int o_col, int B, int H,
                                int W, int rounds, void* stream) {
  if (B <= 0 || n_off <= 0 || n_off > kMaxOffsets || (n_off & 1) ||
      o_row < 0 || o_row >= n_off || o_col < 0 || o_col >= n_off)
    return (int)cudaErrorInvalidValue;
  CclArgs a{};
  long long hl = 0, hr = 0;
  for (int o = 0; o < n_off; ++o) {
    const int dc = offsets[2 * o + 1];
    hl += dc < 0 ? -(long long)dc : 0;
    hr += dc > 0 ? dc : 0;
    a.offs[2 * o] = offsets[2 * o];
    a.offs[2 * o + 1] = dc;
  }
  // the staged instance's strip: sw own and hl + hr halo columns, each
  // row two labels and gate_bytes bytes of gate a column. sw is 32, or
  // wider where that puts every strip of the batch in one wave of blocks
  // (one per SM) and the strip still fits beside the static tables
  const int gate_bytes = (n_off + 7) / 8;
  int dev, sms, optin;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) ||
      (e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return (int)e;
  const long long room = optin - 2LL * kThreads * (long long)sizeof(int);
  auto strip_bytes = [&](long long w) {
    return (w + hl + hr) * H * (8 + gate_bytes);
  };
  long long sw = 32;
  const int per_frame = sms / B;
  if (per_frame > 0 && (long long)B * ((W + 31) / 32) > sms) {
    const long long wide = (W + per_frame - 1) / per_frame;
    if (wide + hl + hr <= kThreads && strip_bytes(wide) <= room) sw = wide;
  }
  const long long S = sw + hl + hr;
  const bool fits = S <= kThreads;
  e = seg_flood::prepare(ccl_gated_kernel<true>, ccl_gated_kernel<false>, H,
                         W, 0, !fits, &g_launch,
                         fits ? (int)((S * (8 + gate_bytes) + 3) / 4) : 0);
  if (e != cudaSuccess) return (int)e;
  const bool staged = g_launch.kernel == (const void*)ccl_gated_kernel<true>;
  const int cap = rounds < 1 ? 1 : rounds;
  // the staged instance's round cap - 1 writes buffer cap % 2
  const bool swap = staged && (cap & 1);
  a.gate = gate;
  a.src = labels0;
  a.p0 = swap ? tmp : labels;
  a.p1 = swap ? labels : tmp;
  a.flags = flags;
  a.rounds_run = rounds_run;
  a.B = B;
  a.rounds = rounds;
  a.n_off = n_off;
  a.o_row = o_row;
  a.o_col = o_col;
  a.hl = (int)hl;
  a.hr = (int)hr;
  a.sw = (int)sw;
  a.gate_bytes = gate_bytes;
  a.plan = g_launch.plan;
  return (int)seg_flood::launch(g_launch, &a, (cudaStream_t)stream);
}
