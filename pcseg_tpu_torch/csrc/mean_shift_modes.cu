// The mean shift's fixed point (M1) on one [H, W, 3] f32 frame, for sm_90a,
// in one launch.
//
// Replaces no TPU kernel: JAX computes this step
// (pcseg_tpu/models/mean_shift.py::mean_shift_modes) with jnp gathers, and
// the port's pipeline ran it inside the host-ops library
// (native/hostops.cc::pcseg_mean_shift_shift) on one host core. This kernel
// computes that function, bit for bit, on the card:
//   1. a pixel seeds when its point is finite and its label is `unlabeled`
//      (the same test, fixed at entry, makes a pixel a window neighbour);
//   2. a seed runs `iterations` shift steps: its window centre is its
//      fractional (row, col) rounded half away from zero (lroundf); the
//      neighbours of the (2 half_win + 1)^2 window inside the grid, rows
//      outer and columns inner, whose squared distance to the mode is at
//      most sq_dist, add their f32 differences (point - mode, row - fr,
//      col - fc) to f64 sums; a support below min_support invalidates the
//      seed for good, else the mode, fr and fc each take the f32 step
//      float(sum / support) and the intensity the support
//      (mean_shift_segmentation.h:232-260);
//   3. every pixel writes its mode xyz, fr, fc, intensity and valid once;
//      a pixel that never seeds writes 0, 0, 0, 0, 0, 1 and 0.
// Every f32 difference, product and sum is rounded on its own, in the
// host library's order (d2 = (dx*dx + dy*dy) + dz*dz, each f64 sum
// s = s + double(d)), with the _rn intrinsics (and --fmad=false), so the
// outputs equal pcseg_mean_shift_shift's, which g++ builds without FMA,
// bit for bit.
//
// What bounds it on this card: each pixel reads its point and label once
// (16 B) and writes 25 B: 12.6 MB and 3.8 us for a VGA frame at
// 3.35 TB/s. The window's reads depend on the data (up to 121 neighbours
// a step, 5 steps, a seed's only) and come from L1 and L2: a VGA frame's
// points and labels (4.9 MB) fit in the 50 MB L2. The design:
// - One thread per pixel, a block of 32 x 8 pixels: the 5 steps of a
//   pixel read only the fixed points and its own mode, so they run in
//   registers with no exchange between threads and no grid sync.
// - The window's points are read straight from global memory (__ldg):
//   a mode drifts away from its pixel, so a block's windows do not share
//   a fixed tile to stage in shared memory.
// - A pixel that never seeds, or whose support falls below the floor,
//   stops stepping at once; its warp's other threads go on.
// Any H and W.

#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr unsigned kExpMask = 0x7F800000u;

__device__ __forceinline__ bool is_finite(float v) {
  return (__float_as_uint(v) & kExpMask) != kExpMask;
}

struct Point {
  float x, y, z;
};

__device__ __forceinline__ Point load(const float* __restrict__ points,
                                      long long cell) {
  const float* p = points + 3 * cell;
  return Point{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__device__ __forceinline__ bool eligible(const float* __restrict__ points,
                                         const int* __restrict__ labels,
                                         long long cell, int unlabeled,
                                         Point& p) {
  if (__ldg(labels + cell) != unlabeled) return false;
  p = load(points, cell);
  return is_finite(p.x) && is_finite(p.y) && is_finite(p.z);
}

// (dx*dx + dy*dy) + dz*dz with d = p - m, each operation rounded
__device__ __forceinline__ float sq_dist(const Point& p, const Point& m) {
  const float dx = __fsub_rn(p.x, m.x);
  const float dy = __fsub_rn(p.y, m.y);
  const float dz = __fsub_rn(p.z, m.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float step(float v, double sum, int support) {
  return __fadd_rn(v, __double2float_rn(__ddiv_rn(sum, (double)support)));
}

__global__ void __launch_bounds__(kTx* kTy)
    mean_shift_modes_kernel(const float* __restrict__ points,
                            const int* __restrict__ labels,
                            float* __restrict__ mode, float* __restrict__ fr,
                            float* __restrict__ fc,
                            float* __restrict__ intensity,
                            unsigned char* __restrict__ valid, int H, int W,
                            int iterations, int half_win, float sq_dist_max,
                            float min_support, int unlabeled) {
  const int c = blockIdx.x * kTx + threadIdx.x;
  const int r = blockIdx.y * kTy + threadIdx.y;
  if (r >= H || c >= W) return;
  const long long pix = (long long)r * W + c;

  Point m{0.0f, 0.0f, 0.0f};
  Point p;
  bool ok = eligible(points, labels, pix, unlabeled, p);
  if (ok) m = p;
  float row = ok ? (float)r : 0.0f;
  float col = ok ? (float)c : 0.0f;
  float inten = 1.0f;
  for (int it = 0; ok && it < iterations; ++it) {
    const int r0 = (int)lroundf(row);
    const int c0 = (int)lroundf(col);
    double sx = 0.0, sy = 0.0, sz = 0.0, sr = 0.0, sc = 0.0;
    int support = 0;
    for (int dr = -half_win; dr <= half_win; ++dr) {
      const int rr = r0 + dr;
      if (rr < 0 || rr >= H) continue;
      const float drow = __fsub_rn((float)rr, row);
      for (int dc = -half_win; dc <= half_win; ++dc) {
        const int cc = c0 + dc;
        if (cc < 0 || cc >= W) continue;
        Point q;
        if (!eligible(points, labels, (long long)rr * W + cc, unlabeled, q))
          continue;
        if (sq_dist(q, m) > sq_dist_max) continue;
        sx = __dadd_rn(sx, (double)__fsub_rn(q.x, m.x));
        sy = __dadd_rn(sy, (double)__fsub_rn(q.y, m.y));
        sz = __dadd_rn(sz, (double)__fsub_rn(q.z, m.z));
        sr = __dadd_rn(sr, (double)drow);
        sc = __dadd_rn(sc, (double)__fsub_rn((float)cc, col));
        ++support;
      }
    }
    if ((float)support < min_support) {
      ok = false;
      break;
    }
    m.x = step(m.x, sx, support);
    m.y = step(m.y, sy, support);
    m.z = step(m.z, sz, support);
    row = step(row, sr, support);
    col = step(col, sc, support);
    inten = (float)support;
  }
  mode[3 * pix] = m.x;
  mode[3 * pix + 1] = m.y;
  mode[3 * pix + 2] = m.z;
  fr[pix] = row;
  fc[pix] = col;
  intensity[pix] = inten;
  valid[pix] = ok;
}

}  // namespace

// points [H, W, 3] f32, labels [H, W] int32; mode [H, W, 3], fr, fc and
// intensity [H, W] f32, valid [H, W] bytes (0 or 1). sq_dist and
// min_support are f32 as the host library takes them. Returns a
// cudaError_t (0 on success, also when the frame is empty).
extern "C" int mean_shift_modes_launch(const float* points, const int* labels,
                                       float* mode, float* fr, float* fc,
                                       float* intensity, unsigned char* valid,
                                       int H, int W, int iterations,
                                       int half_win, float sq_dist,
                                       float min_support, int unlabeled,
                                       void* stream) {
  if (H < 0 || W < 0 || iterations < 0 || half_win < 0)
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return 0;
  const dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  mean_shift_modes_kernel<<<grid, dim3(kTx, kTy), 0, (cudaStream_t)stream>>>(
      points, labels, mode, fr, fc, intensity, valid, H, W, iterations,
      half_win, sq_dist, min_support, unlabeled);
  return (int)cudaGetLastError();
}
