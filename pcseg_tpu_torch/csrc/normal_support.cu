// Normal support scan on [B, H, W, 3] f32 points, for sm_90a, in one launch.
//
// Replaces no TPU kernel: JAX computes this step
// (pcseg_tpu/ops/normals.py::find_normal_support) with jnp shift scans, and
// the port's plain version (kernels/normal_support.py::normal_support_plain)
// issues about 16 torch ops for each of the 4 x max_scan_steps offsets,
// some 4,300 launches a call whatever the batch. This kernel computes the
// whole function in one launch:
//   1. per pixel, the walk along each grid axis (up, down, left, right):
//      the first neighbour within max_scan_steps offsets, before the grid
//      edge, that is finite and whose squared distance to the center lies
//      in [min_d2, max_d2] (FindNormalSupportNeighbors,
//      algorithms.h:106-257);
//   2. optionally the four corners of the box those supports span (a side
//      without a support defaults to the next row or column, clamped to the
//      grid, as the reference's init, algorithms.h:129-132), each taken
//      when its two sides exist and it is finite and in the band;
//   3. the ten moment sums (xx, xy, xz, yy, yz, zz, x, y, z, w) of the
//      center, the axis supports in the order up, down, left, right, then
//      the corners (left-up, left-down, right-up, right-down), the support
//      count (0 for a non-finite center), the center mask and the cleared
//      estimator's +x normal hint, so a call puts one kernel on the card.
// Every f32 product, difference and sum is rounded on its own, in the
// plain version's order (d2 = (dx*dx + dy*dy) + dz*dz, each moment
// m = m + term), with the _rn intrinsics (and --fmad=false), so the moment
// grids and the counts equal the plain version's bit for bit.
//
// What bounds it on this card: the bytes of the batch's points read once
// (12 B a pixel) and of the outputs written once (s2, s1, w, count, the
// center mask and the hint: 57 B a pixel): 170 MB and 51 us for a VGA
// batch of 8 at 3.35 TB/s. The walks read up to 4 x max_scan_steps
// neighbours a pixel, but from L1 and L2: a VGA batch's points (29.5 MB)
// fit in the 50 MB L2, and the rows a block's walks cross overlap its
// neighbours'. The design:
// - One thread per pixel, a block of 32 x 8 pixels: a warp runs along a
//   row, so its threads' vertical walks read one contiguous 384-byte run of
//   a row a step, and its horizontal walks neighbouring points; the 8 rows
//   of a block share the rows their vertical walks cross in L1.
// - A walk stops at its first support (most end within a few dozen steps)
//   or at the grid edge; a center with a NaN coordinate has a NaN distance
//   to every neighbour, takes no support and writes zeros without walking.
// - Points are read straight from global memory (__ldg), not staged in
//   shared memory: a walk's reach (up to 64 rows or columns each way) would
//   make a block's staged window many times its own pixels.
// - The moments are accumulated in registers as each walk ends, so a walk
//   keeps only its support's row or column for the corners, which are read
//   again (one point each) at the end.
// Any B, H and W (column blocks with NaN halos, grids narrower than the
// reach, single frames).

#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr unsigned kExpMask = 0x7F800000u;

__device__ __forceinline__ bool is_finite(float v) {
  return (__float_as_uint(v) & kExpMask) != kExpMask;
}

__device__ __forceinline__ bool is_nan(float v) {
  return (__float_as_uint(v) & 0x7FFFFFFFu) > kExpMask;
}

struct Point {
  float x, y, z;
};

__device__ __forceinline__ Point load(const float* __restrict__ frame,
                                      long long cell) {
  const float* p = frame + 3 * cell;
  return Point{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__device__ __forceinline__ bool finite3(const Point& p) {
  return is_finite(p.x) && is_finite(p.y) && is_finite(p.z);
}

// (dx*dx + dy*dy) + dz*dz with d = p - c, each operation rounded
__device__ __forceinline__ float sq_dist(const Point& p, const Point& c) {
  const float dx = __fsub_rn(p.x, c.x);
  const float dy = __fsub_rn(p.y, c.y);
  const float dz = __fsub_rn(p.z, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ void add(float (&m)[10], const Point& p) {
  m[0] = __fadd_rn(m[0], __fmul_rn(p.x, p.x));
  m[1] = __fadd_rn(m[1], __fmul_rn(p.x, p.y));
  m[2] = __fadd_rn(m[2], __fmul_rn(p.x, p.z));
  m[3] = __fadd_rn(m[3], __fmul_rn(p.y, p.y));
  m[4] = __fadd_rn(m[4], __fmul_rn(p.y, p.z));
  m[5] = __fadd_rn(m[5], __fmul_rn(p.z, p.z));
  m[6] = __fadd_rn(m[6], p.x);
  m[7] = __fadd_rn(m[7], p.y);
  m[8] = __fadd_rn(m[8], p.z);
  m[9] = __fadd_rn(m[9], 1.0f);
}

struct Band {
  float min_d2, max_d2;
  __device__ __forceinline__ bool takes(const Point& p,
                                        const Point& c) const {
    if (!finite3(p)) return false;
    const float d2 = sq_dist(p, c);
    return d2 >= min_d2 && d2 <= max_d2;
  }
};

// Walks from (r, c) in steps of (dr, dc) for at most `steps` offsets inside
// the H x W grid; on the first support adds it to `m` and returns its row
// (dr != 0) or column, else -1.
__device__ __forceinline__ int walk(const float* __restrict__ frame, int H,
                                    int W, int r, int c, int dr, int dc,
                                    int steps, const Point& center,
                                    const Band& band, float (&m)[10]) {
  int rr = r, cc = c;
  for (int k = 1; k <= steps; ++k) {
    rr += dr;
    cc += dc;
    if (rr < 0 || rr >= H || cc < 0 || cc >= W) break;
    const Point p = load(frame, (long long)rr * W + cc);
    if (band.takes(p, center)) {
      add(m, p);
      return dr != 0 ? rr : cc;
    }
  }
  return -1;
}

__global__ void __launch_bounds__(kTx* kTy)
    normal_support_kernel(const float* __restrict__ points,
                          float* __restrict__ s2, float* __restrict__ s1,
                          float* __restrict__ wsum, int* __restrict__ count,
                          unsigned char* __restrict__ center_valid,
                          float* __restrict__ hint, int H, int W,
                          int steps, Band band, bool diagonals) {
  const int c = blockIdx.x * kTx + threadIdx.x;
  const int r = blockIdx.y * kTy + threadIdx.y;
  if (r >= H || c >= W) return;
  const long long hw = (long long)H * W;
  const float* __restrict__ frame = points + 3 * hw * blockIdx.z;
  const long long pix = hw * blockIdx.z + (long long)r * W + c;

  const Point center = load(frame, (long long)r * W + c);
  const bool valid = finite3(center);
  float m[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) m[i] = 0.0f;
  int n = 0;
  if (!(is_nan(center.x) || is_nan(center.y) || is_nan(center.z))) {
    if (valid) {
      add(m, center);
      n = 1;
    }
    const int up = walk(frame, H, W, r, c, -1, 0, steps, center, band, m);
    const int down = walk(frame, H, W, r, c, 1, 0, steps, center, band, m);
    const int left = walk(frame, H, W, r, c, 0, -1, steps, center, band, m);
    const int right = walk(frame, H, W, r, c, 0, 1, steps, center, band, m);
    n += (up >= 0) + (down >= 0) + (left >= 0) + (right >= 0);
    if (diagonals) {
      const int min_row = up >= 0 ? up : max(r - 1, 0);
      const int max_row = down >= 0 ? down : min(r + 1, H - 1);
      const int min_col = left >= 0 ? left : max(c - 1, 0);
      const int max_col = right >= 0 ? right : min(c + 1, W - 1);
      const bool has_up = min_row != r, has_down = max_row != r;
      const bool has_left = min_col != c, has_right = max_col != c;
      const bool gate[4] = {has_left && has_up, has_left && has_down,
                            has_right && has_up, has_right && has_down};
      const int rows[4] = {min_row, max_row, min_row, max_row};
      const int cols[4] = {min_col, min_col, max_col, max_col};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!gate[i]) continue;
        const Point p = load(frame, (long long)rows[i] * W + cols[i]);
        if (band.takes(p, center)) {
          add(m, p);
          ++n;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) s2[6 * pix + i] = m[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) s1[3 * pix + i] = m[6 + i];
  wsum[pix] = m[9];
  count[pix] = valid ? n : 0;
  center_valid[pix] = valid;
  hint[3 * pix] = 1.0f;
  hint[3 * pix + 1] = 0.0f;
  hint[3 * pix + 2] = 0.0f;
}

}  // namespace

// points [B, H, W, 3] f32; s2 [B, H, W, 6], s1 [B, H, W, 3], w and count
// [B, H, W] (f32, int32), center_valid [B, H, W] bytes (0 or 1), hint
// [B, H, W, 3] f32 (every pixel's (1, 0, 0)). min_d2 and max_d2 are the f32
// squared distance band; steps is max_scan_steps. Returns a cudaError_t (0
// on success, also when the batch is empty).
extern "C" int normal_support_launch(const float* points, float* s2,
                                     float* s1, float* w, int* count,
                                     unsigned char* center_valid, float* hint,
                                     int B, int H, int W, int steps,
                                     float min_d2, float max_d2,
                                     int diagonals, void* stream) {
  if (B < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  const dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy, B);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  normal_support_kernel<<<grid, dim3(kTx, kTy), 0, (cudaStream_t)stream>>>(
      points, s2, s1, w, count, center_valid, hint, H, W, steps,
      Band{min_d2, max_d2}, diagonals != 0);
  return (int)cudaGetLastError();
}
