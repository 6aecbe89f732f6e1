// Segmented OR-flood of packed bit-planes to the fixed point, for sm_90a,
// in one persistent cooperative launch.
//
// Replaces the TPU kernel pcseg_tpu/models/planar_batched.py::_flood_pallas
// (entered by _flood_call and flood_fill_static; the closure epochs of the
// batched grower run it when the slot budget exceeds the 32 bits of one
// member word). Each of N planes of [H, W] 32-bit words carries 32
// independent floods, one per bit (slot k of a frame is bit k % 32 of its
// word plane k / 32). One round spreads every reached bit through its whole
// run of gate bits along the rows, then along the columns; rounds repeat to
// the fixed point or `rounds` rounds. Planes never interact, so the frames
// of a batch and the word planes of a frame are one stack of N planes, and
// each plane stops on its own, as JAX's one program per word plane does.
//
// What bounds it on this card (H100, tools/kernel_phases.py): the latency
// of a round (~14 us) for one or two word planes, the bytes of a round
// through L2 (~45 us) for the 16 planes of a VGA batch at 64 slots, whose
// gate and reach (39 MB) stay inside the 50 MB L2 (seg_flood.cuh). The
// design runs every round in one launch with a grid sync after each pass
// and a per-plane stop test on the device that needs no copy of the
// round's start, so no launch is spent on a round after a plane's fixed
// point. The sources are read by the first row pass, so the call copies
// nothing.

#include <cuda_runtime.h>

#include "seg_flood.cuh"

namespace {

namespace cg = cooperative_groups;

struct FloodArgs {
  const unsigned* gate;
  const unsigned* src;
  unsigned* reach;
  int* flags;
  int* rounds_run;
  int N, rounds;
  seg_flood::Plan plan;
};

template <bool kStaged>
__global__ void __launch_bounds__(seg_flood::kThreads, 1)
    flood_packed_kernel(FloodArgs a) {
  extern __shared__ unsigned smem[];
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < a.N; i += blockDim.x) a.flags[i] = 0;
  grid.sync();
  seg_flood::flood<kStaged>(grid, a.plan, smem, a.gate, a.src, a.reach,
                            a.flags, a.rounds_run, a.rounds, a.N);
}

seg_flood::Launch g_launch;

}  // namespace

// All arrays live on the device, int32 [N, H, W] read as unsigned words:
// gate (input), src (the flood's sources), reach (the result). Scratch:
// flags int32 [3 * N], uninitialised. rounds_run: int32 [N], the rounds
// each plane ran, or null. One cooperative launch; returns its CUDA error,
// never falling back.
extern "C" int flood_packed_launch(const int* gate, const int* src,
                                   int* reach, int* flags, int* rounds_run,
                                   int N, int H, int W, int rounds,
                                   void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = seg_flood::prepare(flood_packed_kernel<true>,
                                     flood_packed_kernel<false>, H, W, 0,
                                     false, &g_launch);
  if (e != cudaSuccess) return (int)e;
  FloodArgs a{reinterpret_cast<const unsigned*>(gate),
              reinterpret_cast<const unsigned*>(src),
              reinterpret_cast<unsigned*>(reach), flags, rounds_run, N,
              rounds, g_launch.plan};
  return (int)seg_flood::launch(g_launch, &a, (cudaStream_t)stream);
}
