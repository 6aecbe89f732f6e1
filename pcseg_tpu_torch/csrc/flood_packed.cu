// Segmented OR-flood of packed bit-planes to the fixed point, for sm_90a.
//
// Replaces the TPU kernel pcseg_tpu/models/planar_batched.py::_flood_pallas
// (entered by _flood_call and flood_fill_static; the closure epochs of the
// batched grower run it when the slot budget exceeds the 32 bits of one
// member word). Each of N planes of [H, W] 32-bit words carries 32
// independent floods, one per bit (slot k of a frame is bit k % 32 of its
// word plane k / 32). One round spreads every reached bit through its whole
// run of gate bits along the rows, then along the columns; rounds repeat to
// the fixed point or `rounds` rounds. Planes never interact, so the frames
// of a batch and the word planes of a frame are one stack of N planes.
//
// What bounds it on this card: bytes and launch count, not arithmetic (the
// flood is bitwise AND and OR). Each round reads the gate and reach words
// and writes reach: 1.2 MB each per word plane at VGA, so 59 MB a round for
// a VGA batch of 8 frames at 64 slots (N = 16), above the 50 MB L2. The
// design reads each plane's words once per pass with coalesced loads (a
// warp per row, 32 neighbouring columns per warp in the column pass), keeps
// the run carries in registers and shared memory, and stops without a host
// sync: a device flag per round turns the remaining launches into no-ops
// once a round leaves every word unchanged (seg_flood.cuh). The rounds a
// flood needs are few (the fixed point of a plane comes after as many
// rounds as its reached runs have turns), so the early stop, not the
// per-round bytes, keeps the cap of 64 rounds affordable.
//
// `max_run` of the JAX kernel (a promise that no gate run is longer, which
// bounds its doubling scans) needs no counterpart here: the passes scan
// whole runs, which equals the bounded scans whenever the promise holds.

#include <cuda_runtime.h>

#include "seg_flood.cuh"

// All arrays live on the device, int32 [N, H, W] read as unsigned words:
// gate (input), reach (the flood's sources on entry, its result on return),
// start (scratch). flags: int32[max(rounds, 1)] zeroed by the caller.
extern "C" int flood_packed_launch(const int* gate, int* reach, int* start,
                                   int* flags, int N, int H, int W,
                                   int rounds, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  return (int)seg_flood::flood_rounds(
      reinterpret_cast<const unsigned*>(gate),
      reinterpret_cast<unsigned*>(reach), reinterpret_cast<unsigned*>(start),
      flags, rounds, N, H, W, (cudaStream_t)stream);
}
