// Shared pieces of the port's plan-routing kernels (segment.cu,
// strided.cu, indexed.cu): the lane bit of a packed take-mask, the thread
// layout of a row tile, the plan layer loop over a shared-memory tile, the
// Programmatic Dependent Launch controls and the dynamic shared-memory
// limit.
//
// The layer loop runs what every Pallas plan body in src/repro/kernels
// runs through `shiftnet.apply_plan_operand`: per layer, one static lane
// shift (two for an exchange layer) and a select under constant masks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ bool lane_bit(const uint32_t* row, int lane) {
  return (row[lane >> 5] >> (lane & 31)) & 1u;
}

// Thread layout of a row tile: `lanes` threads per row group, each group
// taking every `groups`-th row, so a beat narrower than the block still
// keeps every thread busy.  A thread owns the same lanes of the same rows
// in every loop of a kernel, so its loads, layers and stores of one (row,
// lane) need no barrier between them beyond the per-layer one.
struct TileMap {
  int lanes, groups, g, t;
  __device__ TileMap(int Wn) {
    lanes = min(Wn, (int)blockDim.x);
    groups = blockDim.x / lanes;
    g = threadIdx.x / lanes;         // == groups for threads left over
    t = threadIdx.x - g * lanes;
  }
};

// Run layers [l0, l1) of the layer table on the tile in `bin`, ping-ponging
// between `ba` and `bb`.  A layer record is (shifts, s0, s1, mask_row):
//   dst[c] = m1[c] ? src[c + s1] : m0[c] ? src[c + s0] : src[c]
// with out-of-tile reads giving 0 (the non-circular static shift).  The
// source lane of lane c is fixed for the layer, so each thread resolves it
// once per lane and then copies it down the rows.
// Returns the buffer that holds the routed tile (`bin` for an empty plan).
template <typename T>
__device__ T* route_plan(T* bin, T* ba, T* bb, int nr, int Wn, int words,
                         const uint32_t* smask, const int* __restrict__ layers,
                         int l0, int l1, const TileMap& tm) {
  T* src = bin;
  for (int l = l0; l < l1; ++l) {
    const int ns = layers[4 * l];
    const int s0 = layers[4 * l + 1];
    const int s1 = layers[4 * l + 2];
    const uint32_t* m0 = smask + (size_t)layers[4 * l + 3] * words;
    const uint32_t* m1 = m0 + words;
    T* dst = (src == ba) ? bb : ba;
    if (tm.g < tm.groups) {
      for (int c = tm.t; c < Wn; c += tm.lanes) {
        int j = c;
        if (ns == 2 && lane_bit(m1, c)) j = c + s1;
        else if (lane_bit(m0, c)) j = c + s0;
        if (j >= 0 && j < Wn) {
          for (int r = tm.g; r < nr; r += tm.groups)
            dst[(size_t)r * Wn + c] = src[(size_t)r * Wn + j];
        } else {
          for (int r = tm.g; r < nr; r += tm.groups)
            dst[(size_t)r * Wn + c] = T(0);
        }
      }
    }
    __syncthreads();
    src = dst;
  }
  return src;
}

// Programmatic Dependent Launch (sm_90): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// kernel before it in the stream still runs.  `pdl_launch_dependents` lets
// the dependent grid start now; `pdl_wait` blocks until the grid before
// has finished and its writes are visible (a no-op without the attribute).
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

#define MAX_DEVICES 64

// Raise a kernel's dynamic shared-memory limit when a tile needs more than
// the default 48 KB.  `granted` (one per kernel instantiation) remembers the
// limit already set on each device, so a steady launch sets nothing.
template <typename K>
static cudaError_t set_smem(K kernel, size_t smem, size_t* granted) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && smem <= granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < MAX_DEVICES) granted[dev] = smem;
  return e;
}
