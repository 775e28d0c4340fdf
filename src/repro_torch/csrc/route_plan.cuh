// Shared pieces of the port's kernels (segment.cu, strided.cu,
// indexed.cu): the block size, the lane bit of a packed take-mask, the
// thread layout of a row tile, the Programmatic Dependent Launch controls
// and the dynamic shared-memory limit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ bool lane_bit(const uint32_t* row, int lane) {
  return (row[lane >> 5] >> (lane & 31)) & 1u;
}

// Thread layout of a row tile: `lanes` threads per row group, each group
// taking every `groups`-th row, so a beat narrower than the block still
// keeps every thread busy.
struct TileMap {
  int lanes, groups, g, t;
  __device__ TileMap(int Wn) {
    lanes = min(Wn, (int)blockDim.x);
    groups = blockDim.x / lanes;
    g = threadIdx.x / lanes;         // == groups for threads left over
    t = threadIdx.x - g * lanes;
  }
};

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
