// The dynamic-count shift network as device code, shared by the port's
// dynamic kernels (B6/B7 in segment.cu, B8/B9 in strided.cu).
//
// What it computes is the reference's `shiftnet._route`
// (src/repro/core/shiftnet.py), the body of every `*_dyn_kernel`:
// ceil(log2 n) layers (none for n <= 1), layer l a non-circular shift by
// 2^l.  The GSN moves lanes toward lower indices consuming count bits LSB
// first; the SSN toward higher indices, MSB first.  At each layer a lane
// takes its candidate (the lane 2^l away) when the candidate is valid and
// its count has bit l set; a lane whose candidate does not arrive keeps its
// old payload, count and validity (`valid = cand_valid | stay`).
//
// The counts are the same for every row (the Pallas bodies carry them as
// (1, n)), so a block derives the per-layer take-masks ONCE from the
// counts in shared memory and then routes every row of its tile through
// route_plan's lane-major layer loop: one shift record and one select
// under the derived mask row per layer, exactly the reference's
// `layer_masks` + `apply_layer_masks`.  The routing is computed on the
// device at run time from the counts: no host plan, no pruned layers.
//
// Shared-memory state of one network (`DynNet`, carved by `dyn_carve`):
//   masks  L x words   packed take-masks, route_plan's bit format (lane_bit)
//   occ    words       final occupancy (validity after the last layer)
//   layers 4 x L       route_plan layer records (1, shift, 0, mask_row)
//   sc     2 x n       shift counts, ping-pong
//   val    2 x words   packed validity, ping-pong
// The caller fills sc[0, n) and val[0, words) (the `*_counts` helpers
// below, or runtime operands), then calls `dyn_derive` from every thread.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "route_plan.cuh"

// ceil(log2 n) for n >= 2, 0 for n <= 1 (shiftnet._num_layers).
__host__ __device__ inline int dyn_layers(int n) {
  int l = 0;
  while (n > 1 && (1 << l) < n) ++l;
  return l;
}

__host__ __device__ inline size_t dyn_bytes(int n) {
  const int words = (n + 31) / 32;
  const int L = dyn_layers(n);
  const size_t b = 4 * ((size_t)L * words + words + 4 * L + 2 * (size_t)n +
                        2 * words);
  return (b + 15) & ~(size_t)15;
}

struct DynNet {
  uint32_t* masks;
  uint32_t* occ;
  int* layers;
  int* sc;
  uint32_t* val;
  int n, words, L;
};

__device__ inline DynNet dyn_carve(unsigned char* base, int n) {
  DynNet net;
  net.n = n;
  net.words = (n + 31) / 32;
  net.L = dyn_layers(n);
  net.masks = reinterpret_cast<uint32_t*>(base);
  net.occ = net.masks + (size_t)net.L * net.words;
  net.layers = reinterpret_cast<int*>(net.occ + net.words);
  net.sc = net.layers + 4 * net.L;
  net.val = reinterpret_cast<uint32_t*>(net.sc + 2 * (size_t)n);
  return net;
}

// int32 floor division and modulo (jnp's `//` and `%`); C++ truncates
// toward zero, which differs for a negative dividend.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// Fill sc/val with `scg.gather_counts(n, stride, offset, vl)`: position p
// holds output element (p - offset) / stride when it divides exactly; its
// count is p - dest.  Lanes are walked in whole warps (words * 32), so the
// validity word is one ballot.
__device__ inline void gather_counts(DynNet& net, int stride, int offset,
                                     int vl) {
  const int step = max(stride, 1);
  for (int c0 = 0; c0 < net.words * 32; c0 += blockDim.x) {
    const int p = c0 + threadIdx.x;
    bool valid = false;
    if (p < net.n) {
      const int rel = p - offset;
      const int dest = floor_div(rel, step);
      valid = rel >= 0 && floor_mod(rel, step) == 0 && dest < vl;
      net.sc[p] = valid ? p - dest : 0;
    }
    const uint32_t w = __ballot_sync(0xffffffffu, valid);
    if ((threadIdx.x & 31) == 0 && (p >> 5) < net.words)
      net.val[p >> 5] = w;
  }
}

// Fill sc/val with `scg.scatter_counts(n, stride, offset, vl)`: dense
// element i < vl lands at offset + i*stride, count offset + i*(stride-1)
// in wrapping int32 arithmetic (no stride clamp, as in the reference).
__device__ inline void scatter_counts(DynNet& net, int stride, int offset,
                                      int vl) {
  for (int c0 = 0; c0 < net.words * 32; c0 += blockDim.x) {
    const int i = c0 + threadIdx.x;
    const bool valid = i < net.n && i < vl;
    if (i < net.n)
      net.sc[i] = valid ? (int)((uint32_t)offset +
                                (uint32_t)i * ((uint32_t)stride - 1u))
                        : 0;
    const uint32_t w = __ballot_sync(0xffffffffu, valid);
    if ((threadIdx.x & 31) == 0 && (i >> 5) < net.words)
      net.val[i >> 5] = w;
  }
}

// Derive the take-mask of every layer and the final occupancy from the
// counts in sc[0, n) / val[0, words).  `gsn`: toward lower lanes, LSB
// first; else the SSN.  Every thread of the block calls it (one barrier
// per layer); it starts and ends with a barrier, so the caller's fill and
// the caller's reads of masks/occ/layers need none of their own.
__device__ inline void dyn_derive(DynNet& net, bool gsn) {
  const int n = net.n, words = net.words, L = net.L;
  int* sc = net.sc;
  int* sc2 = net.sc + n;
  uint32_t* v = net.val;
  uint32_t* v2 = net.val + words;
  __syncthreads();
  for (int i = 0; i < L; ++i) {
    const int l = gsn ? i : L - 1 - i;
    const int d = gsn ? (1 << l) : -(1 << l);     // lane c's candidate: c + d
    for (int c0 = 0; c0 < words * 32; c0 += blockDim.x) {
      const int c = c0 + threadIdx.x;
      bool take = false, keep = false;
      if (c < n) {
        const int own = sc[c];
        keep = lane_bit(v, c) && !((own >> l) & 1);
        int next = own;
        const int src = c + d;
        if (src >= 0 && src < n && lane_bit(v, src)) {
          const int cand = sc[src];
          if ((cand >> l) & 1) {
            take = true;
            next = cand;
          }
        }
        sc2[c] = next;
      }
      const uint32_t tw = __ballot_sync(0xffffffffu, take);
      const uint32_t vw = __ballot_sync(0xffffffffu, take || keep);
      if ((threadIdx.x & 31) == 0 && (c >> 5) < words) {
        net.masks[(size_t)i * words + (c >> 5)] = tw;
        v2[c >> 5] = vw;
      }
    }
    if (threadIdx.x == 0) {
      net.layers[4 * i] = 1;
      net.layers[4 * i + 1] = d;
      net.layers[4 * i + 2] = 0;
      net.layers[4 * i + 3] = i;
    }
    __syncthreads();
    int* ts = sc; sc = sc2; sc2 = ts;
    uint32_t* tv = v; v = v2; v2 = tv;
  }
  for (int w = threadIdx.x; w < words; w += blockDim.x) net.occ[w] = v[w];
  __syncthreads();
}

// Route a row tile through the derived network: route_plan's layer loop
// over the records `dyn_derive` wrote.  Returns the buffer that holds the
// routed tile (`bin` when the network has no layer).
template <typename T>
__device__ inline T* route_dyn(const DynNet& net, T* bin, T* ba, T* bb,
                               int nr, const TileMap& tm) {
  return route_plan<T>(bin, ba, bb, nr, net.n, net.words, net.masks,
                       net.layers, 0, net.L, tm);
}
