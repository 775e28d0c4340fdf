// The dynamic-count shift network as device code, shared by the port's
// dynamic kernels (B6/B7 in segment.cu, B8/B9 in strided.cu, B12/B14 in
// indexed.cu).
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
// (1, n)), so the per-layer take-masks are derived from the counts in
// shared memory (`dyn_derive`, one barrier per layer), exactly the
// reference's `layer_masks`, once per launch.  A lane takes its candidate
// regardless of the payload, so every output lane holds one input lane's
// raw bits: `dyn_sources` composes the masks into a source table, found by
// walking the layers backwards.  The table goes to device memory and a
// copy (perm_copy.cuh) moves the rows through it: the permuted copy for B6
// and B8; B2's interleave copy for B7, which merges the fields' tables as
// it loads them; for B9 the merge copy, through the list of the occupied
// lanes and their sources that the same kernel compacts from the table (vl
// pairs, not n lanes); for B12 and B14 the staged copy, through the list
// of the input units that hold a source lane and the table remapped into
// the row compacted to them (`dyn_staged_units`), so that only those units
// are read.  B6-B9 derive in `dyn_sources_kernel` below, on counts from
// (stride, offset); B12 and B14 in indexed.cu's `shift_sources_kernel`, on
// the (n,) `shift` / `valid` operands (`operand_counts`).  No kernel
// derives a network per block or routes rows layer by layer through it.
// The routing is computed on the device at run time from the counts: no
// host plan, no pruned layers.
//
// Shared-memory state of one network (`DynNet`, carved by `dyn_carve`):
//   masks  L x words   packed take-masks, in lane_bit's format (route_plan.cuh)
//   occ    words       final occupancy (validity after the last layer)
//   shift  L           each layer's signed shift (+-2^l)
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
  const size_t b = 4 * ((size_t)L * words + words + L + 2 * (size_t)n +
                        2 * words);
  return (b + 15) & ~(size_t)15;
}

struct DynNet {
  uint32_t* masks;
  uint32_t* occ;
  int* shift;
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
  net.shift = reinterpret_cast<int*>(net.occ + net.words);
  net.sc = net.shift + net.L;
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

// Fill sc/val from the (n,) int32 operands: sc[c] = shift[c], validity
// bit c = valid[c] != 0 (the raw networks' runtime counts, B12 / B14).
// Lanes are walked in whole warps (words * 32), so each validity word is
// one ballot.
__device__ inline void operand_counts(DynNet& net,
                                      const int* __restrict__ shift,
                                      const int* __restrict__ valid) {
  for (int c0 = 0; c0 < net.words * 32; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    bool v = false;
    if (c < net.n) {
      net.sc[c] = shift[c];
      v = valid[c] != 0;
    }
    const uint32_t w = __ballot_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0 && (c >> 5) < net.words) net.val[c >> 5] = w;
  }
}

// Derive the take-mask and the signed shift of every layer and the final
// occupancy from the counts in sc[0, n) / val[0, words).  `gsn`: toward
// lower lanes, LSB first; else the SSN.  Every thread of the block calls
// it (one barrier per layer); it starts and ends with a barrier, so the
// caller's fill and the caller's reads of masks/occ/shift need none of
// their own.
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
    if (threadIdx.x == 0) net.shift[i] = d;
    __syncthreads();
    int* ts = sc; sc = sc2; sc2 = ts;
    uint32_t* tv = v; v = v2; v2 = tv;
  }
  for (int w = threadIdx.x; w < words; w += blockDim.x) net.occ[w] = v[w];
  __syncthreads();
}

// The set bits below each word of the packed bit row `bits`, over bits
// [0, count): pre[w] for w < ceil(count/32), and pre[words] in all (the
// final occupancy's occupied lanes, or the staged units).  Warp 0 scans (a
// popcount a word, one shuffle scan); it ends with a barrier.  `pre` is
// caller scratch of words + 1 ints.
__device__ inline void bit_prefix(const uint32_t* bits, int count, int* pre) {
  const int words = (count + 31) / 32;
  if (threadIdx.x < 32) {
    const int per = (words + 31) / 32;
    const int w0 = min((int)threadIdx.x * per, words);
    const int w1 = min(w0 + per, words);
    auto ones = [&](int w) {
      const int tail = count - 32 * w;     // bits of word w below count
      const uint32_t keep = tail >= 32 ? 0xffffffffu : (1u << tail) - 1u;
      return __popc(bits[w] & keep);
    };
    int own = 0;
    for (int w = w0; w < w1; ++w) own += ones(w);
    int incl = own;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if ((int)threadIdx.x >= d) incl += y;
    }
    int run = incl - own;
    for (int w = w0; w < w1; ++w) {
      pre[w] = run;
      run += ones(w);
    }
    if (threadIdx.x == 31) pre[words] = incl;
  }
  __syncthreads();
}

// Compose the derived network into a source table for output lanes
// [0, count): src[j] is the input lane whose raw bits the network leaves
// in lane j, or -1 where the final occupancy is clear (the lane is
// written as 0).  Walking backwards from the last layer, lane c's value
// came from c + d_i wherever layer i's take bit of c is set (d_i the
// layer's signed shift, `shift[i]`); a take never reads outside
// [0, n), so the walk stays in range.  No layer (n <= 1): src[j] = j.
// With `list`, also the occupied lanes compacted in lane order:
//   list = {K, lane_0, src_0, lane_1, src_1, ...}
// at most `cap` pairs (K = min(occupied lanes, cap)), the merge copy's
// operand (perm_copy.cuh); `pre` is scratch of count/32 + 1 ints.
// Call after `dyn_derive` (which ends with a barrier); without `list` no
// barrier inside.
__device__ inline void dyn_sources(const DynNet& net, int* __restrict__ src,
                                   int count, int* __restrict__ list = nullptr,
                                   int cap = 0, int* pre = nullptr) {
  if (list) bit_prefix(net.occ, count, pre);
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    int c = j;
    if (!lane_bit(net.occ, j)) {
      c = -1;
    } else {
      for (int i = net.L - 1; i >= 0; --i)
        if (lane_bit(net.masks + (size_t)i * net.words, c))
          c += net.shift[i];
    }
    src[j] = c;
    if (list && c >= 0) {
      const int w = j >> 5;
      const int k = pre[w] + __popc(net.occ[w] & ((1u << (j & 31)) - 1u));
      if (k < cap) {
        list[1 + 2 * k] = j;
        list[2 + 2 * k] = c;
      }
    }
  }
  if (list && threadIdx.x == 0) list[0] = min(pre[(count + 31) / 32], cap);
}

// The staged copy's operands from a source table, composed on the device
// (the twin of the host's `_common.staged_units`, which B3 / B4 take from
// the plan): `src` holds the input lane of each of n output lanes of
// `elem` bytes, -1 where the lane is unoccupied, written before a barrier.
// A row is cut into `sunit`-byte units of per = sunit / elem lanes (sunit
// divides the row's bytes and 32).  Where the units that hold a source lane
// touch every 32-byte sector of the row, the list is every unit and pos[j]
// = src[j]: the same sectors move either way, and a whole row stages as one
// chunk.  Else the list is those units in order and pos[j] = rank * per +
// src[j] % per, the lane's place in the row compacted to them.  pos[j] = -1
// where src[j] is.  Writes nunits[0] = K and units[0, K).  `bits` is
// scratch of ceil(nu/32) words and `pre` of ceil(nu/32) + 1 ints (nu = n /
// per).  Every thread calls it; no barrier at its end.
__device__ inline void dyn_staged_units(const int* src, int n, int elem,
                                        int sunit, uint32_t* bits, int* pre,
                                        int* __restrict__ pos,
                                        int* __restrict__ nunits,
                                        int* __restrict__ units) {
  const int per = sunit / elem;
  const int nu = n / per;
  const int uw = (nu + 31) / 32;
  for (int w = threadIdx.x; w < uw; w += blockDim.x) bits[w] = 0u;
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int s = src[j];
    if (s >= 0) atomicOr(&bits[(s / per) >> 5], 1u << ((s / per) & 31));
  }
  __syncthreads();
  // does every 32-byte sector (ups units) hold a listed unit?
  const int ups = 32 / sunit;
  bool all = true;
  for (int sec = threadIdx.x; sec * ups < nu; sec += blockDim.x) {
    bool hit = false;
    for (int u = sec * ups; u < min((sec + 1) * ups, nu); ++u)
      hit = hit || lane_bit(bits, u);
    all = all && hit;
  }
  if (__syncthreads_and(all)) {
    for (int u = threadIdx.x; u < nu; u += blockDim.x) units[u] = u;
    for (int j = threadIdx.x; j < n; j += blockDim.x) pos[j] = src[j];
    if (threadIdx.x == 0) nunits[0] = nu;
    return;
  }
  bit_prefix(bits, nu, pre);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int s = src[j];
    int p = -1;
    if (s >= 0) {
      const int u = s / per;
      const int k = pre[u >> 5] + __popc(bits[u >> 5] & ((1u << (u & 31)) - 1u));
      units[k] = u;                       // every lane of unit u writes k
      p = k * per + s % per;
    }
    pos[j] = p;
  }
  if (threadIdx.x == 0) nunits[0] = pre[uw];
}

// One derivation per launch: block b fills the counts of
// `scg.gather_counts(n, stride, offset + b, vl)` (`gsn`, then the GSN) or
// `scg.scatter_counts(...)` (the SSN), derives the network and writes the
// source table of lanes [0, count) to table[b * count, (b+1) * count).
// B6 launches one block per field (stride = fields, offset + b = field,
// vl = count = m), B7 one block per field on the SSN (vl = m, count = n:
// every output lane of field b's beat), B8 one block (count = vl), B9 one
// block (the SSN, count = n) that also writes the merge copy's list of at
// most vl pairs (a scatter occupies at most its vl values' lanes) to
// `list`.  It lets the copy that follows start at once (Programmatic
// Dependent Launch), so the copy's first tile load overlaps the
// derivation.
__global__ void __launch_bounds__(THREADS)
dyn_sources_kernel(int gsn, int n, int stride, int offset, int vl, int count,
                   int* __restrict__ table, int* __restrict__ list) {
  extern __shared__ __align__(16) unsigned char smem[];
  pdl_launch_dependents();
  DynNet net = dyn_carve(smem, n);
  if (gsn) gather_counts(net, stride, offset + (int)blockIdx.x, vl);
  else scatter_counts(net, stride, offset + (int)blockIdx.x, vl);
  dyn_derive(net, gsn != 0);
  // the counts are spent: their 2n ints hold the occupancy prefix
  dyn_sources(net, table + (size_t)blockIdx.x * count, count, list, vl,
              net.sc);
}

// With `list` (B9) the launch is one block.
inline cudaError_t launch_dyn_sources(int gsn, int n, int stride, int offset,
                                      int vl, int count, int blocks,
                                      int* table, cudaStream_t stream,
                                      int* list = nullptr) {
  if (n < 1 || count < 0 || count > n || blocks < 1 ||
      (list && (blocks != 1 || vl < 1)))
    return cudaErrorInvalidValue;
  const size_t smem = dyn_bytes(n);
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(dyn_sources_kernel, smem, granted);
  if (e != cudaSuccess) return e;
  dyn_sources_kernel<<<blocks, THREADS, smem, stream>>>(
      gsn, n, stride, offset, vl, count, table, list);
  return cudaGetLastError();
}
