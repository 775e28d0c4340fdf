// Segment (AoS <-> SoA) kernels for Hopper (sm_90a): B1 deinterleave and
// B2 interleave, routed through compiled shift plans, and B6 / B7, the same
// two functions routed through the dynamic-count networks.
//
// Replaces: src/repro/kernels/segment.py, `_deint_plan_kernel` (B1, launched
// by `deinterleave(fused=True)`), `_int_plan_kernel` (B2, launched by
// `interleave(fused=True)`), `_deint_dyn_kernel` (B6, `deinterleave(
// fused=False)`) and `_int_dyn_kernel` (B7, `interleave(fused=False)`).
// B1 and B2 compute what the Pallas plan bodies compute: the plan's layers
// of one static lane shift plus a select under a constant take-mask (two
// shifts and a three-way select for an exchange layer), applied to a row
// tile.  The plans come from core/shiftplan.segment_{de,}interleave_plans:
// one `fused` Benes/butterfly permutation over all fields, or `per_field`
// pruned gather (B1) / scatter (B2) plans, all run in ONE launch on the
// same resident tile.  B6 and B7 compute what the dynamic bodies compute:
// per field f, the counts `scg.gather_counts(n, f_count, f, m)` (B6, GSN)
// or `scg.scatter_counts(...)` (B7, SSN) computed in the kernel, the
// network's take-masks derived from them on the device (route_dyn.cuh),
// every layer run unpruned.  B6 writes lanes [0, m) of field f's routed
// beat to output f; B7 merges field f's routed, zero-padded beat under its
// final occupancy into an output that starts at 0.
//
// Bound: pure data movement.  The least time is (bytes read + bytes
// written) / 3.35 TB/s; the selects cost a few integer operations per lane
// per layer and no floating point.
//
// What this first design does about it: each block loads its row tile from
// device memory once (zero-padding lanes >= n up to the plan width), keeps
// it in shared memory through every layer (ping-pong between two buffers,
// one __syncthreads() per layer), and writes each field slice straight to
// its output, so device memory sees each input byte read once and each
// output byte written once.  The plan's take-masks are packed to bits by
// the wrapper and loaded into shared memory once per block; a dynamic
// kernel derives its masks per block and field instead (one barrier per
// layer over n lanes of counts, paid once for the whole row tile).
// Threads map to lanes and walk down the tile's rows: a lane's source for a
// layer is resolved once and then copied row after row, so the inner loop
// is one shared load and one store.  The wrapper keeps tiles small (24 KB
// of shared memory, so eight blocks share an SM) and, for a small call,
// short enough that the grid covers the card.  Elements move as raw bits
// (templated on the element width: 1, 2, 4 or 8 bytes), so the permutation
// is bit-exact for every dtype, NaN payloads included.
//
// Not yet done (later performance work, measured against this one): vector
// loads of 16 bytes per thread, warp shuffles for plans narrower than a
// warp, composing the plan into a direct index gather.

#include <cuda_runtime.h>
#include <stdint.h>

#include "route_dyn.cuh"
#include "route_plan.cuh"

#define MAX_FIELDS 16

struct Ptrs {
  void* p[MAX_FIELDS];
};

// B1: (R, n) AoS rows -> `fields` outputs of (R, m).
template <typename T>
__global__ void __launch_bounds__(THREADS)
deint_kernel(const T* __restrict__ x, Ptrs outs, long long R, int n, int m,
             int Wn, int fused, int fields, const uint32_t* __restrict__ masks,
             int S, int words, const int* __restrict__ layers,
             const int* __restrict__ plan_lo, int nplans, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* smask = reinterpret_cast<uint32_t*>(smem);
  const size_t mbytes = ((size_t)S * words * 4 + 15) & ~(size_t)15;
  T* bin = reinterpret_cast<T*>(smem + mbytes);
  T* ba = bin + (size_t)rows * Wn;
  T* bb = ba + (size_t)rows * Wn;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, R - r0);
  const TileMap tm(Wn);
  const bool live = tm.g < tm.groups;

  for (int i = threadIdx.x; i < S * words; i += blockDim.x) smask[i] = masks[i];
  const T* xs = x + r0 * n;
  if (live) {
    for (int c = tm.t; c < Wn; c += tm.lanes)
      for (int r = tm.g; r < nr; r += tm.groups)
        bin[(size_t)r * Wn + c] = c < n ? xs[(size_t)r * n + c] : T(0);
  }
  __syncthreads();

  for (int p = 0; p < nplans; ++p) {
    const T* res = route_plan<T>(bin, ba, bb, nr, Wn, words, smask, layers,
                                 plan_lo[p], plan_lo[p + 1], tm);
    if (live && fused) {
      // field f is lanes [f*m, (f+1)*m) of the routed beat
      for (int c = tm.t; c < n; c += tm.lanes) {
        const int f = c / m;
        const int j = c - f * m;
        T* o = static_cast<T*>(outs.p[f]) + r0 * m + j;
        for (int r = tm.g; r < nr; r += tm.groups)
          o[(size_t)r * m] = res[(size_t)r * Wn + c];
      }
    } else if (live) {
      // per-field plan p gathers field p into lanes [0, m)
      T* o = static_cast<T*>(outs.p[p]) + r0 * m;
      for (int c = tm.t; c < m; c += tm.lanes)
        for (int r = tm.g; r < nr; r += tm.groups)
          o[(size_t)r * m + c] = res[(size_t)r * Wn + c];
    }
    __syncthreads();
  }
}

// B2: `fields` inputs of (R, m) -> (R, n) AoS rows.  `valid` holds one
// packed occupancy row per per-field plan; a per-field pass writes only
// the lanes its plan fills, and lanes no plan fills are written as 0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
int_kernel(Ptrs ins, T* __restrict__ out, long long R, int n, int m, int Wn,
           int fused, int fields, const uint32_t* __restrict__ masks, int S,
           int words, const int* __restrict__ layers,
           const int* __restrict__ plan_lo, int nplans,
           const uint32_t* __restrict__ valid, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* smask = reinterpret_cast<uint32_t*>(smem);
  const int vrows = fused ? 0 : nplans;
  uint32_t* svalid = smask + (size_t)S * words;
  const size_t mbytes = ((size_t)(S + vrows) * words * 4 + 15) & ~(size_t)15;
  T* bin = reinterpret_cast<T*>(smem + mbytes);
  T* ba = bin + (size_t)rows * Wn;
  T* bb = ba + (size_t)rows * Wn;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, R - r0);
  T* os = out + r0 * n;
  const TileMap tm(Wn);
  const bool live = tm.g < tm.groups;

  for (int i = threadIdx.x; i < S * words; i += blockDim.x) smask[i] = masks[i];
  for (int i = threadIdx.x; i < vrows * words; i += blockDim.x) svalid[i] = valid[i];

  if (fused) {
    // concatenated SoA fields, zero-padded to the plan width
    if (live) {
      for (int c = tm.t; c < Wn; c += tm.lanes) {
        if (c < n) {
          const int f = c / m;
          const T* xin = static_cast<const T*>(ins.p[f]) + r0 * m + (c - f * m);
          for (int r = tm.g; r < nr; r += tm.groups)
            bin[(size_t)r * Wn + c] = xin[(size_t)r * m];
        } else {
          for (int r = tm.g; r < nr; r += tm.groups)
            bin[(size_t)r * Wn + c] = T(0);
        }
      }
    }
    __syncthreads();
    const T* res = route_plan<T>(bin, ba, bb, nr, Wn, words, smask, layers,
                                 plan_lo[0], plan_lo[1], tm);
    if (live) {
      for (int c = tm.t; c < n; c += tm.lanes)
        for (int r = tm.g; r < nr; r += tm.groups)
          os[(size_t)r * n + c] = res[(size_t)r * Wn + c];
    }
    return;
  }

  __syncthreads();
  if (live) {
    for (int c = tm.t; c < n; c += tm.lanes) {
      bool any = false;
      for (int p = 0; p < nplans; ++p) any |= lane_bit(svalid + (size_t)p * words, c);
      if (!any)
        for (int r = tm.g; r < nr; r += tm.groups) os[(size_t)r * n + c] = T(0);
    }
  }
  for (int p = 0; p < nplans; ++p) {
    const T* xin = static_cast<const T*>(ins.p[p]) + r0 * m;
    if (live) {
      for (int c = tm.t; c < Wn; c += tm.lanes)
        for (int r = tm.g; r < nr; r += tm.groups)
          bin[(size_t)r * Wn + c] = c < m ? xin[(size_t)r * m + c] : T(0);
    }
    __syncthreads();
    const T* res = route_plan<T>(bin, ba, bb, nr, Wn, words, smask, layers,
                                 plan_lo[p], plan_lo[p + 1], tm);
    const uint32_t* vp = svalid + (size_t)p * words;
    if (live) {
      for (int c = tm.t; c < n; c += tm.lanes)
        if (lane_bit(vp, c))
          for (int r = tm.g; r < nr; r += tm.groups)
            os[(size_t)r * n + c] = res[(size_t)r * Wn + c];
    }
    __syncthreads();
  }
}

template <typename T>
static cudaError_t launch_deint(const void* x, const Ptrs& outs, long long R,
                                int n, int m, int Wn, int fused, int fields,
                                const void* masks, int S, int words,
                                const void* layers, const void* plan_lo,
                                int nplans, int rows, cudaStream_t stream) {
  const size_t mbytes = ((size_t)S * words * 4 + 15) & ~(size_t)15;
  const size_t smem = mbytes + 3 * (size_t)rows * Wn * sizeof(T);
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(deint_kernel<T>, smem, granted);
  if (e != cudaSuccess) return e;
  const long long grid = (R + rows - 1) / rows;
  deint_kernel<T><<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), outs, R, n, m, Wn, fused, fields,
      static_cast<const uint32_t*>(masks), S, words,
      static_cast<const int*>(layers), static_cast<const int*>(plan_lo),
      nplans, rows);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_int(const Ptrs& ins, void* out, long long R, int n,
                              int m, int Wn, int fused, int fields,
                              const void* masks, int S, int words,
                              const void* layers, const void* plan_lo,
                              int nplans, const void* valid, int rows,
                              cudaStream_t stream) {
  const int vrows = fused ? 0 : nplans;
  const size_t mbytes = ((size_t)(S + vrows) * words * 4 + 15) & ~(size_t)15;
  const size_t smem = mbytes + 3 * (size_t)rows * Wn * sizeof(T);
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(int_kernel<T>, smem, granted);
  if (e != cudaSuccess) return e;
  const long long grid = (R + rows - 1) / rows;
  int_kernel<T><<<(unsigned)grid, THREADS, smem, stream>>>(
      ins, static_cast<T*>(out), R, n, m, Wn, fused, fields,
      static_cast<const uint32_t*>(masks), S, words,
      static_cast<const int*>(layers), static_cast<const int*>(plan_lo),
      nplans, static_cast<const uint32_t*>(valid), rows);
  return cudaGetLastError();
}

// B6: (R, n) AoS rows -> `fields` outputs of (R, m) through the GSN, one
// derived network per field.  The input tile stays resident in `bin`.
template <typename T>
__global__ void __launch_bounds__(THREADS)
deint_dyn_kernel(const T* __restrict__ x, Ptrs outs, long long R, int n,
                 int m, int fields, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  DynNet net = dyn_carve(smem, n);
  T* bin = reinterpret_cast<T*>(smem + dyn_bytes(n));
  T* ba = bin + (size_t)rows * n;
  T* bb = ba + (size_t)rows * n;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, R - r0);
  const TileMap tm(n);
  const bool live = tm.g < tm.groups;

  const T* xs = x + r0 * n;
  if (live) {
    for (int c = tm.t; c < n; c += tm.lanes)
      for (int r = tm.g; r < nr; r += tm.groups)
        bin[(size_t)r * n + c] = xs[(size_t)r * n + c];
  }
  for (int f = 0; f < fields; ++f) {
    gather_counts(net, fields, f, m);
    dyn_derive(net, true);
    const T* res = route_dyn<T>(net, bin, ba, bb, nr, tm);
    T* o = static_cast<T*>(outs.p[f]) + r0 * m;
    if (live) {
      for (int c = tm.t; c < m; c += tm.lanes)
        for (int r = tm.g; r < nr; r += tm.groups)
          o[(size_t)r * m + c] = res[(size_t)r * n + c];
    }
    __syncthreads();
  }
}

// B7: `fields` inputs of (R, m) -> (R, n) AoS rows through the SSN.  Field
// f's routed lanes are written where its final occupancy is set (the
// reference's `acc = where(valid, payload, acc)`, later fields winning);
// lanes no field occupies are written as 0 at the end.  A thread owns the
// same (row, lane) pairs in every pass, so the writes keep field order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
int_dyn_kernel(Ptrs ins, T* __restrict__ out, long long R, int n, int m,
               int fields, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  DynNet net = dyn_carve(smem, n);
  const int words = net.words;
  uint32_t* uni = reinterpret_cast<uint32_t*>(smem + dyn_bytes(n));
  T* ba = reinterpret_cast<T*>(
      smem + dyn_bytes(n) + (((size_t)words * 4 + 15) & ~(size_t)15));
  T* bb = ba + (size_t)rows * n;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, R - r0);
  T* os = out + r0 * n;
  const TileMap tm(n);
  const bool live = tm.g < tm.groups;

  for (int w = threadIdx.x; w < words; w += blockDim.x) uni[w] = 0u;
  for (int f = 0; f < fields; ++f) {
    const T* xin = static_cast<const T*>(ins.p[f]) + r0 * m;
    if (live) {
      for (int c = tm.t; c < n; c += tm.lanes)
        for (int r = tm.g; r < nr; r += tm.groups)
          ba[(size_t)r * n + c] = c < m ? xin[(size_t)r * m + c] : T(0);
    }
    scatter_counts(net, fields, f, m);
    dyn_derive(net, false);
    const T* res = route_dyn<T>(net, ba, ba, bb, nr, tm);
    for (int w = threadIdx.x; w < words; w += blockDim.x) uni[w] |= net.occ[w];
    if (live) {
      for (int c = tm.t; c < n; c += tm.lanes)
        if (lane_bit(net.occ, c))
          for (int r = tm.g; r < nr; r += tm.groups)
            os[(size_t)r * n + c] = res[(size_t)r * n + c];
    }
    __syncthreads();
  }
  if (live) {
    for (int c = tm.t; c < n; c += tm.lanes)
      if (!lane_bit(uni, c))
        for (int r = tm.g; r < nr; r += tm.groups) os[(size_t)r * n + c] = T(0);
  }
}

template <typename T>
static cudaError_t launch_deint_dyn(const void* x, const Ptrs& outs,
                                    long long R, int n, int m, int fields,
                                    int rows, cudaStream_t stream) {
  const size_t smem = dyn_bytes(n) + 3 * (size_t)rows * n * sizeof(T);
  const long long grid = (R + rows - 1) / rows;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(deint_dyn_kernel<T>, smem, granted);
  if (e != cudaSuccess) return e;
  deint_dyn_kernel<T><<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), outs, R, n, m, fields, rows);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_int_dyn(const Ptrs& ins, void* out, long long R,
                                  int n, int m, int fields, int rows,
                                  cudaStream_t stream) {
  const size_t ubytes = ((size_t)((n + 31) / 32) * 4 + 15) & ~(size_t)15;
  const size_t smem = dyn_bytes(n) + ubytes + 2 * (size_t)rows * n * sizeof(T);
  const long long grid = (R + rows - 1) / rows;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(int_dyn_kernel<T>, smem, granted);
  if (e != cudaSuccess) return e;
  int_dyn_kernel<T><<<(unsigned)grid, THREADS, smem, stream>>>(
      ins, static_cast<T*>(out), R, n, m, fields, rows);
  return cudaGetLastError();
}

extern "C" {

// Plain C entry points (bound with ctypes).  Each returns the cudaError_t
// of the launch; the Python wrapper raises when it is not 0.
int segment_deinterleave(int elem_bytes, const void* x, void* const* outs,
                         int fields, long long R, int n, int m, int Wn,
                         int fused, const void* masks, int S, int words,
                         const void* layers, const void* plan_lo, int nplans,
                         int rows, void* stream) {
  if (fields < 1 || fields > MAX_FIELDS || rows < 1) return cudaErrorInvalidValue;
  Ptrs p;
  for (int i = 0; i < MAX_FIELDS; ++i) p.p[i] = i < fields ? outs[i] : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_deint<uint8_t>(x, p, R, n, m, Wn, fused, fields, masks, S, words, layers, plan_lo, nplans, rows, s);
    case 2: return launch_deint<uint16_t>(x, p, R, n, m, Wn, fused, fields, masks, S, words, layers, plan_lo, nplans, rows, s);
    case 4: return launch_deint<uint32_t>(x, p, R, n, m, Wn, fused, fields, masks, S, words, layers, plan_lo, nplans, rows, s);
    case 8: return launch_deint<unsigned long long>(x, p, R, n, m, Wn, fused, fields, masks, S, words, layers, plan_lo, nplans, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

int segment_interleave(int elem_bytes, void* const* ins, void* out, int fields,
                       long long R, int n, int m, int Wn, int fused,
                       const void* masks, int S, int words, const void* layers,
                       const void* plan_lo, int nplans, const void* valid,
                       int rows, void* stream) {
  if (fields < 1 || fields > MAX_FIELDS || rows < 1) return cudaErrorInvalidValue;
  Ptrs p;
  for (int i = 0; i < MAX_FIELDS; ++i) p.p[i] = i < fields ? ins[i] : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_int<uint8_t>(p, out, R, n, m, Wn, fused, fields, masks, S, words, layers, plan_lo, nplans, valid, rows, s);
    case 2: return launch_int<uint16_t>(p, out, R, n, m, Wn, fused, fields, masks, S, words, layers, plan_lo, nplans, valid, rows, s);
    case 4: return launch_int<uint32_t>(p, out, R, n, m, Wn, fused, fields, masks, S, words, layers, plan_lo, nplans, valid, rows, s);
    case 8: return launch_int<unsigned long long>(p, out, R, n, m, Wn, fused, fields, masks, S, words, layers, plan_lo, nplans, valid, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

// B6 / B7: the dynamic-count segment networks (no plan operands).
int segment_deinterleave_dyn(int elem_bytes, const void* x, void* const* outs,
                             int fields, long long R, int n, int m, int rows,
                             void* stream) {
  if (fields < 1 || fields > MAX_FIELDS || rows < 1 || m < 1 ||
      (long long)fields * m != n)
    return cudaErrorInvalidValue;
  Ptrs p;
  for (int i = 0; i < MAX_FIELDS; ++i) p.p[i] = i < fields ? outs[i] : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_deint_dyn<uint8_t>(x, p, R, n, m, fields, rows, s);
    case 2: return launch_deint_dyn<uint16_t>(x, p, R, n, m, fields, rows, s);
    case 4: return launch_deint_dyn<uint32_t>(x, p, R, n, m, fields, rows, s);
    case 8: return launch_deint_dyn<unsigned long long>(x, p, R, n, m, fields, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

int segment_interleave_dyn(int elem_bytes, void* const* ins, void* out,
                           int fields, long long R, int n, int m, int rows,
                           void* stream) {
  if (fields < 1 || fields > MAX_FIELDS || rows < 1 || m < 1 ||
      (long long)fields * m != n)
    return cudaErrorInvalidValue;
  Ptrs p;
  for (int i = 0; i < MAX_FIELDS; ++i) p.p[i] = i < fields ? ins[i] : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_int_dyn<uint8_t>(p, out, R, n, m, fields, rows, s);
    case 2: return launch_int_dyn<uint16_t>(p, out, R, n, m, fields, rows, s);
    case 4: return launch_int_dyn<uint32_t>(p, out, R, n, m, fields, rows, s);
    case 8: return launch_int_dyn<unsigned long long>(p, out, R, n, m, fields, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
