// Segment (AoS <-> SoA) kernels for Hopper (sm_90a): B1 deinterleave and
// B2 interleave on compiled shift plans, and B6 / B7, the same two
// functions routed through the dynamic-count networks.
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
// pruned gather (B1) / scatter (B2) plans.  B6 and B7 compute what the
// dynamic bodies compute: per field f, the counts `scg.gather_counts(n,
// f_count, f, m)` (B6, GSN) or `scg.scatter_counts(...)` (B7, SSN) computed
// on the device, the network's take-masks derived from them
// (route_dyn.cuh), every layer unpruned.  B6 writes lanes [0, m) of field
// f's routed beat to output f; B7 merges field f's routed, zero-padded beat
// under its final occupancy into an output that starts at 0.
//
// Bound: pure data movement.  The least time is (bytes read + bytes
// written) / 3.35 TB/s; the selects cost a few integer operations per lane
// per layer and no floating point.
//
// B1 and B2, one kernel per call each: a segment plan is static, and its
// composed table (`ShiftPlan.source`) is known on the host.  So no layer
// runs on the card; the wrapper uploads the table once per plan.
//   * B1: field f's lane j takes input lane f + j*fields under either mode
//     (`plans[0].source[f*m + j]` for the fused plan, `plans[f].source[j]`
//     per field).  `perm_copy_kernel` (perm_copy.cuh) moves every row
//     through the (fields, m) table in one pipelined pass: 16-byte cp.async
//     staging, double-buffered, a bank-conflict-free permute in shared
//     memory and 16-byte vector stores of each field's contiguous (rows, m)
//     block, two barriers a tile.
//   * B2: output lane f + j*fields takes lane j of field f under either
//     mode (the n-entry table holds f*m + j; for per-field plans a later
//     field wins, as the reference's merge does).  `interleave_copy_kernel`
//     (perm_copy.cuh), the inverse form, stages the fields' contiguous
//     (rows, m) chunks with 16-byte cp.async, double-buffered and skewed
//     round the banks, reads them through the table into a (rows, n)
//     output tile and stores it in 16-byte vector stores, two barriers a
//     tile.
// Both are launched without Programmatic Dependent Launch: nothing derives
// their tables, and the kernel before them on the stream is whatever wrote
// their input.
//
// B6, two kernels per call: the network does not depend on the payload, so
// it is derived once per launch, not per block.  `dyn_sources_kernel`
// (route_dyn.cuh, one block per field) derives field f's network and
// composes it into the source lane of each of its m output lanes, in a
// small device workspace; the same permuted copy then moves the rows
// through that table, started under Programmatic Dependent Launch, so its
// first tile load overlaps the derivation.
//
// B7: each block loads its row tile from device memory once, per field,
// keeps it in shared memory through every layer (ping-pong between two
// buffers, one __syncthreads() per layer; route_dyn.cuh), and writes the
// lanes the field occupies straight to the output, so device memory sees
// each input byte read once and each output byte written once.  It derives
// its masks per block and field (one barrier per layer over n lanes of
// counts, paid once for the whole row tile).  Threads map to lanes and walk
// down the tile's rows.  The wrapper keeps tiles small (24 KB of shared
// memory, so eight blocks share an SM) and, for a small call, short enough
// that the grid covers the card.
//
// Elements move as raw bits (templated on the element width: 1, 2, 4 or 8
// bytes), so every permutation is bit-exact for every dtype, NaN payloads
// included.

#include <cuda_runtime.h>
#include <stdint.h>

#include "perm_copy.cuh"
#include "route_dyn.cuh"
#include "route_plan.cuh"

#define MAX_FIELDS MAX_PARTS

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
// B1: one permuted copy of the R rows into the `fields` outputs through
// `table` (fields x m int32, the host plan's composed sources, uploaded by
// the wrapper), in `rows`-row tiles over at most `blocks` blocks, staged
// and stored in `unit`-byte units; stream-ordered (no PDL).
int segment_deinterleave(int elem_bytes, const void* x, void* const* outs,
                         int fields, long long R, int n, int m,
                         const void* table, int rows, int blocks, int unit,
                         void* stream) {
  if (fields < 1 || fields > MAX_FIELDS || m < 1 ||
      (long long)fields * m != n)
    return cudaErrorInvalidValue;
  Ptrs p;
  for (int i = 0; i < MAX_FIELDS; ++i) p.p[i] = i < fields ? outs[i] : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  switch (elem_bytes) {
    case 1: return launch_perm_copy<uint8_t>(x, p, R, n, fields, m, tab, rows, blocks, unit, false, s);
    case 2: return launch_perm_copy<uint16_t>(x, p, R, n, fields, m, tab, rows, blocks, unit, false, s);
    case 4: return launch_perm_copy<uint32_t>(x, p, R, n, fields, m, tab, rows, blocks, unit, false, s);
    case 8: return launch_perm_copy<unsigned long long>(x, p, R, n, fields, m, tab, rows, blocks, unit, false, s);
    default: return cudaErrorInvalidValue;
  }
}

// B2: one interleave copy of the `fields` (R, m) inputs into the (R, n)
// output through `table` (n int32, the host plans' composed sources,
// uploaded by the wrapper), in `rows`-row tiles over at most `blocks`
// blocks; the copy unit is picked here from the row's bytes and the
// pointers; stream-ordered (no PDL).
int segment_interleave(int elem_bytes, void* const* ins, void* out, int fields,
                       long long R, int m, const void* table, int rows,
                       int blocks, void* stream) {
  if (fields < 1 || fields > MAX_FIELDS) return cudaErrorInvalidValue;
  Ptrs p;
  for (int i = 0; i < MAX_FIELDS; ++i) p.p[i] = i < fields ? ins[i] : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  switch (elem_bytes) {
    case 1: return launch_interleave_copy<uint8_t>(p, out, R, m, fields, tab, rows, blocks, s);
    case 2: return launch_interleave_copy<uint16_t>(p, out, R, m, fields, tab, rows, blocks, s);
    case 4: return launch_interleave_copy<uint32_t>(p, out, R, m, fields, tab, rows, blocks, s);
    case 8: return launch_interleave_copy<unsigned long long>(p, out, R, m, fields, tab, rows, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

// B6: the dynamic-count segment deinterleave, two kernels on `stream`:
// the derivation of the `fields` source tables into `table` (fields x m
// int32, the caller's workspace), then the permuted copy of the R rows in
// `rows`-row tiles over at most `blocks` blocks, staged and stored in
// `unit`-byte units.
int segment_deinterleave_dyn(int elem_bytes, const void* x, void* const* outs,
                             int fields, long long R, int n, int m,
                             void* table, int rows, int blocks, int unit,
                             void* stream) {
  if (fields < 1 || fields > MAX_FIELDS || m < 1 ||
      (long long)fields * m != n)
    return cudaErrorInvalidValue;
  Ptrs p;
  for (int i = 0; i < MAX_FIELDS; ++i) p.p[i] = i < fields ? outs[i] : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* tab = static_cast<int*>(table);
  cudaError_t e = launch_dyn_sources(1, n, fields, 0, m, m, fields, tab, s);
  if (e != cudaSuccess) return e;
  switch (elem_bytes) {
    case 1: return launch_perm_copy<uint8_t>(x, p, R, n, fields, m, tab, rows, blocks, unit, true, s);
    case 2: return launch_perm_copy<uint16_t>(x, p, R, n, fields, m, tab, rows, blocks, unit, true, s);
    case 4: return launch_perm_copy<uint32_t>(x, p, R, n, fields, m, tab, rows, blocks, unit, true, s);
    case 8: return launch_perm_copy<unsigned long long>(x, p, R, n, fields, m, tab, rows, blocks, unit, true, s);
    default: return cudaErrorInvalidValue;
  }
}

// B6's derivation alone: the `fields` source tables (fields x m int32).
int segment_deinterleave_sources(int n, int m, int fields, void* table,
                                 void* stream) {
  if (fields < 1 || m < 1 || (long long)fields * m != n)
    return cudaErrorInvalidValue;
  return launch_dyn_sources(1, n, fields, 0, m, m, fields,
                            static_cast<int*>(table),
                            static_cast<cudaStream_t>(stream));
}

// B7: the dynamic-count segment interleave (no plan operands).
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
