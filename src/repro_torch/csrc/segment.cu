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
// under its final occupancy into an output that starts at 0.  Both compose
// the derived networks into source tables once per launch, so each is a
// derive kernel plus a table-driven copy (below).
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
// their input.  (B2's copy takes one table row; B7's below takes one per
// field.)
//
// B6, two kernels per call: the network does not depend on the payload, so
// it is derived once per launch, not per block.  `dyn_sources_kernel`
// (route_dyn.cuh, one block per field) derives field f's network and
// composes it into the source lane of each of its m output lanes, in a
// small device workspace; the same permuted copy then moves the rows
// through that table, started under Programmatic Dependent Launch, so its
// first tile load overlaps the derivation.
//
// B7, two kernels per call, the same way: `dyn_sources_kernel` (one block
// per field, on the SSN) writes field f's source lane for each of the n
// output lanes of its routed beat into a (fields, n) device workspace;
// then B2's interleave copy, started under Programmatic Dependent Launch,
// merges the fields' tables as each block loads them (lane c takes lane
// f*m + src_f[c] of the concatenated fields from the last field f that
// occupies it, else 0: the reference's `acc = where(valid, payload, acc)`)
// and moves the rows through the merged table.  Neither kernel derives a
// network per block or runs a pass over the tile per layer.
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
    case 1: return launch_interleave_copy<uint8_t>(p, out, R, m, fields, tab, 1, rows, blocks, false, s);
    case 2: return launch_interleave_copy<uint16_t>(p, out, R, m, fields, tab, 1, rows, blocks, false, s);
    case 4: return launch_interleave_copy<uint32_t>(p, out, R, m, fields, tab, 1, rows, blocks, false, s);
    case 8: return launch_interleave_copy<unsigned long long>(p, out, R, m, fields, tab, 1, rows, blocks, false, s);
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

// B7: the dynamic-count segment interleave, two kernels on `stream`: the
// derivation of the `fields` SSN source tables into `table` (fields x n
// int32, the caller's workspace), then the interleave copy of the R rows
// through them, merged as it loads them, in `rows`-row tiles over at most
// `blocks` blocks; the copy unit is picked here, as for B2.
int segment_interleave_dyn(int elem_bytes, void* const* ins, void* out,
                           int fields, long long R, int m, void* table,
                           int rows, int blocks, void* stream) {
  if (fields < 1 || fields > MAX_FIELDS || m < 1) return cudaErrorInvalidValue;
  const int n = fields * m;
  Ptrs p;
  for (int i = 0; i < MAX_FIELDS; ++i) p.p[i] = i < fields ? ins[i] : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* tab = static_cast<int*>(table);
  cudaError_t e = launch_dyn_sources(0, n, fields, 0, m, n, fields, tab, s);
  if (e != cudaSuccess) return e;
  switch (elem_bytes) {
    case 1: return launch_interleave_copy<uint8_t>(p, out, R, m, fields, tab, fields, rows, blocks, true, s);
    case 2: return launch_interleave_copy<uint16_t>(p, out, R, m, fields, tab, fields, rows, blocks, true, s);
    case 4: return launch_interleave_copy<uint32_t>(p, out, R, m, fields, tab, fields, rows, blocks, true, s);
    case 8: return launch_interleave_copy<unsigned long long>(p, out, R, m, fields, tab, fields, rows, blocks, true, s);
    default: return cudaErrorInvalidValue;
  }
}

// B7's derivation alone: the `fields` SSN source tables (fields x n int32).
int segment_interleave_sources(int n, int m, int fields, void* table,
                               void* stream) {
  if (fields < 1 || m < 1 || (long long)fields * m != n)
    return cudaErrorInvalidValue;
  return launch_dyn_sources(0, n, fields, 0, m, n, fields,
                            static_cast<int*>(table),
                            static_cast<cudaStream_t>(stream));
}

const char* segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
