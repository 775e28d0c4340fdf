// Indexed and compaction kernels for Hopper (sm_90a): B10 row routing
// (MoE compaction and expansion), B11 / B12 the raw GSN gather (compiled
// plan / runtime counts) and B13 / B14 the raw SSN scatter (compiled plan /
// runtime counts).
//
// Replaces:
//   B10 src/repro/kernels/moe_compact.py `_route_kernel` (launched by
//       `_route_rows`, for `compact_rows` and `expand_rows`);
//   B11 src/repro/kernels/shift_gather.py `_plan_kernel`
//       (`shift_gather_static`, and `shift_gather` with host counts);
//   B12 src/repro/kernels/shift_gather.py `_kernel` (`shift_gather` with
//       runtime counts);
//   B13 src/repro/kernels/shift_scatter.py `_plan_kernel`
//       (`shift_scatter_static`, and `shift_scatter` with host counts);
//   B14 src/repro/kernels/shift_scatter.py `_kernel` (`shift_scatter` with
//       runtime counts).
//
// What each computes, as its Pallas body does:
//   B10: out[r, :] = out_valid[r] ? x_L[r, :] : 0, where x_0 = rows and
//        layer i is x_{i+1}[r] = masks[i][r] ? x_i[r + d_i] : x_i[r]
//        (d_i = +2^l for the GSN, which consumes bits LSB first, -2^l for
//        the SSN, MSB first; a read outside [0, n) gives 0).  The (L, n)
//        take-masks come precomputed (`shiftnet.layer_masks`).
//   B11 / B13: rows through a `shiftplan.counts_plan` plan, then zero
//        where the plan's occupancy is clear; B13 also writes that
//        occupancy for every (row, lane).
//   B12 / B14: the same through the dynamic-count network whose counts are
//        the (n,) `shift` / `valid` operands shared by all rows; zero where
//        the routed validity is clear; B14 also writes the routed validity
//        for every (row, lane).
// A lane takes its candidate regardless of the payload, so each of B11-B14
// is one source lane per output lane: out[r][j] = src[j] < 0 ? 0 :
// x[r][src[j]], with the occupancy src[j] >= 0.
//
// Bound: pure data movement, no floating point.  The least time is the
// bytes that must move over 3.35 TB/s: B11-B14 read the 32-byte sectors
// holding the input lanes that can reach the output and write the (R, n)
// payload (B13 / B14 also one occupancy byte per element); B10 reads the
// rows that land in a valid slot and writes every output row.
//
// Design.
//   B10 (new): the Pallas body keeps a (n, 128) column tile of all n rows
//   in VMEM and runs the layers on it.  At the MoE width (n = 16384 rows
//   of 2048 bf16) a shared-memory tile of all n rows would hold fewer
//   than 7 columns, so that shape does not carry over.  The layers do not
//   depend on the payload: destination row r's source row is found by
//   walking the L layers backwards from r, one mask byte per layer
//   (src += d_i where masks[i][src]).  So a block first resolves the
//   source row of each of its rows (one thread per row, L dependent reads
//   that hit L2), then copies whole rows in one coalesced pass with the
//   widest unit (16, 8, 4, 2 or 1 bytes) that divides the row and both
//   pointers; a row outside out_valid is written as zeros without reading
//   its source.  One launch per call, no shared-memory staging of rows.
//   B12 and B14 (two kernels a call, one launcher): one derive kernel
//   (`shift_sources_kernel`, one block) derives the GSN (B12) or the SSN
//   (B14) on the operand counts once, composes it into an (n,) source
//   table (-1 where the routed validity is clear) and from that the staged
//   copy's operands (`dyn_staged_units`, route_dyn.cuh): the list of the
//   units of an input row (16 bytes where the row and the pointer allow)
//   that hold a source lane, or every unit where those touch every
//   32-byte sector, and the table remapped into the row compacted to
//   them.  Then B3's staged copy (perm_copy.cuh), started under
//   Programmatic Dependent Launch, waits for the list, stages only the
//   listed units of each row, moves the rows through the remapped table
//   (0 where it holds -1) and, for B14, in the same pass writes the
//   occupancy (entry >= 0) for every row from the table it holds in
//   shared memory.  On the KV stack B12's sources (the odd lanes) touch
//   every sector, so a tile stages as one contiguous chunk; B14's (2,1)
//   scatter lists the values' half of each row.
//   B11 and B13 (one kernel a call, one C entry): their network is
//   static, and for an occupied lane the plan's `ShiftPlan.source` is the
//   lane the routed network delivers, so the wrapper composes the same
//   operands on the host from where(plan.valid, plan.source, -1) and
//   uploads them once per plan, staging unit and element size; the staged
//   copy (for B13 with the occupancy) is launched plainly, stream-ordered
//   after whatever wrote `x`.  On the KV stack B11's sources (the odd
//   lanes) touch every sector, so a tile stages as one chunk, as B12's.
//   No kernel derives a network per block, and B11-B14 make no pass per
//   layer.  Elements move as raw bits (1, 2, 4 or 8 bytes), so every
//   dtype is bit-exact, -0.0 and NaN payloads included.

#include <cuda_runtime.h>
#include <stdint.h>

#include "perm_copy.cuh"
#include "route_dyn.cuh"
#include "route_plan.cuh"

// ---------------------------------------------------------------------------
// B10: row routing through precomputed take-masks
// ---------------------------------------------------------------------------

template <typename U>
__device__ __forceinline__ U zero_unit() {
  return U(0);
}

template <>
__device__ __forceinline__ uint2 zero_unit<uint2>() {
  return make_uint2(0u, 0u);
}

template <>
__device__ __forceinline__ uint4 zero_unit<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// rows (n, units) and out (n, units) of U; masks (L, n) and out_valid (n)
// as bytes (0 / 1).  Layer i shifts by d_i = +2^l toward lower rows
// (`toward_zero`, the GSN) or -2^l (the SSN), with l = i when `lsb_first`
// and l = L-1-i otherwise.  Block b owns rows [b*rows, b*rows + rows).
template <typename U>
__global__ void __launch_bounds__(THREADS)
route_rows_kernel(const U* __restrict__ x, U* __restrict__ out,
                  const uint8_t* __restrict__ masks,
                  const uint8_t* __restrict__ out_valid, int n, int units,
                  int L, int toward_zero, int lsb_first, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* src_of = reinterpret_cast<int*>(smem);
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, n - r0);
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    const int r = r0 + i;
    int src = -1;
    if (out_valid[r]) {
      src = r;
      for (int k = L - 1; k >= 0; --k) {
        if (masks[(size_t)k * n + src]) {
          const int l = lsb_first ? k : L - 1 - k;
          src += toward_zero ? (1 << l) : -(1 << l);
          if (src < 0 || src >= n) {      // the shift's zero fill
            src = -1;
            break;
          }
        }
      }
    }
    src_of[i] = src;
  }
  __syncthreads();
  const TileMap tm(units);
  if (tm.g >= tm.groups) return;
  for (int i = tm.g; i < nr; i += tm.groups) {
    const int src = src_of[i];
    U* o = out + (size_t)(r0 + i) * units;
    if (src >= 0) {
      const U* s = x + (size_t)src * units;
      for (int u = tm.t; u < units; u += tm.lanes) o[u] = s[u];
    } else {
      for (int u = tm.t; u < units; u += tm.lanes) o[u] = zero_unit<U>();
    }
  }
}

template <typename U>
static cudaError_t launch_route_rows(const void* x, void* out,
                                     const void* masks, const void* out_valid,
                                     int n, int units, int L, int toward_zero,
                                     int lsb_first, int rows,
                                     cudaStream_t stream) {
  const int blocks = (n + rows - 1) / rows;
  const size_t smem = (size_t)rows * sizeof(int);
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(route_rows_kernel<U>, smem, granted);
  if (e != cudaSuccess) return e;
  route_rows_kernel<U><<<blocks, THREADS, smem, stream>>>(
      static_cast<const U*>(x), static_cast<U*>(out),
      static_cast<const uint8_t*>(masks),
      static_cast<const uint8_t*>(out_valid), n, units, L, toward_zero,
      lsb_first, rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B12 / B14's derivation: once per launch, on the operand counts
// ---------------------------------------------------------------------------

// Shared memory of the derive kernel: the network, the n-entry source
// table, and a bit row of the `nu` units of an input row with its prefix.
static inline size_t shift_sources_smem(int n, int nu) {
  const int uw = (nu + 31) / 32;
  return dyn_bytes(n) + pad16((size_t)n * 4) + pad16((size_t)uw * 4) +
         pad16((size_t)(uw + 1) * 4);
}

// One block derives the GSN (`gsn`, B12) or the SSN (B14) on the (n,)
// operand counts, composes it into the source table (`dyn_sources`: n
// int32, -1 where the routed validity is clear) and writes it to `table`,
// and from it the staged copy's operands for rows of `elem`-byte lanes
// staged in `sunit`-byte units (`dyn_staged_units`): the remapped table
// `pos` (n), the unit count `nunits` (1) and the unit list `units` (at
// most n*elem/sunit).  It lets the copy that follows start at once
// (Programmatic Dependent Launch); that copy waits for it before it reads
// the list, since what it stages depends on it.
__global__ void __launch_bounds__(THREADS)
shift_sources_kernel(int gsn, int n, const int* __restrict__ shift,
                     const int* __restrict__ valid, int elem, int sunit,
                     int* __restrict__ table, int* __restrict__ pos,
                     int* __restrict__ nunits, int* __restrict__ units) {
  extern __shared__ __align__(16) unsigned char smem[];
  pdl_launch_dependents();
  DynNet net = dyn_carve(smem, n);
  int* src = reinterpret_cast<int*>(smem + dyn_bytes(n));
  operand_counts(net, shift, valid);
  dyn_derive(net, gsn != 0);
  dyn_sources(net, src, n);
  __syncthreads();                        // the table, before others read it
  for (int j = threadIdx.x; j < n; j += blockDim.x) table[j] = src[j];
  const int uw = (n / (sunit / elem) + 31) / 32;
  uint32_t* bits = reinterpret_cast<uint32_t*>(
      reinterpret_cast<unsigned char*>(src) + pad16((size_t)n * 4));
  int* pre = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(bits) + pad16((size_t)uw * 4));
  dyn_staged_units(src, n, elem, sunit, bits, pre, pos, nunits, units);
}

// `elem` and `sunit` as `dyn_staged_units` takes them.
static cudaError_t launch_shift_sources(int gsn, int n, const int* shift,
                                        const int* valid, int elem, int sunit,
                                        int* table, int* pos, int* nunits,
                                        int* units, cudaStream_t stream) {
  if (n < 1 || elem < 1 || sunit < elem || sunit % elem || 32 % sunit ||
      ((long long)n * elem) % sunit)
    return cudaErrorInvalidValue;
  const size_t smem = shift_sources_smem(n, (int)((long long)n * elem / sunit));
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(shift_sources_kernel, smem, granted);
  if (e != cudaSuccess) return e;
  shift_sources_kernel<<<1, THREADS, smem, stream>>>(
      gsn, n, shift, valid, elem, sunit, table, pos, nunits, units);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B11-B14: the staged copy through a source table's operands
// ---------------------------------------------------------------------------

// The staged copy of the R rows of n `elem`-byte lanes through the
// remapped table `pos` and the unit list `units` (nunits[0] of at most
// `kmax` used), zero where `pos` is -1, and with `occ` the (R, n)
// occupancy bytes; under PDL (`pdl`) behind the derive kernel that writes
// the list, else stream-ordered.
static cudaError_t launch_shift_copy(int elem_bytes, const void* x, void* out,
                                     void* occ, long long R, int n,
                                     const int* pos, const int* units,
                                     const int* nunits, int kmax, int rows,
                                     int blocks, int sunit, int ounit,
                                     bool pdl, cudaStream_t s) {
  switch (elem_bytes) {
    case 1: return launch_staged_copy<uint8_t>(x, out, 1, R, n, n, pos, units, nunits, kmax, rows, blocks, sunit, ounit, s, pdl, occ);
    case 2: return launch_staged_copy<uint16_t>(x, out, 1, R, n, n, pos, units, nunits, kmax, rows, blocks, sunit, ounit, s, pdl, occ);
    case 4: return launch_staged_copy<uint32_t>(x, out, 1, R, n, n, pos, units, nunits, kmax, rows, blocks, sunit, ounit, s, pdl, occ);
    case 8: return launch_staged_copy<unsigned long long>(x, out, 1, R, n, n, pos, units, nunits, kmax, rows, blocks, sunit, ounit, s, pdl, occ);
    default: return cudaErrorInvalidValue;
  }
}

// B12 (the GSN, `gsn`) and B14 (the SSN, with `occ`): the derivation
// of the source table and the staged copy's operands into `work` (the
// caller's int32 workspace of 3n + 1 entries: the table, the remapped
// table, the unit count, the unit list), then the staged copy of the R
// rows under PDL.  The staging and store units are picked here from the
// row's bytes and the pointers.
static cudaError_t launch_shift_dyn(int gsn, int elem_bytes, const void* x,
                                    void* out, void* occ, long long R, int n,
                                    const void* shift, const void* valid,
                                    void* work, int rows, int blocks,
                                    cudaStream_t s) {
  if (n < 1 || rows < 1 || elem_bytes < 1 || elem_bytes > 8)
    return cudaErrorInvalidValue;
  const size_t row = (size_t)n * elem_bytes;
  const void* xp[1] = {x};
  const void* op[1] = {out};
  const int sunit = copy_unit(row, elem_bytes, xp, 1);
  const int ounit = copy_unit(row, elem_bytes, op, 1);
  int* tab = static_cast<int*>(work);
  int* pos = tab + n;
  int* nunits = pos + n;
  int* units = nunits + 1;
  cudaError_t e = launch_shift_sources(
      gsn, n, static_cast<const int*>(shift), static_cast<const int*>(valid),
      elem_bytes, sunit, tab, pos, nunits, units, s);
  if (e != cudaSuccess) return e;
  return launch_shift_copy(elem_bytes, x, out, occ, R, n, pos, units, nunits,
                           (int)(row / sunit), rows, blocks, sunit, ounit,
                           true, s);
}

extern "C" {

// Plain C entry points (bound with ctypes).  Each returns the cudaError_t
// of the launch; the Python wrapper raises when it is not 0.

// B10.  `unit_bytes` is the copy unit (1, 2, 4, 8 or 16), `units` the
// row length in units.
int route_rows(int unit_bytes, const void* x, void* out, const void* masks,
               const void* out_valid, int n, int units, int L,
               int toward_zero, int lsb_first, int rows, void* stream) {
  if (n < 1 || units < 1 || L < 0 || rows < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_bytes) {
    case 1: return launch_route_rows<uint8_t>(x, out, masks, out_valid, n, units, L, toward_zero, lsb_first, rows, s);
    case 2: return launch_route_rows<uint16_t>(x, out, masks, out_valid, n, units, L, toward_zero, lsb_first, rows, s);
    case 4: return launch_route_rows<uint32_t>(x, out, masks, out_valid, n, units, L, toward_zero, lsb_first, rows, s);
    case 8: return launch_route_rows<uint2>(x, out, masks, out_valid, n, units, L, toward_zero, lsb_first, rows, s);
    case 16: return launch_route_rows<uint4>(x, out, masks, out_valid, n, units, L, toward_zero, lsb_first, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

// B12 (`gsn`, occ == NULL) and B14 (the SSN, which also writes the (R, n)
// occupancy bytes `occ`) on the (n,) int32 operand counts: two kernels on
// `stream` (`launch_shift_dyn`), in `rows`-row tiles over at most `blocks`
// blocks, with the caller's int32 workspace `work` of 3n + 1 entries.
int shift_dyn(int gsn, int elem_bytes, const void* x, void* out, void* occ,
              long long R, int n, const void* shift, const void* valid,
              void* work, int rows, int blocks, void* stream) {
  return launch_shift_dyn(gsn, elem_bytes, x, out, occ, R, n, shift, valid,
                          work, rows, blocks,
                          static_cast<cudaStream_t>(stream));
}

// B11 (occ == NULL) and B13 (which also writes the (R, n) occupancy bytes
// `occ`): one staged copy of the R rows through the operands the host
// composed from the plan's table (the remapped table `pos` (n), the unit
// list `units` (kmax entries, nunits[0] of them used)); stream-ordered,
// no PDL.  Staged in `sunit`-byte units (the unit the list counts in) and
// stored in `ounit`-byte units.
int shift_table_copy(int elem_bytes, const void* x, void* out, void* occ,
                     long long R, int n, const void* pos, const void* units,
                     const void* nunits, int kmax, int rows, int blocks,
                     int sunit, int ounit, void* stream) {
  if (n < 1 || rows < 1) return cudaErrorInvalidValue;
  return launch_shift_copy(elem_bytes, x, out, occ, R, n,
                           static_cast<const int*>(pos),
                           static_cast<const int*>(units),
                           static_cast<const int*>(nunits), kmax, rows,
                           blocks, sunit, ounit, false,
                           static_cast<cudaStream_t>(stream));
}

// The derive kernel alone on the operand counts: the (n,) source table of
// the GSN (`gsn`, B12's) or the SSN (B14's) and the staged copy's operands
// for rows of `elem`-byte lanes in `sunit`-byte units, into `work` laid out
// as B12's and B14's workspace (3n + 1 int32).
int shift_sources(int gsn, int n, const void* shift, const void* valid,
                  int elem, int sunit, void* work, void* stream) {
  int* tab = static_cast<int*>(work);
  return launch_shift_sources(gsn, n, static_cast<const int*>(shift),
                              static_cast<const int*>(valid), elem, sunit,
                              tab, tab + n, tab + 2 * n, tab + 2 * n + 1,
                              static_cast<cudaStream_t>(stream));
}

const char* indexed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
