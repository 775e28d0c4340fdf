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
//   B11 / B13: a row tile through a `shiftplan.counts_plan` plan
//        (route_plan.cuh), then zero where the plan's occupancy is clear;
//        B13 also writes that occupancy for every (row, lane).
//   B12 / B14: the same through the dynamic-count network (route_dyn.cuh)
//        whose counts are the (n,) `shift` / `valid` operands shared by all
//        rows; zero where the routed validity is clear; B14 also writes the
//        routed validity.
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
//   B11 / B13: B3's tile loop (strided.cu) at vl = n, with the occupancy
//   row beside the masks.  B12 / B14: B8's tile loop with the counts
//   loaded from device memory into the network's count scratch instead of
//   computed from (stride, offset); the wrapper casts them to int32 on the
//   card and sizes the row tile with `dyn_net_bytes`, as B8 does, so one
//   derivation serves the whole tile.  Elements move as raw bits (1, 2, 4
//   or 8 bytes), so every dtype is bit-exact, -0.0 and NaN payloads
//   included.

#include <cuda_runtime.h>
#include <stdint.h>

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
// B11-B14: the row tile in and out
// ---------------------------------------------------------------------------

// Rows [0, nr) of the (nr, n) payload `xs` into the shared tile `ba`.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ xs, T* ba,
                                          int nr, int n, const TileMap& tm) {
  if (tm.g >= tm.groups) return;
  for (int c = tm.t; c < n; c += tm.lanes)
    for (int r = tm.g; r < nr; r += tm.groups)
      ba[(size_t)r * n + c] = xs[(size_t)r * n + c];
}

// The routed tile `res` to `os`, zero where the lane's bit of `occ_bits`
// is clear; with `oc` (B13 / B14) also that bit for every element.
template <typename T>
__device__ __forceinline__ void store_masked(const T* res, T* __restrict__ os,
                                             uint8_t* __restrict__ oc,
                                             const uint32_t* occ_bits, int nr,
                                             int n, const TileMap& tm) {
  if (tm.g >= tm.groups) return;
  for (int c = tm.t; c < n; c += tm.lanes) {
    const bool keep = lane_bit(occ_bits, c);
    for (int r = tm.g; r < nr; r += tm.groups)
      os[(size_t)r * n + c] = keep ? res[(size_t)r * n + c] : T(0);
    if (oc)
      for (int r = tm.g; r < nr; r += tm.groups)
        oc[(size_t)r * n + c] = keep ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// B11 / B13: the raw network through a compiled plan
// ---------------------------------------------------------------------------

// (R, n) -> (R, n) through plan layers [0, nlayers), zero where the plan's
// occupancy bit is clear; with `occ` (B13) also that bit for every element.
template <typename T>
__global__ void __launch_bounds__(THREADS)
shift_plan_kernel(const T* __restrict__ x, T* __restrict__ out,
                  uint8_t* __restrict__ occ, long long R, int n,
                  const uint32_t* __restrict__ masks, int S, int words,
                  const int* __restrict__ layers, int nlayers,
                  const uint32_t* __restrict__ valid, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* smask = reinterpret_cast<uint32_t*>(smem);
  uint32_t* svalid = smask + (size_t)S * words;
  const size_t mbytes = ((size_t)(S + 1) * words * 4 + 15) & ~(size_t)15;
  T* ba = reinterpret_cast<T*>(smem + mbytes);
  T* bb = ba + (size_t)rows * n;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, R - r0);
  const TileMap tm(n);

  for (int i = threadIdx.x; i < S * words; i += blockDim.x) smask[i] = masks[i];
  for (int i = threadIdx.x; i < words; i += blockDim.x) svalid[i] = valid[i];
  load_tile(x + r0 * n, ba, nr, n, tm);
  __syncthreads();
  const T* res = route_plan<T>(ba, ba, bb, nr, n, words, smask, layers, 0,
                               nlayers, tm);
  store_masked(res, out + r0 * n, occ ? occ + r0 * n : nullptr, svalid, nr,
               n, tm);
}

template <typename T>
static cudaError_t launch_shift_plan(const void* x, void* out, void* occ,
                                     long long R, int n, const void* masks,
                                     int S, int words, const void* layers,
                                     int nlayers, const void* valid, int rows,
                                     cudaStream_t stream) {
  const size_t mbytes = ((size_t)(S + 1) * words * 4 + 15) & ~(size_t)15;
  const size_t smem = mbytes + 2 * (size_t)rows * n * sizeof(T);
  const long long tiles = (R + rows - 1) / rows;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(shift_plan_kernel<T>, smem, granted);
  if (e != cudaSuccess) return e;
  shift_plan_kernel<T><<<(unsigned)tiles, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<uint8_t*>(occ), R, n, static_cast<const uint32_t*>(masks),
      S, words, static_cast<const int*>(layers), nlayers,
      static_cast<const uint32_t*>(valid), rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B12 / B14: the raw network on runtime counts
// ---------------------------------------------------------------------------

// Fill the network's counts from the (n,) int32 operands: sc[c] =
// shift[c], validity bit c = valid[c] != 0.  Lanes are walked in whole
// warps (words * 32), so each validity word is one ballot.
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

// (R, n) -> (R, n) through the GSN (`gsn`, B12) or the SSN (B14) on the
// operand counts, zero where the routed validity is clear; with `occ`
// (B14) also the routed validity for every element.
template <typename T>
__global__ void __launch_bounds__(THREADS)
shift_dyn_kernel(const T* __restrict__ x, T* __restrict__ out,
                 uint8_t* __restrict__ occ, long long R, int n,
                 const int* __restrict__ shift, const int* __restrict__ valid,
                 int gsn, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  DynNet net = dyn_carve(smem, n);
  T* ba = reinterpret_cast<T*>(smem + dyn_bytes(n));
  T* bb = ba + (size_t)rows * n;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, R - r0);
  const TileMap tm(n);

  load_tile(x + r0 * n, ba, nr, n, tm);
  operand_counts(net, shift, valid);
  dyn_derive(net, gsn != 0);
  const T* res = route_dyn<T>(net, ba, ba, bb, nr, tm);
  store_masked(res, out + r0 * n, occ ? occ + r0 * n : nullptr, net.occ, nr,
               n, tm);
}

template <typename T>
static cudaError_t launch_shift_dyn(const void* x, void* out, void* occ,
                                    long long R, int n, const void* shift,
                                    const void* valid, int gsn, int rows,
                                    cudaStream_t stream) {
  const size_t smem = dyn_bytes(n) + 2 * (size_t)rows * n * sizeof(T);
  const long long tiles = (R + rows - 1) / rows;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(shift_dyn_kernel<T>, smem, granted);
  if (e != cudaSuccess) return e;
  shift_dyn_kernel<T><<<(unsigned)tiles, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<uint8_t*>(occ), R, n, static_cast<const int*>(shift),
      static_cast<const int*>(valid), gsn, rows);
  return cudaGetLastError();
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

// B11 (occ == NULL) and B13 (occ != NULL).
int shift_plan(int elem_bytes, const void* x, void* out, void* occ,
               long long R, int n, const void* masks, int S, int words,
               const void* layers, int nlayers, const void* valid, int rows,
               void* stream) {
  if (n < 1 || rows < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_shift_plan<uint8_t>(x, out, occ, R, n, masks, S, words, layers, nlayers, valid, rows, s);
    case 2: return launch_shift_plan<uint16_t>(x, out, occ, R, n, masks, S, words, layers, nlayers, valid, rows, s);
    case 4: return launch_shift_plan<uint32_t>(x, out, occ, R, n, masks, S, words, layers, nlayers, valid, rows, s);
    case 8: return launch_shift_plan<unsigned long long>(x, out, occ, R, n, masks, S, words, layers, nlayers, valid, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

// B12 (gsn = 1, occ == NULL) and B14 (gsn = 0, occ != NULL).
int shift_dyn(int elem_bytes, const void* x, void* out, void* occ,
              long long R, int n, const void* shift, const void* valid,
              int gsn, int rows, void* stream) {
  if (n < 1 || rows < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_shift_dyn<uint8_t>(x, out, occ, R, n, shift, valid, gsn, rows, s);
    case 2: return launch_shift_dyn<uint16_t>(x, out, occ, R, n, shift, valid, gsn, rows, s);
    case 4: return launch_shift_dyn<uint32_t>(x, out, occ, R, n, shift, valid, gsn, rows, s);
    case 8: return launch_shift_dyn<unsigned long long>(x, out, occ, R, n, shift, valid, gsn, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* indexed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
