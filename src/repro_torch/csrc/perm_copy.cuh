// Table-driven copies of row tiles, the copy half of every redesigned
// permutation kernel:
//   * `perm_copy_kernel`: B1 and B6 (segment.cu), the copy half of B8
//     (strided.cu);
//   * `staged_copy_kernel`: the whole of B3 and B4 (strided.cu) and of B13
//     (indexed.cu, which also writes the occupancy), the copy half of B12
//     and B14 (indexed.cu; B14 also writes the occupancy);
//   * `merge_copy_kernel`: the whole of B5 and the copy half of B9
//     (strided.cu);
//   * `interleave_copy_kernel`: the whole of B2 and the copy half of B7
//     (segment.cu), at the end of this file.
//
// The permuted copy.  For every row r of the (R, n) input, part p < parts
// and lane j < w:
//   out_p[r][j] = tab[p*w + j] < 0 ? 0 : x[r][tab[p*w + j]]
// `tab` is a network composed into one source lane per output lane: for B6
// and B8 written to device memory by the derive kernel launched just
// before this one (route_dyn.cuh's `dyn_sources`); for B1 composed on the
// host from the static plan (`ShiftPlan.source`) and uploaded once per
// plan.  Elements move as raw bits (templated on 1, 2, 4 or 8 bytes), so
// every dtype is bit-exact, -0.0 and NaN payloads included.
//
// Bound: pure data movement, each input byte read once and each output
// byte written once, over 3.35 TB/s.  What the design does about it:
//   * a persistent grid (two blocks per SM) walks the row tiles, so the
//     table is loaded into shared memory once per block;
//   * a tile of `rows` whole rows is one contiguous chunk of the input.  It
//     is staged into shared memory with asynchronous copies of `unit` bytes
//     (cp.async, 16 bytes on the main path), double-buffered: tile k+1's
//     load is in flight while tile k is permuted and stored;
//   * the permute reads the staged tile through the table into an output
//     tile that holds each part's (rows, w) block.  Consecutive threads
//     take consecutive output lanes and walk down the rows, so a FIELD=2 or
//     stride-2 read of 2-byte lanes touches 32 distinct banks;
//   * each part's block is contiguous in that part's output, so it leaves
//     in `unit`-byte vector stores;
//   * two barriers a tile (staged tile visible; output tile complete) and
//     none per layer;
//   * behind a derive kernel (B6, B8) the copy is launched under
//     Programmatic Dependent Launch and its first tile's load is issued
//     before it waits on that kernel, so the load overlaps the derivation.
//     B1 has no derive kernel: its copy is launched plainly, stream-ordered
//     after whatever kernel wrote `x`, so the early load cannot read `x`
//     before it is complete.
// `unit` is the widest of 16, 8, 4, 2 or 1 bytes that divides both row
// widths in bytes and every pointer (the wrapper picks it); units of 1 or
// 2 bytes are staged with plain loads, since cp.async moves 4, 8 or 16.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "route_plan.cuh"

#define MAX_PARTS 16

// The output (or input) pointers of a multi-part kernel, by value.
struct Ptrs {
  void* p[MAX_PARTS];
};

__host__ __device__ inline size_t pad16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

template <int U>
__device__ __forceinline__ void cp_async_unit(unsigned char* dst,
                                              const unsigned char* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (U == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if constexpr (U == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until every committed group of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int U>
__device__ __forceinline__ void stage_units(unsigned char* dst,
                                            const unsigned char* src,
                                            size_t bytes) {
  const size_t units = bytes / U;
  for (size_t i = threadIdx.x; i < units; i += blockDim.x) {
    if constexpr (U >= 4)
      cp_async_unit<U>(dst + i * U, src + i * U);
    else if constexpr (U == 2)
      reinterpret_cast<uint16_t*>(dst)[i] =
          reinterpret_cast<const uint16_t*>(src)[i];
    else
      dst[i] = src[i];
  }
}

// Start copying `bytes` from device memory into shared memory.
__device__ inline void stage(unsigned char* dst, const unsigned char* src,
                             size_t bytes, int unit) {
  switch (unit) {
    case 16: stage_units<16>(dst, src, bytes); break;
    case 8: stage_units<8>(dst, src, bytes); break;
    case 4: stage_units<4>(dst, src, bytes); break;
    case 2: stage_units<2>(dst, src, bytes); break;
    default: stage_units<1>(dst, src, bytes); break;
  }
}

template <typename U>
__device__ __forceinline__ void store_units(unsigned char* dst,
                                            const unsigned char* src,
                                            size_t bytes) {
  const size_t units = bytes / sizeof(U);
  const U* s = reinterpret_cast<const U*>(src);
  U* d = reinterpret_cast<U*>(dst);
  for (size_t i = threadIdx.x; i < units; i += blockDim.x) d[i] = s[i];
}

// Copy `bytes` from shared memory out to device memory.
__device__ inline void store(unsigned char* dst, const unsigned char* src,
                             size_t bytes, int unit) {
  switch (unit) {
    case 16: store_units<uint4>(dst, src, bytes); break;
    case 8: store_units<uint2>(dst, src, bytes); break;
    case 4: store_units<uint32_t>(dst, src, bytes); break;
    case 2: store_units<uint16_t>(dst, src, bytes); break;
    default: store_units<uint8_t>(dst, src, bytes); break;
  }
}

// Shared memory: the table (parts*w ints), two staged input tiles of
// rows x n and the output tile, one (rows, w) block per part, each
// rounded up to 16 bytes.
__host__ __device__ inline size_t perm_copy_smem(int n, int parts, int w,
                                                 int rows, size_t elem) {
  return pad16((size_t)parts * w * 4) + 2 * pad16((size_t)rows * n * elem) +
         (size_t)parts * pad16((size_t)rows * w * elem);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
perm_copy_kernel(const T* __restrict__ x, Ptrs outs, long long R, int n,
                 int parts, int w, const int* __restrict__ table, int rows,
                 int unit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nout = parts * w;
  const size_t in_row = (size_t)n * sizeof(T);
  const size_t out_row = (size_t)w * sizeof(T);
  const size_t in_b = pad16((size_t)rows * in_row);
  const size_t out_b = pad16((size_t)rows * out_row);
  int* tab = reinterpret_cast<int*>(smem);
  unsigned char* ibuf = smem + pad16((size_t)nout * 4);
  unsigned char* obuf = ibuf + 2 * in_b;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const long long tiles = (R + rows - 1) / rows;
  long long tile = blockIdx.x;            // the grid is at most `tiles`

  // The input does not depend on the table: stage the first tile, then
  // wait for the derive kernel, if any, before reading its table.
  stage(ibuf, xb + tile * rows * in_row,
        (size_t)min((long long)rows, R - tile * rows) * in_row, unit);
  cp_async_commit();
  pdl_wait();
  for (int c = threadIdx.x; c < nout; c += blockDim.x) tab[c] = table[c];

  const TileMap tm(nout);
  for (int k = 0; tile < tiles; ++k, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    // buffer (k+1)&1 was last read by tile k-1's permute, which ended
    // with a barrier every thread has passed
    if (next < tiles)
      stage(ibuf + ((k + 1) & 1) * in_b, xb + next * rows * in_row,
            (size_t)min((long long)rows, R - next * rows) * in_row, unit);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();      // tile k staged (and the table loaded); the
                          // output tile's last stores are done
    const T* in = reinterpret_cast<const T*>(ibuf + (k & 1) * in_b);
    const int nr = (int)min((long long)rows, R - tile * rows);
    if (tm.g < tm.groups) {
      for (int c = tm.t; c < nout; c += tm.lanes) {
        const int p = c / w;
        const int j = c - p * w;
        const int s = tab[c];
        T* o = reinterpret_cast<T*>(obuf + p * out_b) + j;
        if (s >= 0) {
          for (int r = tm.g; r < nr; r += tm.groups)
            o[(size_t)r * w] = in[(size_t)r * n + s];
        } else {
          for (int r = tm.g; r < nr; r += tm.groups) o[(size_t)r * w] = T(0);
        }
      }
    }
    __syncthreads();      // output tile complete
    for (int p = 0; p < parts; ++p)
      store(static_cast<unsigned char*>(outs.p[p]) + tile * rows * out_row,
            obuf + p * out_b, (size_t)nr * out_row, unit);
  }
}

// Launch `kernel` (THREADS threads a block) on `stream`.  With `pdl`, under
// Programmatic Dependent Launch: it may start before the kernel before it
// on the stream ends, and waits for that kernel (`pdl_wait`) before it
// reads what that kernel writes.  Without, it is plainly stream-ordered.
template <typename... Params, typename... Args>
static cudaError_t launch_chained(void (*kernel)(Params...), dim3 grid,
                                  size_t smem, bool pdl, cudaStream_t stream,
                                  Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launch the permuted copy: with `pdl` after a derive kernel on the same
// stream, allowed to start before that kernel ends (it waits on it before
// reading `table`); without, after whatever wrote `x` and `table`.
template <typename T>
static cudaError_t launch_perm_copy(const void* x, const Ptrs& outs,
                                    long long R, int n, int parts, int w,
                                    const int* table, int rows, int blocks,
                                    int unit, bool pdl, cudaStream_t stream) {
  const size_t e = sizeof(T);
  if (parts < 1 || parts > MAX_PARTS || w < 1 || n < 1 || rows < 1 ||
      blocks < 1 || R < 1 || unit < (int)e || unit > 16 ||
      (unit & (unit - 1)) || (n * e) % unit || (w * e) % unit)
    return cudaErrorInvalidValue;
  const size_t smem = perm_copy_smem(n, parts, w, rows, e);
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t err = set_smem(perm_copy_kernel<T>, smem, granted);
  if (err != cudaSuccess) return err;
  const long long tiles = (R + rows - 1) / rows;
  return launch_chained(perm_copy_kernel<T>,
                        (unsigned)(tiles < blocks ? tiles : blocks), smem, pdl,
                        stream, static_cast<const T*>(x), outs, R, n, parts,
                        w, table, rows, unit);
}

// ---------------------------------------------------------------------------
// The staged copy: B3, B4 (strided.cu) and B12-B14 (indexed.cu)
// ---------------------------------------------------------------------------
//
// For access a < A (blockIdx.y), every row r of its (R, n) window and lane
// j < vl:
//   out_a[r][j] = pos[a*vl + j] < 0 ? 0 : staged_a[r][pos[a*vl + j]]
// where staged_a[r] is row r compacted to its listed units: units[a*kmax +
// k] (k < nunits[a]) of `sunit` bytes each, in order.  For B3 and B4 the
// host composes both from a gather plan's table (`ShiftPlan.source`, which
// is static; every entry >= 0), and for B13 (one access, vl = n) from a
// counts plan's table under its occupancy (-1 where a lane is
// unoccupied), so there is no derive kernel and nothing to wait for: the
// wrapper uploads the list and the remapped table once per plan and copy
// unit, and the copy is launched plainly.  For B12 and B14 (one access, vl
// = n) the derive kernel launched just before this one composes them on
// the card from the GSN's or the SSN's source table (route_dyn.cuh,
// `dyn_staged_units`; -1 where a lane is unoccupied), and the copy starts
// under Programmatic Dependent Launch: it waits for that kernel before it
// reads the list, since what it stages depends on it.  With `occ` (B13,
// B14) it also writes
//   occ[r][j] = pos[j] >= 0
// as one byte (0 / 1) for every row, built once per block in shared memory
// and stored beside each output tile in `occ_unit`-byte vector stores, in
// the same pass.
//
// Bound: the sectors that hold an output lane are read once (the whole
// window while stride x element size <= 32 bytes), the output is written
// once.  What the design does about it, beyond perm_copy_kernel's
// persistent, double-buffered tiles and 16-byte stores:
//   * a row stages only the units that hold an output lane.  Where those
//     touch every 32-byte sector of the row (stride x element size <= 32
//     bytes, the main path among them), the host lists the whole row, and
//     a tile is one contiguous chunk, staged as in perm_copy_kernel: the
//     same sectors move, faster.  Past it each listed unit is its own
//     cp.async, and only the sectors that hold an output lane are read.  A
//     staged row then takes less shared memory, so more rows fit a tile;
//   * a block works on one access only, so it holds just that access's
//     table and list in shared memory (at n = 4096 a table is up to 16 KB,
//     too much for A of them beside the tiles), loaded once; no tile
//     crosses an access's rows;
//   * staging and storing use separate units: the widest that divides the
//     row's bytes and the pointer, each on its own side.
// Shared memory: the table, the list, two staged tiles of kmax units a
// row, the output tile and with `occ` the (rows, vl) occupancy bytes.
__host__ __device__ inline size_t staged_copy_smem(int vl, int kmax, int rows,
                                                   int sunit, size_t elem,
                                                   bool occ = false) {
  return pad16((size_t)vl * 4) + pad16((size_t)kmax * 4) +
         2 * pad16((size_t)rows * kmax * sunit) +
         pad16((size_t)rows * vl * elem) + (occ ? pad16((size_t)rows * vl) : 0);
}

template <int U>
__device__ __forceinline__ void stage_listed_units(unsigned char* dst,
                                                   const unsigned char* src,
                                                   int nr, size_t in_row,
                                                   const int* ulist, int K) {
  const int total = nr * K;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / K;
    const unsigned char* s = src + r * in_row + (size_t)ulist[i - r * K] * U;
    unsigned char* d = dst + (size_t)i * U;
    if constexpr (U >= 4)
      cp_async_unit<U>(d, s);
    else if constexpr (U == 2)
      *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
    else
      *d = *s;
  }
}

// Start staging rows [0, nr) of `src` (rows of `in_row` bytes): only the
// K listed units of each, compacted, or the whole chunk when the list is
// the whole row.
__device__ inline void stage_rows(unsigned char* dst, const unsigned char* src,
                                  int nr, size_t in_row, const int* ulist,
                                  int K, int unit) {
  if ((size_t)K * unit == in_row) {
    stage(dst, src, (size_t)nr * in_row, unit);
    return;
  }
  switch (unit) {
    case 16: stage_listed_units<16>(dst, src, nr, in_row, ulist, K); break;
    case 8: stage_listed_units<8>(dst, src, nr, in_row, ulist, K); break;
    case 4: stage_listed_units<4>(dst, src, nr, in_row, ulist, K); break;
    case 2: stage_listed_units<2>(dst, src, nr, in_row, ulist, K); break;
    default: stage_listed_units<1>(dst, src, nr, in_row, ulist, K); break;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
staged_copy_kernel(const T* __restrict__ x, T* __restrict__ out, long long R,
                   int n, int vl, const int* __restrict__ pos,
                   const int* __restrict__ units,
                   const int* __restrict__ nunits, int kmax, int rows,
                   int sunit, int ounit, uint8_t* __restrict__ occ,
                   int occ_unit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.y;
  pdl_wait();                      // B12 / B14: the derive kernel's list
  const int K = nunits[a];
  const size_t in_row = (size_t)n * sizeof(T);
  const size_t out_row = (size_t)vl * sizeof(T);
  const size_t in_b = pad16((size_t)rows * kmax * sunit);
  int* tab = reinterpret_cast<int*>(smem);
  int* ulist = reinterpret_cast<int*>(smem + pad16((size_t)vl * 4));
  unsigned char* ibuf = smem + pad16((size_t)vl * 4) + pad16((size_t)kmax * 4);
  unsigned char* obuf = ibuf + 2 * in_b;
  uint8_t* otile = obuf + pad16((size_t)rows * vl * sizeof(T));
  const unsigned char* xa =
      reinterpret_cast<const unsigned char*>(x) + (size_t)a * R * in_row;
  unsigned char* oa = reinterpret_cast<unsigned char*>(out) + (size_t)a * R * out_row;
  const int kel = (int)((size_t)K * sunit / sizeof(T));  // lanes of a staged row
  const long long tiles = (R + rows - 1) / rows;
  long long tile = blockIdx.x;            // the grid is at most `tiles` wide

  for (int c = threadIdx.x; c < vl; c += blockDim.x) tab[c] = pos[(size_t)a * vl + c];
  for (int c = threadIdx.x; c < K; c += blockDim.x)
    ulist[c] = units[(size_t)a * kmax + c];
  __syncthreads();                        // the list, before staging reads it
  stage_rows(ibuf, xa + tile * rows * in_row,
             (int)min((long long)rows, R - tile * rows), in_row, ulist, K, sunit);
  cp_async_commit();
  if (occ)                                // the table is loaded: one row of
    for (int i = threadIdx.x; i < rows * vl; i += blockDim.x)  // bytes a row
      otile[i] = tab[i % vl] >= 0;

  const TileMap tm(vl);
  for (int k = 0; tile < tiles; ++k, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    // buffer (k+1)&1 was last read by tile k-1's permute, which ended
    // with a barrier every thread has passed
    if (next < tiles)
      stage_rows(ibuf + ((k + 1) & 1) * in_b, xa + next * rows * in_row,
                 (int)min((long long)rows, R - next * rows), in_row, ulist, K,
                 sunit);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();      // tile k staged; the output tile's last stores are done
    const T* in = reinterpret_cast<const T*>(ibuf + (k & 1) * in_b);
    const int nr = (int)min((long long)rows, R - tile * rows);
    if (tm.g < tm.groups) {
      T* o = reinterpret_cast<T*>(obuf);
      for (int c = tm.t; c < vl; c += tm.lanes) {
        const int s = tab[c];
        if (s >= 0) {
          for (int r = tm.g; r < nr; r += tm.groups)
            o[(size_t)r * vl + c] = in[(size_t)r * kel + s];
        } else {
          for (int r = tm.g; r < nr; r += tm.groups) o[(size_t)r * vl + c] = T(0);
        }
      }
    }
    __syncthreads();      // output tile complete
    store(oa + tile * rows * out_row, obuf, (size_t)nr * out_row, ounit);
    if (occ)
      store(occ + tile * rows * vl, otile, (size_t)nr * vl, occ_unit);
  }
}

// The widest copy unit (16, 8, 4, 2 or 1 bytes, at least `elem`) that
// divides `row_bytes` and every pointer.
static inline int copy_unit(size_t row_bytes, size_t elem,
                            const void* const* ptrs, int np) {
  int u = 16;
  for (; u > (int)elem; u >>= 1) {
    bool ok = row_bytes % u == 0;
    for (int i = 0; ok && i < np; ++i) ok = (uintptr_t)ptrs[i] % u == 0;
    if (ok) break;
  }
  return u;
}

static inline bool bad_unit(int unit, size_t elem) {
  return unit < (int)elem || unit > 16 || (unit & (unit - 1));
}

// One launch of the staged copy over A accesses: a persistent grid of at
// most `blocks` blocks per access.  With `pdl` (B12, B14) after the derive
// kernel that writes the list and the table on the same stream, allowed to
// start before that kernel ends; without (B3, B4, B13: host operands),
// stream-ordered after whatever wrote `x`.  With `occ` (one access only)
// it also writes the (R, vl) occupancy bytes, in the widest unit that
// divides vl and the pointer.
template <typename T>
static cudaError_t launch_staged_copy(const void* x, void* out, int A,
                                      long long R, int n, int vl,
                                      const int* pos, const int* units,
                                      const int* nunits, int kmax, int rows,
                                      int blocks, int sunit, int ounit,
                                      cudaStream_t stream, bool pdl = false,
                                      void* occ = nullptr) {
  const size_t e = sizeof(T);
  if (A < 1 || A > 65535 || n < 1 || vl < 1 || R < 1 || rows < 1 ||
      blocks < 1 || kmax < 1 || bad_unit(sunit, e) || bad_unit(ounit, e) ||
      (n * e) % sunit || (vl * e) % ounit || (size_t)kmax * sunit > n * e ||
      (occ && A != 1))
    return cudaErrorInvalidValue;
  const void* optr[1] = {occ};
  const int occ_unit = occ ? copy_unit((size_t)vl, 1, optr, 1) : 1;
  const size_t smem = staged_copy_smem(vl, kmax, rows, sunit, e,
                                       occ != nullptr);
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t err = set_smem(staged_copy_kernel<T>, smem, granted);
  if (err != cudaSuccess) return err;
  const long long tiles = (R + rows - 1) / rows;
  return launch_chained(staged_copy_kernel<T>,
                        dim3((unsigned)(tiles < blocks ? tiles : blocks),
                             (unsigned)A),
                        smem, pdl, stream, static_cast<const T*>(x),
                        static_cast<T*>(out), R, n, vl, pos, units, nunits,
                        kmax, rows, sunit, ounit, static_cast<uint8_t*>(occ),
                        occ_unit);
}

// ---------------------------------------------------------------------------
// The merge copy: B5 and B9 (strided.cu)
// ---------------------------------------------------------------------------
//
// For every row r of the (R, n) window and the (R, vl) values:
//   out[r] = win[r], except out[r][lane_k] = vals[r][src_k] for k < K
// where list = {K, lane_0, src_0, lane_1, src_1, ...} names the lanes a
// scatter occupies, in lane order, and the values lane each one takes (at
// most `kmax` pairs; lanes left out keep the window).  B9's derive kernel
// writes the list (route_dyn.cuh, `dyn_sources` on the SSN) just before
// this kernel, which then starts under Programmatic Dependent Launch.  B5
// takes the same list from the host: a scatter plan's table
// (`ShiftPlan.source` under `.valid` of `shiftplan.scatter_plan`) is
// static, so the wrapper composes and uploads it once per plan.  Then
// there is no derive kernel, the kernel before the copy on the stream is
// whatever wrote the window or the values, and the copy is launched
// plainly (`pdl` off), as B1 launches its permuted copy.
//
// Bound: the window and the values read once and the output written once,
// over 3.35 TB/s.  What the design does about it:
//   * a persistent grid walks the row tiles, so the list is loaded into
//     shared memory once per block;
//   * a tile's window rows and its value rows are two contiguous chunks,
//     staged with cp.async (16 bytes on the main path), double-buffered;
//   * the occupied lanes are merged in place into the staged window tile.
//     Threads walk the list, not the n lanes: a wide window with few
//     values (n = 4096, vl = 64) merges 64 lanes a row, spread over every
//     thread, and never scans the 4032 lanes that keep the window;
//   * the merged tile leaves whole and contiguous in vector stores;
//   * two barriers a tile: tile k staged and every thread past tile k-1's
//     stores (so tile k+1's load may then reuse that buffer), and the merge
//     done.  Tile k+1's load overlaps tile k's merge and stores;
//   * B9's first tile loads are issued before the kernel waits for the
//     derive kernel: only the list read waits.  Without PDL (B5) the wait
//     is a no-op and the stream has already ordered the loads after the
//     window's and the values' writers.
// `wunit` divides the window row's bytes and both the window and output
// pointers; `vunit` the value row's bytes and the values pointer.
__host__ __device__ inline size_t merge_copy_smem(int n, int vl, int kmax,
                                                  int rows, size_t elem) {
  return pad16((size_t)kmax * 8) + 2 * pad16((size_t)rows * n * elem) +
         2 * pad16((size_t)rows * vl * elem);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
merge_copy_kernel(const T* __restrict__ win, const T* __restrict__ vals,
                  T* __restrict__ out, long long R, int n, int vl,
                  const int* __restrict__ list, int kmax, int rows, int wunit,
                  int vunit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t w_row = (size_t)n * sizeof(T);
  const size_t v_row = (size_t)vl * sizeof(T);
  const size_t w_b = pad16((size_t)rows * w_row);
  const size_t v_b = pad16((size_t)rows * v_row);
  int* pairs = reinterpret_cast<int*>(smem);
  unsigned char* wbuf = smem + pad16((size_t)kmax * 8);
  unsigned char* vbuf = wbuf + 2 * w_b;
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(win);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(vals);
  unsigned char* ob = reinterpret_cast<unsigned char*>(out);
  const long long tiles = (R + rows - 1) / rows;
  long long tile = blockIdx.x;            // the grid is at most `tiles` wide

  // The rows do not depend on the list: stage the first tile, then wait
  // for the derive kernel, if any, before reading its list.
  {
    const size_t nr = (size_t)min((long long)rows, R - tile * rows);
    stage(wbuf, wb + tile * rows * w_row, nr * w_row, wunit);
    stage(vbuf, vb + tile * rows * v_row, nr * v_row, vunit);
  }
  cp_async_commit();
  pdl_wait();
  const int K = max(0, min(list[0], kmax));
  for (int c = threadIdx.x; c < 2 * K; c += blockDim.x) pairs[c] = list[1 + c];

  const TileMap tm(max(K, 1));
  for (int k = 0; tile < tiles; ++k, tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();      // tile k staged (and the list loaded); every
                          // thread is past tile k-1's stores
    const long long next = tile + gridDim.x;
    if (next < tiles) {
      const size_t nr = (size_t)min((long long)rows, R - next * rows);
      stage(wbuf + ((k + 1) & 1) * w_b, wb + next * rows * w_row, nr * w_row,
            wunit);
      stage(vbuf + ((k + 1) & 1) * v_b, vb + next * rows * v_row, nr * v_row,
            vunit);
    }
    cp_async_commit();
    T* w = reinterpret_cast<T*>(wbuf + (k & 1) * w_b);
    const T* v = reinterpret_cast<const T*>(vbuf + (k & 1) * v_b);
    const int nr = (int)min((long long)rows, R - tile * rows);
    if (tm.g < tm.groups) {
      for (int i = tm.t; i < K; i += tm.lanes) {
        const int c = pairs[2 * i];
        const int s = pairs[2 * i + 1];
        for (int r = tm.g; r < nr; r += tm.groups)
          w[(size_t)r * n + c] = v[(size_t)r * vl + s];
      }
    }
    __syncthreads();      // tile k merged
    store(ob + tile * rows * w_row, wbuf + (k & 1) * w_b, (size_t)nr * w_row,
          wunit);
  }
}

// Launch the merge copy over at most `blocks` blocks.  With `pdl` (B9)
// after the derive kernel that writes `list` on the same stream, allowed
// to start before that kernel ends (it waits on it before reading
// `list`); without (B5, the list uploaded from the host), stream-ordered
// after whatever wrote `win` and `vals`.
template <typename T>
static cudaError_t launch_merge_copy(const void* win, const void* vals,
                                     void* out, long long R, int n, int vl,
                                     const int* list, int kmax, int rows,
                                     int blocks, int wunit, int vunit,
                                     bool pdl, cudaStream_t stream) {
  const size_t e = sizeof(T);
  if (n < 1 || vl < 1 || vl > n || kmax < 1 || R < 1 || rows < 1 ||
      blocks < 1 || bad_unit(wunit, e) || bad_unit(vunit, e) ||
      (n * e) % wunit || (vl * e) % vunit)
    return cudaErrorInvalidValue;
  const size_t smem = merge_copy_smem(n, vl, kmax, rows, e);
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t err = set_smem(merge_copy_kernel<T>, smem, granted);
  if (err != cudaSuccess) return err;
  const long long tiles = (R + rows - 1) / rows;
  return launch_chained(merge_copy_kernel<T>,
                        (unsigned)(tiles < blocks ? tiles : blocks), smem, pdl,
                        stream, static_cast<const T*>(win),
                        static_cast<const T*>(vals), static_cast<T*>(out), R,
                        n, vl, list, kmax, rows, wunit, vunit);
}

// ---------------------------------------------------------------------------
// The interleave copy: B2 and B7 (segment.cu)
// ---------------------------------------------------------------------------
//
// The inverse form of the permuted copy: `fields` (R, m) inputs, one (R, n)
// output, n = fields*m.  For every row r and output lane c < n:
//   out[r][c] = tab[c] < 0 ? 0 : in_f[r][j]   where tab[c] = f*m + j,
// the lane of the concatenated fields that lane c takes.  The kernel
// composes `tab` as it loads it, from `tfields` rows of n int32 entries:
// row g's entry s >= 0 at lane c names lane g*span + s of the concatenated
// fields (span = n / tfields), and a later row wins.
//   * B2: one row (span n), composed on the host from the interleave plans
//     (`ShiftPlan.source` under `.valid`; f*m + j at lane f + j*fields for
//     every plan of either mode) and uploaded once per plan.  There is no
//     derive kernel and nothing to wait for: the copy is launched plainly,
//     stream-ordered after whatever wrote the inputs.
//   * B7: `fields` rows (span m), field f's SSN source table on
//     `scg.scatter_counts(n, fields, f, m)`, which the derive kernel
//     (route_dyn.cuh, one block per field) writes just before this copy.
//     A later field winning is the reference's merge, `acc = where(valid,
//     payload, acc)` in field order; a lane no field occupies is 0.  Every
//     block composes the whole table itself, so no two blocks write one
//     entry and no barrier between blocks is needed.  The copy starts
//     under Programmatic Dependent Launch: it stages its first tile, then
//     waits for the derive kernel before it reads the tables.
//
// Bound: each input byte read once, each output byte written once, over
// 3.35 TB/s.  What the design does about it:
//   * a persistent grid (two blocks per SM) walks the row tiles, so the
//     table is loaded into shared memory once per block, as uint16 (n <
//     65535; 0xFFFF where no plan fills the lane), which leaves room for
//     two rows a tile at n = 6144 in bf16;
//   * a tile's rows of one field are one contiguous (rows, m) chunk of that
//     input.  The `fields` chunks are staged with cp.async (16 bytes on the
//     main path), double-buffered: tile k+1's loads are in flight while tile
//     k is permuted and stored;
//   * consecutive threads take consecutive output lanes and walk down the
//     rows, so the output tile is written without bank conflicts.  Lanes c
//     and c+1 come from different fields at the same j, so the field tiles
//     are placed `interleave_skew` bytes apart round the 32 banks (each
//     tile padded to 128 bytes, then skewed): a warp's reads of one row
//     take 32*elem bytes spread over the fields, and with the skew the
//     fields' spans fall in distinct banks (FIELD=2 in bf16: 32 bytes each,
//     8 banks apart);
//   * the (rows, n) output tile is one contiguous chunk of the output and
//     leaves in `unit`-byte vector stores (16 bytes on the main path);
//   * two barriers a tile (tile k staged and every thread past tile k-1's
//     stores; output tile complete).  The first tile's loads are issued
//     before the table is read: behind B7's derive kernel they overlap the
//     derivation, and without PDL (B2) the wait is a no-op.
// `unit` is the widest of 16, 8, 4, 2 or 1 bytes that divides the input
// row's bytes and every pointer, picked in the entry point; it then divides
// the output row's bytes too.
__host__ __device__ inline size_t pad128(size_t b) {
  return (b + 127) & ~(size_t)127;
}

__host__ __device__ inline size_t interleave_skew(int fields, size_t elem) {
  const size_t wave = 32 * elem < 128 ? 32 * elem : 128;
  return pad16((wave + fields - 1) / fields);
}

// Bytes of one field tile of `rows` rows: padded to 128, then skewed.
__host__ __device__ inline size_t interleave_field_bytes(int m, int fields,
                                                         int rows,
                                                         size_t elem) {
  return pad128((size_t)rows * m * elem) + interleave_skew(fields, elem);
}

// Shared memory: the uint16 table, two staged input tiles of `fields` field
// tiles each, the (rows, n) output tile.
__host__ __device__ inline size_t interleave_copy_smem(int n, int fields,
                                                       int rows, size_t elem) {
  return pad16((size_t)n * 2) +
         2 * (size_t)fields *
             interleave_field_bytes(n / fields, fields, rows, elem) +
         pad16((size_t)rows * n * elem);
}

// Start staging rows [tile*rows, tile*rows + nr) of every field.
__device__ inline void stage_fields(unsigned char* dst, const Ptrs& ins,
                                    int fields, size_t fb, long long tile,
                                    int rows, long long R, size_t in_row,
                                    int unit) {
  const size_t nr = (size_t)min((long long)rows, R - tile * rows);
  for (int f = 0; f < fields; ++f)
    stage(dst + f * fb,
          static_cast<const unsigned char*>(ins.p[f]) + tile * rows * in_row,
          nr * in_row, unit);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
interleave_copy_kernel(Ptrs ins, T* __restrict__ out, long long R, int m,
                       int fields, const int* __restrict__ table, int tfields,
                       int rows, int unit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = fields * m;
  const size_t in_row = (size_t)m * sizeof(T);
  const size_t out_row = (size_t)n * sizeof(T);
  const size_t fb = interleave_field_bytes(m, fields, rows, sizeof(T));
  const size_t in_b = (size_t)fields * fb;
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem);
  unsigned char* ibuf = smem + pad16((size_t)n * 2);
  unsigned char* obuf = ibuf + 2 * in_b;
  unsigned char* ob = reinterpret_cast<unsigned char*>(out);
  const long long tiles = (R + rows - 1) / rows;
  long long tile = blockIdx.x;            // the grid is at most `tiles` wide

  // The fields do not depend on the table: stage the first tile, then
  // wait for the derive kernel, if any, before reading its tables.
  stage_fields(ibuf, ins, fields, fb, tile, rows, R, in_row, unit);
  cp_async_commit();
  pdl_wait();
  const int span = n / tfields;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    int t = -1;
    for (int g = 0; g < tfields; ++g) {
      const int s = table[(size_t)g * n + c];
      if (s >= 0 && s < span) t = g * span + s;
    }
    tab[c] = (uint16_t)t;                 // -1 becomes 0xFFFF
  }

  const TileMap tm(n);
  for (int k = 0; tile < tiles; ++k, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    // buffer (k+1)&1 was last read by tile k-1's permute, which ended
    // with a barrier every thread has passed
    if (next < tiles)
      stage_fields(ibuf + ((k + 1) & 1) * in_b, ins, fields, fb, next, rows,
                   R, in_row, unit);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();      // tile k staged (and the table loaded); the
                          // output tile's last stores are done
    const unsigned char* in = ibuf + (k & 1) * in_b;
    const int nr = (int)min((long long)rows, R - tile * rows);
    if (tm.g < tm.groups) {
      T* o = reinterpret_cast<T*>(obuf);
      for (int c = tm.t; c < n; c += tm.lanes) {
        const int s = tab[c];
        if (s != 0xFFFF) {
          const int f = s / m;
          const T* src = reinterpret_cast<const T*>(in + f * fb) + (s - f * m);
          for (int r = tm.g; r < nr; r += tm.groups)
            o[(size_t)r * n + c] = src[(size_t)r * m];
        } else {
          for (int r = tm.g; r < nr; r += tm.groups) o[(size_t)r * n + c] = T(0);
        }
      }
    }
    __syncthreads();      // output tile complete
    store(ob + tile * rows * out_row, obuf, (size_t)nr * out_row, unit);
  }
}

// One launch of the interleave copy over at most `blocks` blocks, through
// `tfields` rows of tables (1 for B2, `fields` for B7).  With `pdl` (B7)
// after the derive kernel that writes `table` on the same stream, allowed
// to start before that kernel ends; without (B2, the table uploaded from
// the host), stream-ordered after whatever wrote the inputs.
template <typename T>
static cudaError_t launch_interleave_copy(const Ptrs& ins, void* out,
                                          long long R, int m, int fields,
                                          const int* table, int tfields,
                                          int rows, int blocks, bool pdl,
                                          cudaStream_t stream) {
  const size_t e = sizeof(T);
  const long long n = (long long)fields * m;
  if (fields < 1 || fields > MAX_PARTS || m < 1 || n >= 0xFFFF || R < 1 ||
      rows < 1 || blocks < 1 || tfields < 1 || n % tfields)
    return cudaErrorInvalidValue;
  const void* ptrs[MAX_PARTS + 1];
  for (int f = 0; f < fields; ++f) ptrs[f] = ins.p[f];
  ptrs[fields] = out;
  const int unit = copy_unit((size_t)m * e, e, ptrs, fields + 1);
  const size_t smem = interleave_copy_smem((int)n, fields, rows, e);
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t err = set_smem(interleave_copy_kernel<T>, smem, granted);
  if (err != cudaSuccess) return err;
  const long long tiles = (R + rows - 1) / rows;
  return launch_chained(interleave_copy_kernel<T>,
                        (unsigned)(tiles < blocks ? tiles : blocks), smem, pdl,
                        stream, ins, static_cast<T*>(out), R, m, fields, table,
                        tfields, rows, unit);
}
