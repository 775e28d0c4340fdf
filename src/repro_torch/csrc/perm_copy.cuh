// Table-driven permuted copies of row tiles: `perm_copy_kernel`, the copy
// half of B6 (segment.cu) and B8 (strided.cu), and `staged_copy_kernel`,
// the whole of B3 and B4 (strided.cu), at the end of this file.
//
// For every row r of the (R, n) input, part p < parts and lane j < w:
//   out_p[r][j] = tab[p*w + j] < 0 ? 0 : x[r][tab[p*w + j]]
// `tab` is a network composed into one source lane per output lane
// (route_dyn.cuh's `dyn_sources`), written to device memory by the derive
// kernel launched just before this one.  Elements move as raw bits
// (templated on 1, 2, 4 or 8 bytes), so every dtype is bit-exact, -0.0 and
// NaN payloads included.
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
//   * the first tile's load is issued before the kernel waits on the
//     derive kernel (Programmatic Dependent Launch), so it overlaps the
//     derivation.
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
  // wait for the derive kernel before reading its table.
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

// Launch the copy after the derive kernel on the same stream, allowed to
// start before that kernel ends (it waits on it before reading `table`).
template <typename T>
static cudaError_t launch_perm_copy(const void* x, const Ptrs& outs,
                                    long long R, int n, int parts, int w,
                                    const int* table, int rows, int blocks,
                                    int unit, cudaStream_t stream) {
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles < blocks ? tiles : blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, perm_copy_kernel<T>, static_cast<const T*>(x),
                           outs, R, n, parts, w, table, rows, unit);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The staged copy: B3 and B4 (strided.cu)
// ---------------------------------------------------------------------------
//
// For access a < A (blockIdx.y), every row r of its (R, n) window and lane
// j < vl:
//   out_a[r][j] = staged_a[r][pos[a*vl + j]]
// where staged_a[r] is row r compacted to its listed units: units[a*kmax +
// k] (k < nunits[a]) of `sunit` bytes each, in order.  The host composes
// both from a gather plan's table (`ShiftPlan.source`, which is static), so
// there is no derive kernel and nothing to wait for: the wrapper uploads
// the list and the remapped table once per plan and copy unit.
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
__host__ __device__ inline size_t staged_copy_smem(int vl, int kmax, int rows,
                                                   int sunit, size_t elem) {
  return pad16((size_t)vl * 4) + pad16((size_t)kmax * 4) +
         2 * pad16((size_t)rows * kmax * sunit) + pad16((size_t)rows * vl * elem);
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
                   int sunit, int ounit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.y;
  const int K = nunits[a];
  const size_t in_row = (size_t)n * sizeof(T);
  const size_t out_row = (size_t)vl * sizeof(T);
  const size_t in_b = pad16((size_t)rows * kmax * sunit);
  int* tab = reinterpret_cast<int*>(smem);
  int* ulist = reinterpret_cast<int*>(smem + pad16((size_t)vl * 4));
  unsigned char* ibuf = smem + pad16((size_t)vl * 4) + pad16((size_t)kmax * 4);
  unsigned char* obuf = ibuf + 2 * in_b;
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
        for (int r = tm.g; r < nr; r += tm.groups)
          o[(size_t)r * vl + c] = in[(size_t)r * kel + s];
      }
    }
    __syncthreads();      // output tile complete
    store(oa + tile * rows * out_row, obuf, (size_t)nr * out_row, ounit);
  }
}

static inline bool bad_unit(int unit, size_t elem) {
  return unit < (int)elem || unit > 16 || (unit & (unit - 1));
}

// One launch of the staged copy over A accesses: a persistent grid of at
// most `blocks` blocks per access.
template <typename T>
static cudaError_t launch_staged_copy(const void* x, void* out, int A,
                                      long long R, int n, int vl,
                                      const int* pos, const int* units,
                                      const int* nunits, int kmax, int rows,
                                      int blocks, int sunit, int ounit,
                                      cudaStream_t stream) {
  const size_t e = sizeof(T);
  if (A < 1 || A > 65535 || n < 1 || vl < 1 || R < 1 || rows < 1 ||
      blocks < 1 || kmax < 1 || bad_unit(sunit, e) || bad_unit(ounit, e) ||
      (n * e) % sunit || (vl * e) % ounit || (size_t)kmax * sunit > n * e)
    return cudaErrorInvalidValue;
  const size_t smem = staged_copy_smem(vl, kmax, rows, sunit, e);
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t err = set_smem(staged_copy_kernel<T>, smem, granted);
  if (err != cudaSuccess) return err;
  const long long tiles = (R + rows - 1) / rows;
  const dim3 grid((unsigned)(tiles < blocks ? tiles : blocks), (unsigned)A);
  staged_copy_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), R, n, vl, pos, units,
      nunits, kmax, rows, sunit, ounit);
  return cudaGetLastError();
}
