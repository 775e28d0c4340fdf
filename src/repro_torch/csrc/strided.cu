// Strided (LSDO) kernels for Hopper (sm_90a): B3 gather, B4 fused gather
// and B5 scatter, routed through compiled shift plans, and B8 gather / B9
// scatter, the same functions routed through the dynamic-count networks.
//
// Replaces, in src/repro/kernels/strided.py:
//   B3 `_gather_plan_kernel`   (launched by `gather_strided`),
//   B4 `_gather_fused_kernel`  (launched by `gather_strided_fused`),
//   B5 `_scatter_plan_kernel`  (launched by `scatter_strided`),
//   B8 `_gather_dyn_kernel`    (`gather_strided(compiled=False)`, and once
//                               per access by `gather_strided_fused(
//                               compiled=False)`),
//   B9 `_scatter_dyn_kernel`   (`scatter_strided(compiled=False)`).
// Each computes what its Pallas body computes.  B3: a row tile of the
// coalesced n-lane window goes through `shiftplan.gather_plan(n, stride,
// offset, vl)` and lanes [0, vl) are the output, so out[r, i] =
// window[r, offset + i*stride].  B4: A stacked windows, each with its own
// (stride, offset) plan, in one launch; the plans' masks are concatenated
// into one operand.  B5: the vl values, zero-padded to n lanes, go through
// `shiftplan.scatter_plan`; the output keeps every window lane that the
// plan's occupancy does not mark (read-modify-write, out of place).  B8 and
// B9 compute the same two functions as the reference's dynamic bodies do:
// `scg.gather_counts` / `scg.scatter_counts` computed in the kernel from
// (n, stride, offset, vl), the GSN / SSN take-masks derived from them on
// the device (route_dyn.cuh), every layer run unpruned, and B9's merge
// under the network's final occupancy.
//
// Bound: pure data movement, no floating point.  The least time is the
// bytes that must move over 3.35 TB/s.  For a gather that is the sectors
// the strided reads touch plus the output: the whole window while
// stride * element size <= 32 bytes, one 32-byte sector per element past
// that.  For the scatter: window read, values read, output written.
//
// What this first design does: the layer loop is the one B1 and B2 run
// (route_plan.cuh).  Each block loads a row tile of its window into shared
// memory once (lane-major, so a warp reads neighbouring lanes), runs the
// plan's layers ping-ponging between two buffers, and writes only the vl
// output lanes (gather) or merges the routed tile with the window read
// straight from device memory (scatter).  Plans are exactly n lanes wide
// (no power-of-two padding); masks are packed to bits by the wrapper, and
// a B4 block loads only its own plan's mask rows.  A B8/B9 block derives
// its masks itself, once for its whole row tile.  Elements move as raw
// bits (templated on 1/2/4/8-byte widths), so every dtype is bit-exact.
//
// Known limit, not addressed here: the tile is the whole coalesced
// window, so past stride * element size = 32 bytes the gather reads
// sectors that hold no output element (at stride 64 in bf16, 4x the
// sectors the strided elements need).

#include <cuda_runtime.h>
#include <stdint.h>

#include "route_dyn.cuh"
#include "route_plan.cuh"

// One gather access: rows [r0, r0 + nr) of window `a` through plan `a`
// (layer records [plan_lo[a], plan_lo[a+1]), mask rows [mask_lo[a],
// mask_lo[a+1]) of the stacked operand, referenced relative to mask_lo[a]).
template <typename T>
__device__ void gather_tile(const T* __restrict__ x, T* __restrict__ out,
                            long long R, int n, int vl,
                            const uint32_t* __restrict__ masks, int words,
                            const int* __restrict__ layers,
                            const int* __restrict__ plan_lo,
                            const int* __restrict__ mask_lo, int mask_rows,
                            int rows, int a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* smask = reinterpret_cast<uint32_t*>(smem);
  const size_t mbytes = ((size_t)mask_rows * words * 4 + 15) & ~(size_t)15;
  T* ba = reinterpret_cast<T*>(smem + mbytes);
  T* bb = ba + (size_t)rows * n;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, R - r0);
  const TileMap tm(n);
  const bool live = tm.g < tm.groups;

  const int mlo = mask_lo[a];
  const int mwords = (mask_lo[a + 1] - mlo) * words;
  for (int i = threadIdx.x; i < mwords; i += blockDim.x)
    smask[i] = masks[(size_t)mlo * words + i];
  const T* xs = x + ((long long)a * R + r0) * n;
  if (live) {
    for (int c = tm.t; c < n; c += tm.lanes)
      for (int r = tm.g; r < nr; r += tm.groups)
        ba[(size_t)r * n + c] = xs[(size_t)r * n + c];
  }
  __syncthreads();
  const T* res = route_plan<T>(ba, ba, bb, nr, n, words, smask, layers,
                               plan_lo[a], plan_lo[a + 1], tm);
  T* os = out + ((long long)a * R + r0) * vl;
  if (live) {
    for (int c = tm.t; c < vl; c += tm.lanes)
      for (int r = tm.g; r < nr; r += tm.groups)
        os[(size_t)r * vl + c] = res[(size_t)r * n + c];
  }
}

// B3: one window, one plan.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_plan_kernel(const T* __restrict__ x, T* __restrict__ out, long long R,
                   int n, int vl, const uint32_t* __restrict__ masks,
                   int words, const int* __restrict__ layers,
                   const int* __restrict__ plan_lo,
                   const int* __restrict__ mask_lo, int mask_rows, int rows) {
  gather_tile<T>(x, out, R, n, vl, masks, words, layers, plan_lo, mask_lo,
                 mask_rows, rows, 0);
}

// B4: A stacked windows (A, R, n), access a = blockIdx.y with its own plan.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_fused_kernel(const T* __restrict__ x, T* __restrict__ out, long long R,
                    int n, int vl, const uint32_t* __restrict__ masks,
                    int words, const int* __restrict__ layers,
                    const int* __restrict__ plan_lo,
                    const int* __restrict__ mask_lo, int mask_rows, int rows) {
  gather_tile<T>(x, out, R, n, vl, masks, words, layers, plan_lo, mask_lo,
                 mask_rows, rows, blockIdx.y);
}

// B5: (R, vl) values merged into (R, n) windows -> (R, n) output.
template <typename T>
__global__ void __launch_bounds__(THREADS)
scatter_kernel(const T* __restrict__ vals, const T* __restrict__ win,
               T* __restrict__ out, long long R, int n, int vl,
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
  const bool live = tm.g < tm.groups;

  for (int i = threadIdx.x; i < S * words; i += blockDim.x) smask[i] = masks[i];
  for (int i = threadIdx.x; i < words; i += blockDim.x) svalid[i] = valid[i];
  const T* vs = vals + r0 * vl;
  if (live) {
    for (int c = tm.t; c < n; c += tm.lanes)
      for (int r = tm.g; r < nr; r += tm.groups)
        ba[(size_t)r * n + c] = c < vl ? vs[(size_t)r * vl + c] : T(0);
  }
  __syncthreads();
  const T* res = route_plan<T>(ba, ba, bb, nr, n, words, smask, layers, 0,
                               nlayers, tm);
  const T* ws = win + r0 * n;
  T* os = out + r0 * n;
  if (live) {
    for (int c = tm.t; c < n; c += tm.lanes) {
      if (lane_bit(svalid, c)) {
        for (int r = tm.g; r < nr; r += tm.groups)
          os[(size_t)r * n + c] = res[(size_t)r * n + c];
      } else {
        for (int r = tm.g; r < nr; r += tm.groups)
          os[(size_t)r * n + c] = ws[(size_t)r * n + c];
      }
    }
  }
}

template <typename T>
static cudaError_t launch_gather(const void* x, void* out, int A, long long R,
                                 int n, int vl, const void* masks, int words,
                                 const void* layers, const void* plan_lo,
                                 const void* mask_lo, int mask_rows, int rows,
                                 cudaStream_t stream) {
  const size_t mbytes = ((size_t)mask_rows * words * 4 + 15) & ~(size_t)15;
  const size_t smem = mbytes + 2 * (size_t)rows * n * sizeof(T);
  const long long tiles = (R + rows - 1) / rows;
  if (tiles > 0x7fffffffLL || A > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)A);
  cudaError_t e;
  if (A == 1) {
    static size_t granted[MAX_DEVICES] = {0};
    e = set_smem(gather_plan_kernel<T>, smem, granted);
    if (e != cudaSuccess) return e;
    gather_plan_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), R, n, vl,
        static_cast<const uint32_t*>(masks), words,
        static_cast<const int*>(layers), static_cast<const int*>(plan_lo),
        static_cast<const int*>(mask_lo), mask_rows, rows);
  } else {
    static size_t granted[MAX_DEVICES] = {0};
    e = set_smem(gather_fused_kernel<T>, smem, granted);
    if (e != cudaSuccess) return e;
    gather_fused_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), R, n, vl,
        static_cast<const uint32_t*>(masks), words,
        static_cast<const int*>(layers), static_cast<const int*>(plan_lo),
        static_cast<const int*>(mask_lo), mask_rows, rows);
  }
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_scatter(const void* vals, const void* win, void* out,
                                  long long R, int n, int vl, const void* masks,
                                  int S, int words, const void* layers,
                                  int nlayers, const void* valid, int rows,
                                  cudaStream_t stream) {
  const size_t mbytes = ((size_t)(S + 1) * words * 4 + 15) & ~(size_t)15;
  const size_t smem = mbytes + 2 * (size_t)rows * n * sizeof(T);
  const long long tiles = (R + rows - 1) / rows;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(scatter_kernel<T>, smem, granted);
  if (e != cudaSuccess) return e;
  scatter_kernel<T><<<(unsigned)tiles, THREADS, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const T*>(win),
      static_cast<T*>(out), R, n, vl, static_cast<const uint32_t*>(masks), S,
      words, static_cast<const int*>(layers), nlayers,
      static_cast<const uint32_t*>(valid), rows);
  return cudaGetLastError();
}

// B8: (R, n) windows -> (R, vl) through the GSN on gather counts.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_dyn_kernel(const T* __restrict__ x, T* __restrict__ out, long long R,
                  int n, int vl, int stride, int offset, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  DynNet net = dyn_carve(smem, n);
  T* ba = reinterpret_cast<T*>(smem + dyn_bytes(n));
  T* bb = ba + (size_t)rows * n;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, R - r0);
  const TileMap tm(n);
  const bool live = tm.g < tm.groups;

  const T* xs = x + r0 * n;
  if (live) {
    for (int c = tm.t; c < n; c += tm.lanes)
      for (int r = tm.g; r < nr; r += tm.groups)
        ba[(size_t)r * n + c] = xs[(size_t)r * n + c];
  }
  gather_counts(net, stride, offset, vl);
  dyn_derive(net, true);
  const T* res = route_dyn<T>(net, ba, ba, bb, nr, tm);
  T* os = out + r0 * vl;
  if (live) {
    for (int c = tm.t; c < vl; c += tm.lanes)
      for (int r = tm.g; r < nr; r += tm.groups)
        os[(size_t)r * vl + c] = res[(size_t)r * n + c];
  }
}

// B9: (R, vl) values merged into (R, n) windows through the SSN on scatter
// counts; lanes outside the final occupancy keep the window.
template <typename T>
__global__ void __launch_bounds__(THREADS)
scatter_dyn_kernel(const T* __restrict__ vals, const T* __restrict__ win,
                   T* __restrict__ out, long long R, int n, int vl,
                   int stride, int offset, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  DynNet net = dyn_carve(smem, n);
  T* ba = reinterpret_cast<T*>(smem + dyn_bytes(n));
  T* bb = ba + (size_t)rows * n;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, R - r0);
  const TileMap tm(n);
  const bool live = tm.g < tm.groups;

  const T* vs = vals + r0 * vl;
  if (live) {
    for (int c = tm.t; c < n; c += tm.lanes)
      for (int r = tm.g; r < nr; r += tm.groups)
        ba[(size_t)r * n + c] = c < vl ? vs[(size_t)r * vl + c] : T(0);
  }
  scatter_counts(net, stride, offset, vl);
  dyn_derive(net, false);
  const T* res = route_dyn<T>(net, ba, ba, bb, nr, tm);
  const T* ws = win + r0 * n;
  T* os = out + r0 * n;
  if (live) {
    for (int c = tm.t; c < n; c += tm.lanes) {
      if (lane_bit(net.occ, c)) {
        for (int r = tm.g; r < nr; r += tm.groups)
          os[(size_t)r * n + c] = res[(size_t)r * n + c];
      } else {
        for (int r = tm.g; r < nr; r += tm.groups)
          os[(size_t)r * n + c] = ws[(size_t)r * n + c];
      }
    }
  }
}

// The derivation alone, for checking and timing it: every block derives
// the network of (kind, n, stride, offset, vl); block 0 writes the packed
// take-masks (L x words) and the final occupancy (words) out.
__global__ void __launch_bounds__(THREADS)
dyn_masks_kernel(int gsn, int n, int stride, int offset, int vl,
                 uint32_t* __restrict__ masks, uint32_t* __restrict__ occ) {
  extern __shared__ __align__(16) unsigned char smem[];
  DynNet net = dyn_carve(smem, n);
  if (gsn) gather_counts(net, stride, offset, vl);
  else scatter_counts(net, stride, offset, vl);
  dyn_derive(net, gsn != 0);
  if (blockIdx.x != 0) return;
  for (int i = threadIdx.x; i < net.L * net.words; i += blockDim.x)
    masks[i] = net.masks[i];
  for (int i = threadIdx.x; i < net.words; i += blockDim.x) occ[i] = net.occ[i];
}

template <typename T>
static cudaError_t launch_gather_dyn(const void* x, void* out, long long R,
                                     int n, int vl, int stride, int offset,
                                     int rows, cudaStream_t stream) {
  const size_t smem = dyn_bytes(n) + 2 * (size_t)rows * n * sizeof(T);
  const long long tiles = (R + rows - 1) / rows;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(gather_dyn_kernel<T>, smem, granted);
  if (e != cudaSuccess) return e;
  gather_dyn_kernel<T><<<(unsigned)tiles, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), R, n, vl, stride,
      offset, rows);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_scatter_dyn(const void* vals, const void* win,
                                      void* out, long long R, int n, int vl,
                                      int stride, int offset, int rows,
                                      cudaStream_t stream) {
  const size_t smem = dyn_bytes(n) + 2 * (size_t)rows * n * sizeof(T);
  const long long tiles = (R + rows - 1) / rows;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(scatter_dyn_kernel<T>, smem, granted);
  if (e != cudaSuccess) return e;
  scatter_dyn_kernel<T><<<(unsigned)tiles, THREADS, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const T*>(win),
      static_cast<T*>(out), R, n, vl, stride, offset, rows);
  return cudaGetLastError();
}

extern "C" {

// Plain C entry points (bound with ctypes).  Each returns the cudaError_t
// of the launch; the Python wrapper raises when it is not 0.  A == 1 runs
// B3, A > 1 runs B4.
int strided_gather(int elem_bytes, const void* x, void* out, int A,
                   long long R, int n, int vl, const void* masks, int words,
                   const void* layers, const void* plan_lo,
                   const void* mask_lo, int mask_rows, int rows, void* stream) {
  if (A < 1 || rows < 1 || vl < 1 || vl > n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_gather<uint8_t>(x, out, A, R, n, vl, masks, words, layers, plan_lo, mask_lo, mask_rows, rows, s);
    case 2: return launch_gather<uint16_t>(x, out, A, R, n, vl, masks, words, layers, plan_lo, mask_lo, mask_rows, rows, s);
    case 4: return launch_gather<uint32_t>(x, out, A, R, n, vl, masks, words, layers, plan_lo, mask_lo, mask_rows, rows, s);
    case 8: return launch_gather<unsigned long long>(x, out, A, R, n, vl, masks, words, layers, plan_lo, mask_lo, mask_rows, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

int strided_scatter(int elem_bytes, const void* vals, const void* win,
                    void* out, long long R, int n, int vl, const void* masks,
                    int S, int words, const void* layers, int nlayers,
                    const void* valid, int rows, void* stream) {
  if (rows < 1 || vl < 1 || vl > n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_scatter<uint8_t>(vals, win, out, R, n, vl, masks, S, words, layers, nlayers, valid, rows, s);
    case 2: return launch_scatter<uint16_t>(vals, win, out, R, n, vl, masks, S, words, layers, nlayers, valid, rows, s);
    case 4: return launch_scatter<uint32_t>(vals, win, out, R, n, vl, masks, S, words, layers, nlayers, valid, rows, s);
    case 8: return launch_scatter<unsigned long long>(vals, win, out, R, n, vl, masks, S, words, layers, nlayers, valid, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

// B8 / B9: the dynamic-count strided networks (no plan operands).
int strided_gather_dyn(int elem_bytes, const void* x, void* out, long long R,
                       int n, int vl, int stride, int offset, int rows,
                       void* stream) {
  if (rows < 1 || vl < 1 || vl > n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_gather_dyn<uint8_t>(x, out, R, n, vl, stride, offset, rows, s);
    case 2: return launch_gather_dyn<uint16_t>(x, out, R, n, vl, stride, offset, rows, s);
    case 4: return launch_gather_dyn<uint32_t>(x, out, R, n, vl, stride, offset, rows, s);
    case 8: return launch_gather_dyn<unsigned long long>(x, out, R, n, vl, stride, offset, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

int strided_scatter_dyn(int elem_bytes, const void* vals, const void* win,
                        void* out, long long R, int n, int vl, int stride,
                        int offset, int rows, void* stream) {
  if (rows < 1 || vl < 1 || vl > n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_scatter_dyn<uint8_t>(vals, win, out, R, n, vl, stride, offset, rows, s);
    case 2: return launch_scatter_dyn<uint16_t>(vals, win, out, R, n, vl, stride, offset, rows, s);
    case 4: return launch_scatter_dyn<uint32_t>(vals, win, out, R, n, vl, stride, offset, rows, s);
    case 8: return launch_scatter_dyn<unsigned long long>(vals, win, out, R, n, vl, stride, offset, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

// The derivation alone over `blocks` blocks (`gsn` 1: gather counts and
// the GSN; 0: scatter counts and the SSN).
int route_dyn_masks(int gsn, int n, int stride, int offset, int vl,
                    void* masks, void* occ, int blocks, void* stream) {
  if (n < 1 || blocks < 1) return cudaErrorInvalidValue;
  const size_t smem = dyn_bytes(n);
  static size_t granted[MAX_DEVICES] = {0};
  cudaError_t e = set_smem(dyn_masks_kernel, smem, granted);
  if (e != cudaSuccess) return e;
  dyn_masks_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      gsn, n, stride, offset, vl, static_cast<uint32_t*>(masks),
      static_cast<uint32_t*>(occ));
  return cudaGetLastError();
}

const char* strided_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
