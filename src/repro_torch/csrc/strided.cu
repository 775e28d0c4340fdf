// Strided (LSDO) kernels for Hopper (sm_90a): B3 gather, B4 fused gather
// and B5 scatter, on compiled shift plans, and B8 gather / B9 scatter, the
// same functions routed through the dynamic-count networks.
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
// (stride, offset) plan, in one launch.  B5: the vl values, zero-padded to
// n lanes, go through `shiftplan.scatter_plan`; the output keeps every
// window lane that the plan's occupancy does not mark (read-modify-write,
// out of place).  B8 and B9 compute the same two functions as the
// reference's dynamic bodies do: `scg.gather_counts` / `scg.scatter_counts`
// computed on the device from (n, stride, offset, vl), the GSN / SSN
// take-masks derived from them (route_dyn.cuh), every layer unpruned, and
// B9's merge under the network's final occupancy.
//
// Bound: pure data movement, no floating point.  The least time is the
// bytes that must move over 3.35 TB/s.  For a gather that is the sectors
// the strided reads touch plus the output: the whole window while
// stride * element size <= 32 bytes, one 32-byte sector per element past
// that.  For the scatter: window read, values read, output written.
//
// B3 and B4, one kernel per call: a gather plan is static, and its composed
// table (`ShiftPlan.source`: lane j of the output takes input lane
// offset + j*stride) is known on the host.  So no layer runs on the card:
// `staged_copy_kernel` (perm_copy.cuh) moves the rows through the table.
// The wrapper uploads, once per plan and copy unit, each access's
// staged-unit list (the units of a row that hold an output lane) and the
// table remapped into the row compacted to those units.  A persistent grid
// stages row tiles with cp.async, double-buffered: the whole row as one
// contiguous chunk while the units that hold an output lane touch every
// 32-byte sector (stride * element size <= 32 bytes, the main path among
// them), else only the listed units (sector-only loads: at stride 64 in
// bf16, one 16-byte unit in eight), so wide strides read only the sectors
// they need and fit more rows a tile.  The permute reads
// through the remapped table into a (rows, vl) output tile, consecutive
// threads on consecutive output lanes, which leaves in 16-byte vector
// stores: two barriers a tile.  A B4 block works on one access, holding
// only that access's table and list.
//
// B5, one kernel per call: a scatter plan is static too, and its table
// (`ShiftPlan.source` under `.valid`: window lane offset + i*stride takes
// values lane i) gives, on the host, the list that B9's derive kernel
// compacts on the card: the occupied lanes in lane order beside the values
// lane each takes.  The wrapper uploads it once per plan, and
// `merge_copy_kernel` (perm_copy.cuh), B9's copy, runs alone, launched
// without Programmatic Dependent Launch (no derive kernel before it; the
// kernel before it wrote the window or the values): a persistent grid
// stages each tile of window rows and its value rows with 16-byte cp.async
// copies, double-buffered, writes the listed lanes in place in shared
// memory (threads walk the vl pairs, not the n lanes) and sends the whole
// tile out in 16-byte vector stores, two barriers a tile.
//
// B8, two kernels per call: the network depends only on (n, stride,
// offset, vl), so it is derived once per launch.  `dyn_sources_kernel`
// (route_dyn.cuh, one block) derives it and composes it into the source
// lane of each of the vl output lanes, in a small device workspace;
// `perm_copy_kernel` (perm_copy.cuh) then stages each tile of whole n-lane
// window rows with 16-byte cp.async copies, double-buffered, permutes the
// vl output lanes in shared memory and writes them with 16-byte vector
// stores: two barriers a tile, none per layer.  The tile height comes from
// the copy's own shared-memory budget (a few rows at n = 4096), and the
// copy starts under Programmatic Dependent Launch, so its first tile load
// overlaps the derivation.
//
// B9, two kernels per call, the same way: `dyn_sources_kernel` (one block)
// derives the SSN once per launch, composes it into the source of each of
// the n window lanes and compacts the occupied ones into a list of (lane,
// values lane) pairs, vl of them for an access that fits; then B5's
// `merge_copy_kernel` moves the rows through that list.  It starts under
// Programmatic Dependent Launch: its first tile's loads overlap the
// derivation, only the list read waits.
//
// Elements move as raw bits (templated on 1/2/4/8-byte widths), so every
// dtype is bit-exact.
//
// Known limit, not addressed here: B8 still stages the whole window, so
// past stride * element size = 32 bytes it reads sectors that hold no
// output element (at stride 64 in bf16, 4x the sectors the strided
// elements need); B3 and B4 read only the units they need.

#include <cuda_runtime.h>
#include <stdint.h>

#include "perm_copy.cuh"
#include "route_dyn.cuh"
#include "route_plan.cuh"

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

extern "C" {

// Plain C entry points (bound with ctypes).  Each returns the cudaError_t
// of the launch; the Python wrapper raises when it is not 0.

// B3 (A == 1) and B4 (A > 1): one staged copy of the A stacked (R, n)
// windows into (A, R, vl), through each access's remapped table `pos` (A,
// vl) and staged-unit list `units` (A, kmax; nunits[a] of them used), in
// `rows`-row tiles over at most `blocks` blocks per access, staged in
// `sunit`-byte and stored in `ounit`-byte units.
int strided_gather(int elem_bytes, const void* x, void* out, int A,
                   long long R, int n, int vl, const void* pos,
                   const void* units, const void* nunits, int kmax, int rows,
                   int blocks, int sunit, int ounit, void* stream) {
  if (vl > n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* u = static_cast<const int*>(units);
  const int* k = static_cast<const int*>(nunits);
  switch (elem_bytes) {
    case 1: return launch_staged_copy<uint8_t>(x, out, A, R, n, vl, p, u, k, kmax, rows, blocks, sunit, ounit, s);
    case 2: return launch_staged_copy<uint16_t>(x, out, A, R, n, vl, p, u, k, kmax, rows, blocks, sunit, ounit, s);
    case 4: return launch_staged_copy<uint32_t>(x, out, A, R, n, vl, p, u, k, kmax, rows, blocks, sunit, ounit, s);
    case 8: return launch_staged_copy<unsigned long long>(x, out, A, R, n, vl, p, u, k, kmax, rows, blocks, sunit, ounit, s);
    default: return cudaErrorInvalidValue;
  }
}

// B5: one merge copy of the R window and value rows through `list` ({K,
// lane, values lane, ...}, K pairs, the host plan's occupied lanes,
// uploaded by the wrapper), in `rows`-row tiles over at most `blocks`
// blocks, the window staged and stored in `wunit`-byte units, the values in
// `vunit`; stream-ordered (no PDL).
int strided_scatter(int elem_bytes, const void* vals, const void* win,
                    void* out, long long R, int n, int vl, const void* list,
                    int K, int rows, int blocks, int wunit, int vunit,
                    void* stream) {
  if (vl < 1 || vl > n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(list);
  switch (elem_bytes) {
    case 1: return launch_merge_copy<uint8_t>(win, vals, out, R, n, vl, l, K, rows, blocks, wunit, vunit, false, s);
    case 2: return launch_merge_copy<uint16_t>(win, vals, out, R, n, vl, l, K, rows, blocks, wunit, vunit, false, s);
    case 4: return launch_merge_copy<uint32_t>(win, vals, out, R, n, vl, l, K, rows, blocks, wunit, vunit, false, s);
    case 8: return launch_merge_copy<unsigned long long>(win, vals, out, R, n, vl, l, K, rows, blocks, wunit, vunit, false, s);
    default: return cudaErrorInvalidValue;
  }
}

// B8: the dynamic-count strided gather, two kernels on `stream`: the
// derivation of the vl-entry source table into `table` (the caller's int32
// workspace), then the permuted copy of the R window rows in `rows`-row
// tiles over at most `blocks` blocks, staged and stored in `unit`-byte
// units.
int strided_gather_dyn(int elem_bytes, const void* x, void* out, long long R,
                       int n, int vl, int stride, int offset, void* table,
                       int rows, int blocks, int unit, void* stream) {
  if (vl < 1 || vl > n) return cudaErrorInvalidValue;
  Ptrs p;
  for (int i = 0; i < MAX_PARTS; ++i) p.p[i] = i == 0 ? out : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* tab = static_cast<int*>(table);
  cudaError_t e = launch_dyn_sources(1, n, stride, offset, vl, vl, 1, tab, s);
  if (e != cudaSuccess) return e;
  switch (elem_bytes) {
    case 1: return launch_perm_copy<uint8_t>(x, p, R, n, 1, vl, tab, rows, blocks, unit, true, s);
    case 2: return launch_perm_copy<uint16_t>(x, p, R, n, 1, vl, tab, rows, blocks, unit, true, s);
    case 4: return launch_perm_copy<uint32_t>(x, p, R, n, 1, vl, tab, rows, blocks, unit, true, s);
    case 8: return launch_perm_copy<unsigned long long>(x, p, R, n, 1, vl, tab, rows, blocks, unit, true, s);
    default: return cudaErrorInvalidValue;
  }
}

// B9: the dynamic-count strided scatter, two kernels on `stream`: the
// derivation of the SSN's n-entry source table and its list of occupied
// lanes into `work` (the caller's int32 workspace of n + 1 + 2*vl: the
// table, then {K, lane, source, ...}), then the merge copy of the R window
// and value rows in `rows`-row tiles over at most `blocks` blocks, the
// window staged and stored in `wunit`-byte units, the values in `vunit`.
int strided_scatter_dyn(int elem_bytes, const void* vals, const void* win,
                        void* out, long long R, int n, int vl, int stride,
                        int offset, void* work, int rows, int blocks,
                        int wunit, int vunit, void* stream) {
  if (vl < 1 || vl > n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* tab = static_cast<int*>(work);
  int* list = tab + n;
  cudaError_t e = launch_dyn_sources(0, n, stride, offset, vl, n, 1, tab, s,
                                     list);
  if (e != cudaSuccess) return e;
  switch (elem_bytes) {
    case 1: return launch_merge_copy<uint8_t>(win, vals, out, R, n, vl, list, vl, rows, blocks, wunit, vunit, true, s);
    case 2: return launch_merge_copy<uint16_t>(win, vals, out, R, n, vl, list, vl, rows, blocks, wunit, vunit, true, s);
    case 4: return launch_merge_copy<uint32_t>(win, vals, out, R, n, vl, list, vl, rows, blocks, wunit, vunit, true, s);
    case 8: return launch_merge_copy<unsigned long long>(win, vals, out, R, n, vl, list, vl, rows, blocks, wunit, vunit, true, s);
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

// One derivation alone into `table` (`gsn` 1: gather counts and the GSN,
// vl entries, B8's table; 0: scatter counts and the SSN, n entries, B9's,
// and with `list` not null B9's list of at most vl pairs, 1 + 2*vl ints).
int route_dyn_sources(int gsn, int n, int stride, int offset, int vl,
                      void* table, void* list, void* stream) {
  if (gsn && list) return cudaErrorInvalidValue;
  return launch_dyn_sources(gsn, n, stride, offset, vl, gsn ? vl : n, 1,
                            static_cast<int*>(table),
                            static_cast<cudaStream_t>(stream),
                            static_cast<int*>(list));
}

const char* strided_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
