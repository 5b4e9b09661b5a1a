// Row segment-sum in a fixed order, over L2-sized column windows, for Hopper.
//
// No TPU kernel stands behind this one: the JAX package leaves the row sums of
// the csc layout to XLA's segment_sum, which repeats itself. On a GPU the
// library route (index_add_) adds with float atomics in an order that changes
// from run to run, so a solve did not repeat itself. This kernel adds each
// row's values in one fixed order and uses no atomics.
//
//     out[r] += sum over the valid slots j whose row is r of vals[j]
//
// ``vals`` is every tile's a*x laid end to end. The plan (sparse/bcsc.py,
// RowSumPlan, built once on the host) cuts the tiles' columns into windows of
// 8 MiB of a*x, lists each window's valid slots sorted by row (``order``),
// cuts each row's run in a window into segments of at most 512 slots
// (``seg_ptr``), and groups consecutive segments into work items of about 128
// slots (``item_ptr``).
//
// What bounds it on an H100: device memory, 8 B per valid slot (a 4 B index
// and a 4 B value, each read once). The values are gathered in row order, so
// each 4 B value costs a 32 B sector. Over the whole a*x (136 MB on the
// 2.5M-source slice, against a 50 MB L2) those sectors came from device
// memory, one per gather; the window keeps the gathers of the warps in flight
// within 8 MB, so a sector comes from device memory once and its other values
// hit L2. What is left is L2's rate for random 32 B sectors.
//
// Design: two launches, no atomics.
//  1. window_sums: one warp per work item, items in window order (blockIdx
//     follows the windows, so about one window is live in L2 at a time). For
//     each segment of its item, lane t adds entries t, t + 32, ... in that
//     order, the 32 partial sums are added in a fixed shuffle tree, and lane 0
//     writes the segment's sum to partial[s]. Items of balanced size end the
//     tail of a launch per tile and the nearly empty warps of small tiles.
//  2. add_rows: one thread per row adds its segments' sums in window order
//     and adds the result onto out[r].
// (One warp per row over a whole tile, one launch per tile, took 0.72 ms for
// 25M values on an H100; four gathers in flight per lane made it slower,
// 0.92 ms.)
//
// C interface: launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS) window_sums(
    const float* __restrict__ vals, const int* __restrict__ order, const int* __restrict__ seg_ptr,
    const int* __restrict__ item_ptr, float* __restrict__ partial, int n_items) {
  const int item = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= n_items) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int s1 = item_ptr[item + 1];
  for (int s = item_ptr[item]; s < s1; ++s) {
    const int j1 = seg_ptr[s + 1];
    float acc = 0.f;
    for (int j = seg_ptr[s] + lane; j < j1; j += 32) acc += __ldg(vals + __ldg(order + j));
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(FULL, acc, off);
    if (lane == 0) partial[s] = acc;
  }
}

__global__ void __launch_bounds__(ROW_THREADS) add_rows(
    const float* __restrict__ partial, const int* __restrict__ row_ptr, const int* __restrict__ row_segs,
    float* __restrict__ out, int m) {
  const int r = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (r >= m) return;
  const int q0 = row_ptr[r], q1 = row_ptr[r + 1];
  if (q0 == q1) return;
  float acc = 0.f;
  for (int q = q0; q < q1; ++q) acc += partial[row_segs[q]];
  out[r] += acc;
}

}  // namespace

extern "C" int dualip_segment_sum(
    const float* vals, const int* order, const int* seg_ptr, const int* item_ptr, const int* row_ptr,
    const int* row_segs, float* partial, float* out, int n_items, int m, void* stream) {
  if (m < 1 || n_items < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  window_sums<<<(n_items + WARPS - 1) / WARPS, THREADS, 0, s>>>(vals, order, seg_ptr, item_ptr, partial, n_items);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  add_rows<<<(m + ROW_THREADS - 1) / ROW_THREADS, ROW_THREADS, 0, s>>>(partial, row_ptr, row_segs, out, m);
  return (int)cudaGetLastError();
}
