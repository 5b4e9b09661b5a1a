// Row segment-sum in a fixed order, for Hopper.
//
// No TPU kernel stands behind this one: the JAX package leaves the row sums of
// the csc layout to XLA's segment_sum, which repeats itself. On a GPU the
// library route (index_add_) adds with float atomics in an order that changes
// from run to run, so a solve did not repeat itself. This kernel adds each
// row's values in one fixed order and uses no atomics.
//
//     out[r] += sum over j in [ptr[r], ptr[r+1]) of vals[order[j]]
//
// ``order`` lists a tile's valid slots sorted by row (stable, so by slot index
// within a row) and ``ptr`` is the (m + 1,) row pointer into it; both are built
// once, on the host, when the tile is built.
//
// What bounds it on an H100: device memory, 8 B per valid slot (a 4 B index
// and a 4 B value). The values are gathered, so the card moves a 32 B sector
// for each 4 B value unless neighbouring slots of a row share one.
//
// Design: one warp per row. Lane t adds entries t, t + 32, ... of the row in
// that order, then the 32 partial sums are added in a fixed shuffle tree; lane
// 0 adds the result onto out[r]. A row belongs to one warp, so launches for
// successive tiles add into ``out`` in launch order. (Four gathers in flight
// per lane, with four partial sums, measured slower on an H100: 0.92 ms
// against 0.72 ms for 25M values.)
//
// C interface: launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS) segment_sum_kernel(
    const float* vals, const int* order, const long long* ptr, float* out, int m) {
  const int row = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (row >= m) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long j0 = ptr[row], j1 = ptr[row + 1];
  float s = 0.f;
  for (long long j = j0 + lane; j < j1; j += 32) s += vals[order[j]];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(FULL, s, off);
  if (lane == 0 && j1 > j0) out[row] += s;
}

}  // namespace

extern "C" int dualip_segment_sum(
    const float* vals, const int* order, const long long* ptr, float* out, int m, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)m * 32;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  segment_sum_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(vals, order, ptr, out, m);
  return (int)cudaGetLastError();
}
