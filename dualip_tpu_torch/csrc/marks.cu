// Device marks of one AGD iteration: a one-thread kernel that stores the
// card's global nanosecond timer (%globaltimer) into a table of `rows` rows of
// four points, at the row a device slot counter names; the point that ends an
// iteration advances the counter.  Captured in a CUDA graph it is one kernel
// node a point, and every replay stamps the row of its own iteration.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* table, long long* slot, int point, int rows, int advance) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long s = *slot;
  table[(s % rows) * 4 + point] = t;
  if (advance) *slot = s + 1;
}

}  // namespace

extern "C" int dualip_stamp(unsigned long long* table, long long* slot, int point, int rows, int advance,
                            void* stream) {
  if (rows < 1 || point < 0 || point > 3) return (int)cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(table, slot, point, rows, advance);
  return (int)cudaGetLastError();
}
