// Fused panel projection kernel (K3) and its x-emitting twin (K4) for Hopper.
//
// Replaces dualip_tpu/ops/pallas_matching.py::_panel_kernel (K3) and
// ::_panel_kernel_x (K4), with their bodies _panel_body and _store_ax. One
// tile's region of the (N,) carry buffer is rows [off/(128*L2), +KP) of the
// view buf.reshape(-1, L2, 128). A buffer row holds q stacked segments of L
// lanes (q = 1 on plain panels, q > 1 on the compact packing); lane l of
// segment s, column c of row kp sits at
//
//     buf[off + kp*L2*128 + (s*L + l)*128 + c]        (fp32 or bf16)
//     a, c[(kp*q*L + s*L + l)*128 + c]                (fp32)
//     length[(kp*q + s)*128 + c]                      (int32)
//
// In place on that region, for every column:
//
//     z[l]  = a[l] * srow[l] + neg_inv_gamma * c[l]          srow read from buf
//     x     = Proj(z) over the L lanes, x[l] = 0 for l >= length
//     buf   <- a*x (rounded once to the carry type); ghost lanes [q*L, L2) <- 0
//     obj  += c*x;  reg += x*x                          (+ x with WANT_X)
//
// Nothing outside the region is written.
//
// What bounds it on an H100: device memory, as K1: srow, a, c in and a*x out,
// 16 B per real slot with an fp32 carry (12 B with bf16, +4 B for x), against
// about 100 fp32 operations per slot, about 6 per byte, below the card's fp32
// ridge of 20.
//
// Design:
//  * One thread per column, one block of 128 threads per (row, segment): the
//    column index is the fastest thread index, so every lane-row load of a
//    block is one 512 B (256 B in bf16) contiguous run. The column stays in
//    registers for the 30 bisection steps (template on a power-of-two cap of
//    L up to 64, project_block.cuh); wider columns re-read their lanes from
//    L1/L2 on every pass (project_column_stream).
//  * Each slot of the region is read and written by one thread only, and a
//    thread has read a lane for the last time before it writes it, so the
//    update is in place with no barrier and no second buffer.
//  * The block of segment 0 also zeroes the row's ghost lanes.
//  * Per-block (obj, reg) partials and a one-block second kernel that adds them
//    in a fixed order, as K1: two runs give the same bits.
//
// C interface: dualip_panel_project(...) launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_bf16.h>

#include "project_block.cuh"

namespace {

using namespace dualip;

constexpr int C = 128;         // columns per panel row = threads per block
constexpr int REG_L_CAP = 64;  // largest L kept in registers

template <typename T>
struct Args {
  T* buf;  // the whole carry buffer
  const float* a;
  const float* c;
  const int* length;
  const float* neg_inv_gamma;
  float* x;
  float* partials;
  long long off;  // region start, in slots
  int L, L2, q;
  Proj proj;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The addresses of one block's column: lane l is at b[l*C] and ac[l*C].
template <typename T>
struct Column {
  T* b;
  const float* a;
  const float* c;
  float* x;
  int len;
  float nig;

  __device__ __forceinline__ Column(const Args<T>& p) {
    const long long row = blockIdx.x / p.q;
    const int seg = blockIdx.x - row * p.q;
    const long long ac = (long long)blockIdx.x * p.L * C + threadIdx.x;
    b = p.buf + p.off + (row * p.L2 + (long long)seg * p.L) * C + threadIdx.x;
    a = p.a + ac;
    c = p.c + ac;
    x = p.x ? p.x + ac : nullptr;
    len = p.length[(long long)blockIdx.x * C + threadIdx.x];
    nig = *p.neg_inv_gamma;
    if (seg == 0) {  // ghost lanes of this row
      T* g = p.buf + p.off + row * p.L2 * C + threadIdx.x;
      for (int l = p.q * p.L; l < p.L2; ++l) store(g + (long long)l * C, 0.f);
    }
  }

  // a*srow + nig*c, rounded as two products and a sum (no contraction)
  __device__ __forceinline__ float z(int l) const {
    return __fadd_rn(__fmul_rn(a[l * C], load(b + l * C)), __fmul_rn(nig, c[l * C]));
  }

  template <bool WANT_X>
  __device__ __forceinline__ void emit(int l, float w, float& cx, float& xx) const {
    const float xv = (l < len) ? w : 0.f;
    const float cv = c[l * C];
    store(b + l * C, __fmul_rn(a[l * C], xv));
    if (WANT_X) x[l * C] = xv;
    cx += cv * xv;
    xx += xv * xv;
  }
};

__device__ __forceinline__ void write_partials(float* partials, float cx, float xx) {
  block_sum2(cx, xx);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = cx;
    partials[2 * blockIdx.x + 1] = xx;
  }
}

// identity / box / cone: elementwise clamps, any L.
template <typename T, bool WANT_X>
__global__ void __launch_bounds__(C) panel_clamp_kernel(Args<T> p) {
  const Column<T> col(p);
  float cx = 0.f, xx = 0.f;
  for (int l = 0; l < p.L; ++l) {
    float w = col.z(l);
    if (p.proj.has_lo) w = fmaxf(w, p.proj.lo);
    if (p.proj.has_hi) w = fminf(w, p.proj.hi);
    col.template emit<WANT_X>(l, w, cx, xx);
  }
  write_partials(p.partials, cx, xx);
}

// simplex / simplex_eq / box_cut / box_cut_eq with the column in registers.
template <typename T, int KIND, int LCAP, bool WANT_X>
__global__ void __launch_bounds__(C) panel_column_kernel(Args<T> p) {
  const Column<T> col(p);
  float cx = 0.f, xx = 0.f;
  project_column<KIND, LCAP>(
      p.L, p.proj, [&](int l) { return col.z(l); },
      [&](int l, float w) { col.template emit<WANT_X>(l, w, cx, xx); });
  write_partials(p.partials, cx, xx);
}

// The same kinds above L = 64: nothing kept, every pass re-reads the lanes.
template <typename T, int KIND, bool WANT_X>
__global__ void __launch_bounds__(C) panel_stream_kernel(Args<T> p) {
  const Column<T> col(p);
  float cx = 0.f, xx = 0.f;
  project_column_stream<KIND>(
      p.L, p.proj, [&](int l) { return col.z(l); },
      [&](int l, float w) { col.template emit<WANT_X>(l, w, cx, xx); });
  write_partials(p.partials, cx, xx);
}

template <typename T, int KIND, bool WANT_X>
void launch_projection(const Args<T>& p, int nb, cudaStream_t s) {
  const int L = p.L;
  if (L > REG_L_CAP) {
    panel_stream_kernel<T, KIND, WANT_X><<<nb, C, 0, s>>>(p);
  } else if (L <= 1) {
    panel_column_kernel<T, KIND, 1, WANT_X><<<nb, C, 0, s>>>(p);
  } else if (L <= 2) {
    panel_column_kernel<T, KIND, 2, WANT_X><<<nb, C, 0, s>>>(p);
  } else if (L <= 4) {
    panel_column_kernel<T, KIND, 4, WANT_X><<<nb, C, 0, s>>>(p);
  } else if (L <= 8) {
    panel_column_kernel<T, KIND, 8, WANT_X><<<nb, C, 0, s>>>(p);
  } else if (L <= 16) {
    panel_column_kernel<T, KIND, 16, WANT_X><<<nb, C, 0, s>>>(p);
  } else if (L <= 32) {
    panel_column_kernel<T, KIND, 32, WANT_X><<<nb, C, 0, s>>>(p);
  } else {
    panel_column_kernel<T, KIND, 64, WANT_X><<<nb, C, 0, s>>>(p);
  }
}

template <typename T, bool WANT_X>
void launch(int kind, const Args<T>& p, int nb, cudaStream_t s) {
  if (kind == CLAMP) {
    panel_clamp_kernel<T, WANT_X><<<nb, C, 0, s>>>(p);
  } else if (kind == SIMPLEX) {
    launch_projection<T, SIMPLEX, WANT_X>(p, nb, s);
  } else {
    launch_projection<T, BOXCUT, WANT_X>(p, nb, s);
  }
}

template <typename T>
int run(void* buf, const float* a, const float* c, const int* length, const float* neg_inv_gamma,
        float* x, float* partials, float* out, long long off, int KP, int L, int L2, int q,
        int kind, const Proj& proj, cudaStream_t s) {
  Args<T> p{static_cast<T*>(buf), a, c, length, neg_inv_gamma, x, partials, off, L, L2, q, proj};
  const int nb = KP * q;
  if (x != nullptr) launch<T, true>(kind, p, nb, s);
  else launch<T, false>(kind, p, nb, s);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials<<<1, REDUCE_THREADS, 0, s>>>(partials, nb, out);
  return (int)cudaGetLastError();
}

}  // namespace

// carry_bytes: 4 (float32 buffer) or 2 (bfloat16 buffer). x == nullptr: K3; else K4.
extern "C" int dualip_panel_project(
    void* buf, const float* a, const float* c, const int* length, const float* neg_inv_gamma,
    float* x, float* partials, float* out, long long off, long long n_buf, int carry_bytes,
    int KP, int L, int L2, int q, int kind, int inequality,
    float lo, float hi, int has_lo, int has_hi, float radius, void* stream) {
  if (KP < 1 || L < 1 || q < 1 || (long long)q * L > L2 || kind < CLAMP || kind > BOXCUT) {
    return (int)cudaErrorInvalidValue;
  }
  if (off < 0 || off + (long long)KP * L2 * C > n_buf) return (int)cudaErrorInvalidValue;
  const Proj proj{inequality, lo, hi, has_lo, has_hi, radius};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (carry_bytes == 4) {
    return run<float>(buf, a, c, length, neg_inv_gamma, x, partials, out, off, KP, L, L2, q, kind, proj, s);
  }
  if (carry_bytes == 2) {
    return run<__nv_bfloat16>(buf, a, c, length, neg_inv_gamma, x, partials, out, off, KP, L, L2, q, kind, proj, s);
  }
  return (int)cudaErrorInvalidValue;
}
