// Fused matching tile kernel (K1) and its x-emitting twin (K2) for Hopper.
//
// Replaces dualip_tpu/ops/pallas_matching.py::_fused_kernel (K1) and
// ::_fused_kernel_x (K2), with their device function _project_block. Per
// (L, K)-transposed tile, for every entity column k:
//
//     z[l]  = a[l,k] * lam_g[l,k] + neg_inv_gamma * c[l,k]        l < L
//     x[:,k] = Proj(z[:,k]) over the L lanes, then x[l,k] = 0 for l >= length[k]
//     ax[l,k] = a[l,k] * x[l,k];  obj += c*x;  reg += x*x       (+ x with WANT_X)
//
// What bounds it on an H100: device memory. It reads lam_g, a, c (12 B per
// slot) and writes a*x (4 B; 8 B with x), about 16 B per slot (20 B for K2),
// against about 100 fp32 operations per slot for the 30 bisection steps:
// about 6 per byte, below the card's fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20.
//
// Design:
//  * One thread per column (L <= 64). The (L, K) layout puts neighbouring
//    columns at neighbouring addresses, so each lane-row load of a warp is
//    coalesced. The column's values stay in registers (template on a
//    power-of-two cap of L) for all 30 bisection steps; the tile is read once
//    from device memory, and pass 2 re-reads a and c (and lam_g on the rare
//    pass-through branch) from L1/L2 to form a*x and the sums.
//  * One block per column above L = 64, with the column in shared memory and
//    block-wide reductions per bisection step (rare: wide buckets only).
//  * No sequential grid: each block writes its partial (obj, reg) to a
//    (num_blocks, 2) scratch and a second one-block kernel sums them in a fixed
//    order, so two runs give the same bits (no float atomics).
//  * The projection itself is the device function of project_block.cuh, which
//    the panel kernel (panel_matching.cu) shares.
//  * Exact numerics of _project_block: 30 bisection steps on [-1, 0] of the
//    max-shifted, radius-normalised, pre-clamped values with the "s > 1" test;
//    the top-2 vertex shortcut with argmax taking the FIRST maximum; the
//    inequality pass-through against radius + 1e-6; box_cut bracketed by
//    [min(z) - u, max(z) - l]. Padding lanes (a = c = 0) take part as z = 0,
//    as on the TPU, and are masked afterwards; padding columns (length 0)
//    contribute zero.
//
// C interface: dualip_fused_tile_eval(...) launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not synchronise.

#include "project_block.cuh"

namespace {

using namespace dualip;

constexpr int THREADS = 128;       // columns per block, per-column kernels
constexpr int REG_L_CAP = 64;      // largest L kept in registers
constexpr int WIDE_THREADS = 256;  // threads per column, wide kernel

struct Args {
  const float* lam_g;
  const float* a;
  const float* c;
  const int* length;
  const float* neg_inv_gamma;
  float* ax;
  float* x;
  float* partials;
  int L;
  long long K;
  int inequality;
  float lo, hi;  // clamp bounds (CLAMP) or box bounds (BOXCUT)
  int has_lo, has_hi;
  float radius;  // simplex radius or box-cut sum bound
};

__device__ __forceinline__ float zval(const Args& p, size_t idx, float nig) {
  // a*lam_g + nig*c, rounded as two products and a sum (no contraction)
  return __fadd_rn(__fmul_rn(p.a[idx], p.lam_g[idx]), __fmul_rn(nig, p.c[idx]));
}

// Block-wide reductions that every thread receives (wide kernel).
enum Op { OP_SUM, OP_MAX, OP_MIN };

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == OP_SUM) return a + b;
  if (OP == OP_MAX) return fmaxf(a, b);
  return fminf(a, b);
}

template <int OP>
__device__ float block_all(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v = combine<OP>(v, __shfl_down_sync(FULL, v, off));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = scratch[0];
    for (int w = 1; w < nwarps; ++w) r = combine<OP>(r, scratch[w]);
    scratch[32] = r;
  }
  __syncthreads();
  const float r = scratch[32];
  __syncthreads();
  return r;
}

// (max, first argmax) over the block; every thread receives both.
__device__ void block_argmax(float& v, int& i, float* scratch, int* iscratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(FULL, v, off);
    const int i2 = __shfl_down_sync(FULL, i, off);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
  if (lane == 0) {
    scratch[warp] = v;
    iscratch[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < nwarps; ++w) {
      if (scratch[w] > scratch[0] || (scratch[w] == scratch[0] && iscratch[w] < iscratch[0])) {
        scratch[0] = scratch[w];
        iscratch[0] = iscratch[w];
      }
    }
  }
  __syncthreads();
  v = scratch[0];
  i = iscratch[0];
  __syncthreads();
}

// Writes one column's x (masked), a*x and the sums, in pass 2.
template <bool WANT_X>
__device__ __forceinline__ void emit(const Args& p, size_t idx, int l, int len, float w, float& cx, float& xx) {
  const float x = (l < len) ? w : 0.f;
  const float av = p.a[idx];
  const float cv = p.c[idx];
  p.ax[idx] = __fmul_rn(av, x);
  if (WANT_X) p.x[idx] = x;
  cx += cv * x;
  xx += x * x;
}

// identity / box / cone: elementwise clamps, any L.
template <bool WANT_X>
__global__ void __launch_bounds__(THREADS) clamp_kernel(Args p) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float cx = 0.f, xx = 0.f;
  if (k < p.K) {
    const float nig = *p.neg_inv_gamma;
    const int len = p.length[k];
    for (int l = 0; l < p.L; ++l) {
      const size_t idx = (size_t)l * p.K + k;
      float w = zval(p, idx, nig);
      if (p.has_lo) w = fmaxf(w, p.lo);
      if (p.has_hi) w = fminf(w, p.hi);
      emit<WANT_X>(p, idx, l, len, w, cx, xx);
    }
  }
  block_sum2(cx, xx);
  if (threadIdx.x == 0) {
    p.partials[2 * blockIdx.x] = cx;
    p.partials[2 * blockIdx.x + 1] = xx;
  }
}

// simplex / simplex_eq / box_cut / box_cut_eq, one thread per column, L <= LCAP.
template <int KIND, int LCAP, bool WANT_X>
__global__ void __launch_bounds__(THREADS) column_kernel(Args p) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float cx = 0.f, xx = 0.f;
  if (k < p.K) {
    const float nig = *p.neg_inv_gamma;
    const int len = p.length[k];
    const Proj proj{p.inequality, p.lo, p.hi, p.has_lo, p.has_hi, p.radius};
    project_column<KIND, LCAP>(
        p.L, proj,
        [&](int l) { return zval(p, (size_t)l * p.K + k, nig); },
        [&](int l, float w) { emit<WANT_X>(p, (size_t)l * p.K + k, l, len, w, cx, xx); });
  }
  block_sum2(cx, xx);
  if (threadIdx.x == 0) {
    p.partials[2 * blockIdx.x] = cx;
    p.partials[2 * blockIdx.x + 1] = xx;
  }
}

// The same kinds above L = 64: block blockIdx.x owns column k; thread t owns
// lanes t, t + blockDim, ..., kept in dynamic shared memory.
template <int KIND, bool WANT_X>
__global__ void __launch_bounds__(WIDE_THREADS) wide_kernel(Args p) {
  extern __shared__ float r[];
  __shared__ float scratch[33];
  __shared__ int iscratch[32];
  const long long k = blockIdx.x;
  const int L = p.L, t = threadIdx.x, nt = blockDim.x;
  const float nig = *p.neg_inv_gamma;
  const int len = p.length[k];
  float cx = 0.f, xx = 0.f;
  if (KIND == SIMPLEX) {
    const float radius = p.radius;
    float vmax = -CUDART_INF_F, sumv = 0.f;
    int i0 = L;
    for (int l = t; l < L; l += nt) {
      const float v = fmaxf(zval(p, (size_t)l * p.K + k, nig), 0.f);
      sumv += v;
      r[l] = __fdiv_rn(v, radius);
      if (r[l] > vmax) {
        vmax = r[l];
        i0 = l;
      }
    }
    block_argmax(vmax, i0, scratch, iscratch);
    sumv = block_all<OP_SUM>(sumv, scratch);
    float v1 = -CUDART_INF_F;
    for (int l = t; l < L; l += nt) {
      if (l != i0) v1 = fmaxf(v1, r[l]);
      r[l] = r[l] - vmax;
    }
    v1 = block_all<OP_MAX>(v1, scratch);
    float lo = -1.f, hi = 0.f;
    for (int it = 0; it < BISECTION_ITERS; ++it) {
      const float mid = (lo + hi) * 0.5f;
      float s = 0.f;
      for (int l = t; l < L; l += nt) s += fmaxf(r[l] - mid, 0.f);
      s = block_all<OP_SUM>(s, scratch);
      if (s > 1.0f) lo = mid; else hi = mid;
    }
    const float nu = (lo + hi) * 0.5f;
    const bool shortcut = L > 1 && (vmax - v1) > 1.0f;
    const bool feasible = p.inequality && sumv <= radius + 1e-6f;
    for (int l = t; l < L; l += nt) {
      const size_t idx = (size_t)l * p.K + k;
      float w;
      if (feasible) w = fmaxf(zval(p, idx, nig), 0.f);
      else if (shortcut) w = (l == i0) ? radius : 0.f;
      else w = __fmul_rn(fmaxf(r[l] - nu, 0.f), radius);
      emit<WANT_X>(p, idx, l, len, w, cx, xx);
    }
  } else {  // BOXCUT
    const float lt = p.lo, ut = p.hi, zcut = p.radius;
    float zmin = CUDART_INF_F, zmax = -CUDART_INF_F, sumclip = 0.f;
    for (int l = t; l < L; l += nt) {
      const float z = zval(p, (size_t)l * p.K + k, nig);
      r[l] = z;
      zmin = fminf(zmin, z);
      zmax = fmaxf(zmax, z);
      sumclip += clip(z, lt, ut);
    }
    zmin = block_all<OP_MIN>(zmin, scratch);
    zmax = block_all<OP_MAX>(zmax, scratch);
    sumclip = block_all<OP_SUM>(sumclip, scratch);
    float lo = zmin - ut, hi = zmax - lt;
    for (int it = 0; it < BISECTION_ITERS; ++it) {
      const float mid = (lo + hi) * 0.5f;
      float s = 0.f;
      for (int l = t; l < L; l += nt) s += clip(r[l] - mid, lt, ut);
      s = block_all<OP_SUM>(s, scratch);
      if (s > zcut) lo = mid; else hi = mid;
    }
    const float nu = (lo + hi) * 0.5f;
    const bool feasible = p.inequality && sumclip <= zcut + 1e-6f;
    for (int l = t; l < L; l += nt) {
      const float w = feasible ? clip(r[l], lt, ut) : clip(r[l] - nu, lt, ut);
      emit<WANT_X>(p, (size_t)l * p.K + k, l, len, w, cx, xx);
    }
  }
  block_sum2(cx, xx);
  if (t == 0) {
    p.partials[2 * k] = cx;
    p.partials[2 * k + 1] = xx;
  }
}

template <int KIND, bool WANT_X>
cudaError_t launch_projection(const Args& p, int nb, cudaStream_t s) {
  const int L = p.L;
  if (L > REG_L_CAP) {
    const size_t smem = (size_t)L * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          wide_kernel<KIND, WANT_X>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    wide_kernel<KIND, WANT_X><<<nb, WIDE_THREADS, smem, s>>>(p);
  } else if (L <= 1) {
    column_kernel<KIND, 1, WANT_X><<<nb, THREADS, 0, s>>>(p);
  } else if (L <= 2) {
    column_kernel<KIND, 2, WANT_X><<<nb, THREADS, 0, s>>>(p);
  } else if (L <= 4) {
    column_kernel<KIND, 4, WANT_X><<<nb, THREADS, 0, s>>>(p);
  } else if (L <= 8) {
    column_kernel<KIND, 8, WANT_X><<<nb, THREADS, 0, s>>>(p);
  } else if (L <= 16) {
    column_kernel<KIND, 16, WANT_X><<<nb, THREADS, 0, s>>>(p);
  } else if (L <= 32) {
    column_kernel<KIND, 32, WANT_X><<<nb, THREADS, 0, s>>>(p);
  } else {
    column_kernel<KIND, 64, WANT_X><<<nb, THREADS, 0, s>>>(p);
  }
  return cudaSuccess;
}

template <bool WANT_X>
cudaError_t launch(int kind, const Args& p, int nb, cudaStream_t s) {
  if (kind == CLAMP) {
    clamp_kernel<WANT_X><<<nb, THREADS, 0, s>>>(p);
    return cudaSuccess;
  }
  if (kind == SIMPLEX) return launch_projection<SIMPLEX, WANT_X>(p, nb, s);
  return launch_projection<BOXCUT, WANT_X>(p, nb, s);
}

}  // namespace

extern "C" int dualip_fused_tile_eval(
    const float* lam_g, const float* a, const float* c, const int* length,
    const float* neg_inv_gamma, float* ax, float* x, float* partials, float* out,
    int L, int K, int nb, int kind, int want_x, int inequality,
    float lo, float hi, int has_lo, int has_hi, float radius, void* stream) {
  if (L < 1 || K < 1 || kind < CLAMP || kind > BOXCUT || (want_x && x == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = kind != CLAMP && L > REG_L_CAP;
  const int expected_nb = wide ? K : (K + THREADS - 1) / THREADS;
  if (nb != expected_nb) return (int)cudaErrorInvalidValue;
  if (wide && (size_t)L * sizeof(float) > 227 * 1024) return (int)cudaErrorInvalidValue;

  Args p{lam_g, a, c, length, neg_inv_gamma, ax, x, partials,
         L, (long long)K, inequality, lo, hi, has_lo, has_hi, radius};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = want_x ? launch<true>(kind, p, nb, s) : launch<false>(kind, p, nb, s);
  if (e != cudaSuccess) return (int)e;
  reduce_partials<<<1, REDUCE_THREADS, 0, s>>>(partials, nb, out);
  return (int)cudaGetLastError();
}
