// Device functions shared by the fused tile kernel (fused_matching.cu, K1/K2)
// and the panel kernel (panel_matching.cu, K3/K4): the per-column projection
// of dualip_tpu/ops/pallas_matching.py::_project_block, and the fixed-order
// reduction of the per-block (sum c*x, sum x*x) partials.
//
// Exact numerics of _project_block, the same in every kernel that includes
// this header: z is formed by the caller as two rounded products and a rounded
// sum (no FMA contraction); simplex runs 30 bisection steps on [-1, 0] of the
// max-shifted, radius-normalised, pre-clamped values with the "s > 1" test,
// the top-2 vertex shortcut with argmax taking the FIRST maximum, and the
// inequality pass-through against radius + 1e-6; box_cut is bracketed by
// [min(z) - u, max(z) - l]. Padding lanes take part as z = 0 and are masked
// by the caller's emit.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace dualip {

constexpr int BISECTION_ITERS = 30;
constexpr int REDUCE_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

enum Kind { CLAMP = 0, SIMPLEX = 1, BOXCUT = 2 };

// Projection parameters of one launch.
struct Proj {
  int inequality;
  float lo, hi;  // clamp bounds (CLAMP) or box bounds (BOXCUT)
  int has_lo, has_hi;
  float radius;  // simplex radius or box-cut sum bound
};

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

// Block-wide sum of two values; thread 0 gets the result. Whole block calls.
__device__ inline void block_sum2(float& u, float& v) {
  __shared__ float s[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  u = warp_sum(u);
  v = warp_sum(v);
  if (lane == 0) {
    s[0][warp] = u;
    s[1][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    u = 0.f;
    v = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      u += s[0][w];
      v += s[1][w];
    }
  }
  __syncthreads();
}

// One column of L <= LCAP lanes kept in registers. ``z_at(l)`` returns z of
// lane l (it may be called twice for a lane; it must return the same value);
// ``emit(l, w)`` receives the projected, not yet length-masked value.
template <int KIND, int LCAP, class ZAt, class Emit>
__device__ __forceinline__ void project_column(int L, const Proj& p, ZAt z_at, Emit emit) {
  float r[LCAP];  // simplex: vn - max(vn); box_cut: z
  if (KIND == SIMPLEX) {
    const float radius = p.radius;
    float vmax = -CUDART_INF_F, sumv = 0.f;
    int i0 = 0;
#pragma unroll
    for (int l = 0; l < LCAP; ++l) {
      if (l < L) {
        const float v = fmaxf(z_at(l), 0.f);
        sumv += v;
        r[l] = __fdiv_rn(v, radius);
        if (r[l] > vmax) {  // strict: the first maximum wins
          vmax = r[l];
          i0 = l;
        }
      }
    }
    float v1 = -CUDART_INF_F;
#pragma unroll
    for (int l = 0; l < LCAP; ++l) {
      if (l < L && l != i0) v1 = fmaxf(v1, r[l]);
    }
#pragma unroll
    for (int l = 0; l < LCAP; ++l) {
      if (l < L) r[l] = r[l] - vmax;
    }
    float lo = -1.f, hi = 0.f;
    for (int it = 0; it < BISECTION_ITERS; ++it) {
      const float mid = (lo + hi) * 0.5f;
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < LCAP; ++l) {
        if (l < L) s += fmaxf(r[l] - mid, 0.f);
      }
      if (s > 1.0f) lo = mid; else hi = mid;
    }
    const float nu = (lo + hi) * 0.5f;
    const bool shortcut = L > 1 && (vmax - v1) > 1.0f;
    const bool feasible = p.inequality && sumv <= radius + 1e-6f;
#pragma unroll
    for (int l = 0; l < LCAP; ++l) {
      if (l < L) {
        float w;
        if (feasible) w = fmaxf(z_at(l), 0.f);
        else if (shortcut) w = (l == i0) ? radius : 0.f;
        else w = __fmul_rn(fmaxf(r[l] - nu, 0.f), radius);
        emit(l, w);
      }
    }
  } else {  // BOXCUT
    const float lt = p.lo, ut = p.hi, zcut = p.radius;
    float zmin = CUDART_INF_F, zmax = -CUDART_INF_F, sumclip = 0.f;
#pragma unroll
    for (int l = 0; l < LCAP; ++l) {
      if (l < L) {
        const float z = z_at(l);
        r[l] = z;
        zmin = fminf(zmin, z);
        zmax = fmaxf(zmax, z);
        sumclip += clip(z, lt, ut);
      }
    }
    float lo = zmin - ut, hi = zmax - lt;
    for (int it = 0; it < BISECTION_ITERS; ++it) {
      const float mid = (lo + hi) * 0.5f;
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < LCAP; ++l) {
        if (l < L) s += clip(r[l] - mid, lt, ut);
      }
      if (s > zcut) lo = mid; else hi = mid;
    }
    const float nu = (lo + hi) * 0.5f;
    const bool feasible = p.inequality && sumclip <= zcut + 1e-6f;
#pragma unroll
    for (int l = 0; l < LCAP; ++l) {
      if (l < L) {
        const float w = feasible ? clip(r[l], lt, ut) : clip(r[l] - nu, lt, ut);
        emit(l, w);
      }
    }
  }
}

// The same column, any L, with nothing kept: every pass calls ``z_at`` again
// (32 passes over the column, served by L1/L2). For the rare buckets wider
// than the register cap. The sums run over the lanes in the same order as
// above, so the result is the same bit for bit.
template <int KIND, class ZAt, class Emit>
__device__ __forceinline__ void project_column_stream(int L, const Proj& p, ZAt z_at, Emit emit) {
  if (KIND == SIMPLEX) {
    const float radius = p.radius;
    float vmax = -CUDART_INF_F, sumv = 0.f;
    int i0 = 0;
    for (int l = 0; l < L; ++l) {
      const float v = fmaxf(z_at(l), 0.f);
      sumv += v;
      const float vn = __fdiv_rn(v, radius);
      if (vn > vmax) {
        vmax = vn;
        i0 = l;
      }
    }
    float v1 = -CUDART_INF_F;
    for (int l = 0; l < L; ++l) {
      if (l != i0) v1 = fmaxf(v1, __fdiv_rn(fmaxf(z_at(l), 0.f), radius));
    }
    float lo = -1.f, hi = 0.f;
    for (int it = 0; it < BISECTION_ITERS; ++it) {
      const float mid = (lo + hi) * 0.5f;
      float s = 0.f;
      for (int l = 0; l < L; ++l) {
        const float rl = __fdiv_rn(fmaxf(z_at(l), 0.f), radius) - vmax;
        s += fmaxf(rl - mid, 0.f);
      }
      if (s > 1.0f) lo = mid; else hi = mid;
    }
    const float nu = (lo + hi) * 0.5f;
    const bool shortcut = L > 1 && (vmax - v1) > 1.0f;
    const bool feasible = p.inequality && sumv <= radius + 1e-6f;
    for (int l = 0; l < L; ++l) {
      const float v = fmaxf(z_at(l), 0.f);
      float w;
      if (feasible) w = v;
      else if (shortcut) w = (l == i0) ? radius : 0.f;
      else w = __fmul_rn(fmaxf((__fdiv_rn(v, radius) - vmax) - nu, 0.f), radius);
      emit(l, w);
    }
  } else {  // BOXCUT
    const float lt = p.lo, ut = p.hi, zcut = p.radius;
    float zmin = CUDART_INF_F, zmax = -CUDART_INF_F, sumclip = 0.f;
    for (int l = 0; l < L; ++l) {
      const float z = z_at(l);
      zmin = fminf(zmin, z);
      zmax = fmaxf(zmax, z);
      sumclip += clip(z, lt, ut);
    }
    float lo = zmin - ut, hi = zmax - lt;
    for (int it = 0; it < BISECTION_ITERS; ++it) {
      const float mid = (lo + hi) * 0.5f;
      float s = 0.f;
      for (int l = 0; l < L; ++l) s += clip(z_at(l) - mid, lt, ut);
      if (s > zcut) lo = mid; else hi = mid;
    }
    const float nu = (lo + hi) * 0.5f;
    const bool feasible = p.inequality && sumclip <= zcut + 1e-6f;
    for (int l = 0; l < L; ++l) {
      const float z = z_at(l);
      emit(l, feasible ? clip(z, lt, ut) : clip(z - nu, lt, ut));
    }
  }
}

// Second pass: out = sum of the per-block partials, in a fixed order.
__global__ void __launch_bounds__(REDUCE_THREADS) reduce_partials(const float* partials, int nb, float* out) {
  float u = 0.f, v = 0.f;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    u += partials[2 * i];
    v += partials[2 * i + 1];
  }
  block_sum2(u, v);
  if (threadIdx.x == 0) {
    out[0] = u;
    out[1] = v;
  }
}

}  // namespace dualip
