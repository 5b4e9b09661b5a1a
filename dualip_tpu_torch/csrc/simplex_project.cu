// Duchi's simplex projection of short rows, for Hopper: each row of a
// (rows, L) float32 array, L <= 64, projected onto {w >= 0, sum w (<=|=) z}
// in registers.
//
// No TPU kernel stands behind this one. The JAX package's csc path projects
// its (K, L) tiles with XLA's sort and cumsum (dualip_tpu/projections/
// simplex.py::duchi_project); the port's torch form of the same ops
// (projections/simplex.py::_duchi_torch) spent most of the default csc
// iteration in torch's scan and sort, library kernels built for long rows,
// run over millions of rows of 4 to 64 lanes.
//
// Per row, the order of projections/simplex.py::duchi_project:
//   1. x = max(x, 0);
//   2. u = x sorted descending (a bitonic network in registers);
//   3. css_i = u_0 + u_1 + ... + u_i, added one after another in that order;
//   4. q_i = (css_i - z) / (i + 1); rho = the largest i with u_i - q_i > 0
//      (0 if none); theta = q_rho;
//   5. w = max(x - theta, 0);
//   6. the top-2 vertex shortcut: if u_0/z - u_1/z > 1 (the largest and the
//      second largest of x/z), w is z at the one lane that holds u_0 and 0
//      elsewhere. Division by z > 0 keeps the order, so these are the
//      largest two of x/z, and when the test passes u_0 is unique, so the
//      lane that holds it is x/z's first argmax;
//   7. inequality: if css_{L-1} <= z + tol the row passes through as x.
// A row with a NaN entry comes out NaN in every lane, as torch's ops give it
// (the clamp, the sort and the max there carry the NaN into theta); the max
// of step 5 carries a NaN of x - theta (inf - inf) as torch.maximum does.
// Every step rounds once in float32 (no product, so no FMA contraction), so
// the plain version (ops/simplex_project.py::simplex_project_reference) gives
// the same bits on the card. Padding lanes of a tile enter as the zeros they
// hold; the caller masks them afterwards.
//
// What bounds it on an H100: device memory, 8 B a slot (x read once, w
// written once); the sort, 4-672 compare-exchanges a row, stays in registers.
//
// Design: P = L rounded up to a power of two (1..64) is a template parameter.
// A row is held by G = P / E lanes of one warp, E = min(P, 16) values each:
// up to 16 lanes one thread a row, 32 two lanes and 64 four. A lane loads its
// E neighbouring values with 16 B (8 B at P = 2) loads where the row is whole
// and the arrays aligned, so a warp reads 32 * E * 4 contiguous bytes. Lanes
// past L (L not a power of two) sort as -inf and are never written. The
// bitonic network's steps across lanes exchange values by __shfl_xor_sync
// within the row's group; the scan is the one sequential chain, handed from
// lane to lane; rho is the largest index over the group by __shfl_xor_sync.
//
// C interface: launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// Loads or stores E neighbouring floats, in 16 B (or 8 B) pieces.
template <int E>
__device__ __forceinline__ void load_vec(const float* src, float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(src) + k);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  } else if constexpr (E % 2 == 0) {
#pragma unroll
    for (int k = 0; k < E / 2; ++k) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(src) + k);
      v[2 * k] = q.x;
      v[2 * k + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = __ldg(src + e);
  }
}

template <int E>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int k = 0; k < E / 4; ++k)
      reinterpret_cast<float4*>(dst)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else if constexpr (E % 2 == 0) {
#pragma unroll
    for (int k = 0; k < E / 2; ++k) reinterpret_cast<float2*>(dst)[k] = make_float2(v[2 * k], v[2 * k + 1]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = v[e];
  }
}

// Bitonic sort, descending, of the P values of a row held E to a lane by the
// G lanes of a group (element i = g * E + e). ``g`` is the lane's place in
// its group; all 32 lanes of the warp call it.
template <int P, int E>
__device__ __forceinline__ void sort_desc(float (&u)[E], int g) {
  const int first = g * E;
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= E) {  // partner on lane g ^ (j / E), same e
        const bool lower = (g & (j / E)) == 0;
        const bool desc = (first & k) == 0;  // k > j >= E > e
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float o = __shfl_xor_sync(FULL, u[e], j / E);
          u[e] = (lower == desc) ? fmaxf(u[e], o) : fminf(u[e], o);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & j) == 0) {
            const bool desc = (k < E ? (e & k) : (first & k)) == 0;
            const float a = u[e], b = u[e | j];
            u[e] = desc ? fmaxf(a, b) : fminf(a, b);
            u[e | j] = desc ? fminf(a, b) : fmaxf(a, b);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float div_z(float v, float z) { return z == 1.f ? v : __fdiv_rn(v, z); }

template <int P>
__global__ void __launch_bounds__(THREADS) duchi_sortscan_kernel(const float* __restrict__ x, float* __restrict__ w,
                                                                 long long rows, int L, float z, float tol,
                                                                 int inequality, int vec) {
  constexpr int E = P < 16 ? P : 16;
  constexpr int G = P / E;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long row = t / G;
  const int g = (int)(t % G);
  const int base = (threadIdx.x & 31) & ~(G - 1);  // the group's first lane
  const int first = g * E;
  const bool live = row < rows;  // dead lanes still take part in the shuffles
  const long long off = row * L + first;

  float xv[E], u[E];
  if (live && vec && L == P) {
    load_vec<E>(x + off, xv);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) xv[e] = (live && first + e < L) ? __ldg(x + off + e) : 0.f;
  }
  bool nan_row = false;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    nan_row |= xv[e] != xv[e];
    xv[e] = fmaxf(xv[e], 0.f);
    u[e] = first + e < L ? xv[e] : -CUDART_INF_F;
  }
#pragma unroll
  for (int d = 1; d < G; d <<= 1) nan_row |= __shfl_xor_sync(FULL, (int)nan_row, d) != 0;
  sort_desc<P, E>(u, g);

  // css in sorted order, one add after another: lane s of the group starts
  // from lane s - 1's last sum
  float css[E];
  float last = 0.f;
#pragma unroll
  for (int s = 0; s < G; ++s) {
    const float carry = s > 0 ? __shfl_sync(FULL, last, base + s - 1) : 0.f;
    if (g == s) {
      float run = carry;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (first + e < L) {
          run = (first + e == 0) ? u[e] : __fadd_rn(run, u[e]);
          css[e] = run;
        }
      }
      last = run;
    }
  }

  // rho: the largest i with u_i - q_i > 0, else 0; theta = q_rho
  int best = g == 0 ? 0 : -1;
  float theta = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = first + e;
    if (i < L) {
      const float q = __fdiv_rn(__fsub_rn(css[e], z), (float)(i + 1));
      if (i == 0) theta = q;
      if (__fsub_rn(u[e], q) > 0.f) {
        best = i;
        theta = q;
      }
    }
  }
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const int ob = __shfl_xor_sync(FULL, best, d);
    const float oq = __shfl_xor_sync(FULL, theta, d);
    if (ob > best) {
      best = ob;
      theta = oq;
    }
  }

  float u0 = u[0], u1 = u[1 % E], total = last;  // (E = 1 only at L = 1, which has no shortcut)
  if (G > 1) {
    u0 = __shfl_sync(FULL, u[0], base);
    u1 = __shfl_sync(FULL, u[1 % E], base);
    total = __shfl_sync(FULL, last, base + (L - 1) / E);
  }
  const bool shortcut = L > 1 && __fsub_rn(div_z(u0, z), div_z(u1, z)) > 1.f;
  const bool feasible = inequality && total <= __fadd_rn(z, tol);

  if (!live) return;
  float out[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float d = __fsub_rn(xv[e], theta);
    if (nan_row) out[e] = CUDART_NAN_F;
    else if (feasible) out[e] = xv[e];
    else if (shortcut) out[e] = xv[e] == u0 ? z : 0.f;
    else out[e] = d < 0.f ? 0.f : d;  // max(d, 0), NaN kept
  }
  if (vec && L == P) {
    store_vec<E>(w + off, out);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (first + e < L) w[off + e] = out[e];
  }
}

template <int P>
int launch(const float* x, float* w, long long rows, int L, float z, float tol, int inequality, int vec,
           cudaStream_t s) {
  constexpr int G = P < 16 ? 1 : P / 16;
  const long long blocks = (rows * G + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  duchi_sortscan_kernel<P><<<(unsigned)blocks, THREADS, 0, s>>>(x, w, rows, L, z, tol, inequality, vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" int dualip_simplex_project(const float* x, float* w, long long rows, int L, float z, float tol,
                                      int inequality, void* stream) {
  if (rows < 0 || L < 1 || L > 64 || !(z > 0.f)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = aligned16(x) && aligned16(w);
  if (L <= 1) return launch<1>(x, w, rows, L, z, tol, inequality, vec, s);
  if (L <= 2) return launch<2>(x, w, rows, L, z, tol, inequality, vec, s);
  if (L <= 4) return launch<4>(x, w, rows, L, z, tol, inequality, vec, s);
  if (L <= 8) return launch<8>(x, w, rows, L, z, tol, inequality, vec, s);
  if (L <= 16) return launch<16>(x, w, rows, L, z, tol, inequality, vec, s);
  if (L <= 32) return launch<32>(x, w, rows, L, z, tol, inequality, vec, s);
  return launch<64>(x, w, rows, L, z, tol, inequality, vec, s);
}
