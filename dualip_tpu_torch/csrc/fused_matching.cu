// Fused matching tile kernel (K1) and its x-emitting twin (K2) for Hopper.
//
// Replaces dualip_tpu/ops/pallas_matching.py::_fused_kernel (K1) and
// ::_fused_kernel_x (K2), with their device function _project_block, and in
// its gather form also the lambda gather that XLA ran before the TPU kernel.
// Per (L, K)-transposed tile, for every entity column k:
//
//     lam[l] = lam_g[l,k]                        (lam_g form, the TPU contract)
//            = scaled[rows[l,k]]                 (gather form)
//     z[l]  = a[l,k] * lam[l] + neg_inv_gamma * c[l,k]          l < L
//     x[:,k] = Proj(z[:,k]) over the L lanes, then x[l,k] = 0 for l >= length[k]
//     ax[l,k] = a[l,k] * x[l,k];  obj += c*x;  reg += x*x       (+ x with WANT_X)
//
// Both forms run the same code (template flag GATHER): z is formed from the
// same rounded products, so they give the same bits.
//
// What bounds it on an H100: device memory. It reads lam_g or rows, a, c
// (12 B per slot) and writes a*x (4 B; 8 B with x), about 16 B per slot (20 B
// for K2), against about 100 fp32 operations per slot for the 30 bisection
// steps: about 6 per byte, below the card's fp32 ridge of 67 TFLOP/s /
// 3.35 TB/s = 20.
//
// Design:
//  * One thread per column (L <= 64). Persistent blocks of 256 threads walk
//    slabs of 256 columns. The (L, K) layout puts neighbouring columns at
//    neighbouring addresses: a slab's (L x 256) lanes of lam_g or rows, a and
//    c, and its 256 lengths, are copied into shared memory with cp.async
//    (16 B pieces when K and the pointers allow), all in flight at once. The
//    column's values stay in registers (template on a power-of-two cap of L)
//    for all 30 bisection steps; pass 2 reads a and c from shared memory.
//  * Gather form: each block copies scaled (m,) into shared memory once, when
//    m * 4 B fits SCALED_SMEM_BYTES beside the slab (40 KB at m = 10,000), and
//    gathers from there; otherwise it reads scaled through L1. Any m is taken.
//    A random gather of 32 lanes costs a few shared-memory wavefronts (bank
//    conflicts) but about one L1 pass per distinct line.
//  * One slab in shared memory per block, not two: on an H100 a second buffer
//    cut the blocks per SM and measured slower; the two blocks of an SM
//    overlap one's copy with the other's bisection.
//  * One block per column above L = 64, with the column in shared memory and
//    block-wide reductions per bisection step (rare: wide buckets only).
//  * One launch per tile: every slab (column, above L = 64) writes its partial
//    (obj, reg) to a scratch; the last block to finish adds them in a fixed
//    order, so two runs give the same bits (no float atomics), whatever the
//    number of blocks.
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
// Launches of this library must not run concurrently on two streams: the
// count of finished blocks is one device variable, reset by each launch's
// last block.
//
// C interface: dualip_fused_tile_eval(...) launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not synchronise.

#include "project_block.cuh"

namespace {

using namespace dualip;

constexpr int THREADS = 256;       // columns per slab = threads per block, per-column kernels
constexpr int REG_L_CAP = 64;      // largest L kept in registers
constexpr int WIDE_THREADS = 256;  // threads per column, wide kernel
constexpr int SLAB_ARRAYS = 3;     // lam_g or rows, a, c
constexpr int SCALED_SMEM_BYTES = 48 * 1024;  // largest scaled (m,) copied into shared memory
constexpr int SMEM_LIMIT = 226 * 1024;  // dynamic shared memory of one block (227 KB less the static part)

__device__ unsigned int g_blocks_done = 0;  // blocks of the running launch that have finished

struct Args {
  const float* g;       // lam_g (L, K) fp32, or rows (L, K) int32 read as its bits (GATHER)
  const float* scaled;  // (m,), GATHER only
  int m;
  const float* a;
  const float* c;
  const int* length;
  const float* neg_inv_gamma;
  float* ax;
  float* x;
  float* partials;  // (nparts, 2)
  float* out;       // (2,)
  int L;
  long long K;
  int nparts;
  int inequality;
  float lo, hi;  // clamp bounds (CLAMP) or box bounds (BOXCUT)
  int has_lo, has_hi;
  float radius;      // simplex radius or box-cut sum bound
  int vec16;         // slab copies in 16 B pieces
  int scaled_smem;   // GATHER: scaled copied into shared memory
};

template <bool GATHER>
__device__ __forceinline__ float lam_at(const float* g, size_t idx, const float* scaled) {
  if (GATHER) return scaled[reinterpret_cast<const int*>(g)[idx]];
  return g[idx];
}

// a*lam + nig*c, rounded as two products and a sum (no contraction)
__device__ __forceinline__ float zform(float a, float lam, float c, float nig) {
  return __fadd_rn(__fmul_rn(a, lam), __fmul_rn(nig, c));
}

template <bool GATHER>
__device__ __forceinline__ float zval(const Args& p, size_t idx, float nig) {
  return zform(p.a[idx], lam_at<GATHER>(p.g, idx, p.scaled), p.c[idx], nig);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Every thread of the block: start copying slab ``slab`` into ``dst``
// ([array][l][THREADS] floats, then the THREADS lengths). Columns at or past
// K are not copied (their threads compute nothing).
__device__ __forceinline__ void start_slab_copy(const Args& p, float* dst, int slab) {
  const int L = p.L, t = threadIdx.x;
  const long long K = p.K, k0 = (long long)slab * THREADS;
  const float* src[SLAB_ARRAYS] = {p.g, p.a, p.c};
  float* dst_len = dst + (size_t)SLAB_ARRAYS * L * THREADS;
  const float* src_len = reinterpret_cast<const float*>(p.length);
  if (p.vec16) {  // a lane row is 32 pieces of 16 B; 4 lane rows per pass
    constexpr int PIECES = THREADS / 4, ROWS = THREADS / PIECES;
    const int piece = t % PIECES;
    const long long col = k0 + 4 * piece;
    if (col >= K) return;
#pragma unroll
    for (int arr = 0; arr < SLAB_ARRAYS; ++arr) {
      for (int l = t / PIECES; l < L; l += ROWS) {
        cp_async16(dst + ((size_t)arr * L + l) * THREADS + 4 * piece, src[arr] + (size_t)l * K + col);
      }
    }
    if (t < PIECES) cp_async16(dst_len + 4 * piece, src_len + col);
  } else {
    const long long col = k0 + t;
    if (col >= K) return;
#pragma unroll
    for (int arr = 0; arr < SLAB_ARRAYS; ++arr) {
      for (int l = 0; l < L; ++l) {
        cp_async4(dst + ((size_t)arr * L + l) * THREADS + t, src[arr] + (size_t)l * K + col);
      }
    }
    cp_async4(dst_len + t, src_len + col);
  }
}

// Writes one lane's x (masked), a*x and the sums, in pass 2.
template <bool WANT_X>
__device__ __forceinline__ void emit(const Args& p, size_t idx, int l, int len, float w, float av, float cv,
                                     float& cx, float& xx) {
  const float x = (l < len) ? w : 0.f;
  p.ax[idx] = __fmul_rn(av, x);
  if (WANT_X) p.x[idx] = x;
  cx += cv * x;
  xx += x * x;
}

// Every thread of every block, after thread 0 wrote the block's last partial:
// the last block to arrive adds all partials in a fixed order into out.
__device__ void finish(const Args& p) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&g_blocks_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // thread t adds partials t, t + blockDim, ... in that order, eight loads in flight
  const float2* parts = reinterpret_cast<const float2*>(p.partials);
  const int n = p.nparts, step = blockDim.x;
  float u = 0.f, v = 0.f;
  int i = threadIdx.x;
  for (; i + 7 * step < n; i += 8 * step) {
    float2 q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = __ldcg(parts + i + j * step);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      u += q[j].x;
      v += q[j].y;
    }
  }
  for (; i < n; i += step) {
    const float2 q = __ldcg(parts + i);
    u += q.x;
    v += q.y;
  }
  block_sum2(u, v);
  if (threadIdx.x == 0) {
    p.out[0] = u;
    p.out[1] = v;
    g_blocks_done = 0;
  }
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

// identity / box / cone: elementwise clamps, any L, a block per 128 columns.
template <bool WANT_X, bool GATHER>
__global__ void __launch_bounds__(THREADS) clamp_kernel(Args p) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float cx = 0.f, xx = 0.f;
  if (k < p.K) {
    const float nig = *p.neg_inv_gamma;
    const int len = p.length[k];
    for (int l = 0; l < p.L; ++l) {
      const size_t idx = (size_t)l * p.K + k;
      float w = zval<GATHER>(p, idx, nig);
      if (p.has_lo) w = fmaxf(w, p.lo);
      if (p.has_hi) w = fminf(w, p.hi);
      emit<WANT_X>(p, idx, l, len, w, p.a[idx], p.c[idx], cx, xx);
    }
  }
  block_sum2(cx, xx);
  if (threadIdx.x == 0) {
    p.partials[2 * blockIdx.x] = cx;
    p.partials[2 * blockIdx.x + 1] = xx;
  }
  finish(p);
}

// simplex / simplex_eq / box_cut / box_cut_eq, one thread per column, L <= LCAP,
// persistent blocks over slabs of THREADS columns in shared memory.
template <int KIND, int LCAP, bool WANT_X, bool GATHER>
__global__ void __launch_bounds__(THREADS) column_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.L, t = threadIdx.x;
  const size_t lanes = (size_t)L * THREADS;  // one array of a slab
  const float* table = p.scaled;  // GATHER: scaled, here or in shared memory
  if (GATHER && p.scaled_smem) {
    float* copy = smem + SLAB_ARRAYS * lanes + THREADS;
    if (p.vec16 && p.m % 4 == 0) {
      for (int i = 4 * t; i < p.m; i += 4 * THREADS) cp_async16(copy + i, p.scaled + i);
    } else {
      for (int i = t; i < p.m; i += THREADS) cp_async4(copy + i, p.scaled + i);
    }
    table = copy;  // arrives with the first slab
  }
  const float nig = *p.neg_inv_gamma;
  const Proj proj{p.inequality, p.lo, p.hi, p.has_lo, p.has_hi, p.radius};
  for (int slab = blockIdx.x; slab < p.nparts; slab += gridDim.x) {
    start_slab_copy(p, smem, slab);
    cp_async_wait_all();
    __syncthreads();
    const float* sg = smem;
    const float* sa = sg + lanes;
    const float* sc = sa + lanes;
    const long long k = (long long)slab * THREADS + t;
    float cx = 0.f, xx = 0.f;
    if (k < p.K) {
      const int len = reinterpret_cast<const int*>(sc + lanes)[t];
      project_column<KIND, LCAP>(
          L, proj,
          [&](int l) {
            const int i = l * THREADS + t;
            return zform(sa[i], lam_at<GATHER>(sg, i, table), sc[i], nig);
          },
          [&](int l, float w) {
            const int i = l * THREADS + t;
            emit<WANT_X>(p, (size_t)l * p.K + k, l, len, w, sa[i], sc[i], cx, xx);
          });
    }
    block_sum2(cx, xx);  // ends with a barrier: the slab may be overwritten after it
    if (t == 0) {
      p.partials[2 * slab] = cx;
      p.partials[2 * slab + 1] = xx;
    }
  }
  finish(p);
}

// The same kinds above L = 64: block blockIdx.x owns column k; thread t owns
// lanes t, t + blockDim, ..., kept in dynamic shared memory.
template <int KIND, bool WANT_X, bool GATHER>
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
      const float v = fmaxf(zval<GATHER>(p, (size_t)l * p.K + k, nig), 0.f);
      sumv += v;
      r[l] = div_radius(v, radius);
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
      if (feasible) w = fmaxf(zval<GATHER>(p, idx, nig), 0.f);
      else if (shortcut) w = (l == i0) ? radius : 0.f;
      else w = __fmul_rn(fmaxf(r[l] - nu, 0.f), radius);
      emit<WANT_X>(p, idx, l, len, w, p.a[idx], p.c[idx], cx, xx);
    }
  } else {  // BOXCUT
    const float lt = p.lo, ut = p.hi, zcut = p.radius;
    float zmin = CUDART_INF_F, zmax = -CUDART_INF_F, sumclip = 0.f;
    for (int l = t; l < L; l += nt) {
      const float z = zval<GATHER>(p, (size_t)l * p.K + k, nig);
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
      const size_t idx = (size_t)l * p.K + k;
      const float w = feasible ? clip(r[l], lt, ut) : clip(r[l] - nu, lt, ut);
      emit<WANT_X>(p, idx, l, len, w, p.a[idx], p.c[idx], cx, xx);
    }
  }
  block_sum2(cx, xx);
  if (t == 0) {
    p.partials[2 * k] = cx;
    p.partials[2 * k + 1] = xx;
  }
  finish(p);
}

// Dynamic shared memory above the default 48 KB (static included) needs an
// opt-in per kernel.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The column kernel's slab: lam_g or rows, a and c (L x THREADS each) and
// THREADS lengths.
size_t slab_bytes(int L) { return (size_t)(SLAB_ARRAYS * L + 1) * THREADS * sizeof(float); }

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <int KIND, int LCAP, bool WANT_X, bool GATHER>
cudaError_t launch_column(const Args& p, cudaStream_t s) {
  const auto kernel = column_kernel<KIND, LCAP, WANT_X, GATHER>;
  const size_t smem = slab_bytes(p.L) + (p.scaled_smem ? (size_t)p.m * sizeof(float) : 0);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;  // as many blocks as the SMs hold at once
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * sm_count();
  kernel<<<(int)(p.nparts < resident ? p.nparts : resident), THREADS, smem, s>>>(p);
  return cudaSuccess;
}

template <int KIND, bool WANT_X, bool GATHER>
cudaError_t launch_projection(const Args& p, cudaStream_t s) {
  const int L = p.L;
  if (L > REG_L_CAP) {
    const size_t smem = (size_t)L * sizeof(float);
    const cudaError_t e = allow_smem(wide_kernel<KIND, WANT_X, GATHER>, smem);
    if (e != cudaSuccess) return e;
    wide_kernel<KIND, WANT_X, GATHER><<<p.nparts, WIDE_THREADS, smem, s>>>(p);
    return cudaSuccess;
  }
  if (L <= 1) return launch_column<KIND, 1, WANT_X, GATHER>(p, s);
  if (L <= 2) return launch_column<KIND, 2, WANT_X, GATHER>(p, s);
  if (L <= 4) return launch_column<KIND, 4, WANT_X, GATHER>(p, s);
  if (L <= 8) return launch_column<KIND, 8, WANT_X, GATHER>(p, s);
  if (L <= 16) return launch_column<KIND, 16, WANT_X, GATHER>(p, s);
  if (L <= 32) return launch_column<KIND, 32, WANT_X, GATHER>(p, s);
  return launch_column<KIND, 64, WANT_X, GATHER>(p, s);
}

template <bool WANT_X, bool GATHER>
cudaError_t launch(int kind, const Args& p, cudaStream_t s) {
  if (kind == CLAMP) {
    clamp_kernel<WANT_X, GATHER><<<p.nparts, THREADS, 0, s>>>(p);
    return cudaSuccess;
  }
  if (kind == SIMPLEX) return launch_projection<SIMPLEX, WANT_X, GATHER>(p, s);
  return launch_projection<BOXCUT, WANT_X, GATHER>(p, s);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// ``g`` is lam_g (L, K) float32, or with ``gather`` the tile's rows (L, K)
// int32 and ``scaled`` (m,) float32.
extern "C" int dualip_fused_tile_eval(
    const void* g, const float* scaled, int m, const float* a, const float* c, const int* length,
    const float* neg_inv_gamma, float* ax, float* x, float* partials, float* out,
    int L, int K, int nb, int kind, int want_x, int gather, int inequality,
    float lo, float hi, int has_lo, int has_hi, float radius, void* stream) {
  if (L < 1 || K < 1 || kind < CLAMP || kind > BOXCUT || (want_x && x == nullptr) ||
      (gather && (scaled == nullptr || m < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = kind != CLAMP && L > REG_L_CAP;
  const int expected_nb = wide ? K : (K + THREADS - 1) / THREADS;
  if (nb != expected_nb) return (int)cudaErrorInvalidValue;
  if (wide && (size_t)L * sizeof(float) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;

  const int vec16 = K % 4 == 0 && aligned16(g) && aligned16(a) && aligned16(c) && aligned16(length) &&
                    (!gather || aligned16(scaled));
  const int scaled_smem = gather && (size_t)m * sizeof(float) <= SCALED_SMEM_BYTES &&
                          slab_bytes(L) + (size_t)m * sizeof(float) <= SMEM_LIMIT;
  Args p{static_cast<const float*>(g), scaled, m, a, c, length, neg_inv_gamma, ax, x, partials, out,
         L, (long long)K, nb, inequality, lo, hi, has_lo, has_hi, radius, vec16, scaled_smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (gather) e = want_x ? launch<true, true>(kind, p, s) : launch<false, true>(kind, p, s);
  else e = want_x ? launch<true, false>(kind, p, s) : launch<false, false>(kind, p, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
