// Fused matching tile kernel (K1) and its x-emitting twin (K2) for Hopper.
//
// Replaces dualip_tpu/ops/pallas_matching.py::_fused_kernel (K1) and
// ::_fused_kernel_x (K2), with their device function _project_block, and
// also the lambda gather that XLA ran before the TPU kernel. Per
// (L, K)-transposed tile, for every entity column k:
//
//     lam[l] = scaled[rows[l,k]]
//     z[l]  = a[l,k] * lam[l] + neg_inv_gamma * c[l,k]          l < L
//     x[:,k] = Proj(z[:,k]) over the L lanes, then x[l,k] = 0 for l >= length[k]
//     ax[l,k] = a[l,k] * x[l,k];  obj += c*x;  reg += x*x       (+ x with WANT_X)
//
// The TPU kernel's contract, which takes lam_g = scaled[rows] gathered by the
// caller, is this kernel on scaled = lam_g and rows = 0, 1, ..., L K - 1
// (ops/fused_matching.py::fused_tile_eval_T): the same bits.
//
// What bounds it on an H100: device memory. It reads rows, a, c
// (12 B per slot) and writes a*x (4 B; 8 B with x), about 16 B per slot (20 B
// for K2), against about 100 fp32 operations per slot for the 30 bisection
// steps: about 6 per byte, below the card's fp32 ridge of 67 TFLOP/s /
// 3.35 TB/s = 20.
//
// Design:
//  * One thread per column (L <= 64). Persistent blocks of 256 threads walk
//    slabs of 256 columns. The (L, K) layout puts neighbouring columns at
//    neighbouring addresses: a slab's (L x 256) lanes of rows, a and c, and
//    its 256 lengths, are copied into shared memory with cp.async
//    (16 B pieces when K and the pointers allow), all in flight at once. The
//    column's values stay in registers (template on a power-of-two cap of L)
//    for all 30 bisection steps; pass 2 reads a and c from shared memory.
//  * Each block copies scaled (m,) into shared memory once, when m * 4 B
//    fits SCALED_SMEM_BYTES beside the slab (40 KB at m = 10,000), and
//    gathers from there; otherwise it reads scaled through L1. Any m is taken.
//    A random gather of 32 lanes costs a few shared-memory wavefronts (bank
//    conflicts) but about one L1 pass per distinct line.
//  * One slab in shared memory per block, not two: on an H100 a second buffer
//    cut the blocks per SM and measured slower; the two blocks of an SM
//    overlap one's copy with the other's bisection.
//  * One warp per column for 64 < L <= 512 (wide_kernel<32, ...>):
//    persistent blocks of 8 warps walk groups of 8 adjacent columns, one a
//    warp (so each 32 B sector of a lane row read from device memory serves
//    the whole block), with the scaled copy of the column kernel. The warp
//    forms z once and keeps it, with a and c, in registers (the bisection
//    then reads no memory, and the emit only stores); every reduction is a
//    warp shuffle, with no block barrier inside a step
//    (project_column_group with a WarpReduce, project_block.cuh).
//  * One block per column above L = 512 (wide_kernel<T, KEEP, ...>, T = 128
//    to 1024 threads, 8 lanes a thread: 128 at L = 1024, 1024 at 8192):
//    persistent blocks walk the tile's columns. These tiles hold few real
//    columns, some thousands of lanes wide: a warp a column left the card
//    nearly empty while the widest columns' warps walked their lanes 33
//    times from device memory. The block keeps z, a and c in registers (at
//    T = 1024 16 lanes a thread up to 16,384 lanes, z alone; then z in
//    shared memory; then nowhere, z formed again on every pass: one kernel
//    instance each, so that one keep's registers do not spill another's),
//    and each reduction costs one barrier (project_column_group with a
//    BlockReduce). scaled is read through the caches: a column reads at most
//    L of its m values. The
//    8 columns that share a sector go to 8 blocks: one block of 8 teams of
//    128 threads, a team a column, measured no faster on an H100 (a tile of
//    thousands of real columns takes the time its uncoalesced lane accesses
//    take, whichever threads issue them).
//  * A column of length 0 (padding) is not projected or read: its lanes take
//    x = 0 and a*x = 0, as the mask gives them (a padding slot's a is 0), and
//    a group of 8 such columns is written by whole sectors (in the block
//    form each of the 8 columns' blocks writes an eighth of its lane rows).
//  * One launch per tile: every slab (column group above L = 64, column
//    above L = 512) writes its partial (obj, reg) to a scratch; the last
//    block to finish adds them in a fixed order, so two runs give the same
//    bits (no float atomics), whatever the number of blocks.
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
constexpr int WIDE_WARPS = 8;      // columns per group (one a warp) = warps per block, wide kernel's warp form
constexpr int WIDE_REGS = 4;       // a wide column in registers, 4 lanes a thread, up to 128 lanes
constexpr int WIDE_REGS_LONG = 16; // ... 16 lanes a thread up to 512; above, a block a column
constexpr int SLAB_ARRAYS = 3;     // rows, a, c
constexpr int SCALED_SMEM_BYTES = 48 * 1024;  // largest scaled (m,) copied into shared memory

// Threads a column of the wide kernel (L > REG_L_CAP): a warp up to
// 32 * WIDE_REGS_LONG lanes, else a block of block_threads(L), its lanes kept
// as block_keep(L) says (project_block.cuh).
// ops/fused_matching.py::k1_path mirrors this rule.
int wide_threads(int L) { return L <= 32 * WIDE_REGS_LONG ? 32 : block_threads(L); }

__device__ unsigned int g_blocks_done = 0;  // blocks of the running launch that have finished

struct Args {
  const int* rows;      // (L, K)
  const float* scaled;  // (m,)
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
  int scaled_smem;   // scaled copied into shared memory
};

// a*lam + nig*c, rounded as two products and a sum (no contraction)
__device__ __forceinline__ float zform(float a, float lam, float c, float nig) {
  return __fadd_rn(__fmul_rn(a, lam), __fmul_rn(nig, c));
}

__device__ __forceinline__ float zval(const Args& p, size_t idx, float nig) {
  return zform(p.a[idx], p.scaled[p.rows[idx]], p.c[idx], nig);
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
  const float* src[SLAB_ARRAYS] = {reinterpret_cast<const float*>(p.rows), p.a, p.c};
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

// Every thread of the block: start copying scaled (m,) into ``copy``.
__device__ __forceinline__ void start_scaled_copy(const Args& p, float* copy) {
  const int t = threadIdx.x, n = blockDim.x;
  if (p.vec16 && p.m % 4 == 0) {
    for (int i = 4 * t; i < p.m; i += 4 * n) cp_async16(copy + i, p.scaled + i);
  } else {
    for (int i = t; i < p.m; i += n) cp_async4(copy + i, p.scaled + i);
  }
}

// Writes one lane's x (masked), a*x and the sums, in pass 2.
template <bool WANT_X>
__device__ __forceinline__ void emit_lane(const Args& p, size_t idx, int l, int len, float w, float av, float cv,
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

// identity / box / cone: elementwise clamps, any L, a block per 128 columns.
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
      emit_lane<WANT_X>(p, idx, l, len, w, p.a[idx], p.c[idx], cx, xx);
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
template <int KIND, int LCAP, bool WANT_X>
__global__ void __launch_bounds__(THREADS) column_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.L, t = threadIdx.x;
  const size_t lanes = (size_t)L * THREADS;  // one array of a slab
  const float* table = p.scaled;  // here or in shared memory
  if (p.scaled_smem) {
    float* copy = smem + SLAB_ARRAYS * lanes + THREADS;
    start_scaled_copy(p, copy);
    table = copy;  // arrives with the first slab
  }
  const float nig = *p.neg_inv_gamma;
  const Proj proj{p.inequality, p.lo, p.hi, p.has_lo, p.has_hi, p.radius};
  for (int slab = blockIdx.x; slab < p.nparts; slab += gridDim.x) {
    start_slab_copy(p, smem, slab);
    cp_async_wait_all();
    __syncthreads();
    const int* sr = reinterpret_cast<const int*>(smem);
    const float* sa = smem + lanes;
    const float* sc = sa + lanes;
    const long long k = (long long)slab * THREADS + t;
    float cx = 0.f, xx = 0.f;
    if (k < p.K) {
      const int len = reinterpret_cast<const int*>(sc + lanes)[t];
      project_column<KIND, LCAP>(
          L, proj,
          [&](int l) {
            const int i = l * THREADS + t;
            return zform(sa[i], table[sr[i]], sc[i], nig);
          },
          [&](int l, float w) {
            const int i = l * THREADS + t;
            emit_lane<WANT_X>(p, (size_t)l * p.K + k, l, len, w, sa[i], sc[i], cx, xx);
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

// The same kinds for 64 < L <= 512, one warp per column: persistent blocks
// of WIDE_WARPS warps over groups of WIDE_WARPS adjacent columns; warp w of a
// block takes column group * WIDE_WARPS + w.
template <int KIND, bool WANT_X>
__device__ __forceinline__ void wide_warps(const Args& p) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.L, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* table = p.scaled;  // here or in shared memory
  if (p.scaled_smem) {
    start_scaled_copy(p, smem);
    cp_async_wait_all();
    __syncthreads();
    table = smem;
  }
  const float nig = *p.neg_inv_gamma;
  const Proj proj{p.inequality, p.lo, p.hi, p.has_lo, p.has_hi, p.radius};
  WarpReduce red;
  for (int grp = blockIdx.x; grp < p.nparts; grp += gridDim.x) {
    const long long k0 = (long long)grp * WIDE_WARPS, k = k0 + warp;
    float cx = 0.f, xx = 0.f;
    bool padding = k0 + WIDE_WARPS <= p.K;  // a whole group of padding columns (the tail of a tile)?
#pragma unroll
    for (int i = 0; i < WIDE_WARPS; ++i) padding = padding && p.length[k0 + i] == 0;
    if (padding) {  // zeros by whole sectors: each warp instruction 4 lane rows of the 8 columns
      constexpr int ROWS = 32;  // lane rows a pass of the block's 256 threads over 8 columns
      for (int l = threadIdx.x / WIDE_WARPS; l < L; l += ROWS) {
        const size_t idx = (size_t)l * p.K + k0 + threadIdx.x % WIDE_WARPS;
        p.ax[idx] = 0.f;
        if (WANT_X) p.x[idx] = 0.f;
      }
    } else if (k < p.K) {  // the whole warp, or none of it
      const int len = p.length[k];
      if (len == 0) {  // padding: x = 0 and a*x = 0 on every lane; nothing read
        for (int l = lane; l < L; l += 32) {
          const size_t idx = (size_t)l * p.K + k;
          p.ax[idx] = 0.f;
          if (WANT_X) p.x[idx] = 0.f;
        }
      } else {
        // a and c of the thread's lanes kept in registers from the first pass, so that the
        // emit only stores (a read there waits for the previous lane's store)
        float av[WIDE_REGS_LONG], cv[WIDE_REGS_LONG];
        const auto z = [&](int j, int l) {
          const size_t idx = (size_t)l * p.K + k;
          av[j] = p.a[idx];
          cv[j] = p.c[idx];
          return zform(av[j], table[p.rows[idx]], cv[j], nig);
        };
        const auto emit = [&](int j, int l, float w) {
          emit_lane<WANT_X>(p, (size_t)l * p.K + k, l, len, w, av[j], cv[j], cx, xx);
        };
        if (L <= 32 * WIDE_REGS) project_column_group<KIND, KeepRegs<WIDE_REGS>>(L, proj, red, nullptr, z, emit);
        else project_column_group<KIND, KeepRegs<WIDE_REGS_LONG>>(L, proj, red, nullptr, z, emit);
      }
    }
    block_sum2(cx, xx);
    if (threadIdx.x == 0) {
      p.partials[2 * grp] = cx;
      p.partials[2 * grp + 1] = xx;
    }
  }
}

// One real column k of the block form, its lanes kept as ``Keep`` says; with
// BLOCK_REGS lanes a thread or fewer a and c are kept beside them, so that
// the emit only stores.
template <int KIND, class Keep, bool WANT_X, class Reduce>
__device__ __forceinline__ void block_column(const Args& p, long long k, int len, float nig, const Proj& proj,
                                             Reduce& red, float* stretch, float& cx, float& xx) {
  constexpr int N = Keep::n;
  constexpr bool KEEP_AC = N > 0 && N <= BLOCK_REGS;
  [[maybe_unused]] float av[KEEP_AC ? N : 1], cv[KEEP_AC ? N : 1];
  const auto z = [&](int j, int l) {
    const size_t idx = (size_t)l * p.K + k;
    const float a = p.a[idx], c = p.c[idx];
    if constexpr (KEEP_AC) {
      av[j] = a;
      cv[j] = c;
    }
    return zform(a, p.scaled[p.rows[idx]], c, nig);
  };
  const auto emit = [&](int j, int l, float w) {
    const size_t idx = (size_t)l * p.K + k;
    if constexpr (KEEP_AC) emit_lane<WANT_X>(p, idx, l, len, w, av[j], cv[j], cx, xx);
    else emit_lane<WANT_X>(p, idx, l, len, w, p.a[idx], p.c[idx], cx, xx);
  };
  project_column_group<KIND, Keep>(p.L, proj, red, stretch, z, emit);
}

// The same kinds above L = 512, one block of T threads per column:
// persistent blocks walk the tile's columns, one partial a column.
template <int T, int KEEP, int KIND, bool WANT_X>
__device__ __forceinline__ void wide_block(const Args& p) {
  extern __shared__ __align__(16) float smem[];  // the column's lanes, where kept in shared memory
  __shared__ BlockTotals totals;
  BlockReduce<T> red(totals);
  const int L = p.L, t = threadIdx.x;
  const float nig = *p.neg_inv_gamma;
  const Proj proj{p.inequality, p.lo, p.hi, p.has_lo, p.has_hi, p.radius};
  for (long long k = blockIdx.x; k < p.K; k += gridDim.x) {
    const int len = p.length[k];
    float cx = 0.f, xx = 0.f;
    if (len == 0) {  // padding: x = 0 and a*x = 0 on every lane; nothing read
      // in a whole group of 8 padding columns each column's block writes an eighth of the group's lane
      // rows by whole sectors (4 lane rows of the 8 columns a warp instruction)
      const long long k0 = k - k % WIDE_WARPS;
      bool group = k0 + WIDE_WARPS <= p.K;
#pragma unroll
      for (int i = 0; i < WIDE_WARPS; ++i) group = group && p.length[k0 + i] == 0;
      const long long col = group ? k0 + t % WIDE_WARPS : k;
      const int first = group ? (int)(k % WIDE_WARPS) + WIDE_WARPS * (t / WIDE_WARPS) : t;
      for (int l = first; l < L; l += T) {
        const size_t idx = (size_t)l * p.K + col;
        p.ax[idx] = 0.f;
        if (WANT_X) p.x[idx] = 0.f;
      }
    } else {
      block_column<KIND, KeepOf<KEEP>, WANT_X>(p, k, len, nig, proj, red, smem, cx, xx);
      red.sum2(cx, xx);
    }
    if (t == 0) {
      p.partials[2 * k] = cx;
      p.partials[2 * k + 1] = xx;
    }
  }
}

// Simplex and box_cut above L = 64: a warp a column (T = 32, up to 512 lanes),
// or a block of T threads a column (above), its lanes kept as KEEP says.
template <int T, int KEEP, int KIND, bool WANT_X>
__global__ void __launch_bounds__(T == 32 ? WIDE_WARPS * 32 : T, T == 32 ? 1 : BLOCK_MAX / T) wide_kernel(Args p) {
  if constexpr (T == 32) wide_warps<KIND, WANT_X>(p);
  else wide_block<T, KEEP, KIND, WANT_X>(p);
  finish(p);
}

// Dynamic shared memory above the default 48 KB (static included) needs an
// opt-in per kernel.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The column kernel's slab: rows, a and c (L x THREADS each) and
// THREADS lengths.
size_t slab_bytes(int L) { return (size_t)(SLAB_ARRAYS * L + 1) * THREADS * sizeof(float); }

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

// A persistent kernel: as many blocks as the SMs hold at once, at most one
// per unit of work (slab, column group or column).
template <class Kernel>
cudaError_t launch_persistent(Kernel kernel, int threads, size_t smem, const Args& p, cudaStream_t s) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * sm_count();
  kernel<<<(int)(p.nparts < resident ? p.nparts : resident), threads, smem, s>>>(p);
  return cudaSuccess;
}

size_t scaled_bytes(const Args& p) { return p.scaled_smem ? (size_t)p.m * sizeof(float) : 0; }

template <int KIND, int LCAP, bool WANT_X>
cudaError_t launch_column(const Args& p, cudaStream_t s) {
  return launch_persistent(column_kernel<KIND, LCAP, WANT_X>, THREADS, slab_bytes(p.L) + scaled_bytes(p), p,
                           s);
}

template <int T, int KEEP, int KIND, bool WANT_X>
cudaError_t launch_block(const Args& p, cudaStream_t s) {
  const size_t smem = KEEP == SHARED ? (size_t)p.L * sizeof(float) : 0;
  return launch_persistent(wide_kernel<T, KEEP, KIND, WANT_X>, T, smem, p, s);
}

template <int KIND, bool WANT_X>
cudaError_t launch_projection(const Args& p, cudaStream_t s) {
  const int L = p.L;
  if (L > REG_L_CAP) {
    switch (wide_threads(L)) {
      case 32:
        return launch_persistent(wide_kernel<32, REGS, KIND, WANT_X>, WIDE_WARPS * 32, scaled_bytes(p), p,
                                 s);
      case 128: return launch_block<128, REGS, KIND, WANT_X>(p, s);
      case 256: return launch_block<256, REGS, KIND, WANT_X>(p, s);
      case 512: return launch_block<512, REGS, KIND, WANT_X>(p, s);
    }
    switch (block_keep(L)) {
      case REGS: return launch_block<BLOCK_MAX, REGS, KIND, WANT_X>(p, s);
      case REGS_LONG: return launch_block<BLOCK_MAX, REGS_LONG, KIND, WANT_X>(p, s);
      case SHARED: return launch_block<BLOCK_MAX, SHARED, KIND, WANT_X>(p, s);
      default: return launch_block<BLOCK_MAX, NONE, KIND, WANT_X>(p, s);
    }
  }
  if (L <= 1) return launch_column<KIND, 1, WANT_X>(p, s);
  if (L <= 2) return launch_column<KIND, 2, WANT_X>(p, s);
  if (L <= 4) return launch_column<KIND, 4, WANT_X>(p, s);
  if (L <= 8) return launch_column<KIND, 8, WANT_X>(p, s);
  if (L <= 16) return launch_column<KIND, 16, WANT_X>(p, s);
  if (L <= 32) return launch_column<KIND, 32, WANT_X>(p, s);
  return launch_column<KIND, 64, WANT_X>(p, s);
}

template <bool WANT_X>
cudaError_t launch(int kind, const Args& p, cudaStream_t s) {
  if (kind == CLAMP) {
    clamp_kernel<WANT_X><<<p.nparts, THREADS, 0, s>>>(p);
    return cudaSuccess;
  }
  if (kind == SIMPLEX) return launch_projection<SIMPLEX, WANT_X>(p, s);
  return launch_projection<BOXCUT, WANT_X>(p, s);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// ``rows`` (L, K) int32 indexes ``scaled`` (m,) float32.
extern "C" int dualip_fused_tile_eval(
    const int* rows, const float* scaled, int m, const float* a, const float* c, const int* length,
    const float* neg_inv_gamma, float* ax, float* x, float* partials, float* out,
    int L, int K, int nb, int kind, int want_x, int inequality,
    float lo, float hi, int has_lo, int has_hi, float radius, void* stream) {
  if (L < 1 || K < 1 || kind < CLAMP || kind > BOXCUT || (want_x && x == nullptr) || scaled == nullptr || m < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = kind != CLAMP && L > REG_L_CAP;  // any L: past SMEM_LIMIT the block form keeps no lanes
  const bool block = wide && wide_threads(L) > 32;
  const int expected_nb = block ? K : wide ? (K + WIDE_WARPS - 1) / WIDE_WARPS : (K + THREADS - 1) / THREADS;
  if (nb != expected_nb) return (int)cudaErrorInvalidValue;

  const int vec16 = K % 4 == 0 && aligned16(rows) && aligned16(a) && aligned16(c) && aligned16(length) &&
                    aligned16(scaled);
  const int scaled_smem = !block && (size_t)m * sizeof(float) <= SCALED_SMEM_BYTES &&
                          (wide ? 0 : slab_bytes(L)) + (size_t)m * sizeof(float) <= SMEM_LIMIT;
  Args p{rows, scaled, m, a, c, length, neg_inv_gamma, ax, x, partials, out,
         L, (long long)K, nb, inequality, lo, hi, has_lo, has_hi, radius, vec16, scaled_smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = want_x ? launch<true>(kind, p, s) : launch<false>(kind, p, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
