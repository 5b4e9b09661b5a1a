// Device functions shared by the fused tile kernel (fused_matching.cu, K1/K2)
// and the panel kernel (panel_matching.cu, K3/K4): the per-column projection
// of dualip_tpu/ops/pallas_matching.py::_project_block by a group of threads
// (project_column_group: one thread, one warp for the kernels' wide columns,
// one block for the widest, with the rule that sizes the block), the same by
// one thread holding its column in
// registers (project_column, the narrow columns), and the block-wide sum of
// the per-thread (sum c*x, sum x*x) pairs.
//
// Exact numerics of _project_block, the same in every kernel that includes
// this header (only the order of the lane sums differs between the group
// sizes, see project_column_group): z is formed by the caller as two rounded
// products and a rounded sum (no FMA contraction); simplex runs 30 bisection
// steps on [-1, 0] of the max-shifted, radius-normalised, pre-clamped values
// with the "s > 1" test, the top-2 vertex shortcut with argmax taking the
// FIRST maximum, and the inequality pass-through against radius + 1e-6;
// box_cut is bracketed by [min(z) - u, max(z) - l]. Padding lanes take part as z = 0 and are masked
// by the caller's emit.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace dualip {

constexpr int BISECTION_ITERS = 30;
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

// v / radius, rounded. v / 1 is v exactly, so for the unit simplex the
// division (a sequence of instructions, not one) is skipped, same bits.
__device__ __forceinline__ float div_radius(float v, float radius) {
  return radius == 1.f ? v : __fdiv_rn(v, radius);
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

// One column of L <= LCAP lanes kept in registers, one thread. ``z_at(l)``
// returns z of lane l (it may be called twice for a lane; it must return the
// same value); ``emit(l, w)`` receives the projected, not yet length-masked
// value. The same tests, products and sums in the same order, and so the
// same bits, as project_column_group with a ThreadReduce and KeepRegs<LCAP>;
// written out on its own because the compiler allocates that instance worse
// (-Xptxas -v, sm_90a): K1's column_kernel<SIMPLEX, 16> took 64 registers and
// spilled 4 B against 80 and none here, and K3's panel_tiles_kernel spilled
// 48-264 B more.
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
        r[l] = div_radius(v, radius);
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

// ---------------------------------------------------------------------------
// Where a group keeps what the passes need of a lane (z formed once by the
// caller's ``z_at``): in registers (KeepRegs<N>, L <= T N, the passes
// unrolled over N), in the group's own stretch of shared memory (KeepShared,
// lane l at s[l], so a warp's 32 threads hit 32 banks), or nowhere
// (KeepNone: every pass calls z_at again, the group's reads in parallel).

template <int N>
struct KeepRegs {  // lanes in registers: L <= T * N
  static constexpr int n = N;
  static constexpr bool kept = true;
  float r[N];
  __device__ __forceinline__ explicit KeepRegs(float*) {}
  __device__ __forceinline__ float get(int j, int) const { return r[j]; }
  __device__ __forceinline__ void set(int j, int, float v) { r[j] = v; }
};

struct KeepShared {  // lanes in the group's stretch of shared memory, L floats
  static constexpr int n = 0;
  static constexpr bool kept = true;
  float* s;
  __device__ __forceinline__ explicit KeepShared(float* stretch) : s(stretch) {}
  __device__ __forceinline__ float get(int, int l) const { return s[l]; }
  __device__ __forceinline__ void set(int, int l, float v) { s[l] = v; }
};

struct KeepNone {  // nothing kept: z formed again on every pass
  static constexpr int n = 0;
  static constexpr bool kept = false;
  __device__ __forceinline__ explicit KeepNone(float*) {}
  __device__ __forceinline__ float get(int, int) const { return 0.f; }
  __device__ __forceinline__ void set(int, int, float) {}
};

// The calling thread's rank t in its group of T threads (threadIdx.x % T):
// 0 alone, its lane in a warp, threadIdx.x in a block (the block is the group).
template <int T>
__device__ __forceinline__ int group_rank() {
  if constexpr (T == 1) return 0;
  else if constexpr (T == 32) return threadIdx.x & 31;
  else return threadIdx.x;
}

// f(j, l) for the thread's lanes l = t + T j < L: unrolled over N (compile
// time, so a register array stays in registers), or a loop when N = 0.
template <int N, int T, class F>
__device__ __forceinline__ void group_lanes(int L, F f) {
  const int t = group_rank<T>();
  if constexpr (N > 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (T * j + t < L) f(j, T * j + t);
    }
  } else {
    for (int j = 0, l = t; l < L; ++j, l += T) f(j, l);
  }
}

// f(j, l, z_at(j, l)) for the thread's lanes: the pass that forms z. In a
// group, all N lanes (registers) or Z_BATCH lanes (a loop) at a time, their
// z formed before f runs on any of them, so that their loads (for a gather,
// two dependent ones a lane) are in flight together: f may store into shared
// memory, which the compiler cannot tell apart from the loads' memory. A
// thread alone keeps nothing in memory and takes its lanes one at a time.
constexpr int Z_BATCH = 8;

template <int N, int T, class ZAt, class F>
__device__ __forceinline__ void group_lanes_z(int L, ZAt z_at, F f) {
  const int t = group_rank<T>();
  constexpr int B = T == 1 ? 1 : N > 0 ? N : Z_BATCH;
  const auto batch = [&](int j0) {
    float z[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int l = T * (j0 + b) + t;
      z[b] = l < L ? z_at(j0 + b, l) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int l = T * (j0 + b) + t;
      if (l < L) f(j0 + b, l, z[b]);
    }
  };
  if constexpr (N > 0) {
    static_assert(N % B == 0, "whole batches");
#pragma unroll
    for (int j0 = 0; j0 < N; j0 += B) batch(j0);
  } else {
    for (int j0 = 0; T * j0 < L; j0 += B) batch(j0);
  }
}

// ---------------------------------------------------------------------------
// Reductions across a group: the max with its FIRST lane and a sum
// (argmax_sum), a max, a sum, and box_cut's (min, max, sum). Every thread of
// the group calls each, with the same column, and receives the same bits
// (each step adds or compares the same two values on both sides), so all
// take the same branch.

// A thread alone: its own values are the group's.
struct ThreadReduce {
  static constexpr int GROUP = 1;
  __device__ __forceinline__ void argmax_sum(float&, int&, float&) {}
  __device__ __forceinline__ float max(float v) { return v; }
  __device__ __forceinline__ float sum(float v) { return v; }
  __device__ __forceinline__ void min_max_sum(float&, float&, float&) {}
};

__device__ __forceinline__ float warp_all_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float warp_all_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_all_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// (max, its first lane) across the warp; a thread without lanes holds (-inf, INT_MAX).
__device__ __forceinline__ void warp_all_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, off);
    const int i2 = __shfl_xor_sync(FULL, i, off);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
}

// A warp: a butterfly of __shfl_xor_sync, with no block barrier.
struct WarpReduce {
  static constexpr int GROUP = 32;
  __device__ __forceinline__ void argmax_sum(float& v, int& i, float& u) {
    warp_all_argmax(v, i);
    u = warp_all_sum(u);
  }
  __device__ __forceinline__ float max(float v) { return warp_all_max(v); }
  __device__ __forceinline__ float sum(float v) { return warp_all_sum(v); }
  __device__ __forceinline__ void min_max_sum(float& a, float& b, float& u) {
    a = warp_all_min(a);
    b = warp_all_max(b);
    u = warp_all_sum(u);
  }
};

// The warps' totals of a block's reductions: two alternating slots of up to
// three floats and an int a warp.
struct BlockTotals {
  float f[2][3][32];
  int i[2][32];
};

// A block of T threads, in two stages: a warp butterfly, then the warps'
// totals, which lane 0 of each warp stores in shared memory; after one
// barrier every warp reduces them by the same butterfly (lane w holds warp
// w's total). Two slots alternate, so each reduction, and so each bisection
// step, takes one barrier: a slot is written again two reductions later, once
// every thread has passed the barrier of the reduction between, after its
// last read of the slot. One object a block, kept across its columns: the
// slots alternate from one reduction to the next, whichever column it
// belongs to.
template <int T>
class BlockReduce {
 public:
  static constexpr int GROUP = T;
  static constexpr int WARPS = T / 32;
  static_assert(T % 32 == 0 && WARPS >= 2 && WARPS <= 32 && (WARPS & (WARPS - 1)) == 0,
                "a block of 2 to 32 warps, a power of two");

  __device__ __forceinline__ explicit BlockReduce(BlockTotals& s)
      : s_(s), lane_(threadIdx.x & 31), warp_(threadIdx.x >> 5) {}

  __device__ __forceinline__ float sum(float v) {
    v = warp_all_sum(v);
    put(0, v);
    __syncthreads();
    v = get(0, 0.f);
    slot_ ^= 1;
    return across_sum(v);
  }

  // two sums at once
  __device__ __forceinline__ void sum2(float& u, float& v) {
    u = warp_all_sum(u);
    v = warp_all_sum(v);
    put(0, u);
    put(1, v);
    __syncthreads();
    u = get(0, 0.f);
    v = get(1, 0.f);
    slot_ ^= 1;
    u = across_sum(u);
    v = across_sum(v);
  }

  __device__ __forceinline__ float max(float v) {
    v = warp_all_max(v);
    put(0, v);
    __syncthreads();
    v = get(0, -CUDART_INF_F);
    slot_ ^= 1;
    return across_max(v);
  }

  // (max with its FIRST lane, sum); a thread without lanes holds (-inf, INT_MAX, 0)
  __device__ __forceinline__ void argmax_sum(float& v, int& i, float& u) {
    warp_all_argmax(v, i);
    u = warp_all_sum(u);
    put(0, v);
    put(1, u);
    if (lane_ == 0) s_.i[slot_][warp_] = i;
    __syncthreads();
    v = get(0, -CUDART_INF_F);
    u = get(1, 0.f);
    i = lane_ < WARPS ? s_.i[slot_][lane_] : INT_MAX;
    slot_ ^= 1;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const float v2 = __shfl_xor_sync(FULL, v, off);
      const int i2 = __shfl_xor_sync(FULL, i, off);
      if (v2 > v || (v2 == v && i2 < i)) {
        v = v2;
        i = i2;
      }
    }
    v = __shfl_sync(FULL, v, 0);
    i = __shfl_sync(FULL, i, 0);
    u = across_sum(u);
  }

  // (min, max, sum)
  __device__ __forceinline__ void min_max_sum(float& a, float& b, float& u) {
    a = warp_all_min(a);
    b = warp_all_max(b);
    u = warp_all_sum(u);
    put(0, a);
    put(1, b);
    put(2, u);
    __syncthreads();
    a = get(0, CUDART_INF_F);
    b = get(1, -CUDART_INF_F);
    u = get(2, 0.f);
    slot_ ^= 1;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) a = fminf(a, __shfl_xor_sync(FULL, a, off));
    a = __shfl_sync(FULL, a, 0);
    b = across_max(b);
    u = across_sum(u);
  }

 private:
  BlockTotals& s_;
  const int lane_, warp_;
  int slot_ = 0;

  __device__ __forceinline__ void put(int q, float v) {
    if (lane_ == 0) s_.f[slot_][q][warp_] = v;
  }
  // lane w: warp w's total; lanes past the block's warps: ``none``
  __device__ __forceinline__ float get(int q, float none) const {
    return lane_ < WARPS ? s_.f[slot_][q][lane_] : none;
  }
  // the butterfly over the warps' totals in lanes 0 .. WARPS - 1, then lane 0's to every lane
  static __device__ __forceinline__ float across_sum(float v) {
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
    return __shfl_sync(FULL, v, 0);
  }
  static __device__ __forceinline__ float across_max(float v) {
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
    return __shfl_sync(FULL, v, 0);
  }
};

// ---------------------------------------------------------------------------
// The BISECTION_ITERS halvings of [lo, hi], ``above(mid)`` true where the
// root lies above mid; returns the last bracket's midpoint. ROLLED keeps the
// loop rolled (a group runs a column's steps alone: a short loop stays in the
// instruction cache); a thread's loop is left to the compiler.
template <bool ROLLED, class Above>
__device__ __forceinline__ float bisect(float lo, float hi, Above above) {
  const auto step = [&] {
    const float mid = (lo + hi) * 0.5f;
    if (above(mid)) lo = mid; else hi = mid;
  };
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int it = 0; it < BISECTION_ITERS; ++it) step();
  } else {
    for (int it = 0; it < BISECTION_ITERS; ++it) step();
  }
  return (lo + hi) * 0.5f;
}

// One column of any L, projected by the group of ``red`` (Reduce::GROUP = T
// threads: ThreadReduce, WarpReduce or a block's BlockReduce<T>; the whole
// group calls, with the same column). Thread t of the group holds lanes
// t, t + T, ...; what the passes need of a lane stays as ``Keep`` says.
// ``stretch`` is the group's shared memory for KeepShared (L floats), ignored
// otherwise. ``z_at(j, l)`` returns z of lane l (it may be called again for a
// lane; it must return the same value) and ``emit(j, l, w)`` receives the
// projected, not yet length-masked value; both take the lane l and its place
// j among the thread's lanes (known at compile time where the passes are
// unrolled, so a caller may keep what it read of a lane in registers of its
// own).
//
// The tests, products and branches are the same for every T. Only the order
// of the lane sums follows the group: a thread adds its lanes in order (lane
// order, for a thread alone), then the group's Reduce combines the threads'
// sums (a butterfly across the warp; then one across the block's warps). A
// sum of L terms then moves by at most about L * 2^-24 of its magnitude; a
// bisection test "s > 1" flips only where mid already lies that close to the
// root (s falls with slope <= -1 in mid wherever it crosses 1), so nu, x and
// a*x move by about L * 2^-24 * radius (2.3e-5 at L = 394, radius 1), and the
// inequality pass-through flips only for a column whose sum lies within that
// of radius + 1e-6. Against the plain version (which adds in lane order) the
// kernels' groups are held to 5e-5 * max(1, max|x|) on a*x and x.
template <int KIND, class Keep, class Reduce, class ZAt, class Emit>
__device__ __forceinline__ void project_column_group(int L, const Proj& p, Reduce& red, float* stretch, ZAt z_at,
                                                     Emit emit) {
  constexpr int T = Reduce::GROUP, N = Keep::n;
  constexpr bool ALONE = T == 1;
  Keep keep(stretch);
  if constexpr (KIND == SIMPLEX) {
    const float radius = p.radius;
    float vmax = -CUDART_INF_F, sumv = 0.f;
    int i0 = ALONE ? 0 : INT_MAX;  // in a group, a thread without lanes loses the argmax
    group_lanes_z<N, T>(L, z_at, [&](int j, int l, float z) {
      const float v = fmaxf(z, 0.f);
      sumv += v;
      const float vn = div_radius(v, radius);
      keep.set(j, l, vn);
      if (vn > vmax) {  // strict: the thread's first maximum
        vmax = vn;
        i0 = l;
      }
    });
    red.argmax_sum(vmax, i0, sumv);
    const auto vn_at = [&](int j, int l) {
      return Keep::kept ? keep.get(j, l) : div_radius(fmaxf(z_at(j, l), 0.f), radius);
    };
    float v1 = -CUDART_INF_F;
    group_lanes<N, T>(L, [&](int j, int l) {
      const float vn = vn_at(j, l);
      if (l != i0) v1 = fmaxf(v1, vn);
      keep.set(j, l, vn - vmax);
    });
    v1 = red.max(v1);
    const auto r_at = [&](int j, int l) { return Keep::kept ? keep.get(j, l) : vn_at(j, l) - vmax; };
    const float nu = bisect<!ALONE>(-1.f, 0.f, [&](float mid) {
      float s = 0.f;
      group_lanes<N, T>(L, [&](int j, int l) { s += fmaxf(r_at(j, l) - mid, 0.f); });
      return red.sum(s) > 1.0f;
    });
    const bool shortcut = L > 1 && (vmax - v1) > 1.0f;
    const bool feasible = p.inequality && sumv <= radius + 1e-6f;
    group_lanes<N, T>(L, [&](int j, int l) {
      float w;
      if (feasible) w = fmaxf(z_at(j, l), 0.f);
      else if (shortcut) w = (l == i0) ? radius : 0.f;
      else w = __fmul_rn(fmaxf(r_at(j, l) - nu, 0.f), radius);
      emit(j, l, w);
    });
  } else {  // BOXCUT
    const float lt = p.lo, ut = p.hi, zcut = p.radius;
    float zmin = CUDART_INF_F, zmax = -CUDART_INF_F, sumclip = 0.f;
    group_lanes_z<N, T>(L, z_at, [&](int j, int l, float z) {
      keep.set(j, l, z);
      zmin = fminf(zmin, z);
      zmax = fmaxf(zmax, z);
      sumclip += clip(z, lt, ut);
    });
    red.min_max_sum(zmin, zmax, sumclip);
    const auto z_of = [&](int j, int l) { return Keep::kept ? keep.get(j, l) : z_at(j, l); };
    const float nu = bisect<!ALONE>(zmin - ut, zmax - lt, [&](float mid) {
      float s = 0.f;
      group_lanes<N, T>(L, [&](int j, int l) { s += clip(z_of(j, l) - mid, lt, ut); });
      return red.sum(s) > zcut;
    });
    const bool feasible = p.inequality && sumclip <= zcut + 1e-6f;
    group_lanes<N, T>(L, [&](int j, int l) {
      const float z = z_of(j, l);
      emit(j, l, feasible ? clip(z, lt, ut) : clip(z - nu, lt, ut));
    });
  }
}

// ---------------------------------------------------------------------------
// A block a column (K1's wide_kernel and K3's block form, columns above 512
// lanes): the fewest threads, a power of two up to BLOCK_MAX, that hold the
// lanes in registers at BLOCK_REGS a thread (block_threads); the largest
// block keeps them as block_keep says. Each kernel takes one instance a keep,
// so that one keep's registers do not spill another's.
// ops/fused_matching.py::_block_rule mirrors both.
constexpr int BLOCK_REGS = 8;         // lanes a thread in registers, a and c kept beside them
constexpr int BLOCK_REGS_LONG = 16;   // ... z alone, 16 lanes a thread of the largest block, up to 16,384 lanes
constexpr int BLOCK_MAX = 1024;       // threads of the largest block
constexpr int SMEM_LIMIT = 226 * 1024;  // dynamic shared memory of one block (227 KB less the static part)

inline int block_threads(int L) {
  int t = 32;
  while (t < BLOCK_MAX && t * BLOCK_REGS < L) t *= 2;
  return t;
}

// Where the largest block keeps its column's lanes (every smaller block keeps
// them in registers, BLOCK_REGS a thread): registers, then z alone in
// registers, then the block's shared memory, then nowhere (z formed again on
// every pass).
enum BlockKeep { REGS = 0, REGS_LONG = 1, SHARED = 2, NONE = 3 };

inline int block_keep(int L) {
  if (L <= BLOCK_MAX * BLOCK_REGS) return REGS;
  if (L <= BLOCK_MAX * BLOCK_REGS_LONG) return REGS_LONG;
  return (size_t)L * sizeof(float) <= SMEM_LIMIT ? SHARED : NONE;
}

template <int KEEP>
using KeepOf = std::conditional_t<KEEP == REGS, KeepRegs<BLOCK_REGS>,
                                  std::conditional_t<KEEP == REGS_LONG, KeepRegs<BLOCK_REGS_LONG>,
                                                     std::conditional_t<KEEP == SHARED, KeepShared, KeepNone>>>;

// One column, one warp, with the lanes kept where they fit: in registers up
// to 32 * NREG lanes, else in the warp's ``stretch`` of shared memory (room
// for ``room`` lanes), else nowhere.
template <int KIND, int NREG, class ZAt, class Emit>
__device__ __forceinline__ void project_column_warp_any(int L, const Proj& p, float* stretch, int room, ZAt z_at,
                                                        Emit emit) {
  WarpReduce warp;
  if (L <= 32 * NREG) project_column_group<KIND, KeepRegs<NREG>>(L, p, warp, stretch, z_at, emit);
  else if (L <= room) project_column_group<KIND, KeepShared>(L, p, warp, stretch, z_at, emit);
  else project_column_group<KIND, KeepNone>(L, p, warp, stretch, z_at, emit);
}

}  // namespace dualip
