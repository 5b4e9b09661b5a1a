// The three Benes-network kernels for Hopper: fine stages (K5), one coarse
// group (K6), one whole two-axis coarse side (K7).
//
// Replaces dualip_tpu/ops/butterfly.py::_fine_kernel (K5), ::_coarse_kernel
// (K6) and ::_coarse2_kernel (K7). A stage at distance d on the flat (N,)
// carry buffer is  out[i] = mask[i] ? in[i ^ d] : in[i];  the stages do no
// arithmetic, so 4-byte (fp32) and 2-byte (bf16) payloads pass through
// unchanged. Masks are bit-packed 8 stages per uint8 plane, (P, N) flat, as
// pack_plan lays them out; a launch is handed its stages in execution order
// (the wrapper walks them backwards for ``reverse``; masks are never flipped).
//
// What bounds them on an H100: device memory. Each kernel reads and writes the
// payload once (8 B per fp32 slot) and reads its mask planes once
// (ceil(stages/8) B per slot); there is no arithmetic.
//
// Design (the TPU kernels keep a 512 KB block or a 4 MB strip in VMEM; a
// Hopper block has at most 227 KB of shared memory, so the pieces are smaller):
//  * Every kernel runs ALL stages of its group in one launch on a piece of the
//    buffer held in shared memory: read once, exchanged in place, written once.
//  * A stage pairs shared-memory indices that differ in one bit. Stages are
//    run in WINDOWS: up to 8 consecutive stages of one mask plane whose bits
//    span at most 4 positions [k, k+4). A thread takes the 16 slots that
//    differ in those bits into registers, with their mask bytes, runs the
//    window's stages there, and writes the 16 slots back: one shared-memory
//    round trip and one barrier per window instead of per stage (29 fine
//    stages are 9 windows). Within a window no slot is touched by two threads.
//  * Shared memory is XOR-swizzled in 16-byte units so that the strided slots
//    of a window fall into different banks; 16-byte copies stay whole.
//  * K5: the piece is one block of 2^block_log2 consecutive slots (128 KB in
//    fp32 at the port's default 2^15). Its mask planes are staged one at a
//    time (a plane serves 8 stages), so payload + one plane fit together.
//  * K6: the piece is a strip (E, W) of the (O, E, inner) view: all E
//    positions of the exchange axis, W consecutive lanes (W as narrow as
//    shared memory asks, at most one 128 B line), copied with 16-byte
//    accesses. All planes of the group are staged with the payload.
//  * K7: the piece is a strip (E_hi, E_lo, W) of the (O2, E_hi, E_lo, inner)
//    view; a stage exchanges along E_hi or along E_lo. When the whole
//    (E_hi, E_lo) side does not fit in shared memory at one 32 B sector of
//    lanes, the wrapper runs the E_hi stages and the E_lo stages as two
//    launches, each over a strip (E_hi, 1, W) or (1, E_lo, W).
//  * K6 and K7 are one CUDA kernel and one C entry point: K6's strip is the
//    case E_hi = 1 of K7's. The Python wrappers fill the geometry.
//
// C interface: each function launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CMAX = 4;          // a window spans at most 4 bit positions: 16 slots a thread
constexpr int MAX_STAGES = 8;    // stages of a window: one mask plane holds 8
constexpr int MAX_WINDOWS = 32;  // a launch: at most 64 stages, at least 2 a window but for plane ends
constexpr int MAX_THREADS = 1024;
constexpr size_t SMEM_LIMIT = 227 * 1024;

// Consecutive stages on one mask plane whose paired bits lie in [k, k + c).
struct Window {
  unsigned char k, c, plane, n;
  unsigned char t[MAX_STAGES];    // stage s pairs bit k + t[s]
  unsigned char bit[MAX_STAGES];  // and reads mask bit bit[s] of the plane
};

struct Steps {
  int n;
  Window w[MAX_WINDOWS];
};

// Shared-memory position of slot i: 16-byte units are XORed within their
// 128-byte row by bits of the row number, so slots a power-of-two stride apart
// spread over the banks. A bijection on every aligned 128-byte row.
template <typename T>
__device__ __forceinline__ int swz(int i) {
  constexpr int SH = sizeof(T) == 4 ? 2 : 3;  // log2 slots per 16 bytes
  return i ^ ((((i >> (SH + 3)) ^ (i >> (SH + 6))) & 7) << SH);
}

// One stage on the R slots a thread holds: pairs differ in bit TB.
template <typename T, int R, int TB>
__device__ __forceinline__ void stage(T (&r)[R], const uint8_t (&m)[R], int bit) {
  const unsigned bm = 1u << bit;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (!(j & (1 << TB))) {
      const int j2 = j | (1 << TB);
      const T a = r[j], b = r[j2];
      r[j] = (m[j] & bm) ? b : a;
      r[j2] = (m[j2] & bm) ? a : b;
    }
  }
}

// One window on the n slots of x (swizzled); mk is the window's mask plane
// (not swizzled). Group g holds the 2^C slots base + (j << k).
template <typename T, int C>
__device__ __forceinline__ void run_window(T* x, const uint8_t* mk, int n, const Window& w) {
  constexpr int R = 1 << C;
  const int k = w.k, low = (1 << k) - 1;
  for (int g = threadIdx.x; g < (n >> C); g += blockDim.x) {
    const int base = ((g & ~low) << C) | (g & low);
    T r[R];
    uint8_t m[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = base + (j << k);
      r[j] = x[swz<T>(i)];
      m[j] = mk[i];
    }
    for (int s = 0; s < w.n; ++s) {
      const int bit = w.bit[s];
      switch (w.t[s]) {
        case 0: stage<T, R, 0>(r, m, bit); break;
        case 1: if constexpr (C > 1) stage<T, R, 1>(r, m, bit); break;
        case 2: if constexpr (C > 2) stage<T, R, 2>(r, m, bit); break;
        default: if constexpr (C > 3) stage<T, R, 3>(r, m, bit); break;
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) x[swz<T>(base + (j << k))] = r[j];
  }
}

template <typename T>
__device__ __forceinline__ void run_window_any(T* x, const uint8_t* mk, int n, const Window& w) {
  switch (w.c) {
    case 1: run_window<T, 1>(x, mk, n, w); break;
    case 2: run_window<T, 2>(x, mk, n, w); break;
    case 3: run_window<T, 3>(x, mk, n, w); break;
    default: run_window<T, 4>(x, mk, n, w); break;
  }
}

// K5: all fine stages of block blockIdx.x (2^bs_log2 consecutive slots).
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) fine_kernel(
    T* v, const uint8_t* masks, long long N, int bs_log2, Steps st) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PER16 = 16 / sizeof(T);
  const int bs = 1 << bs_log2;
  T* x = reinterpret_cast<T*>(smem);
  uint8_t* mk = smem + sizeof(T) * (size_t)bs;
  const long long base = (long long)blockIdx.x << bs_log2;

  {  // 16-byte copies: a block is at least 128 slots and 16-byte aligned
    const int4* src = reinterpret_cast<const int4*>(v + base);
#pragma unroll 4
    for (int q = threadIdx.x; q < bs / PER16; q += blockDim.x) {
      *reinterpret_cast<int4*>(x + swz<T>(q * PER16)) = src[q];
    }
  }
  int cur = -1;
  for (int s = 0; s < st.n; ++s) {
    const int plane = st.w[s].plane;
    __syncthreads();  // the previous window is written back, and has read the old plane
    if (plane != cur) {
      const int4* src = reinterpret_cast<const int4*>(masks + (long long)plane * N + base);
      int4* dst = reinterpret_cast<int4*>(mk);
#pragma unroll 4
      for (int q = threadIdx.x; q < bs / 16; q += blockDim.x) dst[q] = src[q];
      cur = plane;
      __syncthreads();
    }
    run_window_any(x, mk, bs, st.w[s]);
  }
  __syncthreads();
  {
    int4* dst = reinterpret_cast<int4*>(v + base);
#pragma unroll 4
    for (int q = threadIdx.x; q < bs / PER16; q += blockDim.x) {
      dst[q] = *reinterpret_cast<const int4*>(x + swz<T>(q * PER16));
    }
  }
}

// Geometry of a coarse launch. The strip in shared memory is indexed
// [eh][el][w] with extents 2^eh_log2, 2^el_log2, 2^w_log2; in the buffer eh
// moves by sh slots, el by sl slots, w by one. The block index enumerates, from
// the fastest: the lane windows of ``inner``, the E_lo positions outside the
// strip, the E_hi positions outside the strip, and the outer index.
struct Strip {
  int eh_log2, el_log2, w_log2;
  long long sh, sl;
  int wb_log2;       // log2(inner / W)
  int lo_rest_log2;  // log2(E_lo / strip's E_lo extent)
  int hi_rest_log2;  // log2(E_hi / strip's E_hi extent)
  long long outer;   // slots per outer index: E_hi * E_lo * inner
  int planes;        // mask planes of the group
};

// Buffer offset of strip slot i (a multiple of the copy width).
__device__ __forceinline__ long long strip_at(const Strip& g, long long base, int i) {
  const int w = i & ((1 << g.w_log2) - 1), e = i >> g.w_log2;
  return base + (long long)(e >> g.el_log2) * g.sh + (long long)(e & ((1 << g.el_log2) - 1)) * g.sl + w;
}

// Copies the strip's mask planes into mk with accesses of sizeof(V) bytes
// (a run of W lanes is a multiple of that, and so aligned).
template <typename V>
__device__ __forceinline__ void load_planes(uint8_t* mk, const uint8_t* masks, long long N,
                                            const Strip& g, long long base, int n) {
  constexpr int B = sizeof(V);
  for (int p = 0; p < g.planes; ++p) {
    const uint8_t* src = masks + (long long)p * N;
#pragma unroll 4
    for (int q = threadIdx.x; q < n / B; q += blockDim.x) {
      *reinterpret_cast<V*>(mk + (size_t)p * n + q * B) =
          *reinterpret_cast<const V*>(src + strip_at(g, base, q * B));
    }
  }
}

template <typename T>
__device__ __forceinline__ void coarse_body(T* v, const uint8_t* masks, long long N, const Strip& g, const Steps& st) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PER16 = 16 / sizeof(T);
  const int n_log2 = g.eh_log2 + g.el_log2 + g.w_log2;
  const int n = 1 << n_log2;
  const int W = 1 << g.w_log2;
  T* x = reinterpret_cast<T*>(smem);
  uint8_t* mk = smem + sizeof(T) * (size_t)n;

  long long b = blockIdx.x;
  const long long wb = b & ((1LL << g.wb_log2) - 1);
  b >>= g.wb_log2;
  const long long el0 = b & ((1LL << g.lo_rest_log2) - 1);
  b >>= g.lo_rest_log2;
  const long long eh0 = b & ((1LL << g.hi_rest_log2) - 1);
  b >>= g.hi_rest_log2;
  const long long base = b * g.outer + eh0 * g.sh + el0 * g.sl + (wb << g.w_log2);

  const bool wide = W >= PER16;  // a run of W lanes holds whole 16-byte units
  if (wide) {
#pragma unroll 4
    for (int q = threadIdx.x; q < n / PER16; q += blockDim.x) {
      const int i = q * PER16;
      *reinterpret_cast<int4*>(x + swz<T>(i)) = *reinterpret_cast<const int4*>(v + strip_at(g, base, i));
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) x[swz<T>(i)] = v[strip_at(g, base, i)];
  }
  if (W >= 16) load_planes<int4>(mk, masks, N, g, base, n);
  else if (W >= 8) load_planes<int2>(mk, masks, N, g, base, n);
  else if (W >= 4) load_planes<int>(mk, masks, N, g, base, n);
  else load_planes<uint8_t>(mk, masks, N, g, base, n);

  for (int s = 0; s < st.n; ++s) {
    __syncthreads();
    run_window_any(x, mk + (size_t)st.w[s].plane * n, n, st.w[s]);
  }
  __syncthreads();
  if (wide) {
#pragma unroll 4
    for (int q = threadIdx.x; q < n / PER16; q += blockDim.x) {
      const int i = q * PER16;
      *reinterpret_cast<int4*>(v + strip_at(g, base, i)) = *reinterpret_cast<const int4*>(x + swz<T>(i));
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) v[strip_at(g, base, i)] = x[swz<T>(i)];
  }
}

// K6 and K7 are this one kernel. K6 (one single-axis group) is the strip
// (E, W) with eh extent 1; K7 (a two-axis side) is the strip (E_hi, E_lo, W),
// or one of the two axes alone when the side is run as two launches.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) coarse_kernel(T* v, const uint8_t* masks, long long N, Strip g, Steps st) {
  coarse_body(v, masks, N, g, st);
}

int ilog2(long long v) {
  int n = 0;
  while ((1LL << n) < v) ++n;
  return n;
}

bool pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

// Cuts the stage list (execution order; ``add`` turns a stage's log2 distance
// into its bit in shared-memory index units) into windows, greedily: a window
// grows while the plane stays, its bits span at most CMAX positions, and it
// has fewer than MAX_STAGES stages. Returns non-zero when the list does not fit.
int fill_steps(Steps& st, int n, const int* planes, const int* bits, const int* dlogs, int add) {
  if (n < 0) return 1;
  st.n = 0;
  for (int s = 0; s < n;) {
    if (st.n == MAX_WINDOWS) return 1;
    Window& w = st.w[st.n++];
    int lo = dlogs[s] + add, hi = lo, pos[MAX_STAGES], cnt = 0;
    w.plane = (unsigned char)planes[s];
    while (s < n && cnt < MAX_STAGES && planes[s] == w.plane) {
      const int b = dlogs[s] + add;
      const int nlo = b < lo ? b : lo, nhi = b > hi ? b : hi;
      if (nhi - nlo + 1 > CMAX) break;
      lo = nlo;
      hi = nhi;
      pos[cnt] = b;
      w.bit[cnt] = (unsigned char)bits[s];
      ++cnt;
      ++s;
    }
    w.k = (unsigned char)lo;
    w.c = (unsigned char)(hi - lo + 1);
    w.n = (unsigned char)cnt;
    for (int i = 0; i < cnt; ++i) w.t[i] = (unsigned char)(pos[i] - lo);
  }
  return 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Threads for a piece of n slots: one per group of 16, at least a warp.
int threads_for(long long n) {
  long long t = n >> CMAX;
  if (t < 32) t = 32;
  return (int)(t > MAX_THREADS ? MAX_THREADS : t);
}

template <typename T, typename K>
int launch_coarse(K kernel, void* v, const uint8_t* masks, long long N, const Strip& g, const Steps& st, cudaStream_t s) {
  const int n_log2 = g.eh_log2 + g.el_log2 + g.w_log2;
  const size_t smem = ((size_t)1 << n_log2) * (sizeof(T) + g.planes);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = N >> n_log2;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads_for(1LL << n_log2), smem, s>>>(static_cast<T*>(v), masks, N, g, st);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. ``dlogs`` are log2 of the stage distances in slots (all < 2^bs_log2).
extern "C" int dualip_benes_fine(
    void* v, const uint8_t* masks, long long N, int bs_log2, int elem_bytes,
    int n_steps, const int* planes, const int* bits, const int* dlogs, void* stream) {
  if (!pow2(N) || bs_log2 < 7 || (1LL << bs_log2) > N) return (int)cudaErrorInvalidValue;
  Steps st;
  if (fill_steps(st, n_steps, planes, bits, dlogs, 0)) return (int)cudaErrorInvalidValue;
  const size_t bs = (size_t)1 << bs_log2;
  const size_t smem = bs * elem_bytes + bs;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)(N >> bs_log2);
  const int threads = threads_for((long long)bs);
  cudaError_t e;
  if (elem_bytes == 4) {
    if ((e = allow_smem(fine_kernel<uint32_t>, smem)) != cudaSuccess) return (int)e;
    fine_kernel<uint32_t><<<blocks, threads, smem, s>>>(static_cast<uint32_t*>(v), masks, N, bs_log2, st);
  } else if (elem_bytes == 2) {
    if ((e = allow_smem(fine_kernel<uint16_t>, smem)) != cudaSuccess) return (int)e;
    fine_kernel<uint16_t><<<blocks, threads, smem, s>>>(static_cast<uint16_t*>(v), masks, N, bs_log2, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K6 and K7. View (O2, E_hi, E_lo, inner); a single-axis group (K6) is the
// case E_hi = 1 with its E as E_lo. ``n_planes`` mask planes in the group, W
// lanes per strip. ``axis`` 2: the strip holds both axes and
// ``qlogs`` are log2 of the block distances q (q >= E_lo exchanges along
// E_hi). ``axis`` 1: the strip holds E_hi alone and ``qlogs`` are log2 of
// q / E_lo. ``axis`` 0: the strip holds E_lo alone.
extern "C" int dualip_benes_coarse(
    void* v, const uint8_t* masks, long long N, long long E_hi, long long E_lo, long long inner,
    long long W, int axis, int n_planes, int elem_bytes,
    int n_steps, const int* planes, const int* bits, const int* qlogs, void* stream) {
  if (!pow2(N) || !pow2(E_hi) || !pow2(E_lo) || !pow2(inner) || !pow2(W) || W > inner ||
      E_hi * E_lo * inner > N || n_planes < 1 || axis < 0 || axis > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int hl = ilog2(E_hi), ll = ilog2(E_lo);
  Strip g;
  g.eh_log2 = axis >= 1 ? hl : 0;
  g.el_log2 = axis != 1 ? ll : 0;
  g.w_log2 = ilog2(W);
  g.sh = E_lo * inner;
  g.sl = inner;
  g.wb_log2 = ilog2(inner / W);
  g.lo_rest_log2 = ll - g.el_log2;
  g.hi_rest_log2 = hl - g.eh_log2;
  g.outer = E_hi * E_lo * inner;
  g.planes = n_planes;
  Steps st;
  // in shared memory E_lo (when present) sits just above the lanes and E_hi
  // above it, so a distance of 2^k in the strip's own axis units is bit
  // w_log2 + k: for axis 2 the block distance q counts E_lo positions already
  if (fill_steps(st, n_steps, planes, bits, qlogs, g.w_log2)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return launch_coarse<uint32_t>(coarse_kernel<uint32_t>, v, masks, N, g, st, s);
  if (elem_bytes == 2) return launch_coarse<uint16_t>(coarse_kernel<uint16_t>, v, masks, N, g, st, s);
  return (int)cudaErrorInvalidValue;
}
