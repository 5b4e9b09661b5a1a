// The three Benes-network kernels for Hopper: fine stages (K5), one coarse
// group (K6), one whole two-axis coarse side (K7).
//
// Replaces dualip_tpu/ops/butterfly.py::_fine_kernel (K5), ::_coarse_kernel
// (K6) and ::_coarse2_kernel (K7). A stage at distance d on the flat (N,)
// carry buffer is  out[i] = mask[i] ? in[i ^ d] : in[i];  the stages do no
// arithmetic, so 4-byte (fp32) and 2-byte (bf16) payloads pass through
// unchanged. Masks are bit-packed 8 stages per uint8 plane, (P, N) flat, as
// pack_plan lays them out.
//
// What bounds them on an H100: device memory. Each kernel reads and writes the
// payload once (8 B per fp32 slot) and reads what describes its permutation
// once; there is no arithmetic.
//
// K5 and K7 are GATHERS. The TPU has no gather hardware, so the JAX package
// walks the masks stage by stage; an H100 gathers from shared memory at full
// rate. The fine stages only permute within one block, and a two-axis coarse
// side only moves each lane across the block positions, so each launch's
// composed permutation is computed once per plan (ops/butterfly.py::
// build_index) as a 16-bit source index per slot and direction, in the
// payload's own layout. A launch is then one shared-memory round trip:
//  * K5 (fine_gather_kernel): one block of 2^block_log2 consecutive slots
//    (128 KB in fp32 at the port's default 2^15) is copied into shared memory
//    with bulk copies (TMA, cp.async.bulk) on an mbarrier while each thread
//    loads its slots' indices into registers; then out[o] = smem[src[o]],
//    written back in place in 16-byte stores.
//  * K7 (rows_gather_kernel): the (O, E, inner) view permuted along E per
//    lane; a strip of all E positions x W lanes (64 B per position, at most
//    2^15 slots) and its index rows are copied in by TMA as 2-D boxes
//    (tensor maps encoded per launch), then out[e][w] = smem[src[e][w]][w]:
//    a warp reads two rows of consecutive lanes, so a read conflicts at most
//    two ways at W = 16. A two-axis side whose strip does not fit (E = 8192)
//    runs as one launch per axis, each with its own index.
// No stage windows, no mask planes are read at run time.
//
// The WINDOW forms stay: fine_kernel and coarse_kernel run the
// stages themselves from the mask planes. coarse_kernel is K6 (a single-axis
// group; K6 and K7 no longer share a kernel), and both build the gather
// kernels' index, run once on an iota payload (they move 4-byte payloads of any
// type). Their design:
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
//  * fine_kernel: the piece is one block of 2^block_log2 consecutive slots.
//    Its mask planes are staged one at a time (a plane serves 8 stages), so
//    payload + one plane fit together. A launch is handed its stages in
//    execution order (the wrapper walks them backwards for ``reverse``).
//  * coarse_kernel: the piece is a strip (E_hi, E_lo, W) of the (O2, E_hi,
//    E_lo, inner) view (K6: E_hi = 1); a stage exchanges along E_hi or along
//    E_lo. When the whole (E_hi, E_lo) side does not fit in shared memory at
//    one 32 B sector of lanes, the wrapper runs the E_hi stages and the E_lo
//    stages as two launches, each over a strip (E_hi, 1, W) or (1, E_lo, W).
//    At most 512 threads: a 1024-thread block capped it at 64 registers and
//    it spilled.
//
// C interface: each function launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CMAX = 4;          // a window spans at most 4 bit positions: 16 slots a thread
constexpr int MAX_STAGES = 8;    // stages of a window: one mask plane holds 8
constexpr int MAX_WINDOWS = 32;  // a launch: at most 64 stages, at least 2 a window but for plane ends
constexpr int MAX_THREADS = 1024;
constexpr int COARSE_THREADS = 512;  // window-form coarse kernel: up to 128 registers a thread
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

// K6 (one single-axis group) is the strip (E, W) with eh extent 1; the window
// form of a two-axis side is the strip (E_hi, E_lo, W), or one of the two axes
// alone when the side is run as two launches.
template <typename T>
__global__ void __launch_bounds__(COARSE_THREADS) coarse_kernel(T* v, const uint8_t* masks, long long N, Strip g, Steps st) {
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
int threads_for(long long n, int cap = MAX_THREADS) {
  long long t = n >> CMAX;
  if (t < 32) t = 32;
  return (int)(t > cap ? cap : t);
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
  kernel<<<(unsigned)blocks, threads_for(1LL << n_log2, COARSE_THREADS), smem, s>>>(static_cast<T*>(v), masks, N, g, st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Gather kernels: K5 and K7
// ---------------------------------------------------------------------------

constexpr int FINE_UNITS = 8;          // 16-byte output units a K5 thread holds at most
constexpr unsigned BULK_BYTES = 32768;  // bytes per bulk copy
constexpr int ROWS_PER_THREAD = 32;     // slots a K7 thread gathers
constexpr int STRIP_SLOTS = MAX_THREADS * ROWS_PER_THREAD;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// One bulk (TMA 1-D) copy global -> shared, completing on the mbarrier.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// One 2-D box (TMA) global -> shared: columns c0.., rows c1.. of the tensor map.
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map, int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The indices of one 16-byte output unit: 4 fp32 or 8 bf16 slots.
template <typename T> struct UnitIndex;
template <> struct UnitIndex<uint32_t> { using type = uint2; };
template <> struct UnitIndex<uint16_t> { using type = uint4; };

__device__ __forceinline__ int4 gather_unit(const uint32_t* x, uint2 i) {
  return make_int4((int)x[i.x & 0xffffu], (int)x[i.x >> 16], (int)x[i.y & 0xffffu], (int)x[i.y >> 16]);
}

__device__ __forceinline__ unsigned pair(const uint16_t* x, unsigned i) {
  return (unsigned)x[i & 0xffffu] | ((unsigned)x[i >> 16] << 16);
}

__device__ __forceinline__ int4 gather_unit(const uint16_t* x, uint4 i) {
  return make_int4((int)pair(x, i.x), (int)pair(x, i.y), (int)pair(x, i.z), (int)pair(x, i.w));
}

// K5: block blockIdx.x of 2^bs_log2 consecutive slots, out[o] = in[src[o]]
// with src an in-block offset. Launched with units / blockDim.x <= FINE_UNITS,
// a power of two; shared memory is the block plus 8 bytes of mbarrier.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) fine_gather_kernel(T* v, const uint16_t* src, int bs_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  using IV = typename UnitIndex<T>::type;
  constexpr int VEC = 16 / sizeof(T);
  const unsigned bytes = (unsigned)sizeof(T) << bs_log2;
  const long long base = (long long)blockIdx.x << bs_log2;
  const unsigned bar = smem_u32(smem + bytes);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_expect_tx(bar, bytes);
    const unsigned char* from = reinterpret_cast<const unsigned char*>(v + base);
    for (unsigned off = 0; off < bytes; off += BULK_BYTES) {
      bulk_load(smem_u32(smem) + off, from + off, bytes - off < BULK_BYTES ? bytes - off : BULK_BYTES, bar);
    }
  }
  const int per = (1 << bs_log2) / VEC / blockDim.x;
  const IV* sv = reinterpret_cast<const IV*>(src + base);
  IV idx[FINE_UNITS];
#pragma unroll
  for (int k = 0; k < FINE_UNITS; ++k) {
    if (k < per) idx[k] = __ldg(sv + k * blockDim.x + threadIdx.x);
  }
  __syncthreads();  // the barrier is initialised
  while (!mbar_try_wait(bar, 0)) {
  }
  const T* x = reinterpret_cast<const T*>(smem);
  int4* out = reinterpret_cast<int4*>(v + base);
#pragma unroll
  for (int k = 0; k < FINE_UNITS; ++k) {
    if (k < per) out[k * blockDim.x + threadIdx.x] = gather_unit(x, idx[k]);
  }
}

// Geometry of a K7 launch: the (O, E, inner) view; a strip is all E
// positions x W lanes; the block index enumerates the lane windows of
// ``inner`` (fastest), then O.
struct Rows {
  long long E, inner;
  int w_log2;   // log2 W
  int wb_log2;  // log2(inner / W)
};

constexpr int BOX_ROWS = 256;  // rows of a TMA box, the most one may hold

// K7: out[o][e][w] = in[o][src[o][e][w]][w] on one strip. The strip and its
// index are copied in by TMA as 2-D boxes of W lanes x BOX_ROWS positions of
// the (O*E, inner) payload and index, all on one mbarrier; then each thread
// gathers from shared memory, a warp over one or more whole rows of lanes.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) rows_gather_kernel(const __grid_constant__ CUtensorMap vmap,
                                                                  const __grid_constant__ CUtensorMap imap,
                                                                  T* v, Rows g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int wl = g.w_log2, wmask = (1 << wl) - 1;
  const int n = (int)g.E << wl;
  const unsigned xbytes = (unsigned)n * sizeof(T), ibytes = (unsigned)n * 2;
  const unsigned ioff = (xbytes + 127) & ~127u;
  const T* x = reinterpret_cast<const T*>(smem);
  const uint16_t* ix = reinterpret_cast<const uint16_t*>(smem + ioff);
  const unsigned bar = smem_u32(smem + ioff + ((ibytes + 127) & ~127u));
  const long long b = blockIdx.x;
  const long long o = b >> g.wb_log2;
  const int col = (int)((b & ((1LL << g.wb_log2) - 1)) << wl);
  const int box = g.E < BOX_ROWS ? (int)g.E : BOX_ROWS;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_expect_tx(bar, xbytes + ibytes);
    for (int r = 0; r < g.E; r += box) {
      const int row = (int)(o * g.E) + r;
      tma_load_2d(smem_u32(smem) + (unsigned)(r << wl) * sizeof(T), &vmap, col, row, bar);
      tma_load_2d(smem_u32(smem) + ioff + (unsigned)(r << wl) * 2, &imap, col, row, bar);
    }
  }
  __syncthreads();  // the barrier is initialised
  while (!mbar_try_wait(bar, 0)) {
  }
  const long long base = o * g.E * g.inner + col;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    v[base + (i >> wl) * g.inner + (i & wmask)] = x[((int)ix[i] << wl) + (i & wmask)];
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda through the runtime's entry-point query,
// so the library links against the runtime alone.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The (N / inner, inner) view of ``ptr`` as a tensor map with boxes of
// (box_rows, W) elements.
bool tensor_map(CUtensorMap* map, const void* ptr, int elem_bytes, long long N, long long inner, long long W,
                int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)(N / inner)};
  const cuuint64_t strides[1] = {(cuuint64_t)(inner * elem_bytes)};
  const cuuint32_t box[2] = {(cuuint32_t)W, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_UINT32 : CU_TENSOR_MAP_DATA_TYPE_UINT16, 2,
            const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Window form of the fine stages (the index builder of K5). ``dlogs`` are
// log2 of the stage distances in slots (all < 2^bs_log2).
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

// K6 and the window form of a two-axis side (the index builder of K7). View
// (O2, E_hi, E_lo, inner); a single-axis group (K6) is the case E_hi = 1 with
// its E as E_lo. ``n_planes`` mask planes in the group, W
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

// K5. ``src`` (N,) uint16: each slot's in-block source offset.
extern "C" int dualip_benes_gather_fine(void* v, const void* src, long long N, int bs_log2, int elem_bytes,
                                        void* stream) {
  if (!pow2(N) || bs_log2 < 7 || bs_log2 > 16 || (1LL << bs_log2) > N || (elem_bytes != 4 && elem_bytes != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = ((size_t)elem_bytes << bs_log2) + 16;  // + the mbarrier
  const long long units = (1LL << bs_log2) / (16 / elem_bytes);
  const int threads = (int)(units < MAX_THREADS ? units : MAX_THREADS);
  if (smem > SMEM_LIMIT || units / threads > FINE_UNITS) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(N >> bs_log2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* ix = static_cast<const uint16_t*>(src);
  cudaError_t e;
  if (elem_bytes == 4) {
    if ((e = allow_smem(fine_gather_kernel<uint32_t>, smem)) != cudaSuccess) return (int)e;
    fine_gather_kernel<uint32_t><<<blocks, threads, smem, s>>>(static_cast<uint32_t*>(v), ix, bs_log2);
  } else {
    if ((e = allow_smem(fine_gather_kernel<uint16_t>, smem)) != cudaSuccess) return (int)e;
    fine_gather_kernel<uint16_t><<<blocks, threads, smem, s>>>(static_cast<uint16_t*>(v), ix, bs_log2);
  }
  return (int)cudaGetLastError();
}

// K7. View (O, E, inner) of the N slots, permuted along E per lane; ``src``
// (N,) uint16 in the same layout: each slot's source position along E. W
// lanes per strip (at least 8, so that a row of the index is 16 bytes).
extern "C" int dualip_benes_gather_rows(void* v, const void* src, long long N, long long E, long long inner,
                                        long long W, int elem_bytes, void* stream) {
  if (!pow2(N) || !pow2(E) || !pow2(inner) || !pow2(W) || W < 8 || W > inner || E < 2 || E > 65536 ||
      N % (E * inner) || N / inner > 0x7fffffffLL || (elem_bytes != 4 && elem_bytes != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = E * W;
  // the strip, then its index, each 128-byte aligned for TMA, then the mbarrier
  const size_t smem = (((size_t)n * elem_bytes + 127) & ~(size_t)127) + (((size_t)n * 2 + 127) & ~(size_t)127) + 16;
  if (n > STRIP_SLOTS || smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const long long blocks = N / n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  long long t = n / ROWS_PER_THREAD;
  const int threads = (int)(t < 32 ? 32 : t > MAX_THREADS ? MAX_THREADS : t);
  const int box = E < BOX_ROWS ? (int)E : BOX_ROWS;
  CUtensorMap vmap, imap;
  if (!tensor_map(&vmap, v, elem_bytes, N, inner, W, box) || !tensor_map(&imap, src, 2, N, inner, W, box)) {
    return (int)cudaErrorInvalidValue;
  }
  Rows g;
  g.E = E;
  g.inner = inner;
  g.w_log2 = ilog2(W);
  g.wb_log2 = ilog2(inner / W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (elem_bytes == 4) {
    if ((e = allow_smem(rows_gather_kernel<uint32_t>, smem)) != cudaSuccess) return (int)e;
    rows_gather_kernel<uint32_t><<<(unsigned)blocks, threads, smem, s>>>(vmap, imap, static_cast<uint32_t*>(v), g);
  } else {
    if ((e = allow_smem(rows_gather_kernel<uint16_t>, smem)) != cudaSuccess) return (int)e;
    rows_gather_kernel<uint16_t><<<(unsigned)blocks, threads, smem, s>>>(vmap, imap, static_cast<uint16_t*>(v), g);
  }
  return (int)cudaGetLastError();
}
