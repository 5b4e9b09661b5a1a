// Fused panel projection kernel (K3) and its x-emitting twin (K4) for Hopper,
// over every column tile of a layout in one launch.
//
// Replaces dualip_tpu/ops/pallas_matching.py::_panel_kernel (K3) and
// ::_panel_kernel_x (K4), with their bodies _panel_body and _store_ax. The TPU
// launches one kernel per tile; here one launch walks the work items of every
// tile listed in a tile table (one row per tile, built once per layout).
//
// One tile's region of the (N,) carry buffer is rows [off/(128*L2), +KP) of
// the view buf.reshape(-1, L2, 128). A buffer row holds q stacked segments of
// L lanes (q = 1 on plain panels, q > 1 on the compact packing); lane l of
// segment s, column c of row kp sits at
//
//     buf[off + kp*L2*128 + (s*L + l)*128 + c]        (fp32 or bf16)
//     a, c[(kp*q*L + s*L + l)*128 + c]                (fp32 or bf16, one type for all tiles)
//     length[(kp*q + s)*128 + c]                      (int32)
//
// In place on that region, for every column:
//
//     z[l]  = a[l] * srow[l] + neg_inv_gamma * c[l]          srow read from buf, all in fp32
//     x     = Proj(z) over the L lanes, x[l] = 0 for l >= length
//     buf   <- a*x (rounded once to the carry type); ghost lanes [q*L, L2) <- 0
//     obj  += c*x;  reg += x*x                          (+ x with WANT_X)
//
// Nothing outside the tiles' regions is written.
//
// What bounds it on an H100: device memory and the projection's arithmetic
// about equally. srow, a, c in and a*x out are 16 B per real slot with an fp32
// carry and fp32 tiles (12 B with a bf16 carry or bf16 tiles, 8 B with both;
// +4 B for x); the simplex projection does about 106
// fp32 operations per slot, none of them an FMA, so at the card's non-FMA
// issue rate the arithmetic takes about two thirds of the bytes' time. The
// copies of one work item overlap the projection of another, so what is left
// is the consumers' arithmetic: measured on the card, the kernel takes as
// long with the copies skipped, and a third of its time is the projection's
// work outside the 30 bisection steps (max and argmax, the emit).
//
// Design:
//  * A work item is one panel row of 128 columns (one segment of it on the
//    compact packing): L lanes x 128 of srow, a and c, and 128 lengths, all
//    contiguous. Items are numbered tile after tile; the table gives each
//    tile's first item.
//  * Persistent blocks of 160 threads: 4 consumer warps (one thread per
//    column) and one producer warp. Block b takes items b, b + grid, ...
//    (a static schedule that spreads every tile over all blocks).
//  * The producer's lane 0 brings each coming item into a ring in shared
//    memory with four 1-D bulk copies (TMA: srow, a, c, length), completing
//    on the item's "full" mbarrier, while the consumers project the items
//    that have arrived; the consumers release an item on its "empty"
//    mbarrier. Items take the ring's bytes one after the other, as large as
//    their L needs (an L = 16 item is 25 KB, an L = 29 one 45 KB), so small
//    items do not waste the room of the largest; up to 16 are in flight. The
//    ring is 72 KB a block, so two blocks share an SM (the registers allow
//    two as well); on an H100 80GB HBM3, rings of 44, 112 and 200 KB were
//    slower.
//  * The consumers switch on the tile's kind and on a power-of-two cap of L
//    to reach project_column<KIND, LCAP> (project_block.cuh): the column stays
//    in registers for the 30 bisection steps, up to L = 32. Where L is its
//    cap (and, for the simplex, the radius 1) the call site says so, so the
//    compiler drops the per-lane tests; the arithmetic is the same. a and c
//    are read for the emit from shared memory, so once from device memory;
//    a*x (and x) go out as coalesced stores from registers.
//  * L = 33 up to the largest item the ring holds (ring_l_cap: 47 with fp32
//    carry and tiles, 57 with a bf16 carry, 71 with bf16 tiles, 95 with
//    both) go through the ring but re-read their lanes from
//    shared memory on every pass (project_column_stream): a 64-lane column
//    in registers raised the whole kernel's register use and spills, and
//    cost the common tiles more than it saved the rare wide ones. Wider
//    tiles do not go through the ring: their consumers re-read the lanes
//    from device memory, with the same arithmetic.
//  * Each slot of a region is read (by its item's copy) and written (by its
//    column's thread) once, so the update is in place with no second buffer.
//    The thread of segment 0 also zeroes its row's ghost lanes.
//  * Tiles in bf16 (a and c) are the TPU kernel's other tile type: the
//    kernel is instanced for {fp32, bf16} carry x {fp32, bf16} tiles, and a
//    and c are widened to fp32 where they are read. The widening is exact,
//    so bf16 tiles give the bits of fp32 tiles holding the same values.
//  * Numerics: z, the projection and the emit are those of the per-tile
//    kernel this replaces, lane by lane, so a*x and x are bit for bit those
//    of a launch per tile. Only the order of the (obj, reg) sums changes:
//    each thread adds its items in order, each block adds its threads in a
//    fixed order into its partial, and the last block to finish adds the
//    partials in block order, as K1 does. Two runs give the same bits.
//
// Launches of this library must not run concurrently on two streams: the
// count of finished blocks is one device variable, reset by each launch's
// last block.
//
// C interface: dualip_panel_project_tiles(...) (a table in device memory) and
// dualip_panel_project(...) (one tile, its row passed by value) launch on the
// given stream and return cudaGetLastError(); they allocate nothing and do
// not synchronise. The grid is worked out, and the kernel's shared-memory
// attribute set, once per device and kernel instance, at its first launch.

#include <atomic>

#include <cuda_bf16.h>
#include <stddef.h>

#include "project_block.cuh"

namespace {

using namespace dualip;

constexpr int C = 128;                 // columns per panel row = consumer threads
constexpr int CONSUMER_WARPS = C / 32;
constexpr int THREADS = C + 32;        // + one producer warp
constexpr int REG_L_CAP = 32;          // largest L kept in registers
constexpr int MIN_BLOCKS = 2;          // blocks an SM the registers must allow
constexpr int SLOTS = 16;              // items in flight in a block at most (one mbarrier pair each)
constexpr int BAR_BYTES = 2 * SLOTS * 8;  // the mbarriers, ahead of the ring
constexpr unsigned BULK_BYTES = 32768;  // bytes per bulk copy
constexpr unsigned RING_BYTES = 72 * 1024;  // the ring of items in shared memory
constexpr size_t SMEM_BYTES = BAR_BYTES + (size_t)RING_BYTES;
constexpr int MAX_DEVICES = 64;

// One row of the tile table. Must match ops/fused_matching.py::_TILE_DTYPE.
struct Tile {
  const void* a;     // (KP, q*L, 128), the launch's tile type
  const void* c;
  const int* len;    // (KP, q, 128)
  long long off;     // region start in the carry buffer, in slots
  long long x_off;   // first slot of the tile's x in the x buffer
  long long first;   // first work item
  int L, L2, q, kind;
  int inequality, has_lo, has_hi;
  float lo, hi, radius;
};
static_assert(sizeof(Tile) == 88, "Tile layout");
static_assert(offsetof(Tile, off) == 24 && offsetof(Tile, L) == 48 && offsetof(Tile, lo) == 76, "Tile layout");

__device__ unsigned int g_blocks_done = 0;  // blocks of the running launch that have finished

struct Args {
  void* buf;
  const Tile* table;  // nullptr: the one tile below
  Tile one;
  int n_tiles;
  long long n_items;
  const float* neg_inv_gamma;
  float* x;
  float* partials;  // (gridDim.x, 2)
  float* out;       // (2,)
};

__device__ __forceinline__ Tile tile_at(const Args& p, int t) { return p.table ? p.table[t] : p.one; }
__device__ __forceinline__ long long first_of(const Args& p, int t) { return p.table ? p.table[t].first : 0; }

// The tile of an item, walking forward (a block's items only grow).
struct TileWalk {
  int t = 0;
  Tile tile;
  long long next_first;  // the first item of tile t + 1 (n_items after the last)
  __device__ __forceinline__ TileWalk(const Args& p) : tile(tile_at(p, 0)) {
    next_first = p.n_tiles > 1 ? first_of(p, 1) : p.n_items;
  }
  __device__ __forceinline__ void seek(const Args& p, long long item) {
    if (item < next_first) return;
    do {
      ++t;
      next_first = t + 1 < p.n_tiles ? first_of(p, t + 1) : p.n_items;
    } while (item >= next_first);
    tile = tile_at(p, t);
  }
};

// Bytes of one item in the ring: a, c (tile type TA), srow (carry type T),
// length. Every part is a multiple of 256 B (C = 128 lanes of 2 or 4 B), so
// each bulk copy and each part's place in the ring stay on 16 B.
template <typename T, typename TA>
__host__ __device__ __forceinline__ constexpr unsigned item_bytes(int L) {
  return (unsigned)L * C * (2 * sizeof(TA) + sizeof(T)) + C * 4;
}

// The largest L whose item the ring holds: 47 (fp32 carry and tiles), 57
// (bf16 carry), 71 (bf16 tiles), 95 (both).
template <typename T, typename TA>
__host__ __device__ __forceinline__ constexpr int ring_l_cap() {
  return (int)((RING_BYTES - C * 4) / (C * (2 * sizeof(TA) + sizeof(T))));
}
static_assert(ring_l_cap<float, float>() == 47 && ring_l_cap<__nv_bfloat16, float>() == 57, "ring size");
static_assert(ring_l_cap<float, __nv_bfloat16>() == 71 && ring_l_cap<__nv_bfloat16, __nv_bfloat16>() == 95,
              "ring size");

template <typename T, typename TA>
__device__ __forceinline__ bool in_ring(const Tile& t) { return t.L <= ring_l_cap<T, TA>(); }

// Where the items go in the ring: one after the other, back to the start
// when an item does not fit before the end. The producer and the consumers
// walk the same items and place them alike.
struct RingWalk {
  unsigned pos = 0;
  __device__ __forceinline__ unsigned place(unsigned bytes) {
    const unsigned at = pos + bytes > RING_BYTES ? 0u : pos;
    pos = at + bytes;
    return at;
  }
};

// The slot (mbarrier pair) of the k-th item of a block and the parity of its
// use, advanced item by item.
struct Slot {
  int i = 0;
  unsigned parity = 0;
  __device__ __forceinline__ void next() {
    if (++i == SLOTS) {
      i = 0;
      parity ^= 1;
    }
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Bulk (TMA 1-D) copies global -> shared of ``bytes`` (a multiple of 16),
// completing on the mbarrier.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes, unsigned bar) {
  const unsigned char* from = static_cast<const unsigned char*>(src);
  for (unsigned o = 0; o < bytes; o += BULK_BYTES) {
    const unsigned n = bytes - o < BULK_BYTES ? bytes - o : BULK_BYTES;
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 ::"r"(dst + o), "l"(from + o), "r"(n), "r"(bar)
                 : "memory");
  }
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Where one item lies: its index within the tile, buffer row and segment.
struct Where {
  long long local, row;
  int seg;
  __device__ __forceinline__ Where(const Tile& t, long long item) {
    local = item - t.first;
    const unsigned l32 = (unsigned)local;  // the items of a launch number fewer than 2^31
    const unsigned r32 = t.q == 1 ? l32 : l32 / (unsigned)t.q;
    row = r32;
    seg = (int)(l32 - r32 * (unsigned)t.q);
  }
  __device__ __forceinline__ long long srow(const Tile& t) const {
    return t.off + (row * t.L2 + (long long)seg * t.L) * C;
  }
};

// One thread's column of one item: lane l of a, c and srow at a[l*C], c[l*C],
// s[l*C] (shared memory for an item of the ring, device memory otherwise);
// a*x goes to b[l*C] in the carry buffer. a and c are widened to fp32 on the
// read.
template <typename T, typename TA>
struct Column {
  const TA* a;
  const TA* c;
  const T* s;
  T* b;
  float* x;
  int len;
  float nig;

  // a*srow + nig*c, rounded as two products and a sum (no contraction)
  __device__ __forceinline__ float z(int l) const {
    return __fadd_rn(__fmul_rn(load(a + l * C), load(s + l * C)), __fmul_rn(nig, load(c + l * C)));
  }

  template <bool WANT_X>
  __device__ __forceinline__ void emit(int l, float w, float& cx, float& xx) const {
    const float xv = (l < len) ? w : 0.f;
    const float cv = load(c + l * C);
    store(b + l * C, __fmul_rn(load(a + l * C), xv));
    if (WANT_X) x[l * C] = xv;
    cx += cv * xv;
    xx += xv * xv;
  }
};

// project_column at a call site that tells the compiler more where it can:
// every lane real when L is the cap (no per-lane test), and for the simplex
// its radius of 1 as well (no per-lane division test). The arithmetic is
// the same.
template <typename T, typename TA, int KIND, int LCAP, bool WANT_X>
__device__ __forceinline__ void project(const Tile& t, const Proj& pr, const Column<T, TA>& col, float& cx,
                                        float& xx) {
  const auto z = [&](int l) { return col.z(l); };
  const auto emit = [&](int l, float w) { col.template emit<WANT_X>(l, w, cx, xx); };
  if (t.L == LCAP && (KIND != SIMPLEX || pr.radius == 1.f)) {
    const Proj exact{pr.inequality, pr.lo, pr.hi, pr.has_lo, pr.has_hi, KIND == SIMPLEX ? 1.f : pr.radius};
    project_column<KIND, LCAP>(LCAP, exact, z, emit);
  } else {
    project_column<KIND, LCAP>(t.L, pr, z, emit);
  }
}

template <typename T, typename TA, int KIND, bool WANT_X>
__device__ __forceinline__ void project_any(const Tile& t, const Proj& pr, const Column<T, TA>& col, float& cx,
                                            float& xx) {
  const int L = t.L;
  if (L > REG_L_CAP) {
    project_column_stream<KIND>(
        L, pr, [&](int l) { return col.z(l); },
        [&](int l, float w) { col.template emit<WANT_X>(l, w, cx, xx); });
  } else if (L <= 1) {
    project<T, TA, KIND, 1, WANT_X>(t, pr, col, cx, xx);
  } else if (L <= 2) {
    project<T, TA, KIND, 2, WANT_X>(t, pr, col, cx, xx);
  } else if (L <= 4) {
    project<T, TA, KIND, 4, WANT_X>(t, pr, col, cx, xx);
  } else if (L <= 8) {
    project<T, TA, KIND, 8, WANT_X>(t, pr, col, cx, xx);
  } else if (L <= 16) {
    project<T, TA, KIND, 16, WANT_X>(t, pr, col, cx, xx);
  } else if (REG_L_CAP <= 32 || L <= 32) {
    project<T, TA, KIND, 32, WANT_X>(t, pr, col, cx, xx);
  } else {
    if constexpr (REG_L_CAP > 32) project<T, TA, KIND, 64, WANT_X>(t, pr, col, cx, xx);
  }
}

// identity / box / cone: elementwise, any L.
template <typename T, typename TA, bool WANT_X>
__device__ __forceinline__ void clamp_item(const Tile& t, const Proj& pr, const Column<T, TA>& col, float& cx,
                                           float& xx) {
  for (int l = 0; l < t.L; ++l) {
    float w = col.z(l);
    if (pr.has_lo) w = fmaxf(w, pr.lo);
    if (pr.has_hi) w = fminf(w, pr.hi);
    col.template emit<WANT_X>(l, w, cx, xx);
  }
}

// One item of the ring, one column: project and emit (the column
// in registers up to L = 32).
template <typename T, typename TA, bool WANT_X>
__device__ __forceinline__ void ring_item(const Tile& t, const Column<T, TA>& col, float& cx, float& xx) {
  const Proj pr{t.inequality, t.lo, t.hi, t.has_lo, t.has_hi, t.radius};
  if (t.kind == CLAMP) clamp_item<T, TA, WANT_X>(t, pr, col, cx, xx);
  else if (t.kind == SIMPLEX) project_any<T, TA, SIMPLEX, WANT_X>(t, pr, col, cx, xx);
  else project_any<T, TA, BOXCUT, WANT_X>(t, pr, col, cx, xx);
}

// One item wider than the ring takes, one column, from device
// memory: nothing kept, every pass re-reads the lanes.
template <typename T, typename TA, bool WANT_X>
__device__ __forceinline__ void wide_item(const Tile& t, const Column<T, TA>& col, float& cx, float& xx) {
  const Proj pr{t.inequality, t.lo, t.hi, t.has_lo, t.has_hi, t.radius};
  const auto z = [&](int l) { return col.z(l); };
  const auto emit = [&](int l, float w) { col.template emit<WANT_X>(l, w, cx, xx); };
  if (t.kind == CLAMP) clamp_item<T, TA, WANT_X>(t, pr, col, cx, xx);
  else if (t.kind == SIMPLEX) project_column_stream<SIMPLEX>(t.L, pr, z, emit);
  else project_column_stream<BOXCUT>(t.L, pr, z, emit);
}

// Every thread of every block, after thread 0 wrote the block's partial: the
// last block to arrive adds all partials in block order into out.
__device__ void finish(const Args& p) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&g_blocks_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  const float2* parts = reinterpret_cast<const float2*>(p.partials);
  float u = 0.f, v = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) {
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

template <typename T, typename TA, bool WANT_X>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) panel_tiles_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned full0 = smem_u32(smem), empty0 = full0 + SLOTS * 8;
  unsigned char* ring = smem + BAR_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's arrival (+ its bytes)
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  T* buf = static_cast<T*>(p.buf);
  float cx = 0.f, xx = 0.f;
  TileWalk tw(p);
  const Tile& tile = tw.tile;
  RingWalk walk;
  Slot slot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == CONSUMER_WARPS) {
    // producer: lane 0 fills the ring, item after item. Before an item goes
    // in, the oldest items in flight are waited for (released by the
    // consumers) until its slot is free and its bytes clash with none.
    if (lane == 0) {
      unsigned lo[SLOTS], hi[SLOTS];  // bytes of the items in flight, by slot
      Slot oldest;
      int in_flight = 0;
      for (long long item = blockIdx.x; item < p.n_items; item += gridDim.x, slot.next()) {
        tw.seek(p, item);
        const unsigned bytes = in_ring<T, TA>(tile) ? item_bytes<T, TA>(tile.L) : 0u;
        const unsigned at = walk.place(bytes);
        for (;;) {
          bool clash = in_flight == SLOTS;
          for (int k = 0, s = oldest.i; !clash && k < in_flight; ++k, s = s + 1 == SLOTS ? 0 : s + 1) {
            clash = bytes && lo[s] < at + bytes && at < hi[s];
          }
          if (!clash) break;
          mbar_wait(empty0 + 8 * oldest.i, oldest.parity);
          oldest.next();
          --in_flight;
        }
        lo[slot.i] = at;
        hi[slot.i] = at + bytes;
        ++in_flight;
        const unsigned full = full0 + 8 * slot.i;
        if (bytes) {
          const Where w(tile, item);
          const unsigned lanes = (unsigned)tile.L * C;
          const unsigned ab = lanes * (unsigned)sizeof(TA);  // bytes of a (and of c)
          const unsigned dst = smem_u32(ring + at);
          mbar_expect_tx(full, bytes);
          bulk_load(dst, static_cast<const TA*>(tile.a) + w.local * lanes, ab, full);
          bulk_load(dst + ab, static_cast<const TA*>(tile.c) + w.local * lanes, ab, full);
          bulk_load(dst + 2 * ab, buf + w.srow(tile), lanes * (unsigned)sizeof(T), full);
          bulk_load(dst + 2 * ab + lanes * (unsigned)sizeof(T), tile.len + w.local * C, C * 4, full);
        } else {
          mbar_arrive(full);  // read from device memory by the consumers
        }
      }
    }
    __syncwarp();
  } else {
    // consumers: one thread per column
    const int col_i = threadIdx.x;
    const float nig = *p.neg_inv_gamma;
    for (long long item = blockIdx.x; item < p.n_items; item += gridDim.x, slot.next()) {
      tw.seek(p, item);
      const Where w(tile, item);
      const bool ringed = in_ring<T, TA>(tile);
      const unsigned at = walk.place(ringed ? item_bytes<T, TA>(tile.L) : 0u);
      const long long lanes = (long long)tile.L * C;
      const long long srow = w.srow(tile);
      T* const b = buf + srow + col_i;
      float* const x = WANT_X ? p.x + tile.x_off + w.local * lanes + col_i : nullptr;
      mbar_wait(full0 + 8 * slot.i, slot.parity);
      if (ringed) {  // a, c, srow and length from shared memory
        const unsigned char* sb = ring + at;
        const long long ab = lanes * (long long)sizeof(TA);
        const Column<T, TA> col{reinterpret_cast<const TA*>(sb) + col_i,
                                reinterpret_cast<const TA*>(sb + ab) + col_i,
                                reinterpret_cast<const T*>(sb + 2 * ab) + col_i, b, x,
                                reinterpret_cast<const int*>(sb + 2 * ab + lanes * sizeof(T))[col_i], nig};
        ring_item<T, TA, WANT_X>(tile, col, cx, xx);
      } else {
        const Column<T, TA> col{static_cast<const TA*>(tile.a) + w.local * lanes + col_i,
                                static_cast<const TA*>(tile.c) + w.local * lanes + col_i, b, b, x,
                                tile.len[w.local * C + col_i], nig};
        wide_item<T, TA, WANT_X>(tile, col, cx, xx);
      }
      if (w.seg == 0) {  // ghost lanes of this buffer row
        T* g = buf + tile.off + w.row * tile.L2 * C + col_i;
        for (int l = tile.q * tile.L; l < tile.L2; ++l) store(g + (long long)l * C, 0.f);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot.i);
    }
  }
  block_sum2(cx, xx);
  if (threadIdx.x == 0) {
    p.partials[2 * blockIdx.x] = cx;
    p.partials[2 * blockIdx.x + 1] = xx;
  }
  finish(p);
}

// Blocks a launch may take on the current device: as many as fit on every
// SM, worked out (and the kernel's shared memory opted in) at the first
// launch on each device.
template <typename T, typename TA, bool WANT_X>
cudaError_t full_grid(int& grid) {
  static std::atomic<int> cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if ((grid = cached[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  auto kernel = panel_tiles_kernel<T, TA, WANT_X>;
  // dynamic shared memory above the default 48 KB needs an opt-in per kernel
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM_BYTES)) != cudaSuccess) {
    return e;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  grid = sms * per_sm;
  cached[dev].store(grid, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename T, typename TA, bool WANT_X>
int launch(Args& p, int max_grid, cudaStream_t s) {
  int grid = 0;
  const cudaError_t e = full_grid<T, TA, WANT_X>(grid);
  if (e != cudaSuccess) return (int)e;
  if (grid > max_grid) grid = max_grid;
  if (grid > p.n_items) grid = (int)p.n_items;
  panel_tiles_kernel<T, TA, WANT_X><<<grid, THREADS, SMEM_BYTES, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename TA>
int launch_x(Args& p, int max_grid, cudaStream_t s) {
  return p.x != nullptr ? launch<T, TA, true>(p, max_grid, s) : launch<T, TA, false>(p, max_grid, s);
}

template <typename T>
int launch_tiles(Args& p, int tile_bytes, int max_grid, cudaStream_t s) {
  if (tile_bytes == 4) return launch_x<T, float>(p, max_grid, s);
  if (tile_bytes == 2) return launch_x<T, __nv_bfloat16>(p, max_grid, s);
  return (int)cudaErrorInvalidValue;
}

int dispatch(Args& p, int carry_bytes, int tile_bytes, int max_grid, cudaStream_t s) {
  if (p.n_items < 1 || p.n_items >= (1ll << 31) || max_grid < 1) return (int)cudaErrorInvalidValue;
  if (carry_bytes == 4) return launch_tiles<float>(p, tile_bytes, max_grid, s);
  if (carry_bytes == 2) return launch_tiles<__nv_bfloat16>(p, tile_bytes, max_grid, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every tile of ``table`` (n_tiles rows in device memory, checked by the
// caller against the layout): n_items work items. carry_bytes: 4 (float32
// buffer) or 2 (bfloat16); tile_bytes: the same for every tile's a and c.
// x == nullptr: K3; else K4. ``partials`` holds ``max_grid`` (obj, reg)
// pairs; ``out`` receives the two sums.
extern "C" int dualip_panel_project_tiles(
    void* buf, int carry_bytes, int tile_bytes, const void* table, int n_tiles, long long n_items,
    const float* neg_inv_gamma, float* x, float* partials, int max_grid, float* out, void* stream) {
  if (table == nullptr || n_tiles < 1) return (int)cudaErrorInvalidValue;
  Args p{};
  p.buf = buf;
  p.table = static_cast<const Tile*>(table);
  p.n_tiles = n_tiles;
  p.n_items = n_items;
  p.neg_inv_gamma = neg_inv_gamma;
  p.x = x;
  p.partials = partials;
  p.out = out;
  return dispatch(p, carry_bytes, tile_bytes, max_grid, static_cast<cudaStream_t>(stream));
}

// One tile, its table row passed by value: region ``off`` of the (n_buf,)
// buffer, KP buffer rows of q segments of L lanes in L2; x (if any) is the
// tile's own (KP, q*L, 128) output.
extern "C" int dualip_panel_project(
    void* buf, long long n_buf, int carry_bytes, int tile_bytes, const void* a, const void* c, const int* length,
    long long off, int KP, int L, int L2, int q, int kind, int inequality,
    float lo, float hi, int has_lo, int has_hi, float radius,
    const float* neg_inv_gamma, float* x, float* partials, int max_grid, float* out, void* stream) {
  if (KP < 1 || L < 1 || q < 1 || (long long)q * L > L2 || kind < CLAMP || kind > BOXCUT) {
    return (int)cudaErrorInvalidValue;
  }
  if (off < 0 || off % ((long long)L2 * C) || off + (long long)KP * L2 * C > n_buf) return (int)cudaErrorInvalidValue;
  Args p{};
  p.buf = buf;
  p.table = nullptr;
  p.one = Tile{a, c, length, off, 0, 0, L, L2, q, kind, inequality, has_lo, has_hi, lo, hi, radius};
  p.n_tiles = 1;
  p.n_items = (long long)KP * q;
  p.neg_inv_gamma = neg_inv_gamma;
  p.x = x;
  p.partials = partials;
  p.out = out;
  return dispatch(p, carry_bytes, tile_bytes, max_grid, static_cast<cudaStream_t>(stream));
}
