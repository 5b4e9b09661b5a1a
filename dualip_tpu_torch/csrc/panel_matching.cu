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
//    contiguous. An item the ring holds is one work unit; an item wider than
//    the ring (below) is 16 units of 8 adjacent columns; a tile above
//    STRETCH_L has none (its own launch of the block form, below, takes it
//    column by column). Units are numbered tile after tile; the table gives
//    each tile's first unit.
//  * Persistent blocks of 160 threads: 4 consumer warps and one producer
//    warp. Block b takes units b, b + grid, ... (a static schedule that
//    spreads every tile over all blocks).
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
//  * L = 33 up to RING_L_CAP = 47, the largest item of fp32 carry and tiles
//    the ring holds, go through the ring but re-read their lanes from shared
//    memory on every pass (project_column_group, KeepNone): a 64-lane column in
//    registers raised the whole kernel's register use and spills, and cost
//    the common tiles more than it saved the rare wide ones. Items of a bf16
//    carry or bf16 tiles are smaller but go through the ring up to the same
//    L: a bf16 tile then takes the path and the schedule of an fp32 tile
//    holding the same values, and gives its bits, (obj, reg) included (a
//    wide unit adds its lane sums and its (obj, reg) terms in another order
//    than a thread of the ring).
//  * Wider tiles up to STRETCH_L = 512 do not go through the ring (the
//    producer passes their units with a bare arrival). A wide unit is 8
//    adjacent columns of one item, 2 a consumer warp, one after the other,
//    each projected by the whole warp (project_column_warp_any): z formed
//    once from device memory, kept in registers up to L = 128, in the warp's
//    2 KB stretch of shared memory up to L = 512; every reduction a warp
//    shuffle. The 8 columns of a unit are one 32 B sector of each fp32 lane
//    row, so each sector read from device memory serves all 8 (the other
//    warps of the block, and the warp's second column, find it in L1); a
//    column of length 0 (padding) is not projected or read: its lanes take
//    x = 0 and a*x = 0, as the mask gives them, and a unit of 8 such
//    columns is written by whole sectors. So a wide tile's columns spread
//    over the whole grid, where one thread a column re-read every lane from
//    device memory on each of ~33 passes and only as many blocks as the
//    tile had items worked on it. The wide path is kept lean (z alone kept,
//    the lanes' loops not unrolled above L = 128), and it is compiled only
//    into the instances that launches with a wide tile take (WIDE): in one
//    kernel with the ring's code it raised the ring's spills (bf16 carry 128
//    to 220 B) and slowed tables of narrow tiles by up to 20%.
//  * A tile above STRETCH_L takes the kernel's block form, a launch of its
//    own after the ring's, on the same stream: one column a block of
//    T = block_threads(L) threads (128 to 1024, 8 lanes a thread), with no
//    ring and no producer, persistent blocks taking the tile's columns in
//    order. The block keeps z, a and c in registers (at T = 1024 z alone to
//    16,384 lanes, then z in shared memory, then nowhere: one instance each,
//    block_keep) and each reduction costs one barrier: project_column_group
//    over a BlockReduce<T>, the routine of K1's blocks (project_block.cuh).
//    These tiles hold few real columns, thousands of lanes wide: a warp
//    walking two of them from device memory, 33 passes each, held the whole
//    launch while the card sat nearly empty. A column's lanes are read at
//    b[l*C] as in a wide unit, so the 8 columns of a sector go to 8
//    neighbouring blocks, and a group of 8 padding columns is written by
//    whole sectors, an eighth of its lane rows by each column's block. The
//    ring's blocks of 160 threads with a producer warp cannot take a
//    __syncthreads reduction, and the block form's code in the ring's
//    instances would raise their spills, as the wide path's did.
//  * Each slot of a region is read (by its item's copy, or its column's
//    warp or block) and written (by its column's thread, warp or block)
//    once, so the update is in place with no second buffer. The column's
//    thread (warp, block) of segment 0 also zeroes its ghost lanes.
//  * Tiles in bf16 (a and c) are the TPU kernel's other tile type: the
//    kernel is instanced for {fp32, bf16} carry x {fp32, bf16} tiles, and a
//    and c are widened to fp32 where they are read. The widening is exact,
//    so bf16 tiles give the bits of fp32 tiles holding the same values.
//  * Numerics: z, the projection and the emit are those of the per-tile
//    kernel this replaces, lane by lane (a wide column's lane sums add in
//    the warp's order, project_block.cuh), and a launch of one tile runs the
//    same code as the all-tiles launch (a tile above STRETCH_L the same
//    block form), so a*x and x are bit for bit those of a launch per tile.
//    Only the order of the (obj, reg) sums changes: each thread (block form:
//    each block) adds its items (columns) in order, each block adds its
//    threads in a fixed order into its partial, and the last block to finish
//    adds the partials in block order, as K1 does; each block-form launch
//    then adds its sums to those of the launches before it. Two runs give
//    the same bits.
//
// Launches of this library must not run concurrently on two streams: the
// count of finished blocks is one device variable, reset by each launch's
// last block, and the launches of one call share the partials' scratch in
// turn.
//
// C interface: dualip_panel_project_tiles(...) (a table in device memory) and
// dualip_panel_project(...) (one tile, its row passed by value) launch on the
// given stream and return cudaGetLastError(); they allocate nothing and do
// not synchronise. The ring's grid is worked out, and its shared-memory
// attribute set, once per device and kernel instance, at its first launch;
// the block form's at each launch.

#include <atomic>
#include <type_traits>

#include <cuda_bf16.h>
#include <limits.h>
#include <stddef.h>

#include "project_block.cuh"

namespace {

using namespace dualip;

constexpr int C = 128;                 // columns per panel row = consumer threads
constexpr int CONSUMER_WARPS = C / 32;
constexpr int THREADS = C + 32;        // + one producer warp
constexpr int REG_L_CAP = 32;          // largest L kept in registers (ring)
constexpr int MIN_BLOCKS = 2;          // blocks an SM the registers must allow
constexpr int SLOTS = 16;              // units in flight in a block at most (one mbarrier pair each)
constexpr int BAR_BYTES = 2 * SLOTS * 8;  // the mbarriers, ahead of the ring
constexpr unsigned BULK_BYTES = 32768;  // bytes per bulk copy
constexpr unsigned RING_BYTES = 72 * 1024;  // the ring of items in shared memory
constexpr int WIDE_COLS = 8;           // columns of a wide unit (a 32 B sector of fp32)
constexpr int WIDE_UNITS = C / WIDE_COLS;  // units of a wide item
constexpr int COLS_PER_WARP = WIDE_COLS / CONSUMER_WARPS;
constexpr int WIDE_REGS = 4;           // a wide column in registers up to 32 * 4 lanes
constexpr int STRETCH_L = 512;         // ... in its warp's stretch of shared memory up to 512; above, the block form
constexpr int RING_L_CAP = 47;         // the largest L that goes through the ring

// Shared memory of a launch: the ring, and the wide columns' stretches.
template <bool WIDE>
constexpr size_t smem_bytes() {
  return BAR_BYTES + (size_t)RING_BYTES + (WIDE ? CONSUMER_WARPS * STRETCH_L * sizeof(float) : 0);
}
constexpr int MAX_DEVICES = 64;
static_assert(WIDE_COLS % CONSUMER_WARPS == 0 && C % WIDE_COLS == 0, "wide units");

// One row of the tile table. Must match ops/fused_matching.py::_TILE_DTYPE.
struct Tile {
  const void* a;     // (KP, q*L, 128), the launch's tile type
  const void* c;
  const int* len;    // (KP, q, 128)
  long long off;     // region start in the carry buffer, in slots
  long long x_off;   // first slot of the tile's x in the x buffer
  long long first;   // first work unit
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
  long long n_items;  // work units of the launch
  bool wide;          // a tile is above the ring's cap
  const float* neg_inv_gamma;
  float* x;
  float* partials;  // (gridDim.x, 2)
  float* out;       // (2,)
  bool add_out;     // block form: out holds the sums of the call's launches before this one; add to them
};

__device__ __forceinline__ Tile tile_at(const Args& p, int t) { return p.table ? p.table[t] : p.one; }
__device__ __forceinline__ long long first_of(const Args& p, int t) { return p.table ? p.table[t].first : 0; }

// The tile of a unit, walking forward (a block's units only grow).
struct TileWalk {
  int t = 0;
  Tile tile;
  long long next_first;  // the first unit of tile t + 1 (n_items after the last)
  __device__ __forceinline__ TileWalk(const Args& p) : tile(tile_at(p, 0)) {
    next_first = p.n_tiles > 1 ? first_of(p, 1) : p.n_items;
  }
  __device__ __forceinline__ void seek(const Args& p, long long unit) {
    if (unit < next_first) return;
    do {
      ++t;
      next_first = t + 1 < p.n_tiles ? first_of(p, t + 1) : p.n_items;
    } while (unit >= next_first);
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

// The ring holds an item of RING_L_CAP lanes of fp32 carry and tiles, and
// not one lane more (items of bf16 are smaller).
static_assert(item_bytes<float, float>(RING_L_CAP) <= RING_BYTES && item_bytes<float, float>(RING_L_CAP + 1) > RING_BYTES,
              "ring size");

__host__ __device__ __forceinline__ bool in_ring(int L) { return L <= RING_L_CAP; }

// Work units of one item: 1 in the ring, WIDE_UNITS above it.
__host__ __device__ __forceinline__ int units_per_item(int L) { return in_ring(L) ? 1 : WIDE_UNITS; }

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

// Where one unit lies: its item's index within the tile, buffer row and
// segment, and its first column (0 for an item of the ring).
// ops/fused_matching.py::panel_unit_where is the same map.
// An instance without WIDE holds no wide tile: one unit an item.
template <bool WIDE>
struct Where {
  long long local, row;
  int seg, col0;
  __device__ __forceinline__ Where(const Tile& t, long long unit) {
    const unsigned u = (unsigned)(unit - t.first);  // units of a launch: fewer than 2^31
    const unsigned per = WIDE ? (unsigned)units_per_item(t.L) : 1u;
    const unsigned l32 = per == 1 ? u : u / per;
    col0 = (int)(u - l32 * per) * WIDE_COLS;
    local = l32;
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
  __device__ __forceinline__ float z(int l) const { return z_kept(l, load(a + l * C), load(c + l * C)); }

  // the same with lane l's a and c (widened) read by the caller
  __device__ __forceinline__ float z_kept(int l, float av, float cv) const {
    return __fadd_rn(__fmul_rn(av, load(s + l * C)), __fmul_rn(nig, cv));
  }

  // lane l of a column of length 0: a*x = 0 and x = 0, a and c not read
  template <bool WANT_X>
  __device__ __forceinline__ void emit_zero(int l) const {
    store(b + l * C, 0.f);
    if (WANT_X) x[l * C] = 0.f;
  }

  template <bool WANT_X>
  __device__ __forceinline__ void emit(int l, float w, float& cx, float& xx) const {
    emit_kept<WANT_X>(l, w, load(a + l * C), load(c + l * C), cx, xx);
  }

  // the same with lane l's a and c (widened) read by the caller
  template <bool WANT_X>
  __device__ __forceinline__ void emit_kept(int l, float w, float av, float cv, float& cx, float& xx) const {
    const float xv = (l < len) ? w : 0.f;
    store(b + l * C, __fmul_rn(av, xv));
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
  if (L > REG_L_CAP) {  // one thread, nothing kept: every pass reads the lanes again from the ring
    ThreadReduce alone;
    project_column_group<KIND, KeepNone>(
        L, pr, alone, nullptr, [&](int, int l) { return col.z(l); },
        [&](int, int l, float w) { col.template emit<WANT_X>(l, w, cx, xx); });
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

// identity / box / cone: elementwise, any L; lanes l0, l0 + step, ...
template <typename T, typename TA, bool WANT_X>
__device__ __forceinline__ void clamp_item(const Tile& t, const Proj& pr, const Column<T, TA>& col, float& cx,
                                           float& xx, int l0 = 0, int step = 1) {
  for (int l = l0; l < t.L; l += step) {
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

// One column of a wide unit, the whole consumer warp: lanes from device
// memory, z formed once and kept (project_column_warp_any). A column of
// length 0 (padding) writes x = 0 and a*x = 0 on every lane, what the mask
// makes of any projection (a padding slot's a is 0), and reads nothing.
template <typename T, typename TA, bool WANT_X>
__device__ __forceinline__ void wide_column(const Tile& t, const Column<T, TA>& col, float* stretch, float& cx,
                                            float& xx) {
  const Proj pr{t.inequality, t.lo, t.hi, t.has_lo, t.has_hi, t.radius};
  const int lane = threadIdx.x & 31;
  const auto z = [&](int, int l) { return col.z(l); };
  const auto emit = [&](int, int l, float w) { col.template emit<WANT_X>(l, w, cx, xx); };
  if (col.len == 0) {
    for (int l = lane; l < t.L; l += 32) col.template emit_zero<WANT_X>(l);
  } else if (t.kind == CLAMP) {
    clamp_item<T, TA, WANT_X>(t, pr, col, cx, xx, lane, 32);
  } else if (t.kind == SIMPLEX) {
    project_column_warp_any<SIMPLEX, WIDE_REGS>(t.L, pr, stretch, STRETCH_L, z, emit);
  } else {
    project_column_warp_any<BOXCUT, WIDE_REGS>(t.L, pr, stretch, STRETCH_L, z, emit);
  }
}

// Zero a column's ghost lanes [from, to) (slot g[l*C]), lanes l0, l0 + step, ...
template <typename T>
__device__ __forceinline__ void zero_ghosts(T* g, int from, int to, int l0, int step) {
  for (int l = from + l0; l < to; l += step) store(g + (long long)l * C, 0.f);
}

// A wide unit, by a block's consumer warps: COLS_PER_WARP adjacent columns a
// warp, one after the other, from device memory. ``stretches`` is the
// consumers' shared memory past the ring. A unit of padding columns only
// (length 0: the tail of a tile) is written as zeros by whole sectors, each
// warp instruction 4 lane rows of the unit's 8 columns, where a warp a
// column would write 32 lane rows of one column (32 partial sectors).
template <typename T, typename TA, bool WANT_X>
__device__ __forceinline__ void wide_unit(const Args& p, const Tile& t, const Where<true>& w, unsigned char* stretches,
                                          float nig, float& cx, float& xx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long lanes = (long long)t.L * C;
  T* const buf = static_cast<T*>(p.buf);
  T* const b = buf + w.srow(t);  // the item's lane 0, column 0
  T* const ghost = buf + t.off + w.row * t.L2 * C;  // the buffer row's lane 0
  float* const x = WANT_X ? p.x + t.x_off + w.local * lanes : nullptr;
  const int* const len = t.len + w.local * C + w.col0;
  bool padding = true;
#pragma unroll
  for (int i = 0; i < WIDE_COLS; ++i) padding &= len[i] == 0;
  if (padding) {
    constexpr int ROWS = CONSUMER_WARPS * 32 / WIDE_COLS;  // lane rows a pass
    const int col_i = w.col0 + lane % WIDE_COLS, r0 = warp * (32 / WIDE_COLS) + lane / WIDE_COLS;
    for (int l = r0; l < t.L; l += ROWS) {
      store(b + (long long)l * C + col_i, 0.f);
      if (WANT_X) x[(long long)l * C + col_i] = 0.f;
    }
    if (w.seg == 0) zero_ghosts(ghost + col_i, t.q * t.L, t.L2, r0, ROWS);
    return;
  }
  float* const stretch = reinterpret_cast<float*>(stretches) + warp * STRETCH_L;
  for (int k = 0; k < COLS_PER_WARP; ++k) {
    const int col_i = w.col0 + warp * COLS_PER_WARP + k;
    const Column<T, TA> col{static_cast<const TA*>(t.a) + w.local * lanes + col_i,
                            static_cast<const TA*>(t.c) + w.local * lanes + col_i, b + col_i, b + col_i,
                            WANT_X ? x + col_i : nullptr, t.len[w.local * C + col_i], nig};
    wide_column<T, TA, WANT_X>(t, col, stretch, cx, xx);
    if (w.seg == 0) zero_ghosts(ghost + col_i, t.q * t.L, t.L2, lane, 32);
  }
}

// Every thread of every block, after thread 0 wrote the block's partial: the
// last block to arrive adds all partials in block order into out (MAY_ADD:
// to out's sums, where p.add_out says an earlier launch left them there).
template <bool MAY_ADD>
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
    if (MAY_ADD && p.add_out) {
      u = p.out[0] + u;
      v = p.out[1] + v;
    }
    p.out[0] = u;
    p.out[1] = v;
    g_blocks_done = 0;
  }
}

// The ring's form: every unit of the launch. WIDE: the launch may hold a
// tile above the ring's cap (else none does).
template <typename T, typename TA, bool WANT_X, bool WIDE>
__device__ __forceinline__ void ring_units(const Args& p) {
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
    // producer: lane 0 fills the ring, unit after unit. Before an item goes
    // in, the oldest units in flight are waited for (released by the
    // consumers) until its slot is free and its bytes clash with none. A
    // wide unit takes a slot and no bytes: a bare arrival.
    if (lane == 0) {
      unsigned lo[SLOTS], hi[SLOTS];  // bytes of the units in flight, by slot
      Slot oldest;
      int in_flight = 0;
      for (long long unit = blockIdx.x; unit < p.n_items; unit += gridDim.x, slot.next()) {
        tw.seek(p, unit);
        const unsigned bytes = !WIDE || in_ring(tile.L) ? item_bytes<T, TA>(tile.L) : 0u;
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
          const Where<WIDE> w(tile, unit);
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
    // consumers: an item of the ring one thread a column, a wide unit one warp a column
    const int col_i = threadIdx.x;
    const float nig = *p.neg_inv_gamma;
    for (long long unit = blockIdx.x; unit < p.n_items; unit += gridDim.x, slot.next()) {
      tw.seek(p, unit);
      const Where<WIDE> w(tile, unit);
      const bool ringed = !WIDE || in_ring(tile.L);
      const unsigned at = walk.place(ringed ? item_bytes<T, TA>(tile.L) : 0u);
      mbar_wait(full0 + 8 * slot.i, slot.parity);
      if (ringed) {  // a, c, srow and length from shared memory
        const long long lanes = (long long)tile.L * C;
        T* const b = buf + w.srow(tile) + col_i;
        float* const x = WANT_X ? p.x + tile.x_off + w.local * lanes + col_i : nullptr;
        const unsigned char* sb = ring + at;
        const long long ab = lanes * (long long)sizeof(TA);
        const Column<T, TA> col{reinterpret_cast<const TA*>(sb) + col_i,
                                reinterpret_cast<const TA*>(sb + ab) + col_i,
                                reinterpret_cast<const T*>(sb + 2 * ab) + col_i, b, x,
                                reinterpret_cast<const int*>(sb + 2 * ab + lanes * sizeof(T))[col_i], nig};
        ring_item<T, TA, WANT_X>(tile, col, cx, xx);
        if (w.seg == 0) zero_ghosts(buf + tile.off + w.row * tile.L2 * C + col_i, tile.q * tile.L, tile.L2, 0, 1);
      } else if constexpr (WIDE) {
        wide_unit<T, TA, WANT_X>(p, tile, w, ring + RING_BYTES, nig, cx, xx);
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
  finish<false>(p);
}

// One real column of the block form, its lanes kept as ``Keep`` says; with
// BLOCK_REGS lanes a thread or fewer a and c are kept beside them, so that
// the emit only stores.
template <int KIND, class Keep, bool WANT_X, typename T, typename TA, class Reduce>
__device__ __forceinline__ void block_column(int L, const Proj& pr, const Column<T, TA>& col, Reduce& red,
                                             float* stretch, float& cx, float& xx) {
  constexpr int N = Keep::n;
  constexpr bool KEEP_AC = N > 0 && N <= BLOCK_REGS;
  [[maybe_unused]] float av[KEEP_AC ? N : 1], cv[KEEP_AC ? N : 1];
  const auto z = [&](int j, int l) {
    if constexpr (KEEP_AC) {
      av[j] = load(col.a + l * C);
      cv[j] = load(col.c + l * C);
      return col.z_kept(l, av[j], cv[j]);
    } else {
      return col.z(l);
    }
  };
  const auto emit = [&](int j, int l, float w) {
    if constexpr (KEEP_AC) col.template emit_kept<WANT_X>(l, w, av[j], cv[j], cx, xx);
    else col.template emit<WANT_X>(l, w, cx, xx);
  };
  project_column_group<KIND, Keep>(L, pr, red, stretch, z, emit);
}

// The block form: the launch's one tile (above STRETCH_L), a column a block
// of BT threads. Block b takes columns b, b + grid, ... in item order and adds
// their (obj, reg) in that order into its partial.
template <typename T, typename TA, bool WANT_X, int BT, int KEEP>
__device__ __forceinline__ void block_columns(const Args& p) {
  extern __shared__ __align__(128) unsigned char smem[];  // the column's z, where kept in shared memory
  __shared__ BlockTotals totals;
  BlockReduce<BT> red(totals);
  const Tile t = tile_at(p, 0);
  const Proj pr{t.inequality, t.lo, t.hi, t.has_lo, t.has_hi, t.radius};
  const float nig = *p.neg_inv_gamma;
  const int r = threadIdx.x;
  const long long lanes = (long long)t.L * C;
  T* const buf = static_cast<T*>(p.buf);
  float bx = 0.f, bxx = 0.f;
  for (long long u = blockIdx.x; u < p.n_items; u += gridDim.x) {
    const long long local = u / C;  // the column's item
    const int col_i = (int)(u - local * C);
    const long long row = local / t.q;
    const int seg = (int)(local - row * t.q);
    const int* const len = t.len + local * C;
    T* const b = buf + t.off + (row * t.L2 + (long long)seg * t.L) * C;  // the item's lane 0, column 0
    T* const ghost = buf + t.off + row * t.L2 * C;  // the buffer row's lane 0
    float* const x = WANT_X ? p.x + t.x_off + local * lanes : nullptr;
    if (len[col_i] == 0) {
      // padding: x = 0 and a*x = 0 on every lane, nothing read. In a group of
      // 8 such columns each column's block writes an eighth of the group's
      // lane rows by whole sectors (4 lane rows of the 8 columns a warp
      // instruction).
      const int c0 = col_i - col_i % WIDE_COLS;
      bool group = true;
#pragma unroll
      for (int i = 0; i < WIDE_COLS; ++i) group &= len[c0 + i] == 0;
      const int ci = group ? c0 + r % WIDE_COLS : col_i;
      const int l0 = group ? col_i % WIDE_COLS + WIDE_COLS * (r / WIDE_COLS) : r;
      for (int l = l0; l < t.L; l += BT) {
        store(b + (long long)l * C + ci, 0.f);
        if (WANT_X) x[(long long)l * C + ci] = 0.f;
      }
      if (seg == 0) zero_ghosts(ghost + ci, t.q * t.L, t.L2, l0, BT);
      continue;
    }
    const long long at = local * lanes + col_i;
    const Column<T, TA> col{static_cast<const TA*>(t.a) + at, static_cast<const TA*>(t.c) + at, b + col_i,
                            b + col_i, WANT_X ? x + col_i : nullptr, len[col_i], nig};
    float cx = 0.f, xx = 0.f;
    float* const stretch = reinterpret_cast<float*>(smem);
    if (t.kind == CLAMP) clamp_item<T, TA, WANT_X>(t, pr, col, cx, xx, r, BT);
    else if (t.kind == SIMPLEX) block_column<SIMPLEX, KeepOf<KEEP>, WANT_X>(t.L, pr, col, red, stretch, cx, xx);
    else block_column<BOXCUT, KeepOf<KEEP>, WANT_X>(t.L, pr, col, red, stretch, cx, xx);
    red.sum2(cx, xx);
    bx += cx;
    bxx += xx;
    if (seg == 0) zero_ghosts(ghost + col_i, t.q * t.L, t.L2, r, BT);
  }
  if (r == 0) {
    p.partials[2 * blockIdx.x] = bx;
    p.partials[2 * blockIdx.x + 1] = bxx;
  }
  finish<true>(p);
}

// Threads and blocks an SM of the ring's form (BT = 0) and of the block form.
constexpr int threads_of(int bt) { return bt ? bt : THREADS; }
constexpr int blocks_of(int bt) { return bt ? BLOCK_MAX / bt : MIN_BLOCKS; }

// The ring's form (BT = 0), or the block form of BT threads, its lanes kept
// as KEEP says. One name for both, so a trace reads them as one kernel.
template <typename T, typename TA, bool WANT_X, bool WIDE, int BT = 0, int KEEP = REGS>
__global__ void __launch_bounds__(threads_of(BT), blocks_of(BT)) panel_tiles_kernel(Args p) {
  if constexpr (BT > 0) block_columns<T, TA, WANT_X, BT, KEEP>(p);
  else ring_units<T, TA, WANT_X, WIDE>(p);
}

// Blocks a launch may take on the current device: as many as fit on every
// SM, worked out (and the kernel's shared memory opted in) at the first
// launch on each device.
template <typename T, typename TA, bool WANT_X, bool WIDE>
cudaError_t full_grid(int& grid) {
  static std::atomic<int> cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if ((grid = cached[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  auto kernel = panel_tiles_kernel<T, TA, WANT_X, WIDE>;
  // dynamic shared memory above the default 48 KB needs an opt-in per kernel
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<WIDE>());
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem_bytes<WIDE>())) != cudaSuccess) {
    return e;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  grid = sms * per_sm;
  cached[dev].store(grid, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename T, typename TA, bool WANT_X, bool WIDE>
int launch(Args& p, int max_grid, cudaStream_t s) {
  int grid = 0;
  const cudaError_t e = full_grid<T, TA, WANT_X, WIDE>(grid);
  if (e != cudaSuccess) return (int)e;
  if (grid > max_grid) grid = max_grid;
  if (grid > p.n_items) grid = (int)p.n_items;
  panel_tiles_kernel<T, TA, WANT_X, WIDE><<<grid, THREADS, smem_bytes<WIDE>(), s>>>(p);
  return (int)cudaGetLastError();
}

// The block form of the launch's tile of L lanes (above STRETCH_L), as many
// blocks as fit on every SM, at most one a column.
template <typename T, typename TA, bool WANT_X, int BT, int KEEP>
int launch_block(Args& p, int L, int max_grid, cudaStream_t s) {
  auto kernel = panel_tiles_kernel<T, TA, WANT_X, false, BT, KEEP>;
  const size_t smem = KEEP == SHARED ? (size_t)L * sizeof(float) : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BT, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long grid = (long long)sms * per_sm;
  if (grid > max_grid) grid = max_grid;
  if (grid > p.n_items) grid = p.n_items;
  kernel<<<(int)grid, BT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename TA, bool WANT_X>
int launch_block_of(Args& p, int L, int max_grid, cudaStream_t s) {
  switch (block_threads(L)) {
    case 128: return launch_block<T, TA, WANT_X, 128, REGS>(p, L, max_grid, s);
    case 256: return launch_block<T, TA, WANT_X, 256, REGS>(p, L, max_grid, s);
    case 512: return launch_block<T, TA, WANT_X, 512, REGS>(p, L, max_grid, s);
  }
  switch (block_keep(L)) {
    case REGS: return launch_block<T, TA, WANT_X, BLOCK_MAX, REGS>(p, L, max_grid, s);
    case REGS_LONG: return launch_block<T, TA, WANT_X, BLOCK_MAX, REGS_LONG>(p, L, max_grid, s);
    case SHARED: return launch_block<T, TA, WANT_X, BLOCK_MAX, SHARED>(p, L, max_grid, s);
    default: return launch_block<T, TA, WANT_X, BLOCK_MAX, NONE>(p, L, max_grid, s);
  }
}

template <typename V>
struct Of {  // a type passed by value, to pick a template instance
  using type = V;
};

// f(Of<carry type>, Of<tile type>, want_x) for the launch's carry bytes (4:
// float32, 2: bfloat16), tile bytes and K4 (x != nullptr).
template <class F>
int typed(int carry_bytes, int tile_bytes, bool want_x, F f) {
  const auto tiles = [&](auto carry) -> int {
    const auto x = [&](auto tile) -> int {
      return want_x ? f(carry, tile, std::true_type{}) : f(carry, tile, std::false_type{});
    };
    if (tile_bytes == 4) return x(Of<float>{});
    if (tile_bytes == 2) return x(Of<__nv_bfloat16>{});
    return (int)cudaErrorInvalidValue;
  };
  if (carry_bytes == 4) return tiles(Of<float>{});
  if (carry_bytes == 2) return tiles(Of<__nv_bfloat16>{});
  return (int)cudaErrorInvalidValue;
}

bool bad_launch(const Args& p, int max_grid) { return p.n_items < 1 || p.n_items >= (1ll << 31) || max_grid < 1; }

// The ring's form over p's units.
int dispatch(Args& p, int carry_bytes, int tile_bytes, int max_grid, cudaStream_t s) {
  if (bad_launch(p, max_grid)) return (int)cudaErrorInvalidValue;
  return typed(carry_bytes, tile_bytes, p.x != nullptr, [&](auto t, auto ta, auto want_x) {
    using T = typename decltype(t)::type;
    using TA = typename decltype(ta)::type;
    constexpr bool WANT_X = decltype(want_x)::value;
    return p.wide ? launch<T, TA, WANT_X, true>(p, max_grid, s) : launch<T, TA, WANT_X, false>(p, max_grid, s);
  });
}

// The block form over p's one tile, of L lanes, one unit a column.
int dispatch_block(Args& p, int L, int carry_bytes, int tile_bytes, int max_grid, cudaStream_t s) {
  if (L <= STRETCH_L || bad_launch(p, max_grid)) return (int)cudaErrorInvalidValue;
  return typed(carry_bytes, tile_bytes, p.x != nullptr, [&](auto t, auto ta, auto want_x) {
    using T = typename decltype(t)::type;
    using TA = typename decltype(ta)::type;
    return launch_block_of<T, TA, decltype(want_x)::value>(p, L, max_grid, s);
  });
}

}  // namespace

// Every tile of ``table`` (n_tiles rows in device memory, checked by the
// caller against the layout): the ring's form over n_items work units (none:
// no launch); wide != 0 if a tile is above the ring's cap (RING_L_CAP); then
// the block form on each of the n_blocks tiles above STRETCH_L, one launch
// each, given by ``blocks`` (host memory) as (table row, L, columns) triples
// in table order. carry_bytes: 4 (float32 buffer) or 2 (bfloat16);
// tile_bytes: the same for every tile's a and c. x == nullptr: K3; else K4.
// ``partials`` holds ``max_grid`` (obj, reg) pairs, used by each launch in
// turn; ``out`` receives the two sums over all launches.
extern "C" int dualip_panel_project_tiles(
    void* buf, int carry_bytes, int tile_bytes, const void* table, int n_tiles, long long n_items, int wide,
    const long long* blocks, int n_blocks, const float* neg_inv_gamma, float* x, float* partials, int max_grid,
    float* out, void* stream) {
  if (table == nullptr || n_tiles < 1 || n_items < 0 || n_blocks < 0 || (n_blocks > 0 && blocks == nullptr) ||
      n_items + n_blocks == 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args p{};
  p.buf = buf;
  p.table = static_cast<const Tile*>(table);
  p.n_tiles = n_tiles;
  p.n_items = n_items;
  p.wide = wide != 0;
  p.neg_inv_gamma = neg_inv_gamma;
  p.x = x;
  p.partials = partials;
  p.out = out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_items > 0) {
    const int e = dispatch(p, carry_bytes, tile_bytes, max_grid, s);
    if (e != 0) return e;
  }
  for (int k = 0; k < n_blocks; ++k) {
    const long long row = blocks[3 * k], L = blocks[3 * k + 1], columns = blocks[3 * k + 2];
    if (row < 0 || row >= n_tiles || L > INT_MAX) return (int)cudaErrorInvalidValue;
    Args q = p;
    q.table = p.table + row;
    q.n_tiles = 1;
    q.n_items = columns;
    q.add_out = n_items > 0 || k > 0;
    const int e = dispatch_block(q, (int)L, carry_bytes, tile_bytes, max_grid, s);
    if (e != 0) return e;
  }
  return (int)cudaSuccess;
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
  p.neg_inv_gamma = neg_inv_gamma;
  p.x = x;
  p.partials = partials;
  p.out = out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L > STRETCH_L) {  // the block form, as in the all-tiles call
    p.n_items = (long long)KP * q * C;
    return dispatch_block(p, L, carry_bytes, tile_bytes, max_grid, s);
  }
  p.n_items = (long long)KP * q * units_per_item(L);
  p.wide = !in_ring(L);
  return dispatch(p, carry_bytes, tile_bytes, max_grid, s);
}
