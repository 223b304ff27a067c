// 3x3 stride-1 SAME convolution at C_in = C_out = 64 (ResNet layer1's
// conv2) for Hopper (sm_90a): warp-specialised kernels that stage image
// rows with TMA through mbarrier rings and multiply on wgmma (bf16 x bf16
// -> float32).
//
// Replaces simclr_tpu/ops/pallas/conv64.py: _kernel (B4f, launched by the
// pallas_call in _conv_hwcn, line 160; also the input gradient, with the
// filter rotated 180 degrees and in/out swapped) and _wgrad_kernel (B4w,
// pallas_call in _wgrad_hwcn, line 250).
//
// Tensors are NHWC bf16 (channels_last in PyTorch): a pixel is 64
// channels, 128 bytes, which is exactly one row of the 128-byte swizzle
// (CU_TENSOR_MAP_SWIZZLE_128B). A TMA box of pixels therefore lands in
// shared memory in the layout a 128-byte-swizzle wgmma descriptor reads:
// K-major for B4f's pixels x ci, MN-major for B4w's pixels x co and
// pixels x ci. Each box is loaded three times, at column offsets dx = -1,
// 0 and +1 ("copies"); TMA's zero fill outside the tensor is the SAME
// padding, in both directions. With a row pitch wt that is a multiple of 8
// pixels, tap (dy, dx) of every output pixel is then copy dx read from
// (dy + 1) x wt pixels on: a whole number of 1024-byte swizzle atoms, so
// every tap is an aligned descriptor into the staged box and nothing is
// gathered again per tap.
//
// Geometry (`geometry`, mirrored by ops/kernels/conv64.py:geometry and
// tile_boxes; conv64_geometry returns it): an image row is cut into
// ceil(W / 64) column tiles of wt columns (W split evenly, rounded up to 8
// for B4f and 16 for B4w; columns past W are zeros on input and are
// computed but not stored on output). B4f tiles are `rows` output rows x
// wt columns of one image, at most 256 pixels, whose box of rows + 2 rows
// fits a 320-pixel slot; B4w items are 64 / wt rows (one at wt = 48, 64).
//
// What bounds them on the H100: at [1024, 64, 32, 32] (1,048,576 pixels)
// a pass moves 268 MB of bf16 (0.080 ms at 3.35 TB/s) and does 77.3 GFLOP
// (0.078 ms at 989 TFLOP/s): memory and tensor cores bound it nearly
// together, so the loads must overlap the products and neither may move
// much more than its share. A pixel is 36,864 MACs, 18 clocks of an SM's
// tensor cores (2,048 bf16 MACs a clock).
//
// B4f, conv64_fwd_kernel: an implicit GEMM with M = 64 output channels,
// N = pixels and K = 9 taps x 64 input channels. One persistent block of
// 288 threads on each SM: warp 8 is the producer (the packed filter, 72 KB,
// once by a bulk copy; then per tile the three copies of its box
// [64 channels, wt columns, rows + 2 rows, 1 image], from row r0 - 1, into
// a ring of three 40 KB slots, one per copy, so the next tile's copy dx
// loads while this tile's later copies are multiplied); warpgroups 0 and 1
// each own 128 of the tile's pixels (m64n128k16, 64 float32 accumulators a
// thread, A = the filter tap and B = the shifted copy, both K-major). A
// consumer releases a slot as soon as its 12 products (3 dy x 4 k-steps)
// are done. Shared-memory operand traffic, at the tensor cores' rate:
// M = 64 pixels x N = 64 co (m64n64k16) would read 2 KB of A and 2 KB of B
// per 32 clocks, 128 B a clock, the SM's whole shared-memory rate; this
// orientation reads 2 KB of filter and 4 KB of pixels per 64 clocks, 96 B
// a clock (80 at N = 256, which would need 128 accumulators). The TMA
// writes add 3 x 10/8 x 128 B a pixel (27 B a clock at rows = 8) and the
// epilogue's staging 256 B a pixel (14 B a clock): about 137 B a clock in
// all, so shared memory allows some 93% of the tensor rate. x crosses L2
// 3 x (1 + 2 / rows) times (3.75 at the path's shape, 503 MB a call; a
// gather per tap would read it 9 times, 1.21 GB). The epilogue rounds to
// bf16 once, transposes through shared memory (stmatrix.trans into the
// tile's [pixel][64 co] in the 128-byte swizzle) and writes the tile with
// one TMA store, which leaves out what lies outside the image; the
// warpgroups go on to the next tile while the store drains (16-byte
// stores by the warpgroups themselves ran markedly slower on an H100).
// Shared memory: filter 73,728 + ring 3 x 40,960 + staging 32,768 +
// barriers = 229,440 bytes of the 232,448 a block may have.
//
// (B4w reads its warp index through a shuffle, warp_index: with threadIdx
// / 32, ptxas serialised its products, C7520; B4f still does.)
//
// B4w, conv64_wgrad_kernel: dW[tap][co][ci] = sum over pixels p of
// g[p][co] x[p + tap][ci], M = 64 co (A = g, MN-major), N = 3 dx x 64 ci
// (B = the three copies of an x row, MN-major, the descriptor's leading
// offset stepping from one copy to the next) and K = pixels. One block of
// 416 threads per pixel range: warp 12 is the producer (per item, 64
// pixels of rows of one image: boxes of its three x copies and of its g
// rows, 32 KB, into a ring of 7 items); warpgroup ky = dy + 1 multiplies
// g of each row r by the x copies of row r + dy (m64n192k16, 96
// accumulators a thread: all 9 taps stay in registers across the three
// warpgroups), the row above or below coming from the neighbouring item.
// So each staged x row feeds all nine taps and is loaded once per dx, g
// once: 3 + 1 crossings of L2 (537 MB a call; a block per dy would read
// x 9 times and g 3 times, 1.61 GB). Operand traffic: 2 KB of g and 6 KB of x per 96
// clocks, 85 B a clock, plus 512 B a pixel of TMA writes (28 B a clock).
// A step is one item: four products a warpgroup (the k-steps unrolled at
// compile time, one instantiation per wt / 16), one commit, and the
// release of item s - 2 once step s - 1's products are done. Items of one
// row (two products a step, the k-loop at run time) ran markedly slower on
// an H100: the barrier waits and the loop sat between too few products.
// A warpgroup skips the rows whose r + dy falls outside the image. The
// items (N x column tiles x row tiles, in that order) are split into
// min(items, SMs) ranges of equal shares (132 at the path's shape, 124 or
// 125 items each), so every SM does the same work. Each block writes its float32 partial,
// [range][tap][co][ci], 132 x 9 x 64 x 64 x 4 B = 19.5 MB at 132 ranges,
// and conv64_wgrad_reduce sums them over the ranges in a fixed order: no
// atomics, so dW is the same from run to run. dW is float32 and not
// rounded (the JAX kernel returns it so too).
// Shared memory: ring 229,376 + barriers 192 = 229,568 bytes.
//
// Both kernels check that their dynamic shared memory starts on a
// 1024-byte boundary (the swizzle atoms and TMA's swizzle assume it) and
// trap otherwise. A launch the runtime refuses returns its error.

#include <algorithm>

#include "hopper.cuh"

namespace {

using simclr::aligned16;
using simclr::bulk_commit;
using simclr::bulk_load;
using simclr::bulk_wait;
using simclr::bulk_wait_read;
using simclr::desc_sw128;
using simclr::fence_operands;
using simclr::fence_proxy_async;
using simclr::mbar_arrive;
using simclr::mbar_expect_tx;
using simclr::mbar_fence_init;
using simclr::mbar_init;
using simclr::mbar_wait;
using simclr::named_barrier;
using simclr::sm_count;
using simclr::smem_addr;
using simclr::stmatrix_x4_trans;
using simclr::tma_load_4d;
using simclr::tma_prefetch_map;
using simclr::tma_store_4d;
using simclr::wgmma_64x128x16;
using simclr::wgmma_64x192x16;
using simclr::wgmma_commit;
using simclr::wgmma_fence;
using simclr::wgmma_wait;
using simclr::warp_index;

constexpr int C = 64;               // input and output channels
constexpr int TAPS = 9;
constexpr int PX = C * 2;           // bytes of one pixel: one swizzle row
constexpr int ATOM = 8 * PX;        // 1024-byte swizzle atom, 8 pixels
constexpr int MAX_WT = 64;          // columns of a column tile

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// B4f
constexpr int F_THREADS = 288;      // warpgroups 0-1 consume, warp 8 loads
constexpr int F_CHUNK = 128;        // pixels of one consumer warpgroup
constexpr int F_TILE = 2 * F_CHUNK;
constexpr int F_SLOT_PX = 320;      // pixels of one copy of a tile's box
constexpr int F_SLOT = F_SLOT_PX * PX;
constexpr int F_FILTER = TAPS * C * PX;         // 73,728
constexpr int F_RING = F_FILTER;
constexpr int F_STAGE = F_RING + 3 * F_SLOT;    // 196,608
constexpr int F_BAR = F_STAGE + 2 * F_CHUNK * PX;
constexpr int F_SMEM = F_BAR + 64;
static_assert(F_SLOT % ATOM == 0 && F_RING % ATOM == 0, "atoms");
static_assert(F_SMEM <= 232448, "B4f shared memory");

// B4w
constexpr int W_THREADS = 416;      // warpgroups 0-2 consume, warp 12 loads
constexpr int W_ITEM_PX = 64;       // pixels of an item's rows (at most)
constexpr int W_RING_BYTES = 7 * 4 * W_ITEM_PX * PX;   // 229,376
constexpr int W_MAX_ITEMS = 12;     // ring slots (9 at wt = 48, else 7)
constexpr int W_BAR = W_RING_BYTES;
constexpr int W_SMEM = W_BAR + 2 * W_MAX_ITEMS * 8;
static_assert(W_SMEM <= 232448, "B4w shared memory");

// ---------------------------------------------------------------------------
// Geometry
// ---------------------------------------------------------------------------

struct Geom {
  int wt;     // columns of a column tile (a multiple of 8, 16 for B4w)
  int rows;   // output rows of a tile (B4w: rows of an item)
  int nct;    // column tiles of an image row
  int nrt;    // row tiles of an image
  int tiles;  // n x nrt x nct tiles (B4w: items)
};

// kernel 0: B4f tiles, ordered (image, row tile, column tile), the last
// fastest; kernel 1: B4w items, ordered (image, column tile, row tile).
Geom geometry(int n, int h, int w, int kernel) {
  Geom q;
  q.nct = cdiv(w, MAX_WT);
  const int align = kernel == 0 ? 8 : 16;
  q.wt = cdiv(cdiv(w, q.nct), align) * align;
  q.rows = kernel == 0 ? std::max(1, std::min({h, F_TILE / q.wt,
                                               F_SLOT_PX / q.wt - 2}))
                       : std::max(1, W_ITEM_PX / q.wt);
  q.nrt = cdiv(h, q.rows);
  q.tiles = n * q.nrt * q.nct;
  return q;
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void check_atoms(const void* smem) {
  if (smem_addr(smem) & (ATOM - 1)) __trap();
}

// ---------------------------------------------------------------------------
// B4f
// ---------------------------------------------------------------------------

// y = conv3x3(x, w) for the tiles blockIdx.x, + gridDim.x, ...; wpk is the
// packed filter (ops/kernels/conv64.py:pack_filter): [tap][co][ci] with
// the 16-byte chunk c of row co at chunk c ^ (co % 8), the K-major
// 128-byte-swizzle layout, 8 KB a tap.
__global__ void __launch_bounds__(F_THREADS, 1)
conv64_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap ymap,
                  const unsigned char* __restrict__ wpk, Geom q) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + F_BAR);
  uint64_t* full = bar;        // [3] copy j of the tile has landed
  uint64_t* empty = bar + 3;   // [3] both warpgroups are done with it
  uint64_t* wbar = bar + 6;    // the filter has landed
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int block = blockIdx.x, grid = gridDim.x;
  const int mine = q.tiles > block ? cdiv(q.tiles - block, grid) : 0;
  if (tid == 0) {
    check_atoms(smem);
    for (int j = 0; j < 3; ++j) {
      mbar_init(&full[j], 1);
      mbar_init(&empty[j], 8);
    }
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane != 0) return;
    tma_prefetch_map(&xmap);
    tma_prefetch_map(&ymap);
    mbar_expect_tx(wbar, F_FILTER);
    bulk_load(smem, wpk, F_FILTER, wbar);
    const uint32_t bytes = PX * q.wt * (q.rows + 2);
    for (int i = 0; i < mine; ++i) {
      const int t = block + i * grid;
      const int ct = t % q.nct, rt = (t / q.nct) % q.nrt,
                img = t / (q.nct * q.nrt);
      for (int j = 0; j < 3; ++j) {
        mbar_wait(&empty[j], (i & 1) ^ 1);
        mbar_expect_tx(&full[j], bytes);
        tma_load_4d(smem + F_RING + j * F_SLOT, &xmap, &full[j], 0,
                    ct * q.wt + j - 1, rt * q.rows - 1, img);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns pixels [128 wg, 128 wg + 128) of each
  // tile; thread rows 16 wr + lane / 4 (+ 8) are output channels, columns
  // pixels. Where a tile has fewer pixels, the rest are computed from
  // whatever follows the box in shared memory and are not stored.
  const int wg = warp >> 2, wr = warp & 3;
  unsigned char* stage = smem + F_STAGE + wg * F_CHUNK * PX;
  const uint64_t da0 = desc_sw128(smem, 16, ATOM);
  const uint64_t db0 = desc_sw128(smem + F_RING, 16, ATOM);
  const uint32_t chunk_off = F_CHUNK * wg * PX;
  mbar_wait(wbar, 0);
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  for (int i = 0; i < mine; ++i) {
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      mbar_wait(&full[j], i & 1);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // Start addresses in 16-byte units; shared memory stays below
          // 2**18 bytes, so the sum never carries out of the field.
          const uint64_t da = da0 + (((3 * ky + j) * C * PX + 32 * k) >> 4);
          const uint64_t db =
              db0 + ((j * F_SLOT + ky * q.wt * PX + chunk_off + 32 * k) >> 4);
          wgmma_64x128x16<0, 0>(acc, da, db, (j | ky | k) != 0);
        }
      wgmma_commit();
      if (j > 0) {
        // Copy j - 1's products are done: release its slot.
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[j - 1]);
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[2]);

    // Epilogue: bf16 outputs transposed into the staging buffer as the
    // tile's [pixel][64 co] (16-byte chunk c of pixel p at c ^ (p % 8), as
    // a 128-byte-swizzle box), then one TMA store of the tile's box, which
    // leaves out what lies outside the image. Thread 0 issues the stores
    // and waits for the last one to have read the staging first.
    const int t = block + i * grid;
    const int ct = t % q.nct, rt = (t / q.nct) % q.nrt,
              img = t / (q.nct * q.nrt);
    if (tid == 0) bulk_wait_read<0>();
    named_barrier(1, 256);
    const int mq = lane >> 3, mrow = lane & 7;
#pragma unroll
    for (int jj = 0; jj < 16; jj += 2) {
      const int p = 8 * (jj + (mq >> 1)) + mrow, c = 2 * wr + (mq & 1);
      stmatrix_x4_trans(smem_addr(stage + p * PX + ((c ^ (p & 7)) << 4)),
                        pack(acc[4 * jj], acc[4 * jj + 1]),
                        pack(acc[4 * jj + 2], acc[4 * jj + 3]),
                        pack(acc[4 * jj + 4], acc[4 * jj + 5]),
                        pack(acc[4 * jj + 6], acc[4 * jj + 7]));
    }
    fence_proxy_async();
    named_barrier(1, 256);
    if (tid == 0) {
      tma_store_4d(&ymap, smem + F_STAGE, 0, ct * q.wt, rt * q.rows, img);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// B4w
// ---------------------------------------------------------------------------

// One range's partial dW [tap][co][ci] float32 over items [b0, b1) of
// `items`, the range blockIdx.x / tiles of `ranges` equal shares, for the
// 64 x 64 channel tile blockIdx.x % tiles of x and g with c channels
// (tiles = (c / 64)^2: 1 for layer1's conv; the fused bottleneck's dw2
// takes c up to 512; the CTAs of one range are adjacent, so that the
// range crosses L2 about once). An item is
// q.rows = RS rows of wt = 16 KS columns of one image (64 pixels, or 48
// at wt = 48): its three x copies (dx = -1, 0, 1) and its g rows, each a
// box of RS x wt pixels; the ring holds `ring` (at least 5) items.
template <int KS>
__global__ void __launch_bounds__(W_THREADS, 1)
conv64_wgrad_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap gmap,
                    float* __restrict__ partial, Geom q, int h, int ring,
                    int c, int ranges) {
  constexpr int RS = KS == 3 ? 1 : 4 / KS;   // rows of an item
  constexpr int ROW = 16 * KS * PX;          // bytes of one row of a copy
  constexpr int COPY = RS * ROW;
  constexpr int ITEM = 4 * COPY;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W_BAR);
  uint64_t* empty = full + W_MAX_ITEMS;
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_index();
  const long long items = q.tiles;
  const int cb = c / C, tiles = cb * cb;
  const int range = blockIdx.x / tiles, tile = blockIdx.x - range * tiles;
  const int co0 = (tile / cb) * C, ci0 = (tile % cb) * C;
  const int b0 = static_cast<int>(items * range / ranges);
  const int b1 = static_cast<int>(items * (range + 1) / ranges);
  if (tid == 0) {
    check_atoms(smem);
    for (int s = 0; s < ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 12);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Ring position k holds item b0 - 1 + k: the range and one item of halo
  // on each side (the consumers read only the halo rows that lie in the
  // same image and column tile; items outside the batch are not loaded).
  // Slot, phase and the item's (row tile, column tile, image) are kept as
  // counters: no division in the loops.
  if (warp == 12) {
    if (lane != 0) return;
    tma_prefetch_map(&xmap);
    tma_prefetch_map(&gmap);
    int slot = 0, phase = 0, rt = 0, ct = 0, img = 0;
    if (b0 > 0) {
      rt = (b0 - 1) % q.nrt;
      ct = ((b0 - 1) / q.nrt) % q.nct;
      img = (b0 - 1) / (q.nrt * q.nct);
    }
    for (int i = b0 - 1; i <= b1; ++i) {
      mbar_wait(&empty[slot], phase ^ 1);
      if (i < 0 || i >= items) {
        mbar_arrive(&full[slot]);
      } else {
        unsigned char* dst = smem + slot * ITEM;
        mbar_expect_tx(&full[slot], ITEM);
        for (int j = 0; j < 3; ++j)
          tma_load_4d(dst + j * COPY, &xmap, &full[slot], ci0,
                      ct * q.wt + j - 1, rt * RS, img);
        tma_load_4d(dst + 3 * COPY, &gmap, &full[slot], co0, ct * q.wt,
                    rt * RS, img);
        if (++rt == q.nrt) {
          rt = 0;
          if (++ct == q.nct) {
            ct = 0;
            ++img;
          }
        }
      }
      if (++slot == ring) {
        slot = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumers: warpgroup ky (dy = ky - 1) accumulates taps (ky, 0..2):
  // thread rows 16 wr + lane / 4 (+ 8) are co, columns dx x 64 + ci. Row
  // rho of an item meets x row rho + dy: in the same item, or the last row
  // of the item before (rho = 0, dy = -1) or the first of the item after
  // (rho = RS - 1, dy = 1), where that row is in the image.
  const int ky = warp >> 2, dy = ky - 1, wr = warp & 3;
  const uint64_t d0 = desc_sw128(smem, COPY, ATOM);
  float acc[96];
#pragma unroll
  for (int e = 0; e < 96; ++e) acc[e] = 0.f;
  // No instruction but wgmma touches acc inside the loop: an operand
  // fence there would make ptxas serialise the products.
  fence_operands(acc);
  wgmma_fence();
  // Item s sits at ring position s - b0 + 1.
  int slot = 1, phase = 0, rt = b0 % q.nrt;
  for (int s = b0; s < b1; ++s) {
    const bool above = dy < 0 && rt > 0;
    const bool below = dy > 0 && (rt + 1) * RS < h;
    int xs = slot, xphase = phase;
    if (above || below) {
      xs = slot + dy;
      if (xs < 0 || xs == ring) {
        xs -= dy * ring;
        xphase ^= 1;
      }
      mbar_wait(&full[xs], xphase);
    }
    mbar_wait(&full[slot], phase);
    const uint32_t g_at = slot * ITEM + 3 * COPY;
#pragma unroll
    for (int rho = 0; rho < RS; ++rho) {
      const int xr = rho + dy;
      if (xr < 0 && !above) continue;
      if (xr == RS && !below) continue;
      const uint32_t x_at = xr < 0 ? xs * ITEM + (RS - 1) * ROW
                            : xr == RS ? xs * ITEM
                                       : slot * ITEM + xr * ROW;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_64x192x16<1, 1>(
            acc, d0 + ((g_at + rho * ROW + kk * 2 * ATOM) >> 4),
            d0 + ((x_at + kk * 2 * ATOM) >> 4), 1);
    }
    wgmma_commit();
    // Step s - 1's products are done: item s - 2 is no longer read.
    wgmma_wait<1>();
    if (s > b0) {
      __syncwarp();
      if (lane == 0)
        mbar_arrive(&empty[slot >= 2 ? slot - 2 : slot + ring - 2]);
    }
    if (++slot == ring) {
      slot = 0;
      phase ^= 1;
    }
    if (++rt == q.nrt) rt = 0;
  }
  wgmma_wait<0>();
  fence_operands(acc);

  float* out = partial + static_cast<long long>(range) * TAPS * c * c;
#pragma unroll
  for (int j = 0; j < 24; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = 16 * wr + (lane >> 2) + 8 * half;
      const int tap = 3 * ky + j / 8, ci = 8 * (j % 8) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(
          out + (static_cast<long long>(tap) * c + co0 + co) * c + ci0 +
          ci) = make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
}

// dw[co][ci][ky][kx] = sum over ranges, in order, of the partials.
__global__ void __launch_bounds__(256)
conv64_wgrad_reduce(const float* __restrict__ partial, int ranges,
                    float* __restrict__ dw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= TAPS * C * C) return;
  float acc = 0.f;
#pragma unroll 4
  for (int r = 0; r < ranges; ++r) acc += partial[r * TAPS * C * C + j];
  const int tap = j / (C * C), co = (j / C) % C, ci = j % C;
  dw[(co * C + ci) * TAPS + tap] = acc;
}

bool shape_ok(int n, int h, int w, int c = C) {
  return n > 0 && h > 0 && w > 0 &&
         static_cast<long long>(n) * h * w * c < (1LL << 31);
}

simclr::SmemOptIn fwd_smem;
simclr::SmemOptIn wgrad_smem[4];

template <int KS>
cudaError_t wgrad_launch(const CUtensorMap& xmap, const CUtensorMap& gmap,
                         float* partial, const Geom& q, int h, int ring,
                         int c, int ranges, cudaStream_t s) {
  cudaError_t err = wgrad_smem[KS - 1](conv64_wgrad_kernel<KS>, W_SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (c / C) * (c / C);
  conv64_wgrad_kernel<KS><<<ranges * tiles, W_THREADS, W_SMEM, s>>>(
      xmap, gmap, partial, q, h, ring, c, ranges);
  return cudaGetLastError();
}

// B4w's partials over `ranges` pixel ranges of x and g (NHWC bf16, c
// channels, c a multiple of 64): partial [range][tap][co][ci] float32.
cudaError_t wgrad_partials(const void* x, const void* g, float* partial,
                           int n, int h, int w, int c, int ranges,
                           cudaStream_t s) {
  if (!shape_ok(n, h, w, c) || c % C != 0 || ranges < 1 || !aligned16(x) ||
      !aligned16(g))
    return cudaErrorInvalidValue;
  const Geom q = geometry(n, h, w, 1);
  if (ranges > q.tiles) return cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  const uint32_t box[4] = {C, static_cast<uint32_t>(q.wt),
                           static_cast<uint32_t>(q.rows), 1};
  if (!simclr::nhwc_tensor_map(&xmap, x, n, h, w, c, box, true) ||
      !simclr::nhwc_tensor_map(&gmap, g, n, h, w, c, box, true))
    return cudaErrorInvalidValue;
  const int ring =
      std::min(W_MAX_ITEMS, W_RING_BYTES / (4 * q.rows * q.wt * PX));
  switch (q.wt / 16) {
    case 1: return wgrad_launch<1>(xmap, gmap, partial, q, h, ring, c,
                                   ranges, s);
    case 2: return wgrad_launch<2>(xmap, gmap, partial, q, h, ring, c,
                                   ranges, s);
    case 3: return wgrad_launch<3>(xmap, gmap, partial, q, h, ring, c,
                                   ranges, s);
    default: return wgrad_launch<4>(xmap, gmap, partial, q, h, ring, c,
                                    ranges, s);
  }
}

}  // namespace

extern "C" {

// The tiles of kernel 0 (B4f) or the items of kernel 1 (B4w) at this
// shape, out = {wt, rows, column tiles, row tiles, tiles, blocks}, blocks
// being the grid (B4w: the pixel ranges, and so the partials); 0, or -1
// for a shape the kernels refuse.
int conv64_geometry(int n, int h, int w, int kernel, int* out) {
  if (!shape_ok(n, h, w) || (kernel != 0 && kernel != 1)) return -1;
  const Geom q = geometry(n, h, w, kernel);
  const int v[6] = {q.wt, q.rows, q.nct, q.nrt, q.tiles,
                    std::min(q.tiles, sm_count())};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// y = conv3x3(x, w), NHWC bf16, stride 1, SAME. wpk is the filter packed
// by ops/kernels/conv64.py:pack_filter (for the input gradient, the filter
// rotated 180 degrees with in/out swapped).
int conv64_fwd(const void* x, const void* wpk, void* y, int n, int h, int w,
               void* stream) {
  if (!shape_ok(n, h, w) || !aligned16(x) || !aligned16(wpk) ||
      !aligned16(y))
    return cudaErrorInvalidValue;
  const Geom q = geometry(n, h, w, 0);
  CUtensorMap xmap, ymap;
  const uint32_t xbox[4] = {C, static_cast<uint32_t>(q.wt),
                            static_cast<uint32_t>(q.rows + 2), 1};
  const uint32_t ybox[4] = {C, static_cast<uint32_t>(q.wt),
                            static_cast<uint32_t>(q.rows), 1};
  if (!simclr::nhwc_tensor_map(&xmap, x, n, h, w, C, xbox, true) ||
      !simclr::nhwc_tensor_map(&ymap, y, n, h, w, C, ybox, true))
    return cudaErrorInvalidValue;
  cudaError_t err = fwd_smem(conv64_fwd_kernel, F_SMEM);
  if (err != cudaSuccess) return err;
  conv64_fwd_kernel<<<std::min(q.tiles, sm_count()), F_THREADS, F_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      xmap, ymap, static_cast<const unsigned char*>(wpk), q);
  return cudaGetLastError();
}

// dw (64, 64, 3, 3) float32 of y = conv3x3(x, w) for the cotangent g, both
// NHWC bf16. partial: float32 scratch of blocks x 9 x 64 x 64, blocks
// from conv64_geometry(n, h, w, 1, ...).
int conv64_wgrad(const void* x, const void* g, void* partial, void* dw, int n,
                 int h, int w, void* stream) {
  if (!shape_ok(n, h, w)) return cudaErrorInvalidValue;
  const int ranges = std::min(geometry(n, h, w, 1).tiles, sm_count());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = wgrad_partials(x, g, static_cast<float*>(partial), n, h,
                                   w, C, ranges, s);
  if (err != cudaSuccess) return err;
  conv64_wgrad_reduce<<<cdiv(TAPS * C * C, 256), 256, 0, s>>>(
      static_cast<const float*>(partial), ranges, static_cast<float*>(dw));
  return cudaGetLastError();
}

// The fused bottleneck's dw2 (csrc/bottleneck.cu): B4w's float32 partials
// [range][tap][co][ci] of the 3x3 convolution of x (NHWC bf16, c
// channels) with cotangent g over `ranges` pixel ranges (at most
// conv64_geometry's items).
int conv3x3_wgrad_partials(const void* x, const void* g, void* partial,
                           int n, int h, int w, int c, int ranges,
                           void* stream) {
  return wgrad_partials(x, g, static_cast<float*>(partial), n, h, w, c,
                        ranges, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
