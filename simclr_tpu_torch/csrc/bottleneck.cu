// The fused stride-1 identity bottleneck of ResNet-50 for Hopper (sm_90a):
// forward (B6f) and recompute-from-x backward (B6b), warp-specialised
// kernels that stream the weights through an mbarrier ring and multiply on
// wgmma (bf16 x bf16 -> float32).
//
// Replaces simclr_tpu/ops/pallas/bottleneck.py: _fwd_kernel (B6f,
// launched by the pallas_call in _fused_fwd, line 213) and _bwd_kernel
// (B6b, pallas_call in _fused_bwd, line 237). Per pixel, with x of 4C
// = F channels, bf16 weights and float32 per-channel affines:
//   y1 = x w1, a1 = bf16(relu(y1 A1 + B1)), y2 = conv3x3(a1, w2) (SAME,
//   zero padding of a1), a2 = bf16(relu(y2 A2 + B2)), y3 = a2 w3,
//   out = bf16(relu(y3 A3 + B3 + x)).
// The backward recomputes that from x and rounds dy3, dy2, dy1 and dx (once)
// to bf16, as the Pallas body does; the masks come from the float32
// pre-activations, and every affine is a product then a sum (no fused
// multiply-add), as in the plain version.
//
// Tensors are NHWC (channels_last in PyTorch): a pixel is a row of F (or C)
// bf16, and every operand tile in shared memory is a [64 rows][64
// channels] block in the 128-byte swizzle (a TMA box of the [pixels][
// channels] matrix lands so), read by K-major wgmma descriptors.
//
// Tiles (`make_geo`, mirrored by ops/kernels/bottleneck.py:geometry). A
// consumer warpgroup owns a tile of at most 64 output pixels, one wgmma M:
// whole images where an image has at most 64 pixels (layer3's 8x8, four
// of layer4's 4x4: no halo, conv1 runs on the tile alone), else a range
// of at most 64 pixels of one image (layer1: two rows of 32, layer2: four
// of 16) whose a1 is computed on the tile plus the rows around it (the
// halo, W or W + 1 pixels on each side: 128 and 96 pixels at layers 1-2,
// two 64-row blocks, one conv1 round at layer1, two at layer2). The 3x3
// taps gather a1 per pixel: the A operand of conv2 comes from registers,
// loaded by ldmatrix with one row address a lane, a zero row where the
// neighbour lies outside the pixel's image (SAME pads a1 with zeros,
// never with relu(B1), and never reads another image's row).
//
// Blocks (Cfg): two tiles share every weight chunk, so every weight byte
// fetched from L2 serves 128 output pixels at every stage (the mma.sync
// design's tiles of 8192 / C pixels served 128, 64, 32 and 16). At C <=
// 128 a block has two consumer warpgroups, one a tile, and a producer warp
// (288 threads; ptxas then allows 168 registers a thread, as for 384); at
// C >= 256 a tile's a1 and a2 fill a block's shared memory, so a block
// has one warpgroup (160 threads, 255 registers) and blocks run in
// clusters of two whose producers each bring half of every chunk to both
// by a multicast bulk copy. A ring slot (32 KB) is released when every
// consumer warp of the block or cluster has arrived on its empty barrier.
// One warpgroup a block runs every epilogue with one warp a scheduler,
// which leaves its latency bare; the second warpgroup made B6f markedly
// faster at C <= 128 on an H100.
//
// Weights: pack_weights (ops/kernels/bottleneck.py) lays each matrix out
// as [pass][64-deep step][rows of the pass][64] in the 128-byte swizzle,
// so that a slot (4, 2 or 1 steps at 64, 128 or 256 rows) is one copy.
// Products, all m64nNk16 with N <= 128 (64 accumulators a thread; at 256,
// BWD1 spilled) on a warpgroup, one commit and wait every 64-deep
// step (4 products, or 8 for conv1 on two halo blocks), one step in flight
// while the next is issued:
//   conv1  A = x (TMA boxes of the halo, streamed through the warpgroup's
//          halo buffer in boxes no earlier round has filled, see
//          round_box), B = w1; N = min(C, 128) (x comes in again for
//          each pass at C >= 256), two 64-row blocks a round at C = 64.
//   conv2  A = a1 gathered into registers (two sets, one a step), B = w2
//          ([co][tap][ci]); N = min(C, 128).
//   conv3  A = a2 (shared memory), B = w3, in passes of 128 (B6f's output
//          in 16-byte stores, the quad's lanes exchanging their pairs).
//   B6b:   da2 = dy3 w3 (A = dy3 by TMA), conv3x3^T(dy2) (A = dy2 gathered
//          from its halo, B = w2 rotated and swapped), both in passes of
//          min(C, 128); dx = dy1 w1 (A = dy1 in shared memory), passes of
//          128.
// B6f is one kernel (mode FWD). B6b runs the same kernel three times
// (modes BWD1-3) and the weight gradients after:
//   BWD1  the forward through y3 with another epilogue: u3 = g [pre3 > 0]
//         (its mask as bits), dA3/dB3, dy3; it stores a1, a2 (bf16) and y1,
//         y2 (float32) at the tile's pixels for the later steps.
//   BWD2  da2 = dy3 w3^T; u2, dA2/dB2, dy2.
//   BWD3  dy2 with its halo by TMA, da1 = conv3x3^T(dy2); u1 from y1,
//         dA1/dB1, dy1; dx = bf16(dy1 w1^T + g [pre3 > 0]).
//   dw3 = dy3^T a2 and dw1 = x^T dy1 (bottleneck_wgrad_kernel: 128 x N
//   output tiles, both operands MN-major from TMA boxes of 64 pixels, the
//   blocks of one pixel range adjacent in the grid so that the range
//   crosses L2 about once), dw2 by conv64.cu's weight-gradient kernel
//   (three column-shifted row boxes of a1, one of dy2, all nine taps from
//   one staging, per 64 x 64 channel tile), each as float32 partials over
//   pixel ranges.
// Cross-block sums have no atomics: every warp stores its affine column
// sums of each tile in a row of its own, and the weight gradients one
// partial per range; bottleneck_sum_rows adds rows in a fixed order, so
// every result is the same from run to run.
//
// What ptxas needs to keep the products asynchronous (each lapse slowed
// them several times on an H100): the warp index read through a shuffle
// (warp_index), else every wgmma behind a branch on it is serialised
// (C7520); accumulators zeroed and fenced before a pass (an undefined
// accumulator cost registers and serialisation); one step in flight (two,
// with three sets of A registers, serialised the forward kernels again).
// The epilogues read their read-only operands through __ldg: plain loads
// do not move past the epilogue's stores and stalled each warp for the
// whole latency. Phase clocks of block 0 (B6_MARK, a build with
// -DSIMCLR_B6_TRACE, `python3 chip_smoke.py b6_trace`) show where a tile's
// time goes.
//
// What bounds it on the H100: at 1,024 images a block's forward is 146
// GFLOP (34.4 + 77.3 + 34.4) and its backward 438 GFLOP; at 989 TFLOP/s
// bf16 that is 0.148 and 0.443 ms, above the bytes of x, out, g and dx
// except at layer1 (537 MB of x: 0.321 and 0.481 ms) and for B6f at
// layer2 (0.160 ms). What this design still does beyond that: the weight
// stream (each SM receives a block's whole weights for every pair of
// tiles: 2.2 MB at C = 256, 8.9 MB at C = 512, at about 24 bytes a clock
// an SM this bounds layers 3-4); conv1 on the halo at layers 1-2; the
// epilogues' single pass over their columns with few warps to hide it;
// the backward's scratch (a1, a2, dy1, dy2 bf16, y1, y2 float32, dy3 F
// wide: 20 F / 4 bytes a pixel, plus F / 8 of mask) written and read
// again; x, g and dy3 each read twice; dw2 on B4w's 16-column row items,
// which at layers 3-4 (W = 8 and 4) multiply 2 and 4 times the pixels.

#include <algorithm>

#include "hopper.cuh"

namespace {

using simclr::aligned16;
using simclr::bulk_load;
using simclr::bulk_load_multicast;
using simclr::cluster_rank;
using simclr::cluster_sync;
using simclr::desc_sw128;
using simclr::fence_operands;
using simclr::fence_proxy_async;
using simclr::ldsm_x4;
using simclr::mbar_arrive;
using simclr::mbar_arrive_cluster;
using simclr::mbar_expect_tx;
using simclr::mbar_fence_init;
using simclr::mbar_init;
using simclr::mbar_wait;
using simclr::named_barrier;
using simclr::sm_count;
using simclr::smem_addr;
using simclr::start_acc;
using simclr::tma_load_2d;
using simclr::tma_prefetch_map;
using simclr::wgmma_commit;
using simclr::wgmma_fence;
using simclr::wgmma_rs;
using simclr::wgmma_ss;
using simclr::wgmma_wait;
using simclr::warp_index;

typedef __nv_bfloat16 bf16;

constexpr int TILE_ELEMS = 8192;    // the gate: W <= TILE_ELEMS / C
constexpr int MT = 64;              // output pixels of a tile (wgmma M)
constexpr int BOX = 64 * 128;       // [64 rows][64 bf16], one TMA box
constexpr int SLOT = 32768;         // weight ring slot
constexpr int MAX_ASLOTS = 8;       // A-operand slots of a warpgroup

enum Mode { FWD = 0, BWD1 = 1, BWD2 = 2, BWD3 = 3 };

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int C>
struct Cfg {
  static constexpr int F = 4 * C;
  static constexpr int CB = C / 64;                // 64-channel blocks
  // Consumer warpgroups (one tile each) a block, and blocks a cluster: two
  // tiles share every weight chunk either way. At C <= 128 both tiles of
  // a block fit its shared memory; at C >= 256 one does, and the blocks
  // of a cluster of two get each chunk by one multicast.
  static constexpr int NWG = C <= 128 ? 2 : 1;
  static constexpr int CL = C <= 128 ? 1 : 2;
  static constexpr int THREADS = 128 * NWG + 32;   // + the producer warp
  // Outputs a pass (a thread holds half as many float32 accumulators):
  // up to 128 for every product (at 256, BWD1 spilled).
  static constexpr int NP1 = C < 128 ? C : 128;
  static constexpr int NP2 = C < 128 ? C : 128;
  static constexpr int NP3 = 128;
  static constexpr int NPB = C < 128 ? C : 128;
  // Halo blocks a conv1 round: G x NP1 / 2 accumulators, at most 64 where
  // two warpgroups share the register file (168 registers a thread).
  static constexpr int G = C == 64 ? 2 : 1;
  // Rows of the halo buffer ([CB][ROWS][64]): a tile and its halo at the
  // widest row the gate takes, W = 8192 / C, and room for conv1's A boxes
  // (see round_box).
  static constexpr int ROWS = C == 64 ? 384 : C == 128 ? 192
                              : C == 256 ? 128 : 64;
  // The largest halo (at C = 64 a block short of ROWS, so that conv1's
  // last round keeps two slots of x boxes).
  static constexpr int CAP = C == 64 ? ROWS - 64 : ROWS;
  static constexpr int BUF = ROWS * C * 2;         // a1 / dy2, x / dy3 boxes
  static constexpr int ACT = MT * C * 2;           // a2 / dy1 ([CB][64][64])
  static constexpr int WGB = BUF + ACT;             // a warpgroup's
  static constexpr int RING = NWG * WGB;
  static constexpr int SLOTS = C == 256 ? 4 : 3;    // weight ring slots
  static constexpr int ZERO = RING + SLOTS * SLOT;  // 128 zero bytes
  static constexpr int BAR = ZERO + 128;
  // Weight ring full/empty, then per warpgroup A full/empty, hfull, bfree.
  static constexpr int WGBAR = 2 * MAX_ASLOTS + 2;
  static constexpr int NBAR = 2 * SLOTS + NWG * WGBAR;
  static constexpr int SMEM = BAR + NBAR * 8;
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(RING % 1024 == 0, "swizzle atoms");
};

// Launch geometry, the same for every kernel of one call.
struct Geo {
  int h, w, hw;
  int pixels;     // n h w
  int t;          // output pixels of a full tile
  int whole;      // 1: a tile is t / hw whole images (no halo)
  int per_image;  // tiles an image (whole == 0)
  int tiles;
  int halo_off;   // halo rows before a tile's first pixel: 0, W or W + 1
  int hb;         // halo blocks of 64 rows
  int groups;     // pairs of tiles sharing the weight stream
};

// Tiles of x (n, h, w) at width c with halos of at most `cap` pixels, or
// false for a shape the kernels refuse.
bool make_geo(int n, int h, int w, int c, int cap, Geo* g) {
  if (n < 1 || h < 1 || w < 1 ||
      (c != 64 && c != 128 && c != 256 && c != 512) ||
      w > TILE_ELEMS / c ||
      static_cast<long long>(n) * h * w * 4 * c >= (1LL << 31))
    return false;
  g->h = h;
  g->w = w;
  g->hw = h * w;
  g->pixels = n * h * w;
  if (g->hw <= MT) {
    g->whole = 1;
    g->t = (MT / g->hw) * g->hw;
    g->per_image = 0;
    g->tiles = cdiv(n, MT / g->hw);
    g->halo_off = 0;
    g->hb = 1;
  } else {
    g->whole = 0;
    int t = MT, off = w + (t % w != 0);
    if (t + 2 * off > cap) {
      t = cap - 2 * (w + 1);
      off = w + (t % w != 0);
    }
    g->t = t;
    g->per_image = cdiv(g->hw, t);
    g->tiles = n * g->per_image;
    g->halo_off = off;
    g->hb = cdiv(t + 2 * off, 64);
  }
  g->groups = cdiv(g->tiles, 2);
  return true;
}

int cap_for(int c) {
  switch (c) {
    case 64: return Cfg<64>::CAP;
    case 128: return Cfg<128>::CAP;
    case 256: return Cfg<256>::CAP;
    default: return Cfg<512>::CAP;
  }
}

struct Tile {
  int p0, t, lo;   // first pixel, pixels (0: past the batch), halo start
};

__device__ __forceinline__ Tile tile_at(const Geo& g, int i) {
  if (i >= g.tiles) return {0, 0, -g.halo_off};
  int p0, t;
  if (g.whole) {
    p0 = i * g.t;
    t = min(g.t, g.pixels - p0);
  } else {
    const int img = i / g.per_image, j = i - img * g.per_image;
    p0 = img * g.hw + j * g.t;
    t = min(g.t, g.hw - j * g.t);
  }
  return {p0, t, p0 - g.halo_off};
}

// Bit 3 ky + kx: pixel i of the tile has its (ky - 1, kx - 1) neighbour in
// its own image.
__device__ __forceinline__ uint32_t tap_mask(const Geo& g, const Tile& tl,
                                             int i) {
  if (i >= tl.t) return 0;
  const int q = (tl.p0 + i) % g.hw, y = q / g.w, x = q - y * g.w;
  uint32_t m = 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
    if (yy >= 0 && yy < g.h && xx >= 0 && xx < g.w) m |= 1u << tap;
  }
  return m;
}

// conv1 runs in rounds, one a pass of NP1 outputs of a group of at most
// G halo blocks; x comes in through the halo buffer, in the
// 64 x 64 boxes that no earlier round of the tile has filled with a1:
// first the round's own rows (those of its columns and later ones), then
// the rows of later groups. Box k of round (gi, p) with nb blocks (BWD2,
// whose dy3 boxes may take the whole buffer: gi = p = 0, nb = 1): its
// byte offset in the buffer, and the round's number of boxes.
template <int C>
__device__ __forceinline__ int round_box(int gi, int p, int nb, int cbp,
                                         int k) {
  constexpr int CB = Cfg<C>::CB, G = Cfg<C>::G, ROWS = Cfg<C>::ROWS;
  const int wide = CB - p * cbp, first = nb * wide;
  int rb, cb;
  if (k < first) {
    rb = gi * G + k / wide;
    cb = p * cbp + k % wide;
  } else {
    k -= first;
    rb = gi * G + nb + k / CB;
    cb = k % CB;
  }
  return cb * ROWS * 128 + rb * BOX;
}

template <int C>
__device__ __forceinline__ int round_boxes(int gi, int p, int nb, int cbp) {
  constexpr int CB = Cfg<C>::CB, G = Cfg<C>::G, R = Cfg<C>::ROWS / 64;
  return nb * (CB - p * cbp) + (R - gi * G - nb) * CB;
}

struct Args {
  Geo g;
  const unsigned char* w0;   // the mode's packed weight matrices, in order
  const unsigned char* w1;
  const unsigned char* w2;
  const float* aff;          // [A1 B1 A2 B2 (C each) A3 B3 (F each)]
  const bf16* x;
  const bf16* gy;
  bf16* out;                 // FWD: the block's output; BWD3: dx
  bf16 *a1, *a2, *dy3, *dy2, *dy1;
  float *y1, *y2;
  uint2* mask;               // u3's mask: a tile's bits, a uint2 a
                             // thread and pass of 128 columns
  float* part;               // affine partial sums, a row a tile's warp
};

__device__ __forceinline__ float pre_affine(float y, float a, float b) {
  return __fadd_rn(__fmul_rn(y, a), b);
}

__device__ __forceinline__ void st_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void sts_bf16x2(uint32_t addr, float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<uint32_t*>(&v)));
}

// Stores this warp's column sums over its 16 rows of (u y, u) for columns
// col and col + 1 into its row of partial sums (dA at prow[ca + ..], dB at
// prow[cb + ..]); sa, sb are the thread's sums over its two rows.
__device__ __forceinline__ void store_sums(float* prow, int ca, int cb,
                                           int col, float2 sa, float2 sb,
                                           int lane) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    sa.x += __shfl_xor_sync(0xffffffffu, sa.x, off);
    sa.y += __shfl_xor_sync(0xffffffffu, sa.y, off);
    sb.x += __shfl_xor_sync(0xffffffffu, sb.x, off);
    sb.y += __shfl_xor_sync(0xffffffffu, sb.y, off);
  }
  if (lane < 4) {
    *reinterpret_cast<float2*>(prow + ca + col) = sa;
    *reinterpret_cast<float2*>(prow + cb + col) = sb;
  }
}

// A thread's row of a [64-channel block][rows][64] shared-memory tile in
// the 128-byte swizzle, from column c0 + 2 q: the address of column c0 +
// 8 jj + 2 q is at(jj).
struct SRow {
  uint32_t base;
  int stride, r7;
  __device__ __forceinline__ uint32_t at(int jj) const {
    return base + (jj >> 3) * stride + (((jj & 7) ^ r7) << 4);
  }
};

__device__ __forceinline__ SRow srow(const unsigned char* tile, int stride,
                                     int row, int c0, int q) {
  return {smem_addr(tile) + (c0 >> 6) * stride + row * 128 + 4 * q, stride,
          row & 7};
}

// Phase clocks of the first 12 tiles of block 0 (thread 0, the first
// consumer thread), for a build with -DSIMCLR_B6_TRACE:
// bottleneck_trace copies them out.
#ifdef SIMCLR_B6_TRACE
__device__ long long b6_trace[1024];
__device__ int b6_trace_n;
#define B6_MARK(id)                                                   \
  do {                                                                \
    if (blockIdx.x == 0 && threadIdx.x == 0 && tcount < 12 &&         \
        b6_trace_n < 1024)                                            \
      b6_trace[b6_trace_n++] = (clock64() << 8) | (MODE << 4) | (id); \
  } while (0)
#else
#define B6_MARK(id) \
  do {              \
  } while (0)
#endif

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stores four bf16 pairs of one row a thread (v[k]: columns 8 k + 2 q and
// + 1 from `row`, q = lane % 4) as one 16-byte store a lane: the quad's
// lanes swap words so that lane q writes columns 8 q .. 8 q + 7, whole
// 32-byte sectors, where a store a pair wrote half sectors. Every lane
// calls it (shuffles); those with `ok` store.
__device__ __forceinline__ void store_quad(bf16* row, const uint32_t (&v)[4],
                                           int lane, bool ok) {
  const int q = lane & 3;
  uint32_t o[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int d = (q - r) & 3, src = (q + r) & 3;
    const uint32_t send = d == 0 ? v[0] : d == 1 ? v[1] : d == 2 ? v[2] : v[3];
    const uint32_t got =
        r == 0 ? send : __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (src == k) o[k] = got;
  }
  if (ok)
    *reinterpret_cast<uint4*>(row + 8 * q) = make_uint4(o[0], o[1], o[2], o[3]);
}

// Keeps the compiler from hoisting an epilogue's loads of all its
// columns at once (their registers would spill). The affines are read
// through the read-only path (__ldg): plain loads would not move past the
// epilogue's stores, and each would stall its warp, the only one on its
// scheduler, for the whole load latency.
__device__ __forceinline__ void epilogue_fence() {
  asm volatile("" ::: "memory");
}

// A consumer thread's view of its block (the warpgroup's shared state is
// in shared memory; these are its own cursors and constants).
template <int C>
struct Ctx {
  unsigned char* smem;
  unsigned char* buf;   // halo buffer
  unsigned char* act;   // a2 / dy1
  uint64_t *wfull, *wempty, *afull, *aempty;
  const Geo* g;
  uint32_t zero;        // shared address of 128 zero bytes
  int lane, wr, q, r0;
  int wpos;             // weight chunks consumed
  uint32_t aph;         // per A slot: parity of its next completion
};

template <int C>
__device__ __forceinline__ void release_w(Ctx<C>& x, int s) {
  __syncwarp();
  if (x.lane == 0) {
    if (Cfg<C>::CL > 1) {
      for (int r = 0; r < Cfg<C>::CL; ++r) mbar_arrive_cluster(&x.wempty[s], r);
    } else {
      mbar_arrive(&x.wempty[s]);
    }
  }
}

template <int C>
__device__ __forceinline__ void release_a(Ctx<C>& x, int s) {
  __syncwarp();
  if (x.lane == 0) mbar_arrive(&x.aempty[s]);
}

// One pass of a product: nsb 64-deep steps, 256 / np a weight slot;
// issue(sb, B base, A slot) issues step sb's products. da > 0: step sb's
// A came by TMA into A slot sb % da (da >= 2). One step's products stay
// in flight while the next is issued; a step's A slot, and its weight slot
// after the slot's last step, go back to the producer once it is done.
// (Keeping two steps in flight, with three sets of A registers, made
// ptxas serialise every product of the forward kernels on an H100.)
template <int C, class Issue>
__device__ __forceinline__ void consume_pass(Ctx<C>& x, int np, int nsb,
                                             int da, Issue& issue) {
  constexpr int NS = Cfg<C>::SLOTS;
  const int per = 256 / np;
  int cur = 0, prev = 0;
  for (int sb = 0; sb < nsb; ++sb) {
    const int k = sb % per;
    if (k == 0) {
      prev = cur;
      cur = x.wpos % NS;
      mbar_wait(&x.wfull[cur], (x.wpos / NS) & 1);
      ++x.wpos;
    }
    const int as = da > 0 ? sb % da : 0;
    if (da > 0) {
      mbar_wait(&x.afull[as], (x.aph >> as) & 1);
      x.aph ^= 1u << as;
    }
    issue(sb, x.smem + Cfg<C>::RING + cur * SLOT + k * np * 128, as);
    wgmma_commit();
    wgmma_wait<1>();
    if (sb > 0) {
      if (k == 0) release_w(x, prev);
      if (da > 0) release_a(x, (sb - 1) % da);
    }
  }
  wgmma_wait<0>();
  release_w(x, cur);
  if (da > 0) release_a(x, (nsb - 1) % da);
}

// A-from-registers step sb of a 3x3 product over the halo buffer (tap
// sb / CB, channels 64 (sb % CB) on) into acc; prow0 is the halo row of
// this lane's pixel, tmask its taps inside the image.
template <int C, int N>
__device__ __forceinline__ void gather_step(const Ctx<C>& x, float (&acc)[N],
                                            uint32_t (&ar)[4][4], int sb,
                                            const unsigned char* wb,
                                            int prow0, uint32_t tmask) {
  constexpr int CB = C / 64, ROWS = Cfg<C>::ROWS;
  const int tap = sb / CB, cb = sb - tap * CB;
  const int row = (tmask >> tap) & 1
                      ? prow0 + (tap / 3 - 1) * x.g->w + (tap % 3 - 1)
                      : -1;
  const uint32_t base =
      row < 0 ? x.zero : smem_addr(x.buf) + cb * ROWS * 128 + row * 128;
  const int sw = row < 0 ? 0 : row & 7;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(base + (((2 * ks + (x.lane >> 4)) ^ sw) << 4), ar[ks]);
  wgmma_fence();
  const uint64_t db = desc_sw128(wb, 16, 1024);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_rs(acc, ar[ks], db + 2 * ks, 1);
}

// One pass of the 3x3 product over the halo buffer (2 N outputs).
template <int C, int N>
__device__ __forceinline__ void conv3x3_pass(Ctx<C>& x, float (&acc)[N],
                                             const Tile& tl) {
  const int i = 16 * x.wr + (x.lane & 15);
  const int prow0 = i + x.g->halo_off;
  const uint32_t tmask = tap_mask(*x.g, tl, i);
  // A registers for the step in flight and the next.
  uint32_t ra[4][4], rb[4][4];
  start_acc(acc);
  auto issue = [&](int sb, const unsigned char* wb, int) {
    if (sb & 1)
      gather_step(x, acc, rb, sb, wb, prow0, tmask);
    else
      gather_step(x, acc, ra, sb, wb, prow0, tmask);
  };
  consume_pass<C>(x, 2 * N, 9 * (C / 64), 0, issue);
  fence_operands(acc);
}

// One pass of an F-wide product with A = act (2 N = NP3 outputs).
template <int C, int N>
__device__ __forceinline__ void act_pass(Ctx<C>& x, float (&acc)[N]) {
  start_acc(acc);
  auto issue = [&](int sb, const unsigned char* wb, int) {
    const uint64_t da = desc_sw128(x.act + sb * BOX, 16, 1024);
    const uint64_t db = desc_sw128(wb, 16, 1024);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<0, 0>(acc, da + 2 * ks, db + 2 * ks, 1);
  };
  consume_pass<C>(x, 2 * N, C / 64, 0, issue);
  fence_operands(acc);
}

// The thread's two rows (r0, r0 + 8), columns c0 + 8 jj + 2 q (+ 1), of a
// row-major [pixel][LD] src for an epilogue, loaded before the pass's
// products: bf16 pairs as uint32 or float32 pairs as float2; zero past
// the tile.
template <int LD, int C, class T, class E, int J>
__device__ __forceinline__ void load_rows(const Ctx<C>& x, T (&v)[2][J],
                                          const E* src, const Tile& tl,
                                          int c0) {
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = x.r0 + 8 * h2;
    const E* row =
        src + static_cast<long long>(tl.p0 + min(i, max(tl.t - 1, 0))) * LD +
        c0 + 2 * x.q;
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
      v[h2][jj] = i < tl.t ? __ldg(reinterpret_cast<const T*>(row + 8 * jj))
                           : T{};
  }
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// The kernel: mode FWD (B6f) or one step of B6b (BWD1-3). A block is
// warpgroup 0 (the consumers) and warp 4 (the producer, lane 0); blocks
// run in clusters of two, block r of cluster k on tile 2 (k + j K) + r of
// round j (K clusters), both fed by each weight chunk once.
template <int C, int MODE>
__global__ void __launch_bounds__(Cfg<C>::THREADS, 1)
bottleneck_tile_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ Args a) {
  using K = Cfg<C>;
  constexpr int F = K::F, CB = K::CB, NP1 = K::NP1, NP2 = K::NP2;
  constexpr int NP3 = K::NP3;
  constexpr int NPB = K::NPB, G = K::G, ROWS = K::ROWS;
  constexpr int CBP = NP1 / 64;   // 64-channel blocks a conv1 pass
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + K::BAR);
  constexpr int NWG = K::NWG, CL = K::CL, SLOTS = K::SLOTS;
  // Column steps (jj) an epilogue loads ahead, fewer where two
  // warpgroups share the register file and in BWD1 and BWD3, whose
  // epilogues hold the most (global scratch, mask bits, column sums).
  constexpr int EB = MODE == BWD1 || MODE == BWD3 ? 2 : NWG > 1 ? 4 : 8;
  // Whether conv3's epilogue gets x in registers before the products.
  constexpr bool XPRE = NWG == 1 && MODE == FWD;
  uint64_t* wfull = bar;
  uint64_t* wempty = bar + SLOTS;
  // Warpgroup w's A full / empty [MAX_ASLOTS each], hfull (BWD3: the dy2
  // halo is in its buf) and bfree (its buf is free for the next tile).
  auto afull_of = [&](int w) { return bar + 2 * SLOTS + w * K::WGBAR; };
  const Geo& g = a.g;
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_index();
  const int rank = CL > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int cid = blockIdx.x / CL, ncl = gridDim.x / CL;
  // Tile of warpgroup w in group grp.
  auto tile_of = [&](int grp, int w) { return 2 * grp + (CL > 1 ? rank : w); };

  if (tid == 0) {
    if (smem_addr(smem) & 1023) __trap();
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], 4 * NWG * CL);   // every consumer warp
    }
    for (int w = 0; w < NWG; ++w) {
      uint64_t* b = afull_of(w);
      for (int s = 0; s < MAX_ASLOTS; ++s) {
        mbar_init(&b[s], 1);
        mbar_init(&b[MAX_ASLOTS + s], 4);
      }
      mbar_init(&b[2 * MAX_ASLOTS], 1);
      mbar_init(&b[2 * MAX_ASLOTS + 1], 4);
    }
    mbar_fence_init();
  }
  if (tid < 32) reinterpret_cast<uint32_t*>(smem + K::ZERO)[tid] = 0;
  __syncthreads();
  if (CL > 1) cluster_sync();

  if (warp == 4 * NWG) {
    // Producer. Issues every load in the order the consumers use them.
    if (lane == 0) {
      tma_prefetch_map(&amap);
      int wpos = 0, tcount = 0;
      uint32_t aph[NWG] = {};   // per A slot: parity of its next fill
      // A chunk of `bytes` (in a cluster, each block's producer brings
      // half to both blocks by one multicast).
      auto weights = [&](const unsigned char* src, int bytes) {
        const int s = wpos % SLOTS;
        mbar_wait(&wempty[s], ((wpos / SLOTS) & 1) ^ 1);
        mbar_expect_tx(&wfull[s], bytes);
        unsigned char* dst = smem + K::RING + s * SLOT;
        if (CL > 1) {
          const int half = bytes / 2;
          bulk_load_multicast(dst + rank * half, src + rank * half, half,
                              &wfull[s], 3);
        } else {
          bulk_load(dst, src, bytes, &wfull[s]);
        }
        ++wpos;
      };
      // Step sb's A for warpgroup w in A slot sb % da: nb TMA boxes (at
      // box k of the round, see round_box), rows r0 + 64 i, columns col.
      auto a_boxes = [&](int w, int sb, int gi, int p, int nb, int cbp,
                         int da, int r0, int col) {
        uint64_t* b = afull_of(w);
        const int s = sb % da;
        mbar_wait(&b[MAX_ASLOTS + s], ((aph[w] >> s) & 1) ^ 1);
        aph[w] ^= 1u << s;
        mbar_expect_tx(&b[s], nb * BOX);
        for (int i = 0; i < nb; ++i)
          tma_load_2d(smem + w * K::WGB +
                          round_box<C>(gi, p, nb, cbp, s * nb + i),
                      &amap, &b[s], col, r0 + 64 * i);
      };
      // One product's weight chunks: passes of np outputs, nsb 64-deep
      // steps a pass, 256 / np steps a slot; a_step(sb) brings A for sb.
      auto product = [&](const unsigned char* w, int np, int passes,
                         int nsb, auto a_step) {
        const int per = 256 / np;
        for (int p = 0; p < passes; ++p)
          for (int s0 = 0; s0 < nsb; s0 += per) {
            const int ns = min(per, nsb - s0);
            weights(w + static_cast<long long>(p * nsb + s0) * np * 128,
                    ns * np * 128);
            for (int sb = s0; sb < s0 + ns; ++sb) a_step(p, sb);
          }
      };
      auto no_a = [](int, int) {};
      for (int grp = cid; grp < g.groups; grp += ncl, ++tcount) {
        Tile tl[NWG];
        for (int w = 0; w < NWG; ++w) tl[w] = tile_at(g, tile_of(grp, w));
        if (MODE != BWD2)
          for (int w = 0; w < NWG; ++w)
            mbar_wait(&afull_of(w)[2 * MAX_ASLOTS + 1], (tcount & 1) ^ 1);
        if (MODE == FWD || MODE == BWD1) {
          for (int gi = 0; gi * G < g.hb; ++gi) {
            const int nb = min(G, g.hb - gi * G);
            for (int p = 0; p < C / NP1; ++p) {
              const int da =
                  min(MAX_ASLOTS, round_boxes<C>(gi, p, nb, CBP) / nb);
              // The round's slots map to other boxes than the last
              // round's: every earlier fill must have been released.
              for (int w = 0; w < NWG; ++w)
                for (int s = 0; s < MAX_ASLOTS; ++s)
                  mbar_wait(&afull_of(w)[MAX_ASLOTS + s],
                            ((aph[w] >> s) & 1) ^ 1);
              product(a.w0 + static_cast<long long>(p) * 4 * CB * NP1 * 128,
                      NP1, 1, 4 * CB, [&](int, int sb) {
                for (int w = 0; w < NWG; ++w)
                  a_boxes(w, sb, gi, p, nb, CBP, da, tl[w].lo + 64 * gi * G,
                          64 * sb);
              });
            }
          }
          product(a.w1, NP2, C / NP2, 9 * CB, no_a);
          product(a.w2, NP3, F / NP3, CB, no_a);
        } else if (MODE == BWD2) {
          const int da = min(MAX_ASLOTS, round_boxes<C>(0, 0, 1, 0));
          product(a.w0, NPB, C / NPB, 4 * CB, [&](int, int sb) {
            for (int w = 0; w < NWG; ++w)
              a_boxes(w, sb, 0, 0, 1, 0, da, tl[w].p0, 64 * sb);
          });
        } else {
          for (int w = 0; w < NWG; ++w) {
            uint64_t* hf = &afull_of(w)[2 * MAX_ASLOTS];
            mbar_expect_tx(hf, g.hb * CB * BOX);
            for (int cb = 0; cb < CB; ++cb)
              for (int i = 0; i < g.hb; ++i)
                tma_load_2d(smem + w * K::WGB + cb * ROWS * 128 + i * BOX,
                            &amap, hf, 64 * cb, tl[w].lo + 64 * i);
          }
          product(a.w0, NPB, C / NPB, 9 * CB, no_a);
          product(a.w1, NP3, F / NP3, CB, no_a);
        }
      }
    }
  } else {
    // Consumers: warp wr owns rows 16 wr .. 16 wr + 15 of the tile; this
    // thread rows r0 and r0 + 8, columns 8 jj + 2 q and + 1.
    const int wg = warp >> 2, wr = warp & 3, wtid = tid & 127;
    unsigned char* buf = smem + wg * K::WGB;
    unsigned char* act = buf + K::BUF;
    uint64_t* afull = afull_of(wg);
    uint64_t* aempty = afull + MAX_ASLOTS;
    uint64_t* hfull = afull + 2 * MAX_ASLOTS;
    uint64_t* bfree = hfull + 1;
    Ctx<C> cx{smem, buf, act, wfull, wempty, afull, aempty, &g,
              smem_addr(smem + K::ZERO), lane, wr, lane & 3,
              16 * wr + (lane >> 2), 0, 0u};
    const int q = cx.q, r0 = cx.r0;
    const float *A1 = a.aff, *B1 = A1 + C, *A2 = B1 + C, *B2 = A2 + C;
    const float *A3 = B2 + C, *B3 = A3 + F;
    int tcount = 0;
    auto wg_sync = [&]() { named_barrier(1 + wg, 128); };
    // This warp is done with buf (its last read, the 3x3 product's
    // gather, is over): the producer may bring the next tile's A there.
    auto buf_free = [&]() {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(bfree);
    };
    auto run_pass = [&](int np, int nsb, int da, auto issue) {
      consume_pass<C>(cx, np, nsb, da, issue);
    };

    for (int grp = cid; grp < g.groups; grp += ncl, ++tcount) {
      const int tile = tile_of(grp, wg);
      const Tile tl = tile_at(g, tile);
      B6_MARK(0);
      // This warp's row of affine partial sums (tiles past the batch have
      // none): [dA1 dB1 dA2 dB2 dA3 dB3].
      float* prow = tile < g.tiles
                        ? a.part + (static_cast<long long>(tile) * 4 + wr) *
                                       (4 * C + 2 * F)
                        : nullptr;
      // This thread's pixels (rows r0, r0 + 8 of the tile) and whether
      // they exist; the pixel of a row past the tile is clamped (not
      // stored).
      long long px[2];
      bool ok[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        ok[h2] = r0 + 8 * h2 < tl.t;
        px[h2] = tl.p0 + min(r0 + 8 * h2, max(tl.t - 1, 0));
      }
      if (MODE == FWD || MODE == BWD1) {
        // conv1 on the halo, in rounds of up to G blocks -> a1 in buf.
        for (int gi = 0; gi * G < g.hb; ++gi) {
          const int nb = min(G, g.hb - gi * G);
          for (int p = 0; p < C / NP1; ++p) {
            float acc[G][NP1 / 2];
            const int da =
                min(MAX_ASLOTS, round_boxes<C>(gi, p, nb, CBP) / nb);
#pragma unroll
            for (int bl = 0; bl < G; ++bl) start_acc(acc[bl]);
            run_pass(NP1, 4 * CB, da,
                     [&](int sb, const unsigned char* wb, int as) {
              const uint64_t db = desc_sw128(wb, 16, 1024);
#pragma unroll
              for (int bl = 0; bl < G; ++bl)
                if (bl < nb) {
                  const uint64_t dab = desc_sw128(
                      buf + round_box<C>(gi, p, nb, CBP, as * nb + bl), 16,
                      1024);
#pragma unroll
                  for (int ks = 0; ks < 4; ++ks)
                    wgmma_ss<0, 0>(acc[bl], dab + 2 * ks, db + 2 * ks, 1);
                }
            });
#pragma unroll
            for (int bl = 0; bl < G; ++bl) fence_operands(acc[bl]);
            B6_MARK(1);
            wg_sync();
#pragma unroll
            for (int bl = 0; bl < G; ++bl) {
              if (bl >= nb) continue;
              SRow sr[2];
              int ti[2];   // the row's tile pixel, a1 and y1 kept if in [0, t)
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2) {
                const int j = (gi * G + bl) * 64 + r0 + 8 * h2;
                ti[h2] = j - g.halo_off;
                sr[h2] = srow(buf, ROWS * 128, j, p * NP1, q);
              }
#pragma unroll
              for (int jj = 0; jj < NP1 / 8; ++jj) {
                if (jj % EB == 0) epilogue_fence();
                const int col = p * NP1 + 8 * jj + 2 * q;
                const float2 av = __ldg(reinterpret_cast<const float2*>(A1 + col));
                const float2 bv = __ldg(reinterpret_cast<const float2*>(B1 + col));
#pragma unroll
                for (int h2 = 0; h2 < 2; ++h2) {
                  const float y0 = acc[bl][4 * jj + 2 * h2];
                  const float y1v = acc[bl][4 * jj + 2 * h2 + 1];
                  const float v0 = fmaxf(pre_affine(y0, av.x, bv.x), 0.f);
                  const float v1 = fmaxf(pre_affine(y1v, av.y, bv.y), 0.f);
                  sts_bf16x2(sr[h2].at(jj), v0, v1);
                  if (MODE == BWD1 && ti[h2] >= 0 && ti[h2] < tl.t) {
                    const long long at =
                        static_cast<long long>(tl.p0 + ti[h2]) * C + col;
                    st_bf16x2(a.a1 + at, v0, v1);
                    *reinterpret_cast<float2*>(a.y1 + at) =
                        make_float2(y0, y1v);
                  }
                }
              }
            }
          }
        }
        wg_sync();
        B6_MARK(2);
        // conv2 -> a2 in act.
        for (int p = 0; p < C / NP2; ++p) {
          float acc[NP2 / 2];
          conv3x3_pass<C>(cx, acc, tl);
          B6_MARK(3);
          SRow sr[2];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            sr[h2] = srow(act, BOX, r0 + 8 * h2, p * NP2, q);
#pragma unroll
          for (int jj = 0; jj < NP2 / 8; ++jj) {
            if (jj % EB == 0) epilogue_fence();
            const int col = p * NP2 + 8 * jj + 2 * q;
            const float2 av = __ldg(reinterpret_cast<const float2*>(A2 + col));
            const float2 bv = __ldg(reinterpret_cast<const float2*>(B2 + col));
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const float y0 = acc[4 * jj + 2 * h2];
              const float y1v = acc[4 * jj + 2 * h2 + 1];
              const float v0 = fmaxf(pre_affine(y0, av.x, bv.x), 0.f);
              const float v1 = fmaxf(pre_affine(y1v, av.y, bv.y), 0.f);
              sts_bf16x2(sr[h2].at(jj), v0, v1);
              if (MODE == BWD1 && ok[h2]) {
                const long long at = px[h2] * C + col;
                st_bf16x2(a.a2 + at, v0, v1);
                *reinterpret_cast<float2*>(a.y2 + at) = make_float2(y0, y1v);
              }
            }
          }
        }
        buf_free();
        fence_proxy_async();
        wg_sync();
        B6_MARK(4);
        // conv3 and the output (FWD) or u3, dA3 / dB3, dy3 (BWD1).
        for (int p = 0; p < F / NP3; ++p) {
          // x for the epilogue: loaded before the products in B6f with one
          // warpgroup a block; else in the epilogue (no registers to hold
          // it across the products).
          uint32_t xr[2][NP3 / 8];
          if (XPRE) load_rows<F>(cx, xr, a.x, tl, p * NP3);
          float acc[NP3 / 2];
          act_pass<C>(cx, acc);
          B6_MARK(5);
          bf16* orow[2];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            orow[h2] = (MODE == FWD ? a.out : a.dy3) + px[h2] * F + p * NP3;
          uint32_t bits[2] = {0, 0}, pk[2][4];   // pk: FWD's packed output
#pragma unroll
          for (int jj = 0; jj < NP3 / 8; ++jj) {
            if (jj % EB == 0) epilogue_fence();
            const int f = p * NP3 + 8 * jj + 2 * q;
            const float2 av = __ldg(reinterpret_cast<const float2*>(A3 + f));
            const float2 bv = __ldg(reinterpret_cast<const float2*>(B3 + f));
            float2 sa = make_float2(0.f, 0.f), sbv = make_float2(0.f, 0.f);
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const float2 xv = unpack_bf16x2(
                  XPRE     ? xr[h2][jj]
                  : ok[h2] ? __ldg(reinterpret_cast<const uint32_t*>(
                                 a.x + px[h2] * F + f))
                           : 0u);
              const float y0 = acc[4 * jj + 2 * h2];
              const float y1v = acc[4 * jj + 2 * h2 + 1];
              const float pre0 = __fadd_rn(pre_affine(y0, av.x, bv.x), xv.x);
              const float pre1 = __fadd_rn(pre_affine(y1v, av.y, bv.y), xv.y);
              if (MODE == FWD) {
                pk[h2][jj & 3] = pack_bf16x2(fmaxf(pre0, 0.f), fmaxf(pre1, 0.f));
              } else {
                const float2 gv = unpack_bf16x2(
                    ok[h2] ? __ldg(reinterpret_cast<const uint32_t*>(
                                 a.gy + px[h2] * F + f))
                           : 0u);
                const bool m0 = ok[h2] && pre0 > 0.f;
                const bool m1 = ok[h2] && pre1 > 0.f;
                const float u0 = m0 ? gv.x : 0.f, u1 = m1 ? gv.y : 0.f;
                const int bit = (jj * 2 + h2) * 2;
                bits[bit >> 5] |= (m0 ? 1u : 0u) << (bit & 31);
                bits[bit >> 5] |= (m1 ? 1u : 0u) << ((bit + 1) & 31);
                sa.x += u0 * y0;
                sa.y += u1 * y1v;
                sbv.x += u0;
                sbv.y += u1;
                if (ok[h2])
                  st_bf16x2(orow[h2] + 8 * jj + 2 * q, __fmul_rn(u0, av.x),
                            __fmul_rn(u1, av.y));
              }
            }
            // The output in 16-byte stores (BWD1's dy3 keeps a store a
            // pair: the quad's exchange cost it registers, which spilled).
            if (MODE == FWD && (jj & 3) == 3)
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2)
                store_quad(orow[h2] + 8 * (jj - 3), pk[h2], lane, ok[h2]);
            if (MODE == BWD1 && prow)
              store_sums(prow, 4 * C, 4 * C + F, f, sa, sbv, lane);
          }
          if (MODE == BWD1 && prow)
            a.mask[(static_cast<long long>(tile) * (F / NP3) + p) * 128 +
                   wtid] = make_uint2(bits[0], bits[1]);
          B6_MARK(6);
        }
      } else if (MODE == BWD2) {
        // da2 = dy3 w3^T; u2, dA2 / dB2, dy2.
        const int da = min(MAX_ASLOTS, round_boxes<C>(0, 0, 1, 0));
        for (int p = 0; p < C / NPB; ++p) {
          float acc[NPB / 2];
          start_acc(acc);
          run_pass(NPB, 4 * CB, da,
                   [&](int sb, const unsigned char* wb, int as) {
            const uint64_t dab =
                desc_sw128(buf + round_box<C>(0, 0, 1, 0, as), 16, 1024);
            const uint64_t db = desc_sw128(wb, 16, 1024);
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma_ss<0, 0>(acc, dab + 2 * ks, db + 2 * ks, 1);
          });
          fence_operands(acc);
          B6_MARK(1);
          bf16* drow[2];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            drow[h2] = a.dy2 + px[h2] * C + p * NPB + 2 * q;
#pragma unroll
          for (int jj = 0; jj < NPB / 8; ++jj) {
            if (jj % EB == 0) epilogue_fence();
            const int col = p * NPB + 8 * jj + 2 * q;
            const float2 av = __ldg(reinterpret_cast<const float2*>(A2 + col));
            const float2 bv = __ldg(reinterpret_cast<const float2*>(B2 + col));
            float2 sa = make_float2(0.f, 0.f), sbv = make_float2(0.f, 0.f);
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const float2 y =
                  ok[h2] ? __ldg(reinterpret_cast<const float2*>(
                               a.y2 + px[h2] * C + col))
                         : make_float2(0.f, 0.f);
              const float u0 = ok[h2] && pre_affine(y.x, av.x, bv.x) > 0.f
                                   ? acc[4 * jj + 2 * h2] : 0.f;
              const float u1 = ok[h2] && pre_affine(y.y, av.y, bv.y) > 0.f
                                   ? acc[4 * jj + 2 * h2 + 1] : 0.f;
              sa.x += u0 * y.x;
              sa.y += u1 * y.y;
              sbv.x += u0;
              sbv.y += u1;
              if (ok[h2])
                st_bf16x2(drow[h2] + 8 * jj, __fmul_rn(u0, av.x),
                          __fmul_rn(u1, av.y));
            }
            if (prow) store_sums(prow, 2 * C, 3 * C, col, sa, sbv, lane);
          }
          B6_MARK(2);
        }
      } else {
        // dy2 and its halo -> buf; da1 = conv3x3^T(dy2); u1, dA1 / dB1,
        // dy1 (global and act); dx = bf16(dy1 w1^T + g [pre3 > 0]).
        mbar_wait(hfull, tcount & 1);
        B6_MARK(1);
        for (int p = 0; p < C / NPB; ++p) {
          float acc[NPB / 2];
          conv3x3_pass<C>(cx, acc, tl);
          B6_MARK(2);
          SRow sr[2];
          bf16* drow[2];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            sr[h2] = srow(act, BOX, r0 + 8 * h2, p * NPB, q);
            drow[h2] = a.dy1 + px[h2] * C + p * NPB + 2 * q;
          }
#pragma unroll
          for (int jj = 0; jj < NPB / 8; ++jj) {
            if (jj % EB == 0) epilogue_fence();
            const int col = p * NPB + 8 * jj + 2 * q;
            const float2 av = __ldg(reinterpret_cast<const float2*>(A1 + col));
            const float2 bv = __ldg(reinterpret_cast<const float2*>(B1 + col));
            float2 sa = make_float2(0.f, 0.f), sbv = make_float2(0.f, 0.f);
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const float2 y =
                  ok[h2] ? __ldg(reinterpret_cast<const float2*>(
                               a.y1 + px[h2] * C + col))
                         : make_float2(0.f, 0.f);
              const float u0 = ok[h2] && pre_affine(y.x, av.x, bv.x) > 0.f
                                   ? acc[4 * jj + 2 * h2] : 0.f;
              const float u1 = ok[h2] && pre_affine(y.y, av.y, bv.y) > 0.f
                                   ? acc[4 * jj + 2 * h2 + 1] : 0.f;
              sa.x += u0 * y.x;
              sa.y += u1 * y.y;
              sbv.x += u0;
              sbv.y += u1;
              const float d0 = __fmul_rn(u0, av.x), d1 = __fmul_rn(u1, av.y);
              sts_bf16x2(sr[h2].at(jj), d0, d1);
              if (ok[h2]) st_bf16x2(drow[h2] + 8 * jj, d0, d1);
            }
            if (prow) store_sums(prow, 0, C, col, sa, sbv, lane);
          }
        }
        buf_free();
        fence_proxy_async();
        wg_sync();
        B6_MARK(3);
        for (int p = 0; p < F / NP3; ++p) {

          const uint2 m = prow ? a.mask[(static_cast<long long>(tile) *
                                             (F / NP3) + p) * 128 + wtid]
                               : make_uint2(0, 0);
          float acc[NP3 / 2];
          act_pass<C>(cx, acc);
          B6_MARK(4);
          bf16* orow[2];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            orow[h2] = a.out + px[h2] * F + p * NP3;
          const uint32_t bits[2] = {m.x, m.y};
#pragma unroll
          for (int jj = 0; jj < NP3 / 8; ++jj) {
            if (jj % EB == 0) epilogue_fence();
            const int f = p * NP3 + 8 * jj + 2 * q;
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              if (!ok[h2]) continue;
              const float2 gv = unpack_bf16x2(__ldg(
                  reinterpret_cast<const uint32_t*>(a.gy + px[h2] * F + f)));
              const int bit = (jj * 2 + h2) * 2;
              const float u0 = (bits[bit >> 5] >> (bit & 31)) & 1 ? gv.x : 0.f;
              const float u1 =
                  (bits[bit >> 5] >> ((bit + 1) & 31)) & 1 ? gv.y : 0.f;
              st_bf16x2(orow[h2] + 8 * jj + 2 * q,
                        __fadd_rn(acc[4 * jj + 2 * h2], u0),
                        __fadd_rn(acc[4 * jj + 2 * h2 + 1], u1));
            }
          }
          B6_MARK(5);
        }
      }
    }
  }
  if (CL > 1) {
    __syncwarp();
    cluster_sync();
  }
}

// ---------------------------------------------------------------------------
// Weight gradients dw3 = dy3^T a2 and dw1 = x^T dy1
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 288;     // warpgroups 0-1 consume, warp 8 loads
constexpr int WG_STAGES = 4;

struct Wgrad {
  int m, n;       // D is m x n: m columns of A, n of B (m % 128 == 0)
  int nt;         // columns of D a block: min(n, 256)
  int tiles;      // (m / 128) x (n / nt)
  int items;      // 64-pixel steps of the pixels
  int ranges;
};

Wgrad plan_wgrad(int m, int n, int pixels, int sms) {
  Wgrad p;
  p.m = m;
  p.n = n;
  p.nt = std::min(n, 256);
  p.tiles = (m / 128) * (n / p.nt);
  p.items = cdiv(pixels, 64);
  p.ranges = std::max(1, std::min(p.items, cdiv(sms, p.tiles)));
  return p;
}

// One range's partial D[m][n] = sum over its pixels of A[p][m] B[p][n],
// for the 128 x NT tile blockIdx.x % tiles of range blockIdx.x / tiles.
template <int NT>
__global__ void __launch_bounds__(WG_THREADS, 1)
bottleneck_wgrad_kernel(const __grid_constant__ CUtensorMap amap,
                        const __grid_constant__ CUtensorMap bmap,
                        float* __restrict__ partial, Wgrad w) {
  constexpr int STAGE = 2 * BOX + NT * 128;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_STAGES * STAGE);
  uint64_t* empty = full + WG_STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_index();
  const int r = blockIdx.x / w.tiles, t = blockIdx.x - r * w.tiles;
  const int mt = t / (w.n / NT), nt = t - mt * (w.n / NT);
  const int i0 = static_cast<int>(static_cast<long long>(w.items) * r /
                                  w.ranges);
  const int i1 = static_cast<int>(static_cast<long long>(w.items) *
                                  (r + 1) / w.ranges);
  if (tid == 0) {
    if (smem_addr(smem) & 1023) __trap();
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == 8) {
    if (lane != 0) return;
    tma_prefetch_map(&amap);
    tma_prefetch_map(&bmap);
    for (int i = i0; i < i1; ++i) {
      const int k = i - i0, s = k % WG_STAGES;
      mbar_wait(&empty[s], ((k / WG_STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[s], STAGE);
      unsigned char* dst = smem + s * STAGE;
      for (int h = 0; h < 2; ++h)
        tma_load_2d(dst + h * BOX, &amap, &full[s], mt * 128 + 64 * h,
                    64 * i);
      for (int j = 0; j < NT / 64; ++j)
        tma_load_2d(dst + 2 * BOX + j * BOX, &bmap, &full[s],
                    nt * NT + 64 * j, 64 * i);
    }
    return;
  }
  const int wg = warp >> 2, wr = warp & 3;
  float acc[NT / 2];
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) acc[e] = 0.f;
  fence_operands(acc);
  wgmma_fence();
  for (int i = i0; i < i1; ++i) {
    const int k = i - i0, s = k % WG_STAGES;
    mbar_wait(&full[s], (k / WG_STAGES) & 1);
    unsigned char* st = smem + s * STAGE;
    const uint64_t da = desc_sw128(st + wg * BOX, BOX, 1024);
    const uint64_t db = desc_sw128(st + 2 * BOX, BOX, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(acc, da + ((kk * 2048) >> 4), db + ((kk * 2048) >> 4),
                     1);
    wgmma_commit();
    wgmma_wait<1>();
    if (k > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(k - 1) % WG_STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
  float* out = partial + static_cast<long long>(r) * w.m * w.n;
#pragma unroll
  for (int jj = 0; jj < NT / 8; ++jj)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int m = mt * 128 + 64 * wg + 16 * wr + (lane >> 2) + 8 * h2;
      const int n = nt * NT + 8 * jj + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + static_cast<long long>(m) * w.n + n) =
          make_float2(acc[4 * jj + 2 * h2], acc[4 * jj + 2 * h2 + 1]);
    }
}

// out[dst(j)] = sum over rows r of in[r][j], in the order of r, for rows
// [chunk y, chunk (y + 1)) (grid.y chunks: out holds a row per chunk, j
// in place) or, with one chunk, into out at dst(j): for j = (i0 b + i1) c
// + i2, dst(j) = (i1 c + i2) a + i0 (a = 1: j itself).
__global__ void __launch_bounds__(256)
bottleneck_sum_rows(const float* __restrict__ in, int rows, long long cols,
                    int chunk, float* __restrict__ out, int ma, int mb,
                    int mc) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= cols) return;
  const int r0 = blockIdx.y * chunk, r1 = min(rows, r0 + chunk);
  float acc = 0.f;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) acc += in[r * cols + j];
  if (gridDim.y > 1) {
    out[blockIdx.y * cols + j] = acc;
  } else {
    const long long i2 = j % mc, i01 = j / mc, i1 = i01 % mb, i0 = i01 / mb;
    out[(i1 * mc + i2) * ma + i0] = acc;
  }
}

// out[dst(j)] = sum over rows of in[r][j] in a fixed order: up to 256
// rows in one pass, more in levels of 64 rows through s1 and s2 (rows /
// 64 and rows / 4096 rows of cols).
cudaError_t sum_rows(const float* in, int rows, long long cols, float* out,
                     int ma, int mb, int mc, float* s1, float* s2,
                     cudaStream_t s) {
  const unsigned bx = static_cast<unsigned>((cols + 255) / 256);
  float* level[2] = {s1, s2};
  for (int k = 0; rows > 256; k ^= 1) {
    const int chunks = cdiv(rows, 64);
    bottleneck_sum_rows<<<dim3(bx, chunks), 256, 0, s>>>(
        in, rows, cols, 64, level[k], 1, 1, 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    in = level[k];
    rows = chunks;
  }
  bottleneck_sum_rows<<<dim3(bx, 1), 256, 0, s>>>(in, rows, cols, rows, out,
                                                  ma, mb, mc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

long long align256(long long b) { return (b + 255) / 256 * 256; }

// Blocks of a tile kernel (a pair of tiles each block at C <= 128, each
// cluster of two at C >= 256), up to one block an SM.
int grid_for(const Geo& g, int c, int sms) {
  const int cl = c <= 128 ? 1 : 2;
  return cl * std::max(1, std::min(g.groups, sms / cl));
}

// Scratch of one backward call (offsets into the workspace).
struct Work {
  long long a1, a2, dy2, dy1, y1, y2, dy3, mask, part, s1, s2, wpart, total;
  int part_rows;
};

int dw2_ranges(int n, int h, int w, int c, int sms);

Work plan_work(const Geo& g, int n, int c, int sms) {
  const long long px = g.pixels, f = 4LL * c, cols = 4 * c + 2 * f;
  Work k;
  long long off = 0;
  auto take = [&](long long bytes) {
    const long long at = off;
    off += align256(bytes);
    return at;
  };
  k.a1 = take(px * c * 2);
  k.a2 = take(px * c * 2);
  k.dy2 = take(px * c * 2);
  k.dy1 = take(px * c * 2);
  k.y1 = take(px * c * 4);
  k.y2 = take(px * c * 4);
  k.dy3 = take(px * f * 2);
  k.mask = take(2LL * g.groups * f * 8);   // a uint4 a thread, F pass, tile
  k.part_rows = g.tiles * 4;   // a row a warp and tile
  k.part = take(k.part_rows * cols * 4);
  k.s1 = take(cdiv(k.part_rows, 64) * cols * 4);
  k.s2 = take(cdiv(cdiv(k.part_rows, 64), 64) * cols * 4);
  const Wgrad w3 = plan_wgrad(static_cast<int>(f), c, g.pixels, sms);
  const int r2 = dw2_ranges(n, g.h, g.w, c, sms);
  long long wp = static_cast<long long>(w3.ranges) * f * c * 4;
  wp = std::max(wp, static_cast<long long>(r2) * 9 * c * c * 4);
  k.wpart = take(wp);
  k.total = off;
  return k;
}

template <int C, int MODE>
cudaError_t launch_tile(const CUtensorMap& amap, const Args& a, int grid,
                        cudaStream_t s) {
  using K = Cfg<C>;
  static simclr::SmemOptIn opt;
  cudaError_t err = opt(bottleneck_tile_kernel<C, MODE>, K::SMEM);
  if (err != cudaSuccess) return err;
  if (K::CL > 1)
    return simclr::launch_clusters(bottleneck_tile_kernel<C, MODE>,
                                   dim3(grid), dim3(K::THREADS), K::SMEM, s,
                                   K::CL, amap, a);
  bottleneck_tile_kernel<C, MODE><<<grid, K::THREADS, K::SMEM, s>>>(amap, a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t tile(int c, const CUtensorMap& amap, const Args& a, int grid,
                 cudaStream_t s) {
  switch (c) {
    case 64: return launch_tile<64, MODE>(amap, a, grid, s);
    case 128: return launch_tile<128, MODE>(amap, a, grid, s);
    case 256: return launch_tile<256, MODE>(amap, a, grid, s);
    default: return launch_tile<512, MODE>(amap, a, grid, s);
  }
}

template <int NT>
cudaError_t wgrad_launch(const CUtensorMap& am, const CUtensorMap& bm,
                         float* partial, const Wgrad& w, cudaStream_t s) {
  constexpr int smem = WG_STAGES * (2 * BOX + NT * 128) + 2 * WG_STAGES * 8;
  static simclr::SmemOptIn opt;
  cudaError_t err = opt(bottleneck_wgrad_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  bottleneck_wgrad_kernel<NT><<<w.ranges * w.tiles, WG_THREADS, smem, s>>>(
      am, bm, partial, w);
  return cudaGetLastError();
}

// D = A^T B over the pixels (A [P][m], B [P][n] bf16), summed over the
// ranges into out at dst (see bottleneck_sum_rows).
cudaError_t wgrad(const bf16* am, int m, const bf16* bm, int n, int pixels,
                  float* partial, float* out, int ma, int mb, int mc,
                  int sms, cudaStream_t s) {
  CUtensorMap amap, bmap;
  if (!simclr::matrix_tensor_map(&amap, am, pixels, m, 64) ||
      !simclr::matrix_tensor_map(&bmap, bm, pixels, n, 64))
    return cudaErrorInvalidValue;
  const Wgrad w = plan_wgrad(m, n, pixels, sms);
  cudaError_t err;
  switch (w.nt) {
    case 64: err = wgrad_launch<64>(amap, bmap, partial, w, s); break;
    case 128: err = wgrad_launch<128>(amap, bmap, partial, w, s); break;
    default: err = wgrad_launch<256>(amap, bmap, partial, w, s);
  }
  if (err != cudaSuccess) return err;
  return sum_rows(partial, w.ranges, static_cast<long long>(m) * n, out, ma,
                  mb, mc, nullptr, nullptr, s);
}

}  // namespace

extern "C" {

int conv64_geometry(int n, int h, int w, int kernel, int* out);
int conv3x3_wgrad_partials(const void* x, const void* g, void* partial,
                           int n, int h, int w, int c, int ranges,
                           void* stream);

}  // extern "C"

namespace {

// Pixel ranges of dw2 (conv64.cu's weight-gradient kernel, one block per
// range and 64 x 64 channel tile): the SMs filled about once.
int dw2_ranges(int n, int h, int w, int c, int sms) {
  int geom[6];
  if (conv64_geometry(n, h, w, 1, geom) != 0) return 1;
  return std::max(1, std::min(geom[4], sms / ((c / 64) * (c / 64))));
}

}  // namespace

extern "C" {

// The tiling at this shape: out = {t, whole, per_image, tiles, halo_off,
// hb, groups, grid}; 0, or -1 for a shape the kernels refuse.
int bottleneck_geometry(int n, int h, int w, int c, int* out) {
  Geo g;
  if (!make_geo(n, h, w, c, cap_for(c), &g)) return -1;
  const int v[8] = {g.t, g.whole, g.per_image, g.tiles, g.halo_off, g.hb,
                    g.groups, grid_for(g, c, sm_count())};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

#ifdef SIMCLR_B6_TRACE
// Copies the phase clocks out and clears them; returns their number.
int bottleneck_trace(long long* out) {
  int n = 0;
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(&n, b6_trace_n, sizeof(int));
  cudaMemcpyFromSymbol(out, b6_trace, sizeof(long long) * n);
  const int zero = 0;
  cudaMemcpyToSymbol(b6_trace_n, &zero, sizeof(int));
  return n;
}
#endif

// Bytes of scratch bottleneck_bwd needs for x of n x h x w pixels at width
// c (0 for a shape the kernels do not take).
long long bottleneck_bwd_workspace(int n, int h, int w, int c) {
  Geo g;
  if (!make_geo(n, h, w, c, cap_for(c), &g)) return 0;
  return plan_work(g, n, c, sm_count()).total;
}

// out = the block of x (NHWC bf16, 4c channels); wp = the forward half of
// ops/kernels/bottleneck.py:pack_weights (w1, w2, w3 in ring chunks); aff
// = [A1 B1 A2 B2 (c each) A3 B3 (4c each)] float32.
int bottleneck_fwd(const void* x, const void* wp, const void* aff, void* out,
                   int n, int h, int w, int c, void* stream) {
  Geo g;
  if (!make_geo(n, h, w, c, cap_for(c), &g) || !aligned16(x) ||
      !aligned16(wp) || !aligned16(out))
    return cudaErrorInvalidValue;
  CUtensorMap xmap;
  if (!simclr::matrix_tensor_map(&xmap, x, g.pixels, 4 * c, 64))
    return cudaErrorInvalidValue;
  const unsigned char* w8 = static_cast<const unsigned char*>(wp);
  Args a = {};
  a.g = g;
  a.w0 = w8;
  a.w1 = w8 + 2LL * 4 * c * c;
  a.w2 = a.w1 + 2LL * 9 * c * c;
  a.aff = static_cast<const float*>(aff);
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  return tile<FWD>(c, xmap, a, grid_for(g, c, sm_count()),
                   static_cast<cudaStream_t>(stream));
}

// The backward for the cotangent gy (NHWC bf16). wp as for the forward;
// wt = the backward half of pack_weights (w3^T, w2 rotated and swapped,
// w1^T). Writes dx (bf16), dw1 (c, 4c), dw2 (c, c, 3, 3), dw3 (4c, c) and
// daff (laid out as aff), all float32 but dx. work:
// bottleneck_bwd_workspace bytes.
int bottleneck_bwd(const void* x, const void* gy, const void* wp,
                   const void* wt, const void* aff, void* work, void* dx,
                   void* dw1, void* dw2, void* dw3, void* daff, int n, int h,
                   int w, int c, void* stream) {
  Geo g;
  if (!make_geo(n, h, w, c, cap_for(c), &g) || !aligned16(x) ||
      !aligned16(gy) || !aligned16(wp) || !aligned16(wt) ||
      !aligned16(dx) || !aligned16(work))
    return cudaErrorInvalidValue;
  const int sms = sm_count(), f = 4 * c;
  const Work k = plan_work(g, n, c, sms);
  unsigned char* base = static_cast<unsigned char*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a = {};
  a.g = g;
  a.aff = static_cast<const float*>(aff);
  a.x = static_cast<const bf16*>(x);
  a.gy = static_cast<const bf16*>(gy);
  a.a1 = reinterpret_cast<bf16*>(base + k.a1);
  a.a2 = reinterpret_cast<bf16*>(base + k.a2);
  a.dy2 = reinterpret_cast<bf16*>(base + k.dy2);
  a.dy1 = reinterpret_cast<bf16*>(base + k.dy1);
  a.dy3 = reinterpret_cast<bf16*>(base + k.dy3);
  a.y1 = reinterpret_cast<float*>(base + k.y1);
  a.y2 = reinterpret_cast<float*>(base + k.y2);
  a.mask = reinterpret_cast<uint2*>(base + k.mask);
  a.part = reinterpret_cast<float*>(base + k.part);
  float* wpart = reinterpret_cast<float*>(base + k.wpart);
  const unsigned char* w8 = static_cast<const unsigned char*>(wp);
  const unsigned char* t8 = static_cast<const unsigned char*>(wt);
  const int grid = grid_for(g, c, sms);
  CUtensorMap xmap, dy3map, dy2map;
  if (!simclr::matrix_tensor_map(&xmap, x, g.pixels, f, 64) ||
      !simclr::matrix_tensor_map(&dy3map, a.dy3, g.pixels, f, 64) ||
      !simclr::matrix_tensor_map(&dy2map, a.dy2, g.pixels, c, 64))
    return cudaErrorInvalidValue;

  a.w0 = w8;
  a.w1 = w8 + 2LL * 4 * c * c;
  a.w2 = a.w1 + 2LL * 9 * c * c;
  cudaError_t err = tile<BWD1>(c, xmap, a, grid, s);
  if (err != cudaSuccess) return err;
  a.w0 = t8;                                   // w3^T
  err = tile<BWD2>(c, dy3map, a, grid, s);
  if (err != cudaSuccess) return err;
  a.w0 = t8 + 2LL * 4 * c * c;                 // w2 rotated and swapped
  a.w1 = a.w0 + 2LL * 9 * c * c;               // w1^T
  a.out = static_cast<bf16*>(dx);
  err = tile<BWD3>(c, dy2map, a, grid, s);
  if (err != cudaSuccess) return err;
  // dw3[f][c] = dy3^T a2; dw2 from (a1, dy2); dw1[c][f] = (x^T dy1)^T.
  err = wgrad(a.dy3, f, a.a2, c, g.pixels, wpart, static_cast<float*>(dw3),
              1, 1, 1, sms, s);
  if (err != cudaSuccess) return err;
  const int r2 = dw2_ranges(n, h, w, c, sms);
  err = static_cast<cudaError_t>(conv3x3_wgrad_partials(
      a.a1, a.dy2, wpart, n, h, w, c, r2, stream));
  if (err != cudaSuccess) return err;
  err = sum_rows(wpart, r2, 9LL * c * c, static_cast<float*>(dw2), 9, c, c,
                 nullptr, nullptr, s);
  if (err != cudaSuccess) return err;
  err = wgrad(static_cast<const bf16*>(x), f, a.dy1, c, g.pixels, wpart,
              static_cast<float*>(dw1), f, c, 1, sms, s);
  if (err != cudaSuccess) return err;
  return sum_rows(a.part, k.part_rows, 4LL * c + 2LL * f,
                  static_cast<float*>(daff), 1, 1, 1,
                  reinterpret_cast<float*>(base + k.s1),
                  reinterpret_cast<float*>(base + k.s2), s);
}

}  // extern "C"
