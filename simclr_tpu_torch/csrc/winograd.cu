// Winograd F(2x2, 3x3) convolution (stride 1, SAME) for Hopper (sm_90a):
// warp-specialised kernels that stage their inputs with TMA (and U with
// bulk copies) through mbarrier rings and multiply on wgmma (bf16 x bf16
// -> float32).
//
// Replaces simclr_tpu/ops/pallas/winograd.py: _fwd_kernel (B5f, launched
// by the pallas_call in _run_fwd, line 218; also the input gradient, with
// the transform of the filter rotated 180 degrees and in/out swapped) and
// _dw_kernel (B5w, pallas_call in _run_dw, line 238).
//
// Tensors are NHWC bf16 (channels_last in PyTorch); H and W even. A tile
// is one 2x2 block of outputs and reads the 4x4 input patch around it
// (zero outside the image). Tiles are grouped into blocks (`Geom`): g
// whole images, or rb whole tile rows of one image, or cb tiles of one
// tile row, whichever holds at most 64 (B5f) or 16 (B5w) tiles. A block's
// input is one TMA box of the NHWC tensor, [channels, 2 cb + 2 columns,
// 2 rb + 2 rows, g images] from (c, 2 tx0 - 1, 2 ty0 - 1, n0): the box's
// zero fill outside the tensor is the SAME padding, and every pixel
// crosses L2 once per block and channel step, not once per patch (at
// layer2 [c, 18, 18, 1], layer3 [c, 10, 10, 4], layer4 [c, 6, 6, 16]).
//
// What bounds them on the H100: the 16 Winograd products are 34.4 GFLOP
// at each of the ResNet-50 path's shapes (0.035 ms of bf16 tensor time);
// layer2's [1024, 128, 16, 16] moves 134 MB (0.040 ms), layer3 and layer4
// less. A block holds its accumulators in registers, and every region of
// a kernel has the same 168 registers a thread at 384 threads (ptxas did
// not allocate past the launch bound where setmaxnreg raised it, and
// spilled), which shapes both designs.
//
// B5f, winograd_fwd_kernel: a block of 384 threads owns 64 tiles x 128
// output channels and walks the input channels 16 at a step. Warp 0 is
// the producer (lane 0: x boxes into a ring of 3; lane 1: U entries of 4
// positions, 16 KB each, into a ring of 4; the wrapper packs U so that an
// entry is one contiguous copy); warps 1-3 compute V = B^T d B for 16
// channels of each tile in float32 in the plain version's order, bit for
// bit, into a ring of 3 stages of 16 V planes; warpgroup 1 + I holds the
// bf16-to-be outputs Y[I][0] and Y[I][1] (64 tiles x 128 channels each,
// 128 float32 registers a thread). Rather than keeping M = V U for the 16
// positions (64 x 128 x 16 float32 a block, twice the register file) or
// folding each step's M into Y on the CUDA cores (36 adds a tile and
// channel a step), each position's product goes straight into every Y it
// feeds, with the output transform's sign as the wgmma A scale: 36
// m64n128k16 products a step instead of 16, 77 GFLOP a pass (the direct
// convolution's count, 0.078 ms of tensor time), in one asynchronous
// stream per warpgroup with no per-position wait. Y thus sums each
// position and step in another float32 order than JAX, which sums M over
// all channels first. The epilogue rounds Y to bf16 once, stages it in
// shared memory and writes 16-byte vectors. V serves 128 output channels;
// U crosses L2 once per block of 64 tiles (512 MB a pass).
//
// B5w, winograd_dw_kernel: dU[pos] = sum over tiles of V[pos]^T dM[pos],
// V from x as above and dM = the adjoint of the output transform applied
// to the 2x2 patches of the cotangent, both rounded to bf16 (as the JAX
// kernel rounds them). A block of 384 threads owns 64 c x 64 k of 8
// positions (one half of the 4x4, grid.z) and one range of tile blocks,
// 16 tiles a stage. Warp 0 is the producer (x box of 64 channels with the
// 128-byte swizzle, and the g box, into a ring of 4); warps 1-3 compute dM
// in float32; the 8 consumer warps compute V on the tensor cores
// (mma.sync against the constant 16 x 16 matrix B^T (x) B^T: products
// exact, the 4 terms summed in float32 in the tensor core's order, so a V
// entry can round to the other bf16 neighbour of the plain version's in
// rare cases), then warpgroup 1 + wq multiplies its 4 positions (A = V^T
// and B = dM, both MN-major from their [tile][channel] planes) from a
// ring of 3 operand stages. With more than one range each block writes a
// float32 partial and winograd_dw_reduce sums them over the ranges in a
// fixed order (no atomics: dU is the same from run to run). The ranges
// fill the SMs once: 16, 4 and 1 at layers 2-4 on 132 SMs, so the
// partials are 16.8 MB at layer2 and layer3 and none at layer4. dw =
// G^T dU G runs outside, in PyTorch, as JAX keeps it outside Pallas.
//
// Operand planes use wgmma's no-swizzle layout: 8 x 8 core matrices of
// 128 contiguous bytes, padded so that the warps' 4-byte stores (8
// positions, or 8 channel groups, a warp store) hit distinct banks. (The
// 32-byte-swizzle layout ran B5f slower on the card.)

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

using simclr::aligned16;
using simclr::bulk_load;
using simclr::desc_interleave;
using simclr::fence_operands;
using simclr::fence_proxy_async;
using simclr::ldsm_x4_t;
using simclr::mbar_arrive;
using simclr::mbar_expect_tx;
using simclr::mbar_fence_init;
using simclr::mbar_init;
using simclr::mbar_wait;
using simclr::mma_bf16_zero;
using simclr::named_barrier;
using simclr::sm_count;
using simclr::smem_addr;
using simclr::tma_load_4d;
using simclr::tma_prefetch_map;
using simclr::wgmma_64x128x16;
using simclr::wgmma_64x64x16;
using simclr::wgmma_commit;
using simclr::wgmma_fence;
using simclr::wgmma_wait;

constexpr int POS = 16;   // 4x4 transform positions
constexpr int CH = 32;    // C and K are multiples of this
constexpr int CC = 16;    // channels of a TMA box (32 bytes a pixel)

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Tile blocks
// ---------------------------------------------------------------------------

// A block of at most bt tiles: g whole images (an image has at most bt
// tiles), else rb whole tile rows of one image (a row has at most bt),
// else cb = bt tiles of one tile row; its input box, with the one-pixel
// halo, holds at most max_px pixels. Blocks are numbered
// (image group, row band, column band), the last fastest.
struct Geom {
  int g, rb, cb;   // extent of a block: images, tile rows, tile columns
  int ng, nr, nc;  // blocks along each
};

Geom geometry(int n, int h, int w, int bt, int max_px) {
  const int th = h / 2, tw = w / 2;
  Geom q;
  if (th * tw <= bt) {
    q.rb = th;
    q.cb = tw;
    q.g = std::min(bt / (th * tw), max_px / ((h + 2) * (w + 2)));
    q.g = std::max(1, std::min(q.g, n));
  } else if (tw <= bt) {
    q.g = 1;
    q.cb = tw;
    q.rb = std::min(bt / tw, max_px / (w + 2) / 2 - 1);
    q.rb = std::max(1, std::min(q.rb, th));
  } else {
    q.g = 1;
    q.rb = 1;
    q.cb = bt;
  }
  q.ng = cdiv(n, q.g);
  q.nr = cdiv(th, q.rb);
  q.nc = cdiv(tw, q.cb);
  return q;
}

struct Block {
  int n0, ty0, tx0;  // first image, tile row, tile column
  int bw, bh;        // box columns and rows (with the halo)
  int rect;          // tiles in the block's rectangle, g * rb * cb
};

__device__ __forceinline__ Block block_of(const Geom& q, int b) {
  Block k;
  const int bc = b % q.nc, br = (b / q.nc) % q.nr, bg = b / (q.nc * q.nr);
  k.n0 = bg * q.g;
  k.ty0 = br * q.rb;
  k.tx0 = bc * q.cb;
  k.bw = 2 * q.cb + 2;
  k.bh = 2 * q.rb + 2;
  k.rect = q.g * q.rb * q.cb;
  return k;
}

// Local tile l of a block -> image, tile row and column within the box.
__device__ __forceinline__ void local_tile(const Geom& q, int l, int& gi,
                                           int& ri, int& ci) {
  ci = l % q.cb;
  ri = (l / q.cb) % q.rb;
  gi = l / (q.cb * q.rb);
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ void st32(unsigned char* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// ---------------------------------------------------------------------------
// Input transform
// ---------------------------------------------------------------------------

// Row r of B^T: h_r = (d0 - d2, d1 + d2, d2 - d1, d1 - d3)[r].
__host__ __device__ constexpr float bt_coef(int r, int i) {
  return r == 0   ? (i == 0 ? 1.f : i == 2 ? -1.f : 0.f)
         : r == 1 ? (i == 1 || i == 2 ? 1.f : 0.f)
         : r == 2 ? (i == 2 ? 1.f : i == 1 ? -1.f : 0.f)
                  : (i == 1 ? 1.f : i == 3 ? -1.f : 0.f);
}

// This lane's A fragment of the 16 x 16 matrix T[p][e] = B^T[p/4][e/4] *
// B^T[p%4][e%4] (position p = 4 k + l, patch element e = 4 i + j), so
// that V = T d over a tile's 16 patch elements, for mma.sync.
__device__ __forceinline__ void transform_fragment(int lane,
                                                   uint32_t (&a)[4]) {
  const int g = lane >> 2, c = (lane & 3) * 2;
  auto t = [](int p, int e) {
    return bt_coef(p >> 2, e >> 2) * bt_coef(p & 3, e & 3);
  };
  a[0] = pack(t(g, c), t(g, c + 1));
  a[1] = pack(t(g + 8, c), t(g + 8, c + 1));
  a[2] = pack(t(g, c + 8), t(g, c + 9));
  a[3] = pack(t(g + 8, c + 8), t(g + 8, c + 9));
}

// This lane's ldmatrix row: patch element e (row i, column j) and channel
// half, for matrices (e 0-7 | 8-15) x (channels 0-7 | 8-15).
__device__ __forceinline__ void lane_element(int lane, int& i, int& j,
                                             int& chalf) {
  const int m = lane >> 3, e = (m & 1) * 8 + (lane & 7);
  i = e >> 2;
  j = e & 3;
  chalf = m >> 1;
}

// V = B^T d B of one tile and two channels in float32, in the plain
// version's order (h_k over the patch rows, then the same over the
// columns of h_k), each entry rounded once to bf16: bit for bit the plain
// version's V. load_patch reads the patch of channel pair `pair` whose
// corner is box pixel p00 (bw pixels a box row); v[4 k + l] packs the
// pair at position (k, l).
__device__ __forceinline__ void load_patch(const unsigned char* box, int p00,
                                           int bw, int pair,
                                           uint32_t (&d)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[i][j] = *reinterpret_cast<const uint32_t*>(
          box + (p00 + i * bw + j) * (CC * 2) + pair * 4);
}

__device__ __forceinline__ void patch_transform(const uint32_t (&d)[4][4],
                                                uint32_t (&v)[POS]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float hk[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = unpack(d[0][j]), b = unpack(d[1][j]),
                   c = unpack(d[2][j]), e = unpack(d[3][j]);
      if (k == 0) { hk[j][0] = a.x - c.x; hk[j][1] = a.y - c.y; }
      if (k == 1) { hk[j][0] = b.x + c.x; hk[j][1] = b.y + c.y; }
      if (k == 2) { hk[j][0] = c.x - b.x; hk[j][1] = c.y - b.y; }
      if (k == 3) { hk[j][0] = b.x - e.x; hk[j][1] = b.y - e.y; }
    }
    v[4 * k + 0] = pack(hk[0][0] - hk[2][0], hk[0][1] - hk[2][1]);
    v[4 * k + 1] = pack(hk[1][0] + hk[2][0], hk[1][1] + hk[2][1]);
    v[4 * k + 2] = pack(hk[2][0] - hk[1][0], hk[2][1] - hk[1][1]);
    v[4 * k + 3] = pack(hk[1][0] - hk[3][0], hk[1][1] - hk[3][1]);
  }
}

// V of two 16-channel units (unit = 4 tile + channel block) of B5w's
// 64-channel x box (128-byte rows with the 128-byte swizzle) on the tensor
// cores, both ldmatrix first; stores the block's half PH of the
// positions (rows lane / 4 + 8 PH of the transform) into the V planes
// (plane lane / 4, [tile / 8][c / 8][tile % 8][c % 8], planes `vplane`
// bytes apart). tab[l] is the box pixel of tile l's patch corner, -1
// past the block's rectangle (stores zeros); lane_px this lane's offset
// in the patch.
template <int PH>
__device__ __forceinline__ void v_units(const unsigned char* xs,
                                        unsigned char* vs, const int* tab,
                                        const int (&unit)[2],
                                        const uint32_t (&a)[4], int lane_px,
                                        int chalf, int lane, int vplane) {
  uint32_t r[2][4];
  int corner[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    corner[t] = tab[unit[t] >> 2];
    const int px = max(corner[t], 0) + lane_px;
    ldsm_x4_t(smem_addr(xs + px * 128 +
                        (((2 * (unit[t] & 3) + chalf) ^ (px & 7)) << 4)),
              r[t]);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float d0[4], d1[4];
    mma_bf16_zero(d0, a, r[t][0], r[t][1]);
    mma_bf16_zero(d1, a, r[t][2], r[t][3]);
    const int l = unit[t] >> 2, m = 2 * (unit[t] & 3);
    unsigned char* dst = vs + (lane >> 2) * vplane + (l >> 3) * 1024 +
                         (l & 7) * 16 + (lane & 3) * 4 + m * 128;
    st32(dst, corner[t] >= 0 ? pack(d0[2 * PH], d0[2 * PH + 1]) : 0u);
    st32(dst + 128, corner[t] >= 0 ? pack(d1[2 * PH], d1[2 * PH + 1]) : 0u);
  }
}

// ---------------------------------------------------------------------------
// B5f
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 384;
constexpr int F_XFORM = 3;                     // transform warps 1-3
constexpr int F_BT = 64;                       // tiles a block
constexpr int F_BK = 128;                      // output channels a block
constexpr int F_MAXPX = 576;                   // box pixels
constexpr int F_XBYTES = F_MAXPX * CC * 2;     // 18432
// Operand planes in wgmma's no-swizzle K-major layout: 8 x 8 core
// matrices [row / 8][channel / 8][row % 8][channel % 8] of 128 bytes, rows
// the tiles of V or the output channels of U; V planes padded by 16 bytes
// so that a warp store (8 positions) hits distinct banks.
constexpr int F_VPLANE = F_BT * CC * 2 + 16;   // 2064
constexpr int F_VBYTES = POS * F_VPLANE;       // 33024
constexpr int F_UPLANE = F_BK * CC * 2;        // 4096
constexpr int F_UPOS = 4;                      // positions of a U entry
constexpr int F_STAGES = 3;
constexpr int F_UENTRIES = 4;
constexpr int F_UENTRY = F_UPOS * F_UPLANE;
constexpr int F_UGROUPS = POS / F_UPOS;        // entries (groups) a step
constexpr int F_XSLOTS = 3;
constexpr int F_X0 = 0;
constexpr int F_V0 = F_X0 + F_XSLOTS * F_XBYTES;
constexpr int F_U0 = (F_V0 + F_STAGES * F_VBYTES + 1023) / 1024 * 1024;
constexpr int F_BAR = F_U0 + F_UENTRIES * F_UENTRY;
constexpr int F_TAB = F_BAR + 256;             // int[64]
constexpr int F_SMEM = F_TAB + F_BT * 4;
constexpr int F_YROW = 4 * F_BK * 2 + 16;      // a tile's staged outputs
static_assert(F_BT * F_YROW <= F_U0, "staging overlaps the U ring");
static_assert(F_SMEM <= 232448, "B5f shared memory");

// A^T of the output transform: y_i = sum over r of A^T[i][r] m_r, A^T =
// ((1, 1, 1, 0), (0, 1, -1, -1)).
__host__ __device__ constexpr int at_coef(int i, int r) {
  return i == 0 ? (r < 3 ? 1 : 0) : (r == 0 ? 0 : r == 1 ? 1 : -1);
}

// Consumer warpgroup of output row I: y[j] += A^T[I][r] A^T[j][q] V_p U_p
// for every position p = 4 r + q, straight into the two Y planes (64
// tiles x 128 k each) on wgmma with the sign as the A operand's scale.
// One commit group per U entry (a row of 4 positions); the group before
// is waited for and its U entry (and, after a step's last group, its V
// stage) released, so the tensor core always has the next group queued.
template <int I>
__device__ __forceinline__ void fwd_consume(unsigned char* smem,
                                            uint64_t* vfull, uint64_t* vempty,
                                            uint64_t* ufull, uint64_t* uempty,
                                            int steps, int lane,
                                            float (&y)[2][64]) {
  // No instruction but wgmma touches y between the fences below: an
  // operand fence inside the loop would make ptxas serialise the wgmmas.
  fence_operands(y[0]);
  fence_operands(y[1]);
  wgmma_fence();
  for (int i = 0; i < steps; ++i) {
    const int s = i % F_STAGES;
    mbar_wait(&vfull[s], (i / F_STAGES) & 1);
    const uint64_t vdesc =
        desc_interleave(smem + F_V0 + s * F_VBYTES, 128, 256);
#pragma unroll
    for (int gr = 0; gr < F_UGROUPS; ++gr) {
      // Group j: the positions of U entry j % F_UENTRIES, whole rows of
      // the 4x4. A plane's start address is the descriptor's low field
      // (16-byte units); shared memory stays below 2**18 bytes, so adding
      // the plane offset never carries out of it.
      const int j = F_UGROUPS * i + gr, e = j % F_UENTRIES;
      mbar_wait(&ufull[e], (j / F_UENTRIES) & 1);
      const uint64_t udesc =
          desc_interleave(smem + F_U0 + e * F_UENTRY, 128, 256);
#pragma unroll
      for (int pp = 0; pp < F_UPOS; ++pp) {
        const int p = F_UPOS * gr + pp, ar = at_coef(I, p >> 2);
        if (ar == 0) continue;
        const uint64_t da = vdesc + p * (F_VPLANE >> 4);
        const uint64_t db = udesc + pp * (F_UPLANE >> 4);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int sign = ar * at_coef(jj, p & 3);
          if (sign == 1) wgmma_64x128x16<0, 0, 1>(y[jj], da, db, 1);
          if (sign == -1) wgmma_64x128x16<0, 0, -1>(y[jj], da, db, 1);
        }
      }
      wgmma_commit();
      // The group before this one is done: release its U entry and, after
      // a step's last group, its V stage.
      wgmma_wait<1>();
      if (j > 0) {
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&uempty[(j - 1) % F_UENTRIES]);
          if (gr == 0) mbar_arrive(&vempty[(i - 1) % F_STAGES]);
        }
      }
    }
  }
  wgmma_wait<0>();
  fence_operands(y[0]);
  fence_operands(y[1]);
}

__global__ void __launch_bounds__(F_THREADS, 1)
winograd_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                    const unsigned char* __restrict__ upk,
                    __nv_bfloat16* __restrict__ y, Geom q, int n, int h,
                    int w, int cin, int kout) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + F_BAR);
  uint64_t* xfull = bar;         // [3] an x box has landed
  uint64_t* xempty = bar + 3;    // [3] the transform warps have read it
  uint64_t* vfull = bar + 6;     // [F_STAGES] the transform warps wrote V
  uint64_t* vempty = bar + 9;    // [F_STAGES] the consumers are done
  uint64_t* ufull = bar + 12;    // [F_UENTRIES] a U entry has landed
  uint64_t* uempty = bar + 16;   // [F_UENTRIES] the consumers are done
  int* tab = reinterpret_cast<int*>(smem + F_TAB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int steps = cin / CC, kb = blockIdx.y;
  const Block blk = block_of(q, blockIdx.x);

  if (tid == 0) {
    for (int s = 0; s < F_XSLOTS; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], F_XFORM);
    }
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(&vfull[s], F_XFORM);
      mbar_init(&vempty[s], 8);
    }
    for (int e = 0; e < F_UENTRIES; ++e) {
      mbar_init(&ufull[e], 1);
      mbar_init(&uempty[e], 8);
    }
    mbar_fence_init();
  }
  // tab[l]: box pixel of the corner of local tile l's patch, -1 past the
  // block's rectangle.
  if (tid < F_BT) {
    int corner = -1;
    if (tid < blk.rect) {
      int gi, ri, ci;
      local_tile(q, tid, gi, ri, ci);
      corner = (gi * blk.bh + 2 * ri) * blk.bw + 2 * ci;
    }
    tab[tid] = corner;
  }
  __syncthreads();

  if (warp == 0) {
    // Producers: lane 0 streams the x boxes, lane 1 the U entries, each
    // running ahead as far as its own ring allows.
    if (lane == 0) {
      tma_prefetch_map(&xmap);
      const uint32_t xbytes = CC * 2 * blk.bw * blk.bh * q.g;
      for (int i = 0; i < steps; ++i) {
        const int xs = i % F_XSLOTS;
        mbar_wait(&xempty[xs], ((i / F_XSLOTS) & 1) ^ 1);
        mbar_expect_tx(&xfull[xs], xbytes);
        tma_load_4d(smem + F_X0 + xs * F_XBYTES, &xmap, &xfull[xs], i * CC,
                    2 * blk.tx0 - 1, 2 * blk.ty0 - 1, blk.n0);
      }
    } else if (lane == 1) {
      const unsigned char* ublk =
          upk + static_cast<long long>(kb) * steps * POS * F_UPLANE;
      for (int j = 0; j < F_UGROUPS * steps; ++j) {
        const int e = j % F_UENTRIES;
        mbar_wait(&uempty[e], ((j / F_UENTRIES) & 1) ^ 1);
        mbar_expect_tx(&ufull[e], F_UENTRY);
        bulk_load(smem + F_U0 + e * F_UENTRY,
                  ublk + static_cast<long long>(j) * F_UENTRY, F_UENTRY,
                  &ufull[e]);
      }
    }
    return;
  }
  if (warp <= F_XFORM) {
    // Transform warps 1-3: item = (tile, channel pair), 4 tiles x 8
    // pairs a warp instruction.
    for (int i = 0; i < steps; ++i) {
      const int s = i % F_STAGES, slot = i % F_XSLOTS;
      mbar_wait(&xfull[slot], (i / F_XSLOTS) & 1);
      mbar_wait(&vempty[s], ((i / F_STAGES) & 1) ^ 1);
      const unsigned char* xs = smem + F_X0 + slot * F_XBYTES;
      unsigned char* vs = smem + F_V0 + s * F_VBYTES;
      // Two items an iteration, (tile, pair) and (tile + 28, pair): all
      // loads first, so that their latencies overlap. A tile past the
      // rectangle reads the first patch and stores zeros.
      for (int item = tid - 32; item < F_BT * (CC / 2);
           item += 64 * F_XFORM) {
        const int l0 = item >> 3, l1 = l0 + 4 * F_XFORM, pair = item & 7;
        const bool two = l1 < F_BT;
        const int c0 = tab[l0], c1 = two ? tab[l1] : -1;
        uint32_t d0[4][4], d1[4][4];
        load_patch(xs, max(c0, 0), blk.bw, pair, d0);
        load_patch(xs, max(c1, 0), blk.bw, pair, d1);
        uint32_t v0[POS], v1[POS];
        patch_transform(d0, v0);
        patch_transform(d1, v1);
        // Plane p: [tile / 8][channel / 8][tile % 8][channel % 8].
        const int col = (pair >> 2) * 128 + (pair & 3) * 4;
        unsigned char* row0 = vs + (l0 >> 3) * 256 + (l0 & 7) * 16 + col;
        unsigned char* row1 = vs + (l1 >> 3) * 256 + (l1 & 7) * 16 + col;
#pragma unroll
        for (int p = 0; p < POS; ++p) {
          st32(row0 + p * F_VPLANE, c0 >= 0 ? v0[p] : 0u);
          if (two) st32(row1 + p * F_VPLANE, c1 >= 0 ? v1[p] : 0u);
        }
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&xempty[slot]);
        mbar_arrive(&vfull[s]);
      }
    }
    return;
  }

  // Consumers: warpgroup 1 + I holds Y planes (I, 0) and (I, 1) of the
  // block's 64 tiles x 128 output channels; thread rows 16 (warp % 4) +
  // lane / 4 (+ 8) are tiles.
  const int wi = (warp >> 2) - 1;
  float acc[2][64];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[jj][e] = 0.f;
  if (wi == 0)
    fwd_consume<0>(smem, vfull, vempty, ufull, uempty, steps, lane, acc);
  else
    fwd_consume<1>(smem, vfull, vempty, ufull, uempty, steps, lane, acc);

  // Epilogue: bf16 Y staged as [tile][pixel][128 k] (rows padded by 16
  // bytes), then 16-byte stores of each output pixel's channels.
  named_barrier(1, 256);   // both warpgroups are past their last wgmma
  const int g8 = lane >> 2, c4 = lane & 3, wr = 16 * (warp & 3);
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int j8 = 0; j8 < 16; ++j8)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int l = wr + g8 + 8 * half, k = 8 * j8 + 2 * c4;
        st32(smem + l * F_YROW + (2 * wi + jj) * F_BK * 2 + k * 2,
             pack(acc[jj][4 * j8 + 2 * half],
                  acc[jj][4 * j8 + 2 * half + 1]));
      }
  named_barrier(1, 256);
  const int th = h / 2, tw = w / 2, kblk = kb * F_BK;
  for (int idx = tid - 128; idx < F_BT * 4 * (F_BK / 8); idx += 256) {
    const int l = idx / (4 * (F_BK / 8)), o = (idx / (F_BK / 8)) & 3,
              ch = idx % (F_BK / 8);
    if (l >= blk.rect || kblk + 8 * ch >= kout) continue;
    int gi, ri, ci;
    local_tile(q, l, gi, ri, ci);
    const int img = blk.n0 + gi, ty = blk.ty0 + ri, tx = blk.tx0 + ci;
    if (img >= n || ty >= th || tx >= tw) continue;
    const long long pix =
        (static_cast<long long>(img) * h + 2 * ty + (o >> 1)) * w + 2 * tx +
        (o & 1);
    *reinterpret_cast<uint4*>(y + pix * kout + kblk + 8 * ch) =
        *reinterpret_cast<const uint4*>(smem + l * F_YROW + o * F_BK * 2 +
                                        ch * 16);
  }
}

// ---------------------------------------------------------------------------
// B5w
// ---------------------------------------------------------------------------

constexpr int W_THREADS = 384;
constexpr int W_XFORM = 3;                     // transform warps 1-3
constexpr int W_BT = 16;                       // tiles a stage
constexpr int W_BC = 64;
constexpr int W_BK = 64;
constexpr int W_MAXPX = 144;
// Input ring: the x box (64 channels, 128-byte rows with their 16-byte
// chunks permuted by the row, CU_TENSOR_MAP_SWIZZLE_128B) and the g box
// (64 channels, plain rows).
constexpr int W_XBYTES = W_MAXPX * W_BC * 2;   // 18432
constexpr int W_GBYTES = W_BT * 4 * W_BK * 2;  // 8192
constexpr int W_IN = W_XBYTES + W_GBYTES;      // 26 x 1024
constexpr int W_INSLOTS = 4;
// Operand ring, wgmma's no-swizzle MN-major layout: 8 x 8 core matrices
// [tile / 8][channel / 8][tile % 8][channel % 8] of 128 bytes. V planes:
// core matrices 128 bytes apart, each plane padded by 16 bytes (a warp
// store covers 8 positions); dM planes: core matrices 144 bytes apart (a
// warp store covers 8 channel groups).
constexpr int W_VPLANE = 2 * 8 * 128 + 16;     // 2064
constexpr int W_VBYTES = 8 * W_VPLANE;         // 16512
constexpr int W_DCORE = 144;
constexpr int W_DPLANE = 2 * 8 * W_DCORE;      // 2304
constexpr int W_DBYTES = 8 * W_DPLANE;         // 18432
constexpr int W_OP = (W_VBYTES + W_DBYTES + 127) / 128 * 128;
constexpr int W_OPSLOTS = 3;
constexpr int W_OP0 = W_INSLOTS * W_IN;
constexpr int W_BAR = W_OP0 + W_OPSLOTS * W_OP;
constexpr int W_TAB = W_BAR + 128;             // int[2][16]
constexpr int W_SMEM = W_TAB + 2 * W_BT * 4;
static_assert(W_IN % 1024 == 0, "swizzled x boxes need 1024-byte slots");
static_assert(W_SMEM <= 232448, "B5w shared memory");

// (a0, a0 + a1, a0 - a1, -a1)[r]: one axis of the adjoint of the output
// transform.
__device__ __forceinline__ float2 adj(float2 a0, float2 a1, int r) {
  return r == 0   ? a0
         : r == 1 ? make_float2(a0.x + a1.x, a0.y + a1.y)
         : r == 2 ? make_float2(a0.x - a1.x, a0.y - a1.y)
                  : make_float2(-a1.x, -a1.y);
}

// dU (or one range's partial) [16][C][K] float32 of 64 c x 64 k, 8
// positions (8 ph .. 8 ph + 7, ph = blockIdx.z % 2).
__global__ void __launch_bounds__(W_THREADS, 1)
winograd_dw_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap gmap,
                   float* __restrict__ out, Geom q, int blocks, int per_range,
                   int cin, int kout) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + W_BAR);
  uint64_t* infull = bar;        // [4] x and g boxes have landed
  uint64_t* inempty = bar + 4;   // [4] transform and dM are done reading
  uint64_t* dfull = bar + 8;     // [3] the transform warps wrote dM
  uint64_t* opempty = bar + 11;  // [3] the consumers' products are done
  int* xtab = reinterpret_cast<int*>(smem + W_TAB);
  int* gtab = xtab + W_BT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * W_BC, k0 = blockIdx.y * W_BK;
  const int ph = blockIdx.z & 1, range = blockIdx.z >> 1;
  const int begin = range * per_range;
  const int count = max(0, min(blocks, begin + per_range) - begin);
  const int bw = 2 * q.cb + 2, bh = 2 * q.rb + 2;

  if (tid == 0) {
    for (int s = 0; s < W_INSLOTS; ++s) {
      mbar_init(&infull[s], 1);
      mbar_init(&inempty[s], W_XFORM + 8);
    }
    for (int s = 0; s < W_OPSLOTS; ++s) {
      mbar_init(&dfull[s], W_XFORM);
      mbar_init(&opempty[s], 8);
    }
    mbar_fence_init();
  }
  // Box pixels of local tile l (the same in every block of the launch):
  // xtab the corner of its x patch, gtab its first cotangent pixel; -1
  // past the block's rectangle.
  if (tid < W_BT) {
    int xc = -1, gc = -1;
    if (tid < q.g * q.rb * q.cb) {
      int gi, ri, ci;
      local_tile(q, tid, gi, ri, ci);
      xc = (gi * bh + 2 * ri) * bw + 2 * ci;
      gc = (gi * 2 * q.rb + 2 * ri) * 2 * q.cb + 2 * ci;
    }
    xtab[tid] = xc;
    gtab[tid] = gc;
  }
  __syncthreads();

  if (warp == 0) {
    // Producer: one thread issues every copy.
    if (lane != 0) return;
    tma_prefetch_map(&xmap);
    tma_prefetch_map(&gmap);
    const uint32_t bytes =
        W_BC * 2 * bw * bh * q.g + W_BK * 2 * 4 * q.rb * q.cb * q.g;
    for (int it = 0; it < count; ++it) {
      const int s = it % W_INSLOTS;
      const Block blk = block_of(q, begin + it);
      mbar_wait(&inempty[s], ((it / W_INSLOTS) & 1) ^ 1);
      unsigned char* in = smem + s * W_IN;
      mbar_expect_tx(&infull[s], bytes);
      tma_load_4d(in, &xmap, &infull[s], c0, 2 * blk.tx0 - 1,
                  2 * blk.ty0 - 1, blk.n0);
      tma_load_4d(in + W_XBYTES, &gmap, &infull[s], k0, 2 * blk.tx0,
                  2 * blk.ty0, blk.n0);
    }
    return;
  }
  if (warp <= W_XFORM) {
    // Transform warps 1-3: dM of this block's 8 positions (rows 2 PH and
    // 2 PH + 1 of the 4x4, PH known at compile time) in float32, lane =
    // output-channel pair, a tile an iteration.
    const int gw = 2 * q.cb;
    auto dm = [&](auto half) {
      constexpr int PH = decltype(half)::value;
      for (int it = 0; it < count; ++it) {
        const int s = it % W_INSLOTS, o = it % W_OPSLOTS;
        mbar_wait(&infull[s], (it / W_INSLOTS) & 1);
        mbar_wait(&opempty[o], ((it / W_OPSLOTS) & 1) ^ 1);
        const unsigned char* gs = smem + s * W_IN + W_XBYTES;
        unsigned char* ds = smem + W_OP0 + o * W_OP + W_VBYTES;
        // A tile past the rectangle reads the first pixel and stores
        // zeros.
        for (int l = warp - 1; l < W_BT; l += W_XFORM) {
          const int gc = gtab[l];
          const unsigned char* px = gs + max(gc, 0) * (W_BK * 2) + lane * 4;
          const float2 y00 = unpack(*reinterpret_cast<const uint32_t*>(px));
          const float2 y10 = unpack(
              *reinterpret_cast<const uint32_t*>(px + gw * (W_BK * 2)));
          const float2 y01 =
              unpack(*reinterpret_cast<const uint32_t*>(px + W_BK * 2));
          const float2 y11 = unpack(*reinterpret_cast<const uint32_t*>(
              px + (gw + 1) * (W_BK * 2)));
          unsigned char* dst = ds + (l >> 3) * (8 * W_DCORE) +
                               (lane >> 2) * W_DCORE + (l & 7) * 16 +
                               (lane & 3) * 4;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            // h = adj(y_0j, y_1j)[k4] per column j, dM = adj(h0, h1).
            const float2 h0 = adj(y00, y10, 2 * PH + kk);
            const float2 h1 = adj(y01, y11, 2 * PH + kk);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float2 d = adj(h0, h1, c);
              st32(dst + (4 * kk + c) * W_DPLANE,
                   gc >= 0 ? pack(d.x, d.y) : 0u);
            }
          }
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&inempty[s]);
          mbar_arrive(&dfull[o]);
        }
      }
    };
    if (ph)
      dm(std::integral_constant<int, 1>());
    else
      dm(std::integral_constant<int, 0>());
    return;
  }

  // Consumers: all 8 warps compute V (two tiles a warp, on the tensor
  // cores); then warpgroup 1 + wq multiplies positions 4 wq .. 4 wq + 3 of
  // the 8 (one row of the 4x4) on wgmma.
  const int wq = (warp >> 2) - 1, cw = warp - 4;
  uint32_t a[4];
  transform_fragment(lane, a);
  int pi, pj, chalf;
  lane_element(lane, pi, pj, chalf);
  const int lane_px = pi * bw + pj;
  float acc[4][32];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;
  // No instruction but wgmma touches acc inside the loop (see fwd_consume).
#pragma unroll
  for (int p = 0; p < 4; ++p) fence_operands(acc[p]);
  wgmma_fence();
  // The loop, for the half PH known at compile time.
  auto consume = [&](auto half) {
    constexpr int PH = decltype(half)::value;
    for (int it = 0; it < count; ++it) {
      const int s = it % W_INSLOTS, o = it % W_OPSLOTS;
      mbar_wait(&infull[s], (it / W_INSLOTS) & 1);
      const unsigned char* xs = smem + s * W_IN;
      unsigned char* vs = smem + W_OP0 + o * W_OP;
      const unsigned char* ds = vs + W_VBYTES;
      // V of tiles 2 cw and 2 cw + 1 (units 8 cw .. 8 cw + 7, unit = 4
      // tile + 16-channel block), two units at a time. This slot was last
      // read by products of stage it - 3, which both warpgroups waited for
      // before the barrier of stage it - 1.
#pragma unroll
      for (int m = 0; m < 8; m += 2) {
        const int unit[2] = {8 * cw + m, 8 * cw + m + 1};
        v_units<PH>(xs, vs, xtab, unit, a, lane_px, chalf, lane, W_VPLANE);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&inempty[s]);
      named_barrier(1, 256);   // V of all 16 tiles is written
      mbar_wait(&dfull[o], (it / W_OPSLOTS) & 1);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int pp = 4 * wq + p;
        wgmma_64x64x16<1, 1>(
            acc[p], desc_interleave(vs + pp * W_VPLANE, 1024, 128),
            desc_interleave(ds + pp * W_DPLANE, 8 * W_DCORE, W_DCORE), 1);
      }
      wgmma_commit();
      // Release the previous stage's operands once its products are done.
      wgmma_wait<1>();
      if (it > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&opempty[(it - 1) % W_OPSLOTS]);
      }
    }
  };
  if (ph)
    consume(std::integral_constant<int, 1>());
  else
    consume(std::integral_constant<int, 0>());
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < 4; ++p) fence_operands(acc[p]);

  float* dst = out + static_cast<long long>(range) * POS * cin * kout;
  const int g8 = lane >> 2, c4 = lane & 3, wr = 16 * (warp & 3);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int pos = 8 * ph + 4 * wq + p;
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const int k = k0 + 8 * j8 + 2 * c4;
      if (k >= kout) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + wr + g8 + 8 * half;
        if (c >= cin) continue;
        *reinterpret_cast<float2*>(
            dst + (static_cast<long long>(pos) * cin + c) * kout + k) =
            make_float2(acc[p][4 * j8 + 2 * half],
                        acc[p][4 * j8 + 2 * half + 1]);
      }
    }
  }
}

// out[j] = sum over ranges, in order, of partial[range][j].
__global__ void __launch_bounds__(256)
winograd_dw_reduce(const float* __restrict__ partial, int ranges,
                   long long count, float* __restrict__ out) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= count) return;
  float acc = 0.f;
  for (int r = 0; r < ranges; ++r) acc += partial[r * count + j];
  out[j] = acc;
}

bool shape_ok(int n, int h, int w, int cin, int kout) {
  const long long pixels = static_cast<long long>(n) * h * w;
  return n > 0 && h > 0 && w > 0 && h % 2 == 0 && w % 2 == 0 &&
         cin > 0 && kout > 0 && cin % CH == 0 && kout % CH == 0 &&
         pixels * cin < (1LL << 31) && pixels * kout < (1LL << 31);
}

simclr::SmemOptIn fwd_smem;
simclr::SmemOptIn dw_smem;

}  // namespace

extern "C" {


// The tile blocks of kernel 0 (B5f) or 1 (B5w) at this shape, as
// out = {g, rb, cb, ng, nr, nc}; 0, or -1 for a shape the kernels refuse.
int winograd_geometry(int n, int h, int w, int kernel, int* out) {
  if (!shape_ok(n, h, w, CH, CH) || (kernel != 0 && kernel != 1)) return -1;
  const Geom q = kernel == 0 ? geometry(n, h, w, F_BT, F_MAXPX)
                             : geometry(n, h, w, W_BT, W_MAXPX);
  const int v[6] = {q.g, q.rb, q.cb, q.ng, q.nr, q.nc};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// Tile ranges winograd_dw splits the batch into (its partial buffer holds
// that many [16][C][K] float32 slices when it is above 1), or -1.
int winograd_dw_ranges(int n, int h, int w, int cin, int kout) {
  if (!shape_ok(n, h, w, cin, kout)) return -1;
  const Geom q = geometry(n, h, w, W_BT, W_MAXPX);
  const int blocks = q.ng * q.nr * q.nc;
  const int per_range = cdiv(cin, W_BC) * cdiv(kout, W_BK) * 2;
  const int ranges = std::max(1, sm_count() / per_range);
  return std::min(ranges, blocks);
}

// y = conv3x3(x, w) through U = transform of w, packed by the wrapper as
// [K / 128][C / 16][16 positions][k % 128][16 c] bf16, K padded with zeros
// to a multiple of 128 and the two 16-byte halves of row k swapped where
// (k / 4) % 2 is 1 (wgmma's 32-byte swizzle); x NHWC (N, H, W, C) bf16, y
// NHWC (N, H, W, K) bf16.
int winograd_fwd(const void* x, const void* u, void* y, int n, int h, int w,
                 int cin, int kout, void* stream) {
  if (!shape_ok(n, h, w, cin, kout) || !aligned16(x) || !aligned16(u) ||
      !aligned16(y))
    return cudaErrorInvalidValue;
  const Geom q = geometry(n, h, w, F_BT, F_MAXPX);
  CUtensorMap xmap;
  const uint32_t box[4] = {CC, static_cast<uint32_t>(2 * q.cb + 2),
                           static_cast<uint32_t>(2 * q.rb + 2),
                           static_cast<uint32_t>(q.g)};
  if (!simclr::nhwc_tensor_map(&xmap, x, n, h, w, cin, box, false))
    return cudaErrorInvalidValue;
  cudaError_t err = fwd_smem(winograd_fwd_kernel, F_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(q.ng * q.nr * q.nc, cdiv(kout, F_BK));
  winograd_fwd_kernel<<<grid, F_THREADS, F_SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      xmap, static_cast<const unsigned char*>(u),
      static_cast<__nv_bfloat16*>(y), q, n, h, w, cin, kout);
  return cudaGetLastError();
}

// dU [16][C][K] float32 of x (N, H, W, C) and the cotangent g (N, H, W, K),
// both NHWC bf16. partial: winograd_dw_ranges(...) x 16 x C x K float32
// when that is above 1 (else unused).
int winograd_dw(const void* x, const void* g, void* partial, void* du, int n,
                int h, int w, int cin, int kout, void* stream) {
  const int ranges = winograd_dw_ranges(n, h, w, cin, kout);
  if (ranges < 1 || !aligned16(x) || !aligned16(g))
    return cudaErrorInvalidValue;
  const Geom q = geometry(n, h, w, W_BT, W_MAXPX);
  CUtensorMap xmap, gmap;
  const uint32_t xbox[4] = {W_BC, static_cast<uint32_t>(2 * q.cb + 2),
                            static_cast<uint32_t>(2 * q.rb + 2),
                            static_cast<uint32_t>(q.g)};
  const uint32_t gbox[4] = {W_BK, static_cast<uint32_t>(2 * q.cb),
                            static_cast<uint32_t>(2 * q.rb),
                            static_cast<uint32_t>(q.g)};
  if (!simclr::nhwc_tensor_map(&xmap, x, n, h, w, cin, xbox, true) ||
      !simclr::nhwc_tensor_map(&gmap, g, n, h, w, kout, gbox, false))
    return cudaErrorInvalidValue;
  cudaError_t err = dw_smem(winograd_dw_kernel, W_SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = q.ng * q.nr * q.nc;
  const int per_range = cdiv(blocks, ranges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = ranges > 1 ? static_cast<float*>(partial)
                          : static_cast<float*>(du);
  const dim3 grid(cdiv(cin, W_BC), cdiv(kout, W_BK), 2 * ranges);
  winograd_dw_kernel<<<grid, W_THREADS, W_SMEM, s>>>(
      xmap, gmap, dst, q, blocks, per_range, cin, kout);
  err = cudaGetLastError();
  if (err != cudaSuccess || ranges == 1) return err;
  const long long count = static_cast<long long>(POS) * cin * kout;
  winograd_dw_reduce<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                       s>>>(static_cast<const float*>(partial), ranges, count,
                            static_cast<float*>(du));
  return cudaGetLastError();
}

}  // extern "C"
