// The fused stride-1 identity bottleneck of ResNet-50 for Hopper (sm_90a):
// forward (B6f) and recompute-from-x backward (B6b), bf16 operands on the
// tensor cores (mma.sync m16n8k16) with float32 accumulation.
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
// bf16. The Pallas kernel tiles whole images and keeps every weight in VMEM;
// here a block has 227 KB of shared memory, and the bf16 weights of one
// block are 136 KB at C = 64 and 8.7 MB at C = 512, so the weights stream
// from L2 in 64-deep chunks (cp.async, two stages) and only the C-wide
// intermediates stay in shared memory.
//
// Tiles. A tile is R = M / W consecutive image rows of the (N*H, W) row
// space (M = 8192 / C pixels: 128 at C = 64, 16 at C = 512), so a tile may
// span images. 8 warps each own 16 pixels x 64 channels of the tile's
// M x C accumulators (C / 64 warps across, 8 / (C / 64) down); F-wide
// products run in C-wide column chunks with the same warp tiling.
//  * a1 is computed on the tile's rows plus one image row above and below
//    (the halo, (R + 2) W pixels, in passes of M) into shared memory. The
//    3x3 gather reads a1 at a neighbour only where the neighbour lies in the
//    same image; elsewhere it reads a zero row. So SAME pads a1 with zeros,
//    never with relu(B1), and a halo row of another image is never read.
//  * B6f, bottleneck_fwd_kernel, per tile: conv1 on the halo -> a1 (shared),
//    conv2 by 9 gathered taps -> a2 (shared), conv3 in 4 column chunks with
//    the affine, residual and ReLU in the epilogue -> out. x is read once
//    (plus the halo rows) and out written once; nothing else leaves the SM.
//  * B6b runs in five steps. bottleneck_bwd_a_kernel, per tile, recomputes
//    a1 and y2 (kept in registers) and a2, then y3 chunk by chunk: u3 =
//    g [pre3 > 0] (written to dx, exact in bf16), dA3/dB3, dy3, and da2 +=
//    dy3 w3^T; then u2, dA2/dB2 and dy2. bottleneck_bwd_b_kernel, per tile:
//    da1 = conv3x3^T(dy2) from dy2 with its halo, y1 recomputed, u1,
//    dA1/dB1, dy1, and dx = bf16(dy1 w1^T + u3). The weight gradients are
//    split-K products over pixels (bottleneck_wgrad_kernel: dw3 = dy3^T a2,
//    dw2 = dy2^T shift(a1) for each of 9 taps, dw1 = dy1^T x). For that,
//    the backward writes five bf16 scratch tensors: a1, a2, dy2, dy1 (C
//    wide) and dy3 (F wide). The Pallas body sums the weight gradients into
//    VMEM blocks revisited over an in-order grid; on the card a partial
//    weight gradient per block would be 17.8 MB at C = 512 (2.35 GB for one
//    per SM). The scratch is 4F bytes a pixel instead, twice x's bytes
//    (1.07 GB at layer1, 134 MB at layer4, at 1,024 images).
//  * Cross-block sums have no atomics: the tile kernels keep their affine
//    sums in shared memory over their (persistent) tiles and write one
//    partial per block; the weight gradients one partial per pixel range.
//    Second kernels add the partials in a fixed order, so every result is
//    the same from run to run.
//
// What bounds it on the H100: at 1,024 images a block's forward is 146
// GFLOP (34.4 + 77.3 + 34.4) and its backward 438 GFLOP; at 989 TFLOP/s
// bf16 that is 0.148 and 0.443 ms, above the bytes of x, out, g and dx
// except at layer1 (537 MB of x: 0.321 and 0.481 ms) and for B6f at
// layer2 (0.160 ms). This design does
// more: conv1 on the halo, weight chunks re-read from L2 for every tile of
// 16-128 pixels, mma.sync rather than wgmma, one 256-thread block an SM,
// and the backward's scratch traffic.
//
// Shared-memory rows are XOR-swizzled in 16-byte chunks (chunk ^ row % 8),
// so ldmatrix reads 8 rows without bank conflicts.

#include "mma.cuh"

namespace {

using simclr::cp_async16;
using simclr::cp_async_commit;
using simclr::cp_async_wait;
using simclr::ldsm_x4;
using simclr::ldsm_x4_t;
using simclr::mma_bf16;
using simclr::smem_addr;

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;        // 8 warps
constexpr int TILE_ELEMS = 8192;    // pixels x C of a tile
constexpr int KC = 64;              // reduction depth of one stage
constexpr int WG_THREADS = 128;     // weight-gradient kernel: 4 warps
constexpr int WG_T = 64;            // its 64 x 64 tile, 64 pixels a step
constexpr int WG_SMEM = 2 * 2 * WG_T * 128;
constexpr int WG_TARGET_BLOCKS = 264;
constexpr int WG_MAX_CHUNKS = 128;

// Launch geometry, the same for every kernel of one call.
struct Geo {
  int h, w;
  int rows;    // n * h image rows
  int r;       // image rows a tile: M / w
  int mt;      // output pixels a tile: r * w
  int mh;      // halo pixels: (r + 2) * w
  int tiles;   // ceil(rows / r)
};

__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int row_bytes,
                                        int chunk) {
  return base + row * row_bytes + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ float relu_affine(float y, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(y, a), b), 0.f);
}

__device__ __forceinline__ float pre_affine(float y, float a, float b) {
  return __fadd_rn(__fmul_rn(y, a), b);
}

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One output pixel of a tile: its index (-1 if the tile row is past the
// end or i >= mt), its row in the tile, column, and row in its image.
struct OutPx {
  int p, li, col, y;
};

__device__ __forceinline__ OutPx out_px(const Geo& g, int r0, int i) {
  const int li = i / g.w, col = i - li * g.w, gr = r0 + li;
  if (i >= g.mt || gr >= g.rows) return {-1, li, col, 0};
  return {gr * g.w + col, li, col, gr % g.h};
}

// The global pixel of halo index j (row j / w - 1 of the tile), or -1.
__device__ __forceinline__ int halo_px(const Geo& g, int r0, int j) {
  if (j >= g.mh) return -1;
  const int hl = j / g.w, gr = r0 + hl - 1;
  if (gr < 0 || gr >= g.rows) return -1;
  return gr * g.w + (j - hl * g.w);
}

// The halo row that output pixel o reads for tap (ky, kx), or -1 (zero
// padding) where the neighbour is outside o's image.
__device__ __forceinline__ int gather_row(const Geo& g, const OutPx& o,
                                          int tap) {
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int yy = o.y + dy, xx = o.col + dx;
  if (o.p < 0 || yy < 0 || yy >= g.h || xx < 0 || xx >= g.w) return -1;
  return (o.li + dy + 1) * g.w + xx;
}

// Shared memory of the tile kernels, carved from the dynamic allocation.
template <int CW>
struct Smem {
  static constexpr int C = 64 * CW, F = 4 * C, M = 128 / CW, WM = 8 / CW;
  uint32_t halo;   // mh rows x C bf16: a1 (or dy2); later dy3 / dy1 tiles
  uint32_t act;    // M rows x C bf16: a2
  uint32_t zero;   // one row of C zeros
  uint32_t ast;    // 2 stages x M rows x 64 bf16 (A operand from global)
  uint32_t bst;    // 2 stages x C rows x 64 bf16 (weight chunk)
  float* red;      // 2 x WM x C float: column sums across warps
  float* blk;      // the block's affine-gradient sums (2F + 2C floats)

  static __host__ __device__ int halo_bytes(int mh) {
    return (mh * C * 2 + 127) / 128 * 128;
  }
  static __host__ __device__ int bytes(int mh) {
    return halo_bytes(mh) + M * C * 2 + C * 2 + 2 * M * 128 + 2 * C * 128 +
           2 * WM * C * 4 + (2 * F + 2 * C) * 4;
  }
  __device__ Smem(unsigned char* base, int mh) {
    uint32_t a = smem_addr(base);
    int off = 0;
    halo = a + off;
    off += halo_bytes(mh);
    act = a + off;
    off += M * C * 2;
    zero = a + off;
    off += C * 2;
    ast = a + off;
    off += 2 * M * 128;
    bst = a + off;
    off += 2 * C * 128;
    red = reinterpret_cast<float*>(base + off);
    off += 2 * WM * C * 4;
    blk = reinterpret_cast<float*>(base + off);
  }
};

__device__ __forceinline__ void st_shared_bf16x2(uint32_t addr, float a,
                                                 float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<uint32_t*>(&v)));
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// acc (this warp's 16 x 64 of the tile's M x C) += A (M x 64 steps) * B^T,
// where B is C rows of a row-major weight matrix with row stride ldb
// starting at b, read 64 columns a step. stage_a(step, buf) issues the
// cp.async copies of A's step into its stage buffer, if A comes from
// global memory; addr_a(step, buf, ks) is this lane's ldmatrix address for
// the 16-deep slice ks of the step (rows lane % 16, chunk lane / 16).
template <int CW, typename StageA, typename AddrA>
__device__ __forceinline__ void gemm(float (&acc)[8][4], int steps,
                                     const bf16* b, int ldb,
                                     const Smem<CW>& s, StageA stage_a,
                                     AddrA addr_a) {
  constexpr int C = Smem<CW>::C;
  const int tid = threadIdx.x, lane = tid & 31, wn = (tid >> 5) % CW;
  auto stage = [&](int st) {
    stage_a(st, st & 1);
    const uint32_t dst = s.bst + (st & 1) * C * 128;
    const bf16* src = b + st * KC;
    for (int i = tid; i < C * 8; i += THREADS) {
      const int row = i >> 3, q = i & 7;
      cp_async16(swz(dst, row, 128, q),
                 src + static_cast<long long>(row) * ldb + q * 8, true);
    }
  };
  stage(0);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) stage(st + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t bbuf = s.bst + (st & 1) * C * 128;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(addr_a(st, st & 1, ks), a);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bq[4];
        const int row = wn * 64 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(swz(bbuf, row, 128, ks * 2 + ((lane >> 3) & 1)), bq);
        mma_bf16(acc[2 * nj], a, bq[0], bq[1]);
        mma_bf16(acc[2 * nj + 1], a, bq[2], bq[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// A from global memory: this thread copies chunk tid % 8 of tile rows
// tid / 8 + 32 k; px[k] is that row's pixel (or -1 for zeros), src the
// row-major [pixel][ld] operand.
template <int CW>
struct GlobalA {
  static constexpr int M = Smem<CW>::M;
  static constexpr int ROWS = (M * 8 + THREADS - 1) / THREADS;
  const bf16* src;
  int ld;
  int px[ROWS];
  uint32_t ast;

  __device__ void operator()(int st, int buf) const {
    const int tid = threadIdx.x, q = tid & 7;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int row = (tid >> 3) + 32 * k;
      if (row < M) {
        const bool ok = px[k] >= 0;
        const bf16* p =
            ok ? src + static_cast<long long>(px[k]) * ld + st * KC + q * 8
               : src;
        cp_async16(swz(ast + buf * M * 128, row, 128, q), p, ok);
      }
    }
  }
};

template <int CW>
__device__ __forceinline__ uint32_t staged_a_addr(uint32_t ast, int buf,
                                                  int ks) {
  constexpr int M = Smem<CW>::M;
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) / CW;
  return swz(ast + buf * M * 128, wm * 16 + (lane & 15), 128,
             ks * 2 + (lane >> 4));
}

// ldmatrix address of this lane's row of a C-wide shared tile (row-major,
// 64-deep step st, slice ks).
template <int CW>
__device__ __forceinline__ uint32_t rows_a_addr(uint32_t base, int st,
                                                int ks) {
  constexpr int C = Smem<CW>::C;
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) / CW;
  return swz(base, wm * 16 + (lane & 15), C * 2,
             st * 8 + ks * 2 + (lane >> 4));
}

// conv3x3 over the halo tile (a1, or dy2 with the rotated filter): step st
// is tap st / CW, channels 64 (st % CW) on.
template <int CW>
__device__ __forceinline__ void conv3x3_tile(float (&acc)[8][4],
                                             const bf16* w2, const Geo& g,
                                             int r0, const Smem<CW>& s) {
  constexpr int C = Smem<CW>::C;
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) / CW;
  const OutPx o = out_px(g, r0, wm * 16 + (lane & 15));
  zero_acc(acc);
  gemm<CW>(acc, 9 * CW, w2, 9 * C, s,
           [](int, int) {},
           [&](int st, int, int ks) {
             const int hj = gather_row(g, o, st / CW);
             const int chunk = (st % CW) * 8 + ks * 2 + (lane >> 4);
             return hj < 0 ? s.zero + (chunk << 4)
                           : swz(s.halo, hj, C * 2, chunk);
           });
}

// Column sums of this thread's fragment (over its two rows) reduced over
// the tile and added to sums_a / sums_b (shared, C entries each) in a
// fixed order: across the 8 row groups of a warp by shuffles, then across
// the warps of a column block through `red`.
template <int CW>
__device__ __forceinline__ void add_column_sums(float (&va)[8][2],
                                                float (&vb)[8][2],
                                                const Smem<CW>& s,
                                                float* sums_a,
                                                float* sums_b) {
  constexpr int C = Smem<CW>::C, WM = Smem<CW>::WM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / CW, wn = warp % CW;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = va[ni][e], b = vb[ni][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
      }
      if (lane < 4) {
        const int col = wn * 64 + ni * 8 + 2 * lane + e;
        s.red[wm * C + col] = a;
        s.red[(WM + wm) * C + col] = b;
      }
    }
  __syncthreads();
  for (int col = tid; col < C; col += THREADS) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < WM; ++k) {
      a += s.red[k * C + col];
      b += s.red[(WM + k) * C + col];
    }
    sums_a[col] += a;
    sums_b[col] += b;
  }
  __syncthreads();
}

// a1 = bf16(relu(A1 (x w1) + B1)) on the tile's halo rows, into s.halo; with
// a1_out, the tile's own rows also to global memory.
template <int CW>
__device__ __forceinline__ void conv1_halo(const bf16* x, const bf16* w1,
                                           const float* aff, const Geo& g,
                                           int r0, const Smem<CW>& s,
                                           bf16* a1_out) {
  constexpr int C = Smem<CW>::C, F = 4 * C, M = Smem<CW>::M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / CW, wn = warp % CW;
  const float *A1 = aff, *B1 = aff + C;
  for (int base = 0; base < g.mh; base += M) {
    GlobalA<CW> ga;
    ga.src = x;
    ga.ld = F;
    ga.ast = s.ast;
#pragma unroll
    for (int k = 0; k < GlobalA<CW>::ROWS; ++k)
      ga.px[k] = halo_px(g, r0, base + (tid >> 3) + 32 * k);
    float acc[8][4];
    zero_acc(acc);
    gemm<CW>(acc, 4 * CW, w1, F, s, ga,
             [&](int, int buf, int ks) {
               return staged_a_addr<CW>(s.ast, buf, ks);
             });
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int j = base + wm * 16 + (lane >> 2) + 8 * h2;
      if (j >= g.mh) continue;
      const int hl = j / g.w;
      const int p = (hl >= 1 && hl <= g.r) ? halo_px(g, r0, j) : -1;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = wn * 64 + ni * 8 + 2 * (lane & 3);
        const float v0 = relu_affine(acc[ni][2 * h2], A1[col], B1[col]);
        const float v1 =
            relu_affine(acc[ni][2 * h2 + 1], A1[col + 1], B1[col + 1]);
        st_shared_bf16x2(swz(s.halo, j, C * 2, col >> 3) + (col & 7) * 2, v0,
                         v1);
        if (a1_out && p >= 0)
          simclr::store_bf16x2(a1_out + static_cast<long long>(p) * C + col,
                               v0, v1);
      }
    }
  }
}

// y2 = conv3x3(a1) on the tile (left in acc); a2 = bf16(relu(A2 y2 + B2))
// into s.act, and with a2_out to global memory.
template <int CW>
__device__ __forceinline__ void conv2_tile(float (&acc)[8][4],
                                           const bf16* w2, const float* aff,
                                           const Geo& g, int r0,
                                           const Smem<CW>& s, bf16* a2_out) {
  constexpr int C = Smem<CW>::C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / CW, wn = warp % CW;
  const float *A2 = aff + 2 * C, *B2 = aff + 3 * C;
  conv3x3_tile<CW>(acc, w2, g, r0, s);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = wm * 16 + (lane >> 2) + 8 * h2;
    const int p = out_px(g, r0, row).p;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = wn * 64 + ni * 8 + 2 * (lane & 3);
      const float v0 = relu_affine(acc[ni][2 * h2], A2[col], B2[col]);
      const float v1 =
          relu_affine(acc[ni][2 * h2 + 1], A2[col + 1], B2[col + 1]);
      st_shared_bf16x2(swz(s.act, row, C * 2, col >> 3) + (col & 7) * 2, v0,
                       v1);
      if (a2_out && p >= 0)
        simclr::store_bf16x2(a2_out + static_cast<long long>(p) * C + col, v0,
                             v1);
    }
  }
}

template <int CW>
__device__ __forceinline__ void init_block(const Smem<CW>& s, int blk_len) {
  constexpr int C = Smem<CW>::C;
  for (int i = threadIdx.x; i < C / 8; i += THREADS)
    asm volatile("st.shared.v4.b32 [%0], {%1,%1,%1,%1};\n" ::"r"(
                     s.zero + i * 16),
                 "r"(0));
  for (int i = threadIdx.x; i < blk_len; i += THREADS) s.blk[i] = 0.f;
  __syncthreads();
}

// B6f.
template <int CW>
__global__ void __launch_bounds__(THREADS, 1)
bottleneck_fwd_kernel(const bf16* __restrict__ x,
                      const bf16* __restrict__ wp,
                      const float* __restrict__ aff, bf16* __restrict__ out,
                      Geo g) {
  constexpr int C = Smem<CW>::C, F = 4 * C;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<CW> s(smem, g.mh);
  const bf16 *w1 = wp, *w2 = w1 + C * F, *w3 = w2 + 9 * C * C;
  const float *A3 = aff + 4 * C, *B3 = A3 + F;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / CW, wn = warp % CW;
  init_block<CW>(s, 0);
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int r0 = tile * g.r;
    conv1_halo<CW>(x, w1, aff, g, r0, s, nullptr);
    float acc[8][4];
    conv2_tile<CW>(acc, w2, aff, g, r0, s, nullptr);
    for (int j = 0; j < 4; ++j) {
      zero_acc(acc);
      gemm<CW>(acc, CW, w3 + static_cast<long long>(j) * C * C, C, s,
               [](int, int) {},
               [&](int st, int, int ks) {
                 return rows_a_addr<CW>(s.act, st, ks);
               });
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int p = out_px(g, r0, wm * 16 + (lane >> 2) + 8 * h2).p;
        if (p < 0) continue;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int f = j * C + wn * 64 + ni * 8 + 2 * (lane & 3);
          const long long at = static_cast<long long>(p) * F + f;
          const float2 xv = ld_bf16x2(x + at);
          simclr::store_bf16x2(
              out + at,
              fmaxf(__fadd_rn(pre_affine(acc[ni][2 * h2], A3[f], B3[f]),
                              xv.x),
                    0.f),
              fmaxf(__fadd_rn(pre_affine(acc[ni][2 * h2 + 1], A3[f + 1],
                                         B3[f + 1]),
                              xv.y),
                    0.f));
        }
      }
    }
  }
}

// B6b, first step (see the note at the top). part: per block, the sums of
// [dA1 | dB1 | dA2 | dB2 | dA3 | dB3]; this kernel writes all but dA1/dB1.
template <int CW>
__global__ void __launch_bounds__(THREADS, 1)
bottleneck_bwd_a_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ gy,
                        const bf16* __restrict__ wp,
                        const float* __restrict__ aff, bf16* __restrict__ dx,
                        bf16* __restrict__ a1_out, bf16* __restrict__ a2_out,
                        bf16* __restrict__ dy2_out,
                        bf16* __restrict__ dy3_out, float* __restrict__ part,
                        Geo g) {
  constexpr int C = Smem<CW>::C, F = 4 * C;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<CW> s(smem, g.mh);
  const bf16 *w1 = wp, *w2 = w1 + C * F, *w3 = w2 + 9 * C * C;
  const bf16* w3t = w3 + F * C + F * C + 9 * C * C;   // (C, F)
  const float *A2 = aff + 2 * C, *B2 = aff + 3 * C;
  const float *A3 = aff + 4 * C, *B3 = A3 + F;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / CW, wn = warp % CW;
  // s.blk: [dA3 (F) | dB3 (F) | dA2 (C) | dB2 (C)]
  init_block<CW>(s, 2 * F + 2 * C);
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int r0 = tile * g.r;
    conv1_halo<CW>(x, w1, aff, g, r0, s, a1_out);
    float y2[8][4];
    conv2_tile<CW>(y2, w2, aff, g, r0, s, a2_out);
    float da2[8][4];
    zero_acc(da2);
    for (int j = 0; j < 4; ++j) {
      float acc[8][4];
      zero_acc(acc);
      gemm<CW>(acc, CW, w3 + static_cast<long long>(j) * C * C, C, s,
               [](int, int) {},
               [&](int st, int, int ks) {
                 return rows_a_addr<CW>(s.act, st, ks);
               });
      float sa[8][2] = {}, sb[8][2] = {};
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = wm * 16 + (lane >> 2) + 8 * h2;
        const int p = out_px(g, r0, row).p;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int col = wn * 64 + ni * 8 + 2 * (lane & 3), f = j * C + col;
          float u[2] = {0.f, 0.f};
          const long long at = static_cast<long long>(p) * F + f;
          if (p >= 0) {
            const float2 xv = ld_bf16x2(x + at), gv = ld_bf16x2(gy + at);
            const float xs[2] = {xv.x, xv.y}, gs[2] = {gv.x, gv.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pre = __fadd_rn(
                  pre_affine(acc[ni][2 * h2 + e], A3[f + e], B3[f + e]),
                  xs[e]);
              u[e] = pre > 0.f ? gs[e] : 0.f;
              sa[ni][e] += u[e] * acc[ni][2 * h2 + e];
              sb[ni][e] += u[e];
            }
          }
          const float d0 = __fmul_rn(u[0], A3[f]);
          const float d1 = __fmul_rn(u[1], A3[f + 1]);
          st_shared_bf16x2(swz(s.halo, row, C * 2, col >> 3) + (col & 7) * 2,
                           d0, d1);
          if (p >= 0) {
            simclr::store_bf16x2(dx + at, u[0], u[1]);
            simclr::store_bf16x2(dy3_out + at, d0, d1);
          }
        }
      }
      add_column_sums<CW>(sa, sb, s, s.blk + j * C, s.blk + F + j * C);
      gemm<CW>(da2, CW, w3t + j * C, F, s, [](int, int) {},
               [&](int st, int, int ks) {
                 return rows_a_addr<CW>(s.halo, st, ks);
               });
    }
    float sa[8][2] = {}, sb[8][2] = {};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int p = out_px(g, r0, wm * 16 + (lane >> 2) + 8 * h2).p;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = wn * 64 + ni * 8 + 2 * (lane & 3);
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = y2[ni][2 * h2 + e];
          const float u =
              (p >= 0 && pre_affine(y, A2[col + e], B2[col + e]) > 0.f)
                  ? da2[ni][2 * h2 + e]
                  : 0.f;
          sa[ni][e] += u * y;
          sb[ni][e] += u;
          d[e] = __fmul_rn(u, A2[col + e]);
        }
        if (p >= 0)
          simclr::store_bf16x2(dy2_out + static_cast<long long>(p) * C + col,
                               d[0], d[1]);
      }
    }
    add_column_sums<CW>(sa, sb, s, s.blk + 2 * F, s.blk + 2 * F + C);
  }
  float* mine = part + static_cast<long long>(blockIdx.x) * (4 * C + 2 * F);
  for (int i = threadIdx.x; i < 2 * C; i += THREADS)
    mine[2 * C + i] = s.blk[2 * F + i];
  for (int i = threadIdx.x; i < 2 * F; i += THREADS)
    mine[4 * C + i] = s.blk[i];
}

// B6b, second step: da1 = conv3x3^T(dy2), y1, u1, dA1/dB1, dy1, and
// dx = bf16(dy1 w1^T + u3) with u3 read from dx.
template <int CW>
__global__ void __launch_bounds__(THREADS, 1)
bottleneck_bwd_b_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ wp,
                        const float* __restrict__ aff, bf16* __restrict__ dx,
                        const bf16* __restrict__ dy2,
                        bf16* __restrict__ dy1_out, float* __restrict__ part,
                        Geo g) {
  constexpr int C = Smem<CW>::C, F = 4 * C;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<CW> s(smem, g.mh);
  const bf16* w1 = wp;
  const bf16* w1t = wp + C * F + 9 * C * C + F * C;     // (F, C)
  const bf16* w2r = w1t + F * C;                        // (C, 9C)
  const float *A1 = aff, *B1 = aff + C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / CW, wn = warp % CW;
  init_block<CW>(s, 2 * C);   // [dA1 | dB1]
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int r0 = tile * g.r;
    // dy2 on the halo rows (zeros outside the batch) into s.halo.
    for (int i = tid; i < g.mh * (C / 8); i += THREADS) {
      const int j = i / (C / 8), q = i % (C / 8);
      const int p = halo_px(g, r0, j);
      cp_async16(swz(s.halo, j, C * 2, q),
                 p >= 0 ? dy2 + static_cast<long long>(p) * C + q * 8 : dy2,
                 p >= 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float da1[8][4];
    conv3x3_tile<CW>(da1, w2r, g, r0, s);
    GlobalA<CW> ga;
    ga.src = x;
    ga.ld = F;
    ga.ast = s.ast;
#pragma unroll
    for (int k = 0; k < GlobalA<CW>::ROWS; ++k)
      ga.px[k] = out_px(g, r0, (tid >> 3) + 32 * k).p;
    float y1[8][4];
    zero_acc(y1);
    gemm<CW>(y1, 4 * CW, w1, F, s, ga, [&](int, int buf, int ks) {
      return staged_a_addr<CW>(s.ast, buf, ks);
    });
    float sa[8][2] = {}, sb[8][2] = {};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = wm * 16 + (lane >> 2) + 8 * h2;
      const int p = out_px(g, r0, row).p;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = wn * 64 + ni * 8 + 2 * (lane & 3);
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = y1[ni][2 * h2 + e];
          const float u =
              (p >= 0 && pre_affine(y, A1[col + e], B1[col + e]) > 0.f)
                  ? da1[ni][2 * h2 + e]
                  : 0.f;
          sa[ni][e] += u * y;
          sb[ni][e] += u;
          d[e] = __fmul_rn(u, A1[col + e]);
        }
        st_shared_bf16x2(swz(s.halo, row, C * 2, col >> 3) + (col & 7) * 2,
                         d[0], d[1]);
        if (p >= 0)
          simclr::store_bf16x2(dy1_out + static_cast<long long>(p) * C + col,
                               d[0], d[1]);
      }
    }
    add_column_sums<CW>(sa, sb, s, s.blk, s.blk + C);
    for (int j = 0; j < 4; ++j) {
      float acc[8][4];
      zero_acc(acc);
      gemm<CW>(acc, CW, w1t + static_cast<long long>(j) * C * C, C, s,
               [](int, int) {},
               [&](int st, int, int ks) {
                 return rows_a_addr<CW>(s.halo, st, ks);
               });
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int p = out_px(g, r0, wm * 16 + (lane >> 2) + 8 * h2).p;
        if (p < 0) continue;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int f = j * C + wn * 64 + ni * 8 + 2 * (lane & 3);
          const long long at = static_cast<long long>(p) * F + f;
          const float2 u3 = ld_bf16x2(dx + at);
          simclr::store_bf16x2(dx + at, __fadd_rn(acc[ni][2 * h2], u3.x),
                               __fadd_rn(acc[ni][2 * h2 + 1], u3.y));
        }
      }
    }
  }
  float* mine = part + static_cast<long long>(blockIdx.x) * (4 * C + 2 * F);
  for (int i = threadIdx.x; i < 2 * C; i += THREADS) mine[i] = s.blk[i];
}

// Weight gradient over one pixel range: partial[chunk][tap][m][n] =
// sum over pixels p of the range of a[p][m] * b[p shifted by tap][n], for
// the 64 x 64 output tile blockIdx.x (tap 3 ky + kx shifts by (ky - 1,
// kx - 1) within the image when taps == 9; zero outside it).
__global__ void __launch_bounds__(WG_THREADS)
bottleneck_wgrad_kernel(const bf16* __restrict__ a, int lda,
                        const bf16* __restrict__ b, int ldb,
                        float* __restrict__ partial, int mtot, int ntot,
                        int taps, int pixels, int h, int w, int per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;   // 32 x 32 a warp
  const int tiles_n = ntot / WG_T;
  const int m0 = (blockIdx.x / tiles_n) * WG_T;
  const int n0 = (blockIdx.x % tiles_n) * WG_T;
  const int tap = blockIdx.z;
  const int dy = taps == 9 ? tap / 3 - 1 : 0, dx = taps == 9 ? tap % 3 - 1 : 0;
  const int begin = blockIdx.y * per_chunk;
  const int end = begin + per_chunk < pixels ? begin + per_chunk : pixels;
  const int steps = end > begin ? (end - begin + WG_T - 1) / WG_T : 0;

  // This thread copies chunk tid % 8 of pixel rows tid / 8 + 16 k of both
  // tiles (a at 0, b at WG_T rows) of a stage.
  auto load = [&](int st) {
    const uint32_t buf = base + (st & 1) * 2 * WG_T * 128;
    const int q = tid & 7;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = (tid >> 3) + 16 * k, p = begin + st * WG_T + r;
      const bool ok = p < end;
      cp_async16(swz(buf, r, 128, q),
                 ok ? a + static_cast<long long>(p) * lda + m0 + q * 8 : a,
                 ok);
      bool okb = ok;
      long long pb = p;
      if (ok && taps == 9) {
        const int yy = (p / w) % h + dy, xx = p % w + dx;
        okb = yy >= 0 && yy < h && xx >= 0 && xx < w;
        pb = p + dy * w + dx;
      }
      cp_async16(swz(buf, WG_T + r, 128, q),
                 okb ? b + pb * ldb + n0 + q * 8 : b, okb);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (steps > 0) load(0);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) load(st + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t at = base + (st & 1) * 2 * WG_T * 128;
    const uint32_t bt = at + WG_T * 128;
#pragma unroll
    for (int ks = 0; ks < WG_T / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_t(swz(at, ks * 16 + ((lane >> 4) << 3) + (lane & 7), 128,
                      wm * 4 + mi * 2 + ((lane >> 3) & 1)),
                  af[mi]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t bq[4];
        ldsm_x4_t(swz(bt, ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), 128,
                      wn * 4 + nj * 2 + (lane >> 4)),
                  bq);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], af[mi], bq[0], bq[1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float* out = partial + (static_cast<long long>(blockIdx.y) * taps + tap) *
                             mtot * ntot;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + mi * 16 + (lane >> 2) + half * 8;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(out + static_cast<long long>(m) * ntot +
                                   n) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

// out[(m * ntot + n) * taps + tap] = sum over chunks, in order, of
// partial[chunk][tap][m][n].
__global__ void __launch_bounds__(256)
bottleneck_wgrad_reduce(const float* __restrict__ partial, int chunks,
                        int taps, int mtot, int ntot,
                        float* __restrict__ out) {
  const long long total = static_cast<long long>(taps) * mtot * ntot;
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= total) return;
  float acc = 0.f;
  for (int k = 0; k < chunks; ++k) acc += partial[k * total + j];
  const long long mn = static_cast<long long>(mtot) * ntot;
  const int tap = static_cast<int>(j / mn);
  out[(j % mn) * taps + tap] = acc;
}

// out[j] = sum over blocks, in order, of part[block][j].
__global__ void __launch_bounds__(256)
bottleneck_affine_reduce(const float* __restrict__ part, int blocks,
                         int cols, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  float acc = 0.f;
  for (int k = 0; k < blocks; ++k)
    acc += part[static_cast<long long>(k) * cols + j];
  out[j] = acc;
}

bool make_geo(int n, int h, int w, int c, Geo* g) {
  if (n < 1 || h < 1 || w < 1 || (c != 64 && c != 128 && c != 256 &&
                                  c != 512))
    return false;
  const int m = TILE_ELEMS / c;
  if (w > m || static_cast<long long>(n) * h * w * 4 * c >= (1LL << 31))
    return false;
  g->h = h;
  g->w = w;
  g->rows = n * h;
  g->r = m / w;
  g->mt = g->r * w;
  g->mh = (g->r + 2) * w;
  g->tiles = (g->rows + g->r - 1) / g->r;
  return true;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

long long align256(long long b) { return (b + 255) / 256 * 256; }

// Weight-gradient problems: (mtot, ntot, taps) -> pixel ranges.
struct Wgrad {
  int mtot, ntot, taps, chunks, per;
};

Wgrad plan_wgrad(int mtot, int ntot, int taps, int pixels) {
  const int tiles = (mtot / WG_T) * (ntot / WG_T) * taps;
  int chunks = (WG_TARGET_BLOCKS + tiles - 1) / tiles;
  const int max_chunks = (pixels + WG_T - 1) / WG_T;
  if (chunks > WG_MAX_CHUNKS) chunks = WG_MAX_CHUNKS;
  if (chunks > max_chunks) chunks = max_chunks;
  int per = (pixels + chunks - 1) / chunks;
  per = (per + WG_T - 1) / WG_T * WG_T;
  return {mtot, ntot, taps, (pixels + per - 1) / per, per};
}

long long wgrad_bytes(const Wgrad& p) {
  return static_cast<long long>(p.chunks) * p.taps * p.mtot * p.ntot * 4;
}

// Scratch of one backward call: a1, a2, dy2, dy1 (C wide), dy3 (F wide),
// the per-block affine sums and the largest weight-gradient partial.
struct Work {
  long long a1, a2, dy2, dy1, dy3, part, wpart, total;
};

Work plan_work(const Geo& g, int c, int sms) {
  const long long px = static_cast<long long>(g.rows) * g.w;
  const int pixels = static_cast<int>(px);
  Work k;
  long long off = 0;
  k.a1 = off;
  off += align256(px * c * 2);
  k.a2 = off;
  off += align256(px * c * 2);
  k.dy2 = off;
  off += align256(px * c * 2);
  k.dy1 = off;
  off += align256(px * c * 2);
  k.dy3 = off;
  off += align256(px * 4 * c * 2);
  k.part = off;
  off += align256(static_cast<long long>(sms) * 12 * c * 4);
  k.wpart = off;
  long long wp = wgrad_bytes(plan_wgrad(4 * c, c, 1, pixels));
  const long long w2 = wgrad_bytes(plan_wgrad(c, c, 9, pixels));
  const long long w1 = wgrad_bytes(plan_wgrad(c, 4 * c, 1, pixels));
  if (w2 > wp) wp = w2;
  if (w1 > wp) wp = w1;
  off += align256(wp);
  k.total = off;
  return k;
}

cudaError_t run_wgrad(const bf16* a, int lda, const bf16* b, int ldb,
                      float* partial, float* out, const Wgrad& p,
                      const Geo& g, cudaStream_t s) {
  const dim3 grid((p.mtot / WG_T) * (p.ntot / WG_T), p.chunks, p.taps);
  bottleneck_wgrad_kernel<<<grid, WG_THREADS, WG_SMEM, s>>>(
      a, lda, b, ldb, partial, p.mtot, p.ntot, p.taps, g.rows * g.w, g.h,
      g.w, p.per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(p.taps) * p.mtot * p.ntot;
  bottleneck_wgrad_reduce<<<static_cast<int>((total + 255) / 256), 256, 0,
                            s>>>(partial, p.chunks, p.taps, p.mtot, p.ntot,
                                 out);
  return cudaGetLastError();
}

template <int CW>
struct Opt {
  static simclr::SmemOptIn fwd, bwd_a, bwd_b;
};
template <int CW>
simclr::SmemOptIn Opt<CW>::fwd;
template <int CW>
simclr::SmemOptIn Opt<CW>::bwd_a;
template <int CW>
simclr::SmemOptIn Opt<CW>::bwd_b;

// Dynamic shared memory for the largest halo a kernel may be launched
// with (W = M), so that the once-per-device opt-in covers every call.
template <int CW>
int max_smem() {
  constexpr int M = Smem<CW>::M;
  return Smem<CW>::bytes(3 * M);
}

int grid_for(const Geo& g) {
  const int sms = sm_count();
  if (sms <= 0) return -1;
  return g.tiles < sms ? g.tiles : sms;
}

template <int CW>
int fwd_impl(const void* x, const void* wp, const void* aff, void* out,
             const Geo& g, cudaStream_t s) {
  cudaError_t err = Opt<CW>::fwd(bottleneck_fwd_kernel<CW>, max_smem<CW>());
  if (err != cudaSuccess) return err;
  const int grid = grid_for(g);
  if (grid < 0) return cudaErrorUnknown;
  bottleneck_fwd_kernel<CW><<<grid, THREADS, Smem<CW>::bytes(g.mh), s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wp),
      static_cast<const float*>(aff), static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

template <int CW>
int bwd_impl(const void* x, const void* gy, const void* wp, const void* aff,
             void* work, void* dx, void* dw1, void* dw2, void* dw3,
             void* daff, const Geo& g, cudaStream_t s) {
  constexpr int C = Smem<CW>::C, F = 4 * C;
  cudaError_t err = Opt<CW>::bwd_a(bottleneck_bwd_a_kernel<CW>,
                                   max_smem<CW>());
  if (err != cudaSuccess) return err;
  err = Opt<CW>::bwd_b(bottleneck_bwd_b_kernel<CW>, max_smem<CW>());
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorUnknown;
  const int grid = g.tiles < sms ? g.tiles : sms;
  const Work k = plan_work(g, C, sms);
  unsigned char* base = static_cast<unsigned char*>(work);
  bf16* a1 = reinterpret_cast<bf16*>(base + k.a1);
  bf16* a2 = reinterpret_cast<bf16*>(base + k.a2);
  bf16* dy2 = reinterpret_cast<bf16*>(base + k.dy2);
  bf16* dy1 = reinterpret_cast<bf16*>(base + k.dy1);
  bf16* dy3 = reinterpret_cast<bf16*>(base + k.dy3);
  float* part = reinterpret_cast<float*>(base + k.part);
  float* wpart = reinterpret_cast<float*>(base + k.wpart);
  const int smem = Smem<CW>::bytes(g.mh);
  const int pixels = g.rows * g.w;

  bottleneck_bwd_a_kernel<CW><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gy),
      static_cast<const bf16*>(wp), static_cast<const float*>(aff),
      static_cast<bf16*>(dx), a1, a2, dy2, dy3, part, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = run_wgrad(dy3, F, a2, C, wpart, static_cast<float*>(dw3),
                  plan_wgrad(F, C, 1, pixels), g, s);
  if (err != cudaSuccess) return err;
  err = run_wgrad(dy2, C, a1, C, wpart, static_cast<float*>(dw2),
                  plan_wgrad(C, C, 9, pixels), g, s);
  if (err != cudaSuccess) return err;
  bottleneck_bwd_b_kernel<CW><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wp),
      static_cast<const float*>(aff), static_cast<bf16*>(dx), dy2, dy1,
      part, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = run_wgrad(dy1, C, static_cast<const bf16*>(x), F, wpart,
                  static_cast<float*>(dw1), plan_wgrad(C, F, 1, pixels), g,
                  s);
  if (err != cudaSuccess) return err;
  bottleneck_affine_reduce<<<(4 * C + 2 * F + 255) / 256, 256, 0, s>>>(
      part, grid, 4 * C + 2 * F, static_cast<float*>(daff));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch bottleneck_bwd needs for x of n x h x w pixels at width
// c (0 for a shape the kernels do not take).
long long bottleneck_bwd_workspace(int n, int h, int w, int c) {
  Geo g;
  const int sms = sm_count();
  if (!make_geo(n, h, w, c, &g) || sms <= 0) return 0;
  return plan_work(g, c, sms).total;
}

// out = the block of x (NHWC bf16, 4c channels); wp = [w1 (c, 4c), w2
// (c, 9c) as [co][tap][ci], w3 (4c, c)] bf16; aff = [A1 B1 A2 B2 (c each)
// A3 B3 (4c each)] float32.
int bottleneck_fwd(const void* x, const void* wp, const void* aff, void* out,
                   int n, int h, int w, int c, void* stream) {
  Geo g;
  if (!make_geo(n, h, w, c, &g)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 64: return fwd_impl<1>(x, wp, aff, out, g, s);
    case 128: return fwd_impl<2>(x, wp, aff, out, g, s);
    case 256: return fwd_impl<4>(x, wp, aff, out, g, s);
    default: return fwd_impl<8>(x, wp, aff, out, g, s);
  }
}

// The backward for the cotangent gy (NHWC bf16). wp as for the forward,
// followed by [w1^T (4c, c), the rotated w2 likewise, w3^T (c, 4c)]. Writes
// dx (bf16), dw1 (c, 4c), dw2 (c, c, 3, 3), dw3 (4c, c) and daff (laid out
// as aff), all float32 but dx. work: bottleneck_bwd_workspace bytes.
int bottleneck_bwd(const void* x, const void* gy, const void* wp,
                   const void* aff, void* work, void* dx, void* dw1,
                   void* dw2, void* dw3, void* daff, int n, int h, int w,
                   int c, void* stream) {
  Geo g;
  if (!make_geo(n, h, w, c, &g)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 64:
      return bwd_impl<1>(x, gy, wp, aff, work, dx, dw1, dw2, dw3, daff, g, s);
    case 128:
      return bwd_impl<2>(x, gy, wp, aff, work, dx, dw1, dw2, dw3, daff, g, s);
    case 256:
      return bwd_impl<4>(x, gy, wp, aff, work, dx, dw1, dw2, dw3, daff, g, s);
    default:
      return bwd_impl<8>(x, gy, wp, aff, work, dx, dw1, dw2, dw3, daff, g, s);
  }
}

}  // extern "C"
