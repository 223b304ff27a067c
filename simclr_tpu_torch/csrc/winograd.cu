// Winograd F(2x2, 3x3) convolution (stride 1, SAME) for Hopper (sm_90a):
// the transforms in float32 registers, the 16 per-position products on
// the tensor cores (bf16 x bf16 -> float32, mma.sync).
//
// Replaces simclr_tpu/ops/pallas/winograd.py: _fwd_kernel (B5f, launched
// by the pallas_call in _run_fwd, line 218; also the input gradient, with
// the transform of the filter rotated 180 degrees and in/out swapped) and
// _dw_kernel (B5w, pallas_call in _run_dw, line 238).
//
// Tensors are NHWC bf16 (channels_last in PyTorch); H and W even. A tile
// is one 2x2 block of outputs and reads the 4x4 input patch around it
// (zero outside the image). Tiles are numbered in (n, h/2, w/2) order.
//
// B5f, winograd_fwd_kernel: a block of 16 warps owns 64 tiles and 64
// output channels (grid.y) and loops over the input channels 16 at a
// step, in two stages of shared memory: while one step's products run,
// the next step's slice of the transformed filter U (16 positions x 64 k
// x 16 c, bf16) is on its way by cp.async and each thread's next input
// patch by plain loads; after the products the thread computes that
// patch's V = B^T d B in float32 (two channels), rounds it to bf16 and
// stores it. A warp computes each step's M[pos] = V[pos] U[pos] for 16
// tiles x 16 channels on mma.sync, one column of positions at a time, and
// at once folds it into its float32 Y = A^T M A accumulators (4 per tile
// and channel, not 16), so Y sums each step's transform where JAX sums M
// over all channels first: the same arithmetic in another float32 order.
// The 2x2 outputs are rounded to bf16 once.
//
// B5w, winograd_dw_kernel: dU[pos] = sum over tiles of V[pos]^T dM[pos],
// V from x as above and dM = the adjoint of the output transform applied
// to the 2x2 patches of the cotangent, both rounded to bf16 (as the JAX
// kernel rounds them). A block of 16 warps owns 32 c x 64 k of all 16
// positions (grid.x, grid.y) and one range of tiles (grid.z), 32 tiles a
// step. With more than one
// range each block writes a float32 partial and winograd_dw_reduce sums
// them over the ranges in a fixed order (no atomics: dU is the same from
// run to run). dw = G^T dU G runs outside, in PyTorch, as JAX keeps it
// outside Pallas.
//
// What bounds it on the H100: the 16 products do 2.25x fewer operations
// than the direct 3x3 convolution, 34.4 GFLOP a pass at each of the
// ResNet-50 path's shapes (0.035 ms of bf16 tensor time); layer2's
// [1024, 128, 16, 16] moves 134 MB (0.040 ms, bytes), layer3 and layer4
// less (operations). These simple designs recompute V once for every 64
// output channels and re-read U (B5f) or the cotangent (B5w) once for
// every block of tiles or input channels, from L2, and run mma.sync
// rather than wgmma; they sit well above that bound.
//
// Shared-memory planes hold one position: B5w's 32 rows of 32 bf16 (64
// bytes; chunk c of row r at chunk c ^ ((r / 2) % 4)), B5f's 64 rows of
// 16 bf16 (32 bytes; chunk c ^ ((r / 4) % 2)), so ldmatrix reads 8 rows
// without bank conflicts.

#include "mma.cuh"

namespace {

using simclr::cp_async16;
using simclr::cp_async_commit;
using simclr::cp_async_wait;
using simclr::ldsm_x2_t;
using simclr::ldsm_x4;
using simclr::ldsm_x4_t;
using simclr::mma_bf16;
using simclr::smem_addr;
using simclr::store_bf16x2;

constexpr int POS = 16;               // 4x4 transform positions
constexpr int CH = 32;                // C and K are multiples of this
// B5w's blocking: 32 c x 64 k of all 16 positions a block of 16 warps,
// 32 tiles a step.
constexpr int W_THREADS = 512;
constexpr int W_BT = 32;
constexpr int W_BC = 32;
constexpr int W_BK = 64;
constexpr int W_VPLANE = W_BT * W_BC * 2;    // [tile][c] bf16, 64-byte rows
constexpr int W_DPLANE = W_BT * W_BK * 2;    // [tile][k] bf16, 128-byte rows
constexpr int W_SMEM = POS * (W_VPLANE + W_DPLANE);
constexpr int DW_TARGET_BLOCKS = 264;   // 2 waves over 132 SMs

// 64-byte rows: chunk c of row r at chunk c ^ ((r / 2) % 4).
__device__ __forceinline__ int vswz(int row, int chunk) {
  return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// 128-byte rows: chunk c of row r at chunk c ^ (r % 8).
__device__ __forceinline__ int dswz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// Image and tile row/column of tile t. Indices fit in int: the wrappers
// refuse tensors of 2**31 elements or more.
__device__ __forceinline__ void tile_of(int t, int h, int w, int& img,
                                        int& ty, int& tx) {
  const int per = (h / 2) * (w / 2);
  img = t / per;
  const int rem = t - img * per;
  ty = rem / (w / 2);
  tx = rem - ty * (w / 2);
}

// Offset of channel c of pixel (img, y, x) in an NHWC tensor.
__device__ __forceinline__ long long at(int img, int y, int x, int h, int w,
                                        int channels, int c) {
  return static_cast<long long>((img * h + y) * w + x) * channels + c;
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The 4x4 input patch of tile t, channels c and c + 1 (packed bf16x2),
// zero outside the image and for t >= end.
__device__ __forceinline__ void load_patch(const __nv_bfloat16* __restrict__ x,
                                           int t, int end, int c, int cin,
                                           int h, int w,
                                           uint32_t (&d)[4][4]) {
  int img = 0, ty = 0, tx = 0;
  if (t < end) tile_of(t, h, w, img, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hh = 2 * ty - 1 + i, ww = 2 * tx - 1 + j;
      d[i][j] = 0u;
      if (t < end && hh >= 0 && hh < h && ww >= 0 && ww < w)
        d[i][j] = *reinterpret_cast<const uint32_t*>(
            x + at(img, hh, ww, h, w, cin, c));
    }
}

// v[4k + l] = bf16(V[k][l]) of a patch, two channels packed, in float32:
//   h_k = (d0 - d2, d1 + d2, d2 - d1, d1 - d3) over the patch's rows,
//   V[k][l] = the same over the columns of h_k.
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

// s_v[pos][r][c] = bf16(V[pos]) of tile t0 + r, channels c0 + c, for the
// 32 tiles of a B5w step (zero for tiles >= end), two channels a thread.
__device__ __forceinline__ void input_transform(
    const __nv_bfloat16* __restrict__ x, unsigned char* s_v, int t0,
    int end, int c0, int cin, int h, int w, int tid) {
  const int cp = tid & 15, r = tid >> 4;
  uint32_t d[4][4], v[POS];
  load_patch(x, t0 + r, end, c0 + 2 * cp, cin, h, w, d);
  patch_transform(d, v);
  const int off = vswz(r, cp >> 2) + (cp & 3) * 4;
#pragma unroll
  for (int pos = 0; pos < POS; ++pos)
    *reinterpret_cast<uint32_t*>(s_v + pos * W_VPLANE + off) = v[pos];
}

// s_d[pos][r][k] = bf16(dM[pos]) of tile t0 + r, channels k0 + k (zero
// for k >= kout): with adj(a0, a1) = (a0, a0 + a1, a0 - a1, -a1),
// h0 = adj(g00, g10), h1 = adj(g01, g11) and
// dM[4 k4 + l] = adj(h0[k4], h1[k4])[l], where g_ij is the cotangent at
// (2 ty + i, 2 tx + j).
__device__ __forceinline__ void dm_transform(
    const __nv_bfloat16* __restrict__ g, unsigned char* s_d, int t0,
    int end, int k0, int kout, int h, int w, int tid) {
  const int kp = tid & 31;
  for (int r = tid >> 5; r < W_BT; r += W_THREADS / 32) {
    const int t = t0 + r;
    float2 y[2][2] = {{{0.f, 0.f}, {0.f, 0.f}}, {{0.f, 0.f}, {0.f, 0.f}}};
    if (t < end && k0 + 2 * kp < kout) {
      int img, ty, tx;
      tile_of(t, h, w, img, ty, tx);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          y[i][j] = unpack(*reinterpret_cast<const uint32_t*>(
              g + at(img, 2 * ty + i, 2 * tx + j, h, w, kout, k0 + 2 * kp)));
    }
    const float2 h0[4] = {
        y[0][0], make_float2(y[0][0].x + y[1][0].x, y[0][0].y + y[1][0].y),
        make_float2(y[0][0].x - y[1][0].x, y[0][0].y - y[1][0].y),
        make_float2(-y[1][0].x, -y[1][0].y)};
    const float2 h1[4] = {
        y[0][1], make_float2(y[0][1].x + y[1][1].x, y[0][1].y + y[1][1].y),
        make_float2(y[0][1].x - y[1][1].x, y[0][1].y - y[1][1].y),
        make_float2(-y[1][1].x, -y[1][1].y)};
    const int off = dswz(r, kp >> 2) + (kp & 3) * 4;
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      const float2 a = h0[k4], b = h1[k4];
      unsigned char* p = s_d + 4 * k4 * W_DPLANE + off;
      *reinterpret_cast<uint32_t*>(p) = pack(a.x, a.y);
      *reinterpret_cast<uint32_t*>(p + W_DPLANE) =
          pack(a.x + b.x, a.y + b.y);
      *reinterpret_cast<uint32_t*>(p + 2 * W_DPLANE) =
          pack(a.x - b.x, a.y - b.y);
      *reinterpret_cast<uint32_t*>(p + 3 * W_DPLANE) = pack(-b.x, -b.y);
    }
  }
}

// B5f's blocking: 64 tiles x 64 output channels a block of 16 warps,
// input channels 16 a step, two stages of V and U in shared memory.
constexpr int F_THREADS = 512;
constexpr int F_BT = 64;
constexpr int F_BK = 64;
constexpr int F_BC = 16;
constexpr int F_ROWB = F_BC * 2;               // bytes of a row of 16 bf16
constexpr int F_PLANE = 64 * F_ROWB;           // one position's 64 rows
constexpr int F_STAGE = 2 * POS * F_PLANE;     // V, then U
constexpr int F_SMEM = 2 * F_STAGE;

// 32-byte rows: chunk c of row r at chunk c ^ ((r / 4) % 2).
__device__ __forceinline__ int fswz(int row, int chunk) {
  return row * F_ROWB + ((chunk ^ ((row >> 2) & 1)) << 4);
}

__global__ void __launch_bounds__(F_THREADS, 1)
winograd_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ u,  // [16][K][C]
                    __nv_bfloat16* __restrict__ y, int n, int h, int w,
                    int cin, int kout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;   // 16 tiles x 16 k a warp
  const int tiles = n * (h / 2) * (w / 2);
  const int t0 = blockIdx.x * F_BT, k0 = blockIdx.y * F_BK;
  const int steps = cin / F_BC;
  const int cp = tid & 7, r = tid >> 3;      // V of tile t0 + r, 2 channels

  auto copy_u = [&](int s) {
    unsigned char* s_u = smem + (s & 1) * F_STAGE + POS * F_PLANE;
    for (int i = tid; i < POS * F_BK * 2; i += F_THREADS) {
      const int pos = i / (F_BK * 2), row = (i >> 1) % F_BK, ch = i & 1;
      const bool ok = k0 + row < kout;
      cp_async16(smem_addr(s_u + pos * F_PLANE + fswz(row, ch)),
                 ok ? u + (static_cast<long long>(pos) * kout + k0 + row) *
                              cin + s * F_BC + ch * 8
                    : u,
                 ok);
    }
    cp_async_commit();
  };
  auto store_v = [&](int s, const uint32_t (&d)[4][4]) {
    uint32_t v[POS];
    patch_transform(d, v);
    unsigned char* s_v = smem + (s & 1) * F_STAGE;
    const int off = fswz(r, cp >> 2) + (cp & 3) * 4;
#pragma unroll
    for (int pos = 0; pos < POS; ++pos)
      *reinterpret_cast<uint32_t*>(s_v + pos * F_PLANE + off) = v[pos];
  };

  // Y accumulators: [n8 tile][fragment element][2 i + j].
  float yacc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int o = 0; o < 4; ++o) yacc[a][e][o] = 0.f;

  uint32_t d[4][4];
  copy_u(0);
  load_patch(x, t0 + r, tiles, 2 * cp, cin, h, w, d);
  store_v(0, d);
  for (int s = 0; s < steps; ++s) {
    // The next step's filter slice and input patch are in flight while
    // this step's products run.
    const bool more = s + 1 < steps;
    if (more) {
      copy_u(s + 1);
      load_patch(x, t0 + r, tiles, (s + 1) * F_BC + 2 * cp, cin, h, w, d);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* s_v = smem + (s & 1) * F_STAGE;
    const unsigned char* s_u = s_v + POS * F_PLANE;
    // This step's M = V U of column l of the positions, then its part of
    // the output transform: u_i = (m0 + m1 + m2, m1 - m2 - m3) over the
    // rows, added to y_i0 for l < 3 and to y_i1 with sign (0, +, -, -)[l].
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      float m[4][2][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int pos = 4 * k + l;
        uint32_t av[4], bv[4];
        ldsm_x4(smem_addr(s_v + pos * F_PLANE +
                          fswz(wm * 16 + (lane & 15), lane >> 4)),
                av);
        ldsm_x4(smem_addr(s_u + pos * F_PLANE +
                          fswz(wn * 16 + (lane & 7) + ((lane >> 4) << 3),
                               (lane >> 3) & 1)),
                bv);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[k][nt][e] = 0.f;
        mma_bf16(m[k][0], av, bv[0], bv[1]);
        mma_bf16(m[k][1], av, bv[2], bv[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float u0 = m[0][nt][e] + m[1][nt][e] + m[2][nt][e];
          const float u1 = m[1][nt][e] - m[2][nt][e] - m[3][nt][e];
          if (l < 3) {
            yacc[nt][e][0] += u0;
            yacc[nt][e][2] += u1;
          }
          if (l == 1) {
            yacc[nt][e][1] += u0;
            yacc[nt][e][3] += u1;
          }
          if (l >= 2) {
            yacc[nt][e][1] -= u0;
            yacc[nt][e][3] -= u1;
          }
        }
    }
    if (more) store_v(s + 1, d);
    __syncthreads();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + wm * 16 + (lane >> 2) + half * 8;
    if (t >= tiles) continue;
    int img, ty, tx;
    tile_of(t, h, w, img, ty, tx);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int k = k0 + wn * 16 + nt * 8 + (lane & 3) * 2;
      if (k >= kout) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          store_bf16x2(y + at(img, 2 * ty + i, 2 * tx + j, h, w, kout, k),
                       yacc[nt][2 * half][2 * i + j],
                       yacc[nt][2 * half + 1][2 * i + j]);
    }
  }
}

// dU (or one range's partial) [16][C][K] float32 of 32 c x 64 k.
__global__ void __launch_bounds__(W_THREADS, 1)
winograd_dw_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ g,
                   float* __restrict__ out, int n, int h, int w, int cin,
                   int kout, int per_range) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_v = smem;
  unsigned char* s_d = smem + POS * W_VPLANE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;   // 16 c x 8 k a warp
  const int c0 = blockIdx.x * W_BC, k0 = blockIdx.y * W_BK;
  const int tiles = n * (h / 2) * (w / 2);
  const int begin = blockIdx.z * per_range;
  const int end = begin + per_range < tiles ? begin + per_range : tiles;

  float acc[POS][4];
#pragma unroll
  for (int p = 0; p < POS; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[p][e] = 0.f;

  for (int t0 = begin; t0 < end; t0 += W_BT) {
    input_transform(x, s_v, t0, end, c0, cin, h, w, tid);
    dm_transform(g, s_d, t0, end, k0, kout, h, w, tid);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < W_BT / 16; ++ks)
#pragma unroll
      for (int pos = 0; pos < POS; ++pos) {
        uint32_t a[4], b[2];
        // A = V^T (c x tiles), B = dM (tiles x k): both transposed from
        // their [tile][channel] planes.
        ldsm_x4_t(smem_addr(s_v + pos * W_VPLANE +
                            vswz(ks * 16 + ((lane >> 4) << 3) + (lane & 7),
                                 wm * 2 + ((lane >> 3) & 1))),
                  a);
        ldsm_x2_t(smem_addr(s_d + pos * W_DPLANE +
                            dswz(ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                 wn)),
                  b);
        mma_bf16(acc[pos], a, b[0], b[1]);
      }
    __syncthreads();
  }

  const int k = k0 + wn * 8 + (lane & 3) * 2;
  if (k >= kout) return;
  float* dst = out + static_cast<long long>(blockIdx.z) * POS * cin * kout;
#pragma unroll
  for (int pos = 0; pos < POS; ++pos)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + wm * 16 + (lane >> 2) + half * 8;
      *reinterpret_cast<float2*>(
          dst + (static_cast<long long>(pos) * cin + c) * kout + k) =
          make_float2(acc[pos][2 * half], acc[pos][2 * half + 1]);
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

int tile_count(int n, int h, int w) { return n * (h / 2) * (w / 2); }

simclr::SmemOptIn fwd_smem;
simclr::SmemOptIn dw_smem;

}  // namespace

extern "C" {

// Tile ranges winograd_dw splits the batch into (its partial buffer holds
// that many [16][C][K] float32 slices when it is above 1), or -1.
int winograd_dw_ranges(int n, int h, int w, int cin, int kout) {
  if (!shape_ok(n, h, w, cin, kout)) return -1;
  const int blocks = (cin / W_BC) * ((kout + W_BK - 1) / W_BK);
  const int steps = (tile_count(n, h, w) + W_BT - 1) / W_BT;
  const int ranges = (DW_TARGET_BLOCKS + blocks - 1) / blocks;
  return ranges < steps ? ranges : steps;
}

// y = conv3x3(x, w) through U = transform of w as [16][K][C] bf16; x NHWC
// (N, H, W, C) bf16, y NHWC (N, H, W, K) bf16.
int winograd_fwd(const void* x, const void* u, void* y, int n, int h, int w,
                 int cin, int kout, void* stream) {
  if (!shape_ok(n, h, w, cin, kout)) return cudaErrorInvalidValue;
  cudaError_t err = fwd_smem(winograd_fwd_kernel, F_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((tile_count(n, h, w) + F_BT - 1) / F_BT,
                  (kout + F_BK - 1) / F_BK);
  winograd_fwd_kernel<<<grid, F_THREADS, F_SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(y),
      n, h, w, cin, kout);
  return cudaGetLastError();
}

// dU [16][C][K] float32 of x (N, H, W, C) and the cotangent g (N, H, W, K),
// both NHWC bf16. partial: winograd_dw_ranges(...) x 16 x C x K float32
// when that is above 1 (else unused).
int winograd_dw(const void* x, const void* g, void* partial, void* du, int n,
                int h, int w, int cin, int kout, void* stream) {
  const int ranges = winograd_dw_ranges(n, h, w, cin, kout);
  if (ranges < 1) return cudaErrorInvalidValue;
  cudaError_t err = dw_smem(winograd_dw_kernel, W_SMEM);
  if (err != cudaSuccess) return err;
  const int steps = (tile_count(n, h, w) + W_BT - 1) / W_BT;
  const int per = (steps + ranges - 1) / ranges * W_BT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = ranges > 1 ? static_cast<float*>(partial)
                          : static_cast<float*>(du);
  const dim3 grid(cin / W_BC, (kout + W_BK - 1) / W_BK, ranges);
  winograd_dw_kernel<<<grid, W_THREADS, W_SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), dst, n, h, w, cin, kout, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || ranges == 1) return err;
  const long long count = static_cast<long long>(POS) * cin * kout;
  winograd_dw_reduce<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                       s>>>(static_cast<const float*>(partial), ranges, count,
                            static_cast<float*>(du));
  return cudaGetLastError();
}

}  // extern "C"
