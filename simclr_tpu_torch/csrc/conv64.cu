// 3x3 stride-1 SAME convolution at C_in = C_out = 64 (ResNet layer1's
// conv2) for Hopper (sm_90a), bf16 operands on the tensor cores with
// float32 accumulation.
//
// Replaces simclr_tpu/ops/pallas/conv64.py: _kernel (B4f, launched by the
// pallas_call in _conv_hwcn, line 160; also the input gradient, with the
// filter rotated 180 degrees and in/out swapped) and _wgrad_kernel (B4w,
// pallas_call in _wgrad_hwcn, line 250).
//
// Tensors are NHWC: a channels_last (N, 64, H, W) tensor in PyTorch, so a
// pixel is a contiguous row of 64 bf16 (128 bytes). The Pallas kernel's
// batch-on-lanes [H, W, C, N] view and its 4-slot DMA ring are TPU layout
// choices and are not carried over.
//
// B4f, conv64_fwd_kernel: an implicit GEMM. M = output pixels (N*H*W, in
// order), N = 64 output channels, K = 9 taps x 64 input channels. A block keeps
// the whole bf16 filter in shared memory (9 x 64 x 64 x 2 = 73,728 bytes,
// loaded once) and walks over tiles of 128 output pixels (persistent
// grid). For each tap it gathers the 128 shifted input pixels with
// cp.async (zero fill outside the image: the SAME padding) into a
// double buffer, so the next tap's copy overlaps this tap's products.
// 4 warps, each 32 pixels x 64 channels of m16n8k16 mma.sync; the sums
// stay in float32 registers over all 576 products and are rounded to
// bf16 once.
//
// B4w, conv64_wgrad_kernel: dW[co][ci][dy][dx] = sum over pixels p of
// g[p][co] * x[p shifted by (dy-1, dx-1)][ci]: M = 64, N = 3 x 64 (the dx
// taps of one dy), K = pixels. grid.y is dy; grid.x splits the pixels into
// WGRAD_CHUNKS ranges. Each block writes its float32 partial, and
// conv64_wgrad_reduce sums the partials over the ranges in a fixed order,
// so dW is the same from run to run (no atomics). dW is float32, not
// rounded (the JAX kernel returns it so too).
//
// What bounds it on the H100: at [1024, 64, 32, 32] each pass moves 268 MB
// (two bf16 tensors) and does 77.3 GFLOP, 0.080 ms of memory time against
// 0.078 ms of bf16 tensor time: both limits nearly at once. This simple
// design reads each input pixel 9 times from L2 (once a tap) and runs
// mma.sync rather than wgmma, so it sits well above that bound; TMA and
// wgmma are later work.
//
// Shared-memory rows are 128 bytes; the 16-byte chunk c of row r is stored
// at chunk c ^ (r % 8), so ldmatrix reads 8 rows without bank conflicts.

#include "mma.cuh"

namespace {

using simclr::cp_async16;
using simclr::cp_async_commit;
using simclr::cp_async_wait;
using simclr::ldsm_x4;
using simclr::ldsm_x4_t;
using simclr::mma_bf16;
using simclr::smem_addr;

constexpr int C = 64;               // input and output channels
constexpr int TAPS = 9;
constexpr int ROW = C * 2;          // bytes of one pixel row
constexpr int FWD_THREADS = 128;
constexpr int FWD_BM = 128;         // output pixels a tile
constexpr int FWD_MAX_GRID = 264;   // 2 blocks on each of 132 SMs
constexpr int FWD_SMEM = TAPS * C * ROW + 2 * FWD_BM * ROW;
constexpr int WG_THREADS = 256;
constexpr int WG_BK = 64;           // pixels a step
constexpr int WGRAD_CHUNKS = 96;    // pixel ranges (x 3 dy = 288 blocks)
constexpr int WG_STAGE = 4 * WG_BK * ROW;   // g + 3 shifted x tiles
constexpr int WG_SMEM = 2 * WG_STAGE;
constexpr int WG_N = 3 * C;         // columns of one dy's partial

__device__ __forceinline__ int swz(int row, int chunk) {
  return row * ROW + ((chunk ^ (row & 7)) << 4);
}

// A pixel's index (-1 past the end) and its row and column, computed
// once and then shifted by each tap. Indices fit in int: the wrappers
// refuse tensors of 2**31 elements or more.
struct Pixel {
  int p, y, x;
};

__device__ __forceinline__ Pixel pixel_at(int p, int pixels, int h, int w) {
  if (p >= pixels) return {-1, 0, 0};
  const int rem = p % (h * w);
  return {p, rem / w, rem % w};
}

// Source of the 16-byte chunk `chunk` of pixel q shifted by (dy, dx), or
// nullptr where that falls outside the image (or q is past the end).
__device__ __forceinline__ const __nv_bfloat16* shifted(
    const __nv_bfloat16* x, Pixel q, int h, int w, int dy, int dx,
    int chunk) {
  const int hh = q.y + dy, ww = q.x + dx;
  if (q.p < 0 || hh < 0 || hh >= h || ww < 0 || ww >= w) return nullptr;
  return x + static_cast<long long>(q.p + dy * w + dx) * C + chunk * 8;
}

__global__ void __launch_bounds__(FWD_THREADS)
conv64_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ wt,  // [tap][co][ci]
                  __nv_bfloat16* __restrict__ y, int n, int h, int w) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_w = smem;
  unsigned char* s_a = smem + TAPS * C * ROW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pixels = n * h * w;
  const int tiles = (pixels + FWD_BM - 1) / FWD_BM;
  const int mine = tiles > static_cast<int>(blockIdx.x)
                       ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int stages = mine * TAPS;

  for (int i = tid; i < TAPS * C * 8; i += FWD_THREADS)
    cp_async16(smem_addr(s_w + swz(i >> 3, i & 7)), wt + i * 8, true);
  cp_async_commit();

  // This thread copies chunk tid % 8 of rows tid / 8 + 16 i of a tile;
  // their pixels are found once a tile, at its first tap.
  constexpr int ROWS = FWD_BM / (FWD_THREADS / 8);
  Pixel rows[ROWS];
  auto load = [&](int s) {
    const int tap = s % TAPS;
    if (tap == 0) {
      const int tile = blockIdx.x + (s / TAPS) * gridDim.x;
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        rows[i] = pixel_at(tile * FWD_BM + (tid >> 3) + 16 * i, pixels, h,
                           w);
    }
    unsigned char* buf = s_a + (s & 1) * FWD_BM * ROW;
    const int chunk = tid & 7;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const __nv_bfloat16* src =
          shifted(x, rows[i], h, w, tap / 3 - 1, tap % 3 - 1, chunk);
      cp_async16(smem_addr(buf + swz((tid >> 3) + 16 * i, chunk)),
                 src ? src : x, src);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (stages > 0) load(0);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) load(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int tap = s % TAPS;
    const unsigned char* buf = s_a + (s & 1) * FWD_BM * ROW;
    const unsigned char* wtap = s_w + tap * C * ROW;
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(smem_addr(buf + swz(warp * 32 + mi * 16 + (lane & 15),
                                    ks * 2 + (lane >> 4))),
                a[mi]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        const int row = nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(smem_addr(wtap + swz(row, ks * 2 + ((lane >> 3) & 1))), b);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (tap == TAPS - 1) {
      const int p0 = (blockIdx.x + (s / TAPS) * gridDim.x) * FWD_BM;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = p0 + warp * 32 + mi * 16 + (lane >> 2) + half * 8;
          if (p < pixels) {
#pragma unroll
            for (int ni = 0; ni < 8; ++ni)
              simclr::store_bf16x2(y + static_cast<long long>(p) * C +
                                       ni * 8 + (lane & 3) * 2,
                                   acc[mi][ni][2 * half],
                                   acc[mi][ni][2 * half + 1]);
          }
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// Partial dW of one dy over one range of pixels:
// partial[chunk][dy][co][dx * 64 + ci], float32.
__global__ void __launch_bounds__(WG_THREADS)
conv64_wgrad_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ g,
                    float* __restrict__ partial, int n, int h, int w,
                    int per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;   // 32 co x 48 columns a warp
  const int dy = static_cast<int>(blockIdx.y) - 1;
  const int pixels = n * h * w;
  const int begin = blockIdx.x * per_chunk;
  const int end = begin + per_chunk < pixels ? begin + per_chunk : pixels;
  const int steps = end > begin ? (end - begin + WG_BK - 1) / WG_BK : 0;

  // Stage layout: tile 0 = g, tiles 1..3 = x shifted by (dy, dx - 1).
  // This thread copies chunk tid % 8 of pixel rows tid / 8 and
  // tid / 8 + 32 of each tile.
  auto load = [&](int s) {
    unsigned char* buf = smem + (s & 1) * WG_STAGE;
    const int chunk = tid & 7;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (tid >> 3) + 32 * half;
      const Pixel q = pixel_at(begin + s * WG_BK + r, end, h, w);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const __nv_bfloat16* src =
            t == 0 ? (q.p >= 0 ? g + static_cast<long long>(q.p) * C +
                                     chunk * 8
                               : nullptr)
                   : shifted(x, q, h, w, dy, t - 2, chunk);
        cp_async16(smem_addr(buf + t * WG_BK * ROW + swz(r, chunk)),
                   src ? src : x, src);
      }
    }
  };

  float acc[2][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (steps > 0) load(0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* buf = smem + (s & 1) * WG_STAGE;
#pragma unroll
    for (int ks = 0; ks < WG_BK / 16; ++ks) {
      // A = g^T (co x pixels) from the [pixel][co] tile, transposed.
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_t(smem_addr(buf + swz(ks * 16 + ((lane >> 4) << 3) +
                                          (lane & 7),
                                      wm * 4 + mi * 2 + ((lane >> 3) & 1))),
                  a[mi]);
      // B = shifted x (pixels x (dx, ci)), transposed from [pixel][ci].
#pragma unroll
      for (int nj = 0; nj < 3; ++nj) {
        const int col = wn * 48 + nj * 16;       // within one dx tile
        const unsigned char* xt = buf + (1 + col / C) * WG_BK * ROW;
        uint32_t b[4];
        ldsm_x4_t(smem_addr(xt + swz(ks * 16 + ((lane >> 3) & 1) * 8 +
                                         (lane & 7),
                                     (col % C) / 8 + (lane >> 4))),
                  b);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float* out = partial + (static_cast<long long>(blockIdx.x) * 3 +
                          blockIdx.y) * C * WG_N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = wm * 32 + mi * 16 + (lane >> 2) + half * 8;
#pragma unroll
      for (int ni = 0; ni < 6; ++ni) {
        const int col = wn * 48 + ni * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(out + co * WG_N + col) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

// dw[co][ci][dy][dx] = sum over chunks, in order, of the partials.
__global__ void __launch_bounds__(256)
conv64_wgrad_reduce(const float* __restrict__ partial, int chunks,
                    float* __restrict__ dw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 3 * C * WG_N) return;
  float acc = 0.f;
  for (int k = 0; k < chunks; ++k)
    acc += partial[static_cast<long long>(k) * 3 * C * WG_N + j];
  const int dy = j / (C * WG_N), co = (j / WG_N) % C, col = j % WG_N;
  const int dx = col / C, ci = col % C;
  dw[((co * C + ci) * 3 + dy) * 3 + dx] = acc;
}

bool shape_ok(int n, int h, int w) {
  return n > 0 && h > 0 && w > 0 &&
         static_cast<long long>(n) * h * w * C < (1LL << 31);
}

simclr::SmemOptIn fwd_smem;
simclr::SmemOptIn wgrad_smem;

}  // namespace

extern "C" {

int conv64_wgrad_chunks() { return WGRAD_CHUNKS; }

// y = conv3x3(x, w), NHWC bf16, stride 1, SAME. wt is the filter as
// [tap = 3 * ky + kx][co][ci] bf16 (for the input gradient, the filter
// rotated 180 degrees with in/out swapped).
int conv64_fwd(const void* x, const void* wt, void* y, int n, int h, int w,
               void* stream) {
  if (!shape_ok(n, h, w)) return cudaErrorInvalidValue;
  cudaError_t err = fwd_smem(conv64_fwd_kernel, FWD_SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (static_cast<long long>(n) * h * w + FWD_BM - 1) / FWD_BM;
  const int grid = tiles < FWD_MAX_GRID ? static_cast<int>(tiles)
                                        : FWD_MAX_GRID;
  conv64_fwd_kernel<<<grid, FWD_THREADS, FWD_SMEM,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt), static_cast<__nv_bfloat16*>(y),
      n, h, w);
  return cudaGetLastError();
}

// dw (64, 64, 3, 3) float32 of y = conv3x3(x, w) for the cotangent g, both
// NHWC bf16. partial is float32 scratch of WGRAD_CHUNKS x 3 x 64 x 192.
int conv64_wgrad(const void* x, const void* g, void* partial, void* dw, int n,
                 int h, int w, void* stream) {
  if (!shape_ok(n, h, w)) return cudaErrorInvalidValue;
  cudaError_t err = wgrad_smem(conv64_wgrad_kernel, WG_SMEM);
  if (err != cudaSuccess) return err;
  const long long pixels = static_cast<long long>(n) * h * w;
  int per = static_cast<int>((pixels + WGRAD_CHUNKS - 1) / WGRAD_CHUNKS);
  per = (per + WG_BK - 1) / WG_BK * WG_BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conv64_wgrad_kernel<<<dim3(WGRAD_CHUNKS, 3), WG_THREADS, WG_SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), static_cast<float*>(partial), n,
      h, w, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  conv64_wgrad_reduce<<<(3 * C * WG_N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), WGRAD_CHUNKS,
      static_cast<float*>(dw));
  return cudaGetLastError();
}

}  // extern "C"
