// Single-pass backward of subset-statistics BN(+residual add)+ReLU for
// Hopper (sm_90a).
//
// Replaces simclr_tpu/ops/pallas/bn_relu.py: _bwd_kernel_relu (B3a),
// _bwd_kernel_add_relu (B3b) and _bwd_kernel_norelu (B3c), all launched by
// the pallas_call in _run_bwd (line 191).
//
// What each pass computes, on the 2-D (rows, C) view of an NHWC tensor
// (a channels_last NCHW tensor in PyTorch; row order does not matter):
//
//   B3a relu:     gy = g*[out > 0]; dx = gy*a; S1 = sum gy; S2' = sum gy*out
//   B3b add_relu: gy = g*[out > 0]; dx = gy*a; dskip = gy;
//                 S1 = sum gy; S2 = sum gy*(x - mean)*rsig
//   B3c norelu:   gy = g;           dx = gy*a; S1 = sum gy; S2 likewise
//
// with a = scale*rsig rounded to g's type (the product gy*a is then exact
// in float and rounded once, as PyTorch rounds a bf16 product), the mask
// compared in float32, and S1/S2 summed in float32. The k statistics rows
// of dx get their correction outside, in PyTorch (ops/kernels/bn_relu.py).
//
// Layout. A block covers a run of rows and a chunk of up to 256 channels:
// each thread owns 8 neighbouring channels (one 16-byte load of bf16, two
// of float32), threadIdx.x runs along the channels and threadIdx.y down the
// rows, so a warp reads whole rows of memory. Each thread keeps its S1/S2
// partials in registers; the block sums them over threadIdx.y in shared
// memory and writes one partial row to a [row_blocks, 2C] float32 buffer.
// A second small kernel sums that buffer over the row blocks. Every sum
// runs in a fixed order, so S1/S2 are the same from run to run (no
// atomics): this replaces the Pallas kernel's (1, C) accumulator, which
// could stay resident only because the TPU runs the grid in order.
//
// What bounds it on the H100: bytes. A pass does a few operations per
// element against 2 bytes (bf16) of every tensor it reads or writes; its
// bound is one read of each input and one write of each output over
// 3.35 TB/s. The grid aims at 8 blocks per SM, and each thread keeps two
// rows of loads in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int VEC = 8;             // channels per thread
constexpr int THREADS = 256;       // threads per block
constexpr int UNROLL = 2;          // rows of loads in flight per thread
constexpr int TARGET_BLOCKS = 132 * 8;

enum Mode { RELU = 0, ADD_RELU = 1, NORELU = 2 };

struct Geometry {
  int tx, ty, chunks, row_blocks, rows_per_block;
};

// Block shape and grid for a (rows, c) view; c is a multiple of VEC.
Geometry geometry(int rows, int c) {
  Geometry geo;
  const int groups = c / VEC;
  geo.tx = groups < 32 ? groups : 32;
  geo.ty = THREADS / geo.tx;
  geo.chunks = (groups + geo.tx - 1) / geo.tx;
  long long want = TARGET_BLOCKS / geo.chunks;
  if (want < 1) want = 1;
  long long per = (rows + want - 1) / want;
  per = (per + geo.ty - 1) / geo.ty * geo.ty;
  geo.rows_per_block = static_cast<int>(per);
  geo.row_blocks = static_cast<int>((rows + per - 1) / per);
  return geo;
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 lo = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[VEC]) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1,
         make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
bn_bwd_kernel(const T* __restrict__ g, const T* __restrict__ out,
              const T* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ mean, const float* __restrict__ rsig,
              T* __restrict__ dx, T* __restrict__ dskip,
              float* __restrict__ partial, int rows, int c,
              int rows_per_block) {
  __shared__ float red[2][THREADS * VEC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;
  const int ch0 = (blockIdx.y * bx + tx) * VEC;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;

  if (ch0 < c) {
    float av[VEC], mv[VEC], rv[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      av[j] = round_to<T>(a[ch0 + j]);
      mv[j] = MODE == RELU ? 0.f : mean[ch0 + j];
      rv[j] = MODE == RELU ? 0.f : rsig[ch0 + j];
    }
    const long long begin = static_cast<long long>(blockIdx.x) *
                            rows_per_block;
    const long long end = begin + rows_per_block < rows
                              ? begin + rows_per_block : rows;
    const long long step = static_cast<long long>(by) * UNROLL;
    for (long long r0 = begin + ty; r0 < end; r0 += step) {
      float gv[UNROLL][VEC], ov[UNROLL][VEC], xv[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long r = r0 + static_cast<long long>(u) * by;
        if (r < end) {
          const long long off = r * c + ch0;
          load8(g + off, gv[u]);
          if (MODE != NORELU) load8(out + off, ov[u]);
          if (MODE != RELU) load8(x + off, xv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long r = r0 + static_cast<long long>(u) * by;
        if (r < end) {
          const long long off = r * c + ch0;
          float gy[VEC], d[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float gj = gv[u][j];
            if (MODE != NORELU) gj = ov[u][j] > 0.f ? gj : 0.f;
            gy[j] = gj;
            d[j] = gj * av[j];
            s1[j] += gj;
            if (MODE == RELU)
              s2[j] += gj * ov[u][j];
            else
              s2[j] += gj * ((xv[u][j] - mv[j]) * rv[j]);
          }
          store8(dx + off, d);
          if (MODE == ADD_RELU) store8(dskip + off, gy);
        }
      }
    }
  }

  // Sum the partials over threadIdx.y, in order, and write this block's
  // row of the [row_blocks, 2C] buffer (S1 in columns [0, C), S2 after).
  const int width = bx * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[0][ty * width + tx * VEC + j] = s1[j];
    red[1][ty * width + tx * VEC + j] = s2[j];
  }
  __syncthreads();
  for (int i = ty * bx + tx; i < 2 * width; i += bx * by) {
    const int s = i / width, col = i % width;
    float acc = 0.f;
    for (int y = 0; y < by; ++y) acc += red[s][y * width + col];
    const int ch = blockIdx.y * width + col;
    if (ch < c)
      partial[static_cast<long long>(blockIdx.x) * 2 * c + s * c + ch] = acc;
  }
}

// sums[j] = sum over b of partial[b, j], j < width: 32 columns a block,
// 32 row blocks at a time, then a fixed-order sum over threadIdx.y.
__global__ void __launch_bounds__(1024)
bn_bwd_reduce(const float* __restrict__ partial, int row_blocks, int width,
              float* __restrict__ sums) {
  __shared__ float red[32][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (j < width)
    for (int b = threadIdx.y; b < row_blocks; b += 32)
      acc += partial[static_cast<long long>(b) * width + j];
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    float total = 0.f;
    for (int y = 0; y < 32; ++y) total += red[y][threadIdx.x];
    sums[j] = total;
  }
}

template <typename T, int MODE>
int launch(const void* g, const void* out, const void* x, const void* a,
           const void* mean, const void* rsig, void* dx, void* dskip,
           void* partial, void* sums, int rows, int c, void* stream) {
  if (rows <= 0 || c <= 0 || c % VEC != 0) return cudaErrorInvalidValue;
  const Geometry geo = geometry(rows, c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(geo.tx, geo.ty), grid(geo.row_blocks, geo.chunks);
  bn_bwd_kernel<T, MODE><<<grid, block, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(out),
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const float*>(mean), static_cast<const float*>(rsig),
      static_cast<T*>(dx), static_cast<T*>(dskip),
      static_cast<float*>(partial), rows, c, geo.rows_per_block);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rblock(32, 32), rgrid((2 * c + 31) / 32);
  bn_bwd_reduce<<<rgrid, rblock, 0, s>>>(static_cast<const float*>(partial),
                                         geo.row_blocks, 2 * c,
                                         static_cast<float*>(sums));
  return cudaGetLastError();
}

template <int MODE>
int dispatch(int bf16, const void* g, const void* out, const void* x,
             const void* a, const void* mean, const void* rsig, void* dx,
             void* dskip, void* partial, void* sums, int rows, int c,
             void* stream) {
  if (bf16)
    return launch<__nv_bfloat16, MODE>(g, out, x, a, mean, rsig, dx, dskip,
                                       partial, sums, rows, c, stream);
  return launch<float, MODE>(g, out, x, a, mean, rsig, dx, dskip, partial,
                             sums, rows, c, stream);
}

}  // namespace

// Rows of the partial-sum buffer the wrapper allocates ([rows, 2C] f32).
extern "C" int bn_bwd_row_blocks(int rows, int c) {
  if (rows <= 0 || c <= 0 || c % VEC != 0) return -1;
  return geometry(rows, c).row_blocks;
}

// Each entry: inputs, per-channel float32 vectors, outputs, the partial
// buffer, sums (2, C) float32 = (S1, S2 or S2'), then rows, C, whether the
// tensors are bf16 (else float32), and the stream. Returns a CUDA error.
extern "C" int bn_bwd_relu(const void* g, const void* out, const void* a,
                           void* dx, void* partial, void* sums, int rows,
                           int c, int bf16, void* stream) {
  return dispatch<RELU>(bf16, g, out, nullptr, a, nullptr, nullptr, dx,
                        nullptr, partial, sums, rows, c, stream);
}

extern "C" int bn_bwd_add_relu(const void* g, const void* out, const void* x,
                               const void* a, const void* mean,
                               const void* rsig, void* dx, void* dskip,
                               void* partial, void* sums, int rows, int c,
                               int bf16, void* stream) {
  return dispatch<ADD_RELU>(bf16, g, out, x, a, mean, rsig, dx, dskip,
                            partial, sums, rows, c, stream);
}

extern "C" int bn_bwd_norelu(const void* g, const void* x, const void* a,
                             const void* mean, const void* rsig, void* dx,
                             void* partial, void* sums, int rows, int c,
                             int bf16, void* stream) {
  return dispatch<NORELU>(bf16, g, nullptr, x, a, mean, rsig, dx, nullptr,
                          partial, sums, rows, c, stream);
}
