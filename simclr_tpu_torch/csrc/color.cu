// Colour distortion for Hopper (sm_90a): colour jitter in a per-image random
// order, random grayscale, then (x - mean) / std.
//
// Replaces simclr_tpu/ops/pallas/color.py: _color_kernel (pallas_call at
// line 195, wrapper color_distort_pallas).
//
// Layout. Images are NHWC float32 (n, hw, 3) with interleaved channels, the
// layout of the port's public augmentation functions, so no transpose runs
// around the kernel. One thread block owns one image: contrast needs the
// mean grey of the whole image at every schedule step, and with the image
// in one block that is one block reduction per contrast step, and no tile
// over the batch is needed (so, unlike the Pallas wrapper, there is no
// fallback for a tile that does not fit). The block reads the image once
// into shared memory as three planes (12 B a pixel: 12 KiB for CIFAR's
// 1,024 pixels, 108 KiB for STL's 9,216), runs the four steps there, and
// writes the normalised result once.
//
// The schedule step's op is one value per image, so the whole block takes
// one branch: only the scheduled op is evaluated, which gives the same
// values as the Pallas kernel's evaluate-all-four-and-select.
//
// What bounds it on the H100: bytes. Each pixel costs some 30 floating
// point operations per step against 24 bytes of input and output, far below
// the card's operations-per-byte balance. The bound is one read and one
// write of the images: 12.6 MB at batch 512 of 32x32.
//
// The `%` of the JAX code is a floor modulo computed as XLA computes it:
// fmodf (exact) with the sign moved onto the divisor's.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_HW = 16384;  // 12 B * 16384 = 192 KiB of shared memory
constexpr float GR = 0.299f, GG = 0.587f, GB = 0.114f;

__device__ __forceinline__ float floor_mod(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.f && ((r < 0.f) != (m < 0.f))) r += m;
  return r;
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

__device__ __forceinline__ float gray_of(float r, float g, float b) {
  return GR * r + GG * g + GB * b;
}

__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is free from any earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < THREADS / 32; ++i) total += red[i];
  return total;
}

// Hue shift of one pixel: RGB -> HSV -> h + fh -> RGB, branch-free as in
// the Pallas kernel, with its guards against division by zero.
__device__ __forceinline__ void hue_shift(float& r, float& g, float& b,
                                          float fh) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = maxc - minc;
  const float safe = delta == 0.f ? 1.f : delta;
  const float sat = maxc == 0.f ? 0.f : delta / maxc;
  const float rc = (maxc - r) / safe;
  const float gc = (maxc - g) / safe;
  const float bc = (maxc - b) / safe;
  // Ties: maxc == r wins, then maxc == g.
  float h = maxc == r ? bc - gc : (maxc == g ? 2.f + rc - bc : 4.f + gc - rc);
  h = floor_mod((delta == 0.f ? 0.f : h) / 6.f, 1.f);
  const float h6 = floor_mod(h + fh, 1.f) * 6.f;
  const float kr = floor_mod(5.f + h6, 6.f);
  const float kg = floor_mod(3.f + h6, 6.f);
  const float kb = floor_mod(1.f + h6, 6.f);
  const float vs = maxc * sat;
  r = maxc - vs * fminf(fmaxf(fminf(kr, 4.f - kr), 0.f), 1.f);
  g = maxc - vs * fminf(fmaxf(fminf(kg, 4.f - kg), 0.f), 1.f);
  b = maxc - vs * fminf(fmaxf(fminf(kb, 4.f - kb), 0.f), 1.f);
}

// factors: (n, 8) = [fb, fc, fs, fh, gray_flag, pad x3]; sched: (n, 4) op
// ids per step (0 brightness, 1 contrast, 2 saturation, 3 hue).
__global__ void __launch_bounds__(THREADS)
color_kernel(const float* __restrict__ img, const float* __restrict__ factors,
             const int* __restrict__ sched, float* __restrict__ out, int hw,
             float m0, float m1, float m2, float s0, float s1, float s2) {
  extern __shared__ float planes[];  // R[hw], G[hw], B[hw]
  __shared__ float red[THREADS / 32];
  float* R = planes;
  float* G = planes + hw;
  float* B = planes + 2 * hw;
  const int n = blockIdx.x, t = threadIdx.x;
  const float* src = img + (size_t)n * hw * 3;
  // Each thread owns pixels t, t + THREADS, ...: only the contrast
  // reduction crosses threads.
  for (int p = t; p < hw; p += THREADS) {
    R[p] = src[3 * p];
    G[p] = src[3 * p + 1];
    B[p] = src[3 * p + 2];
  }
  const float* f = factors + (size_t)n * 8;
  const float fb = f[0], fc = f[1], fs = f[2], fh = f[3], grayf = f[4];

  for (int step = 0; step < 4; ++step) {
    const int op = sched[n * 4 + step];
    if (op == 0) {
      for (int p = t; p < hw; p += THREADS) {
        R[p] = clip01(R[p] * fb);
        G[p] = clip01(G[p] * fb);
        B[p] = clip01(B[p] * fb);
      }
    } else if (op == 1) {
      float part = 0.f;
      for (int p = t; p < hw; p += THREADS) part += gray_of(R[p], G[p], B[p]);
      const float mean_gray = block_sum(part, red) / (float)hw;
      const float off = (1.f - fc) * mean_gray;
      for (int p = t; p < hw; p += THREADS) {
        R[p] = clip01(fc * R[p] + off);
        G[p] = clip01(fc * G[p] + off);
        B[p] = clip01(fc * B[p] + off);
      }
    } else if (op == 2) {
      for (int p = t; p < hw; p += THREADS) {
        const float off = (1.f - fs) * gray_of(R[p], G[p], B[p]);
        R[p] = clip01(fs * R[p] + off);
        G[p] = clip01(fs * G[p] + off);
        B[p] = clip01(fs * B[p] + off);
      }
    } else {
      for (int p = t; p < hw; p += THREADS) {
        float r = R[p], g = G[p], b = B[p];
        hue_shift(r, g, b, fh);
        R[p] = r;
        G[p] = g;
        B[p] = b;
      }
    }
  }
  float* dst = out + (size_t)n * hw * 3;
  for (int p = t; p < hw; p += THREADS) {
    float r = R[p], g = G[p], b = B[p];
    if (grayf > 0.5f) r = g = b = gray_of(r, g, b);
    dst[3 * p] = (r - m0) / s0;
    dst[3 * p + 1] = (g - m1) / s1;
    dst[3 * p + 2] = (b - m2) / s2;
  }
}

// Lets the kernel take the largest image, once per device (the attribute
// depends on nothing that changes between launches).
cudaError_t allow_max_smem() {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> done[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(color_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             3 * MAX_HW * (int)sizeof(float));
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true);
  return err;
}

}  // namespace

extern "C" {

int color_max_hw() { return MAX_HW; }

int color_distort(const float* img, const float* factors, const int* sched,
                  float* out, int n, int hw, float m0, float m1, float m2,
                  float s0, float s1, float s2, cudaStream_t stream) {
  if (hw > MAX_HW) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_max_smem();
  if (err != cudaSuccess) return (int)err;
  const int smem = 3 * hw * (int)sizeof(float);
  color_kernel<<<n, THREADS, smem, stream>>>(img, factors, sched, out, hw,
                                             m0, m1, m2, s0, s1, s2);
  return (int)cudaGetLastError();
}

}  // extern "C"
