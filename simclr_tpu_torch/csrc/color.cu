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
// fallback for a tile that does not fit).
//
// What bounds it on the H100: bytes. Each pixel costs some 30 floating
// point operations per step against 24 bytes of input and output, far below
// the card's operations-per-byte balance. The bound is one read and one
// write of the images: 12.6 MB at batch 512 of 32x32. At that shape the
// grid (512 blocks) is one wave of about four blocks an SM, so the kernel
// takes about one block's chain of latencies, and the design keeps that
// chain short:
//
// * One bulk copy in. Thread 0 arms an mbarrier and issues one
//   cp.async.bulk of the image's bytes into shared memory, in the
//   interleaved layout it has in global memory, while every thread reads
//   the image's 8 factors and 4 schedule entries into registers (one
//   broadcast round trip, under the copy). A bulk copy needs 16-byte
//   aligned ends, so it moves the aligned middle [lo, hi) of the image's
//   bytes (`span`); the at most two pixels that cross its ends (the first
//   and the last) are read by their threads with plain loads, under the
//   copy as well. The shared image sits at the byte offset its global
//   address has modulo 16, so the aligned middle lands aligned.
// * The colour chain in registers. Thread t owns pixels t + k T (k < P; T
//   threads, P pixels a thread, both compile-time constants of the
//   instantiations in `shape_of`). It reads their 3 floats each from
//   shared memory once (a stride of 3 words: no bank conflicts), runs the
//   four steps on registers and writes the results once. A step's op is
//   one value per image, so the whole block takes one branch: only the
//   scheduled op is evaluated, which gives the same values as the Pallas
//   kernel's evaluate-all-four-and-select.
// * The contrast mean in a fixed order: each thread sums its pixels' grey
//   in k order, a warp shuffle tree sums the lanes (every lane ends with
//   the same bits), and every thread sums the warp partials in warp order
//   after the one barrier a contrast step needs. No atomics: two calls
//   give the same bits. A step with no contrast needs no barrier.
// * One bulk copy out. The normalised values go back over the staging
//   buffer, at the output's offset modulo 16 (after a barrier only where
//   that offset differs from the input's), then a proxy fence and a
//   barrier, and thread 0 issues one shared-to-global bulk store of the
//   aligned middle (`hopper.cuh:bulk_store`) and waits until it has read
//   the buffer. The first and last pixels, where they cross its ends, are
//   written with plain stores.
//
// A block's critical path is one DRAM round trip in, the arithmetic, and
// one bulk store out. ops/kernels/color.py:geometry mirrors `shape_of` and
// `span`, and the C entry color_geometry gives them for chip_smoke.py to
// hold against it.
//
// The `%` of the JAX code is a floor modulo computed as XLA computes it:
// fmodf (exact) with the sign moved onto the divisor's. The hue step's
// five take arguments in small known ranges, where the same bits come
// from a compare and a subtraction (`floor_mod1_of_small`,
// `floor_mod_near`, `floor_mod6_of_positive`), and fmodf's general
// reduction stays only for arguments outside them. The same bits are
// shown on a numpy mirror of the three (tests/test_torch_color_geometry.py
// holds it against the plain floor_mod), not on the card: there the
// kernel's output is held to the plain version within chip_smoke.py's
// 1e-4, since nvcc contracts multiplies and adds into FMAs that PyTorch
// rounds twice.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using simclr::bulk_commit;
using simclr::bulk_load;
using simclr::bulk_store;
using simclr::bulk_wait_read;
using simclr::fence_proxy_async;
using simclr::mbar_expect_tx;
using simclr::mbar_fence_init;
using simclr::mbar_init;
using simclr::mbar_wait;

constexpr int MAX_HW = 16384;  // 12 B * 16384 = 192 KiB of shared memory
constexpr float GR = 0.299f, GG = 0.587f, GB = 0.114f;

// The instantiations: threads a block and pixels a thread, the smallest
// that holds hw pixels. One for each image size of the repository's
// datasets: 256 x 4 is CIFAR-10's 1,024 exactly and 1024 x 9 STL-10's
// 9,216; 512 x 32 reaches MAX_HW within 128 registers a thread.
struct Shape {
  int threads, pixels;
};
__host__ __device__ constexpr Shape shape_of(int hw) {
  return hw <= 1024   ? Shape{256, 4}
         : hw <= 9216 ? Shape{1024, 9}
                      : Shape{512, 32};
}

// The bytes [lo, hi) of an image of hw pixels (12 hw bytes) at an address
// that is `mis` modulo 16 that one bulk copy moves: the largest span with
// 16-byte aligned ends (empty, lo == hi, where there is none).
__host__ __device__ inline void span(int hw, int mis, int& lo, int& hi) {
  lo = (16 - mis) & 15;
  hi = (mis + 12 * hw) / 16 * 16 - mis;
  if (hi < lo) hi = lo;
}

// Dynamic shared memory of a block: the image and room to place it at
// its offset modulo 16.
__host__ __device__ constexpr int smem_bytes(int threads, int pixels) {
  return 12 * threads * pixels + 16;
}

__device__ __forceinline__ float floor_mod(float x, float m) {
  float r = fmodf(x, m);
  if (r != 0.f && ((r < 0.f) != (m < 0.f))) r += m;
  return r;
}

// The hue step's five floor modulos, bit for bit, without fmodf's general
// reduction where the argument is small: where |x| < 2 m, fmodf(x, m) is
// x itself or |x| - m (exact: Sterbenz) with x's sign.
//
// floor_mod(x, 1) for x in (-1, 1) or NaN. The first call takes
// h / 6 with h in [-1, 5] or NaN for any pixel (h is a sum of quotients
// in [0, 1] and 0, 2 or 4), so it needs no other case.
__device__ __forceinline__ float floor_mod1_of_small(float x) {
  return x < 0.f ? x + 1.f : x;
}

// floor_mod(x, m) for m > 0 and any x: the shortcut where |x| < 2 m,
// fmodf elsewhere (and for NaN and infinities). The second call takes
// h + fh with h in [0, 1]: |x| < 2 for any factor |fh| < 1.
__device__ __forceinline__ float floor_mod_near(float x, float m) {
  const float a = fabsf(x);
  if (!(a < 2.f * m)) return floor_mod(x, m);
  const float r = a >= m ? copysignf(a - m, x) : x;
  return r < 0.f ? r + m : r;
}

// floor_mod(x, 6) for x in [0, 12) or NaN. The last three calls take
// n + h6 with n in {1, 3, 5} and h6 = 6 floor_mod(., 1) in [0, 6] or NaN.
__device__ __forceinline__ float floor_mod6_of_positive(float x) {
  return x >= 6.f ? x - 6.f : x;
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

__device__ __forceinline__ float gray_of(float r, float g, float b) {
  return GR * r + GG * g + GB * b;
}

// Hue shift of one pixel: RGB -> HSV -> h + fh -> RGB, branch-free as in
// the Pallas kernel, with its guards against division by zero.
__device__ __forceinline__ void hue_shift(float& r, float& g, float& b,
                                          float fh) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = maxc - minc;
  const float safe = delta == 0.f ? 1.f : delta;
  // The division runs for every pixel (no branch around it), the guard
  // selects after it.
  const float sat = maxc == 0.f ? 0.f : delta / (maxc == 0.f ? 1.f : maxc);
  // h = bc - gc, 2 + rc - bc or 4 + gc - rc with xc = (maxc - x) / safe;
  // ties: maxc == r wins, then maxc == g. The branch taken reads two of
  // rc, gc and bc, so only those two are divided out: (u, v) = (b, g),
  // (r, b) or (g, r).
  const bool is_r = maxc == r, is_g = maxc == g;
  const float u = (maxc - (is_r ? b : is_g ? r : g)) / safe;
  const float v = (maxc - (is_r ? g : is_g ? b : r)) / safe;
  float h = is_r ? u - v : (is_g ? 2.f : 4.f) + u - v;
  h = floor_mod1_of_small((delta == 0.f ? 0.f : h) / 6.f);
  const float h6 = floor_mod_near(h + fh, 1.f) * 6.f;
  const float kr = floor_mod6_of_positive(5.f + h6);
  const float kg = floor_mod6_of_positive(3.f + h6);
  const float kb = floor_mod6_of_positive(1.f + h6);
  const float vs = maxc * sat;
  r = maxc - vs * fminf(fmaxf(fminf(kr, 4.f - kr), 0.f), 1.f);
  g = maxc - vs * fminf(fmaxf(fminf(kg, 4.f - kg), 0.f), 1.f);
  b = maxc - vs * fminf(fmaxf(fminf(kb, 4.f - kb), 0.f), 1.f);
}

// Phase clocks of thread 0 of each block (a build with -DSIMCLR_B2_TRACE,
// `python3 chip_smoke.py b2_trace`): the SM, then clock64() at the start,
// with the image in registers, after the four steps, with the results in
// shared memory (after the barrier before the store), and at the end.
#ifdef SIMCLR_B2_TRACE
constexpr int TRACE_BLOCKS = 1024, TRACE_FIELDS = 6;
__device__ long long b2_trace[TRACE_BLOCKS * TRACE_FIELDS];
#define B2_MARK(i)                                                     \
  do {                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < TRACE_BLOCKS)                 \
      b2_trace[blockIdx.x * TRACE_FIELDS + (i)] = clock64();           \
  } while (0)
#else
#define B2_MARK(i) \
  do {             \
  } while (0)
#endif

// factors: (n, 8) = [fb, fc, fs, fh, gray_flag, pad x3]; sched: (n, 4) op
// ids per step (0 brightness, 1 contrast, 2 saturation, else hue).
// At most 64 registers a thread where P <= 16 (four blocks of 256 threads
// an SM: CIFAR's 512 images in one wave), 128 for 512 x 32.
template <int T, int P>
__global__ void __launch_bounds__(T, P > 16 ? 1 : 1024 / T)
color_kernel(const float* __restrict__ img, const float* __restrict__ factors,
             const int* __restrict__ sched, float* __restrict__ out, int hw,
             float m0, float m1, float m2, float s0, float s1, float s2) {
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ uint64_t bar;
  __shared__ float red[4][T / 32];
  const int n = blockIdx.x, t = threadIdx.x;
#ifdef SIMCLR_B2_TRACE
  if (t == 0 && n < TRACE_BLOCKS) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    b2_trace[n * TRACE_FIELDS] = sm;
  }
#endif
  B2_MARK(1);
  const float* src = img + static_cast<size_t>(n) * hw * 3;
  float* dst = out + static_cast<size_t>(n) * hw * 3;
  const int mis_in = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int mis_out = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  int lo_in, hi_in, lo_out, hi_out;
  span(hw, mis_in, lo_in, hi_in);
  span(hw, mis_out, lo_out, hi_out);
  if (t == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
    if (hi_in > lo_in) {
      mbar_expect_tx(&bar, hi_in - lo_in);
      bulk_load(stage + mis_in + lo_in,
                reinterpret_cast<const unsigned char*>(src) + lo_in,
                hi_in - lo_in, &bar);
    }
  }
  // Under the copy: the image's factors and schedule, and the pixels that
  // cross the copied span, from global memory.
  const float* f = factors + static_cast<size_t>(n) * 8;
  const int* s = sched + static_cast<size_t>(n) * 4;
  const float fb = __ldg(f), fc = __ldg(f + 1), fs = __ldg(f + 2),
              fh = __ldg(f + 3), grayf = __ldg(f + 4);
  const int ops[4] = {__ldg(s), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3)};
  float px[P][3];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = t + k * T;
    px[k][0] = px[k][1] = px[k][2] = 0.f;
    if (p < hw && (12 * p < lo_in || 12 * p + 12 > hi_in)) {
      px[k][0] = __ldg(src + 3 * p);
      px[k][1] = __ldg(src + 3 * p + 1);
      px[k][2] = __ldg(src + 3 * p + 2);
    }
  }
  __syncthreads();  // the barrier's initialisation is visible
  if (hi_in > lo_in) mbar_wait(&bar, 0);
  const float* in_s = reinterpret_cast<const float*>(stage + mis_in);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = t + k * T;
    if (p < hw && 12 * p >= lo_in && 12 * p + 12 <= hi_in) {
      px[k][0] = in_s[3 * p];
      px[k][1] = in_s[3 * p + 1];
      px[k][2] = in_s[3 * p + 2];
    }
  }
  B2_MARK(2);

#pragma unroll 1
  for (int step = 0; step < 4; ++step) {
    const int op = step == 0 ? ops[0]
                   : step == 1 ? ops[1]
                   : step == 2 ? ops[2]
                               : ops[3];
    if (op == 0) {
#pragma unroll
      for (int k = 0; k < P; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c) px[k][c] = clip01(px[k][c] * fb);
    } else if (op == 1) {
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (t + k * T < hw) part += gray_of(px[k][0], px[k][1], px[k][2]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if ((t & 31) == 0) red[step][t >> 5] = part;
      __syncthreads();
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < T / 32; ++w) total += red[step][w];
      const float off = (1.f - fc) * (total / static_cast<float>(hw));
#pragma unroll
      for (int k = 0; k < P; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c) px[k][c] = clip01(fc * px[k][c] + off);
    } else if (op == 2) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float off = (1.f - fs) * gray_of(px[k][0], px[k][1], px[k][2]);
#pragma unroll
        for (int c = 0; c < 3; ++c) px[k][c] = clip01(fs * px[k][c] + off);
      }
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k) hue_shift(px[k][0], px[k][1], px[k][2], fh);
    }
  }
  B2_MARK(3);

  // Another offset modulo 16 out than in moves each pixel's words in the
  // buffer: every thread must have read its own first.
  if (mis_out != mis_in) __syncthreads();
  float* out_s = reinterpret_cast<float*>(stage + mis_out);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = t + k * T;
    if (p >= hw) continue;
    float r = px[k][0], g = px[k][1], b = px[k][2];
    if (grayf > 0.5f) r = g = b = gray_of(r, g, b);
    r = (r - m0) / s0;
    g = (g - m1) / s1;
    b = (b - m2) / s2;
    out_s[3 * p] = r;
    out_s[3 * p + 1] = g;
    out_s[3 * p + 2] = b;
    if (12 * p < lo_out || 12 * p + 12 > hi_out) {
      dst[3 * p] = r;
      dst[3 * p + 1] = g;
      dst[3 * p + 2] = b;
    }
  }
  if (hi_out > lo_out) {
    fence_proxy_async();
    __syncthreads();
    B2_MARK(4);
    if (t == 0) {
      bulk_store(reinterpret_cast<unsigned char*>(dst) + lo_out,
                 stage + mis_out + lo_out, hi_out - lo_out);
      bulk_commit();
      bulk_wait_read<0>();
    }
  }
  B2_MARK(5);
}

template <int T, int P>
cudaError_t launch(const float* img, const float* factors, const int* sched,
                   float* out, int n, int hw, float m0, float m1, float m2,
                   float s0, float s1, float s2, cudaStream_t stream) {
  static simclr::SmemOptIn opt;
  cudaError_t err = opt(color_kernel<T, P>, smem_bytes(T, P));
  if (err != cudaSuccess) return err;
  color_kernel<T, P><<<n, T, smem_bytes(T, P), stream>>>(
      img, factors, sched, out, hw, m0, m1, m2, s0, s1, s2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int color_max_hw() { return MAX_HW; }

// The launch for an image of hw pixels at an address that is `mis`
// (0, 4, 8 or 12) modulo 16, as ops/kernels/color.py:geometry mirrors it:
// threads a block, pixels a thread, the bytes [lo, hi) of the image that
// the bulk copy moves, and the block's dynamic shared memory.
int color_geometry(int hw, int mis, int* out) {
  if (hw < 1 || hw > MAX_HW || mis < 0 || mis > 12 || mis % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const Shape sh = shape_of(hw);
  int lo, hi;
  span(hw, mis, lo, hi);
  const int v[5] = {sh.threads, sh.pixels, lo, hi,
                    smem_bytes(sh.threads, sh.pixels)};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

int color_distort(const float* img, const float* factors, const int* sched,
                  float* out, int n, int hw, float m0, float m1, float m2,
                  float s0, float s1, float s2, cudaStream_t stream) {
  if (n < 1 || hw < 1 || hw > MAX_HW) return (int)cudaErrorInvalidValue;
  const Shape sh = shape_of(hw);
  cudaError_t err;
  if (sh.threads == 256)
    err = launch<256, 4>(img, factors, sched, out, n, hw, m0, m1, m2, s0, s1,
                         s2, stream);
  else if (sh.threads == 1024)
    err = launch<1024, 9>(img, factors, sched, out, n, hw, m0, m1, m2, s0,
                          s1, s2, stream);
  else
    err = launch<512, 32>(img, factors, sched, out, n, hw, m0, m1, m2, s0,
                          s1, s2, stream);
  return (int)err;
}

#ifdef SIMCLR_B2_TRACE
// Copies the phase clocks of the last launch's first TRACE_BLOCKS blocks
// into out (TRACE_FIELDS a block, B2_MARK's order); returns TRACE_BLOCKS.
int color_trace(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, b2_trace, sizeof(b2_trace));
  return err == cudaSuccess ? TRACE_BLOCKS : -(int)err;
}
#endif

}  // extern "C"
