// NT-Xent loss, forward and backward, for Hopper (sm_90a).
//
// Replaces simclr_tpu/ops/pallas/ntxent.py: _fwd_kernel (pallas_call at
// line 114) and _bwd_kernel (pallas_call at line 137).
//
// z is (n2, d) float32, already L2-normalised, row-major. S = z z^T / T with
// the self-diagonal set to -1e9; the positive of row i is column
// (i + n2/2) mod n2.
//
// Design. The Pallas kernel holds the whole n2 x n2 matrix in VMEM, which is
// why its supports() refuses n2 = 2048. Here one block owns BR rows and
// streams the columns in tiles of BC, keeping an online row max and sum
// (flash-attention style), so no n2 x n2 buffer exists and n2 has no upper
// limit. Feature dimensions are streamed in chunks of DK through shared
// memory, so the forward has no limit on d either.
//
// Backward. S and the mask are symmetric, and the positive map is an
// involution, so G + G^T at (i, j) is
//   exp(s_ij - lse_i) + exp(s_ij - lse_j) - 2 [j == pos(i)],
// and dz_i = g / (n2 T) * sum_j (G + G^T)_ij z_j needs only row i's block
// and the column lse from the forward residual: one pass per row block,
// no atomics, deterministic. The BR x d accumulator lives in dynamic shared
// memory, which bounds d (see ntxent_max_dim).
//
// What bounds it on the H100. At n2 = 1024, d = 128 the forward does
// 2 n2^2 d = 268 MFLOP on 0.5 MB of input, far above the card's
// operations-per-byte balance; the products run in full float32 on the
// CUDA cores (67 TFLOP/s peak), not on the tensor cores, because the loss
// must agree with the float32 reference. So it is bound by operations.
// This first version is simple: scalar FMAs from shared-memory tiles, no
// wgmma or TMA, and z is re-read from L2 for every column tile.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int BR = 16;        // rows of z per block
constexpr int BC = 64;        // columns per streamed tile
constexpr int DK = 32;        // feature chunk staged in shared memory
constexpr int LANES = 16;     // threads that share one row
constexpr int THREADS = BR * LANES;
constexpr int CPT = BC / LANES;  // columns per thread in a tile
constexpr float NEG = -1e9f;
constexpr int MAX_DIM = 2048;  // BR * MAX_DIM * 4 B = 128 KiB accumulator

// Thread (tr, tc) = (tid / LANES, tid % LANES) computes s[row0 + tr][col]
// for col = col0 + tc + LANES * j, j < CPT, as an unscaled dot product.
__device__ __forceinline__ void dot_tile(
    const float* __restrict__ z, int n2, int d, int row0, int col0,
    float (*sr)[DK + 1], float (*sc)[DK + 1], float acc[CPT]) {
  const int t = threadIdx.x, tr = t / LANES, tc = t % LANES;
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += DK) {
    __syncthreads();  // earlier readers of sr/sc are done
    for (int e = t; e < BR * DK; e += THREADS) {
      const int r = e / DK, k = e % DK, gr = row0 + r, gk = k0 + k;
      sr[r][k] = (gr < n2 && gk < d) ? z[(size_t)gr * d + gk] : 0.f;
    }
    for (int e = t; e < BC * DK; e += THREADS) {
      const int c = e / DK, k = e % DK, gc = col0 + c, gk = k0 + k;
      sc[c][k] = (gc < n2 && gk < d) ? z[(size_t)gc * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < DK; ++k) {
      const float a = sr[tr][k];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        acc[j] = fmaf(a, sc[tc + LANES * j][k], acc[j]);
    }
  }
}

// Reductions over the LANES threads of one row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
ntxent_fwd_kernel(const float* __restrict__ z, float* __restrict__ row_loss,
                  float* __restrict__ correct, float* __restrict__ lse_out,
                  int n2, int d, float inv_t) {
  __shared__ float sr[BR][DK + 1];
  __shared__ float sc[BC][DK + 1];
  const int tr = threadIdx.x / LANES, tc = threadIdx.x % LANES;
  const int row0 = blockIdx.x * BR, row = row0 + tr;
  const int pos = (row + n2 / 2) % n2;

  float m = -INFINITY, l = 0.f, s_pos = -INFINITY;
  for (int col0 = 0; col0 < n2; col0 += BC) {
    float s[CPT];
    dot_tile(z, n2, d, row0, col0, sr, sc, s);
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = col0 + tc + LANES * j;
      if (col >= n2) {
        s[j] = -INFINITY;  // outside the matrix: contributes nothing
      } else {
        s[j] *= inv_t;
        if (col == row) s[j] = NEG;
        if (col == pos) s_pos = s[j];
      }
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, row_max(tile_max));
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) part += expf(s[j] - m_new);
    l = l * expf(m - m_new) + row_sum(part);
    m = m_new;
  }
  s_pos = row_max(s_pos);  // exactly one lane saw the positive
  if (tc == 0 && row < n2) {
    const float lse = logf(l) + m;
    row_loss[row] = lse - s_pos;
    correct[row] = s_pos >= m ? 1.f : 0.f;  // ties count as correct
    lse_out[row] = lse;
  }
}

__global__ void __launch_bounds__(THREADS)
ntxent_bwd_kernel(const float* __restrict__ z, const float* __restrict__ lse,
                  const float* __restrict__ g, float* __restrict__ dz,
                  int n2, int d, float inv_t) {
  extern __shared__ float acc[];  // [BR][d]
  __shared__ float sr[BR][DK + 1];
  __shared__ float sc[BC][DK + 1];
  __shared__ float w[BR][BC + 1];
  const int t = threadIdx.x, tr = t / LANES, tc = t % LANES;
  const int row0 = blockIdx.x * BR, row = row0 + tr;
  const int pos = (row + n2 / 2) % n2;
  const float lse_row = row < n2 ? lse[row] : 0.f;

  for (int e = t; e < BR * d; e += THREADS) acc[e] = 0.f;
  for (int col0 = 0; col0 < n2; col0 += BC) {
    float s[CPT];
    dot_tile(z, n2, d, row0, col0, sr, sc, s);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = col0 + tc + LANES * j;
      float wv = 0.f;
      if (row < n2 && col < n2) {
        const float sv = col == row ? NEG : s[j] * inv_t;
        wv = expf(sv - lse_row) + expf(sv - lse[col]);
        if (col == pos) wv -= 2.f;
      }
      w[tr][tc + LANES * j] = wv;
    }
    // acc[r][:] += sum_c w[r][c] * z[col0 + c][:], a chunk of d at a time.
    for (int k0 = 0; k0 < d; k0 += DK) {
      __syncthreads();  // w is written; readers of sc are done
      for (int e = t; e < BC * DK; e += THREADS) {
        const int c = e / DK, k = e % DK, gc = col0 + c, gk = k0 + k;
        sc[c][k] = (gc < n2 && gk < d) ? z[(size_t)gc * d + gk] : 0.f;
      }
      __syncthreads();
      for (int e = t; e < BR * DK; e += THREADS) {
        const int r = e / DK, k = e % DK;
        if (k0 + k >= d) continue;
        float a = 0.f;
#pragma unroll 8
        for (int c = 0; c < BC; ++c) a = fmaf(w[r][c], sc[c][k], a);
        acc[r * d + k0 + k] += a;
      }
    }
  }
  __syncthreads();
  const float scale = g[0] * inv_t / (float)n2;
  for (int e = t; e < BR * d; e += THREADS) {
    const int r = e / d, gr = row0 + r;
    if (gr < n2) dz[(size_t)gr * d + e % d] = acc[e] * scale;
  }
}

// Lets the backward kernel take the largest accumulator, once per device
// (the attribute depends on nothing that changes between launches).
cudaError_t allow_max_smem() {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> done[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(ntxent_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BR * MAX_DIM * (int)sizeof(float));
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true);
  return err;
}

}  // namespace

extern "C" {

int ntxent_max_dim() { return MAX_DIM; }

// Per-row loss (lse - s_pos), correctness (s_pos >= row max) and lse.
int ntxent_fwd(const float* z, float* row_loss, float* correct, float* lse,
               int n2, int d, float inv_t, cudaStream_t stream) {
  const int blocks = (n2 + BR - 1) / BR;
  ntxent_fwd_kernel<<<blocks, THREADS, 0, stream>>>(
      z, row_loss, correct, lse, n2, d, inv_t);
  return (int)cudaGetLastError();
}

// dz of g * mean(row_loss); g is a one-element device tensor.
int ntxent_bwd(const float* z, const float* lse, const float* g, float* dz,
               int n2, int d, float inv_t, cudaStream_t stream) {
  if (d > MAX_DIM) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_max_smem();
  if (err != cudaSuccess) return (int)err;
  const int smem = BR * d * (int)sizeof(float);
  const int blocks = (n2 + BR - 1) / BR;
  ntxent_bwd_kernel<<<blocks, THREADS, smem, stream>>>(
      z, lse, g, dz, n2, d, inv_t);
  return (int)cudaGetLastError();
}

}  // extern "C"
