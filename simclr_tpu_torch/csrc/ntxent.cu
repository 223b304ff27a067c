// NT-Xent loss, forward (B1f) and backward (B1b), for Hopper (sm_90a).
//
// Replaces simclr_tpu/ops/pallas/ntxent.py: _fwd_kernel (pallas_call at
// line 114) and _bwd_kernel (pallas_call at line 137).
//
// z is (n2, d) float32, already L2-normalised, row-major. S = z z^T / T with
// the self-diagonal set to -1e9; the positive of row i is column
// (i + n2/2) mod n2. The forward gives each row's loss lse - s_pos, its
// correctness (s_pos >= row max, ties correct) and lse. The backward
// recomputes S: S and the mask are symmetric and the positive map is an
// involution, so with G = softmax(S) - onehot(pos),
//   (G + G^T)_ij = W_ij
//                = exp(s_ij - lse_i) + exp(s_ij - lse_j) - 2 [j == pos(i)]
// and dz = g / (n2 T) * W z needs only the rows' and columns' lse.
//
// What bounds it on the H100. At n2 = 1024, d = 128 the forward's product
// is 2 n2^2 d = 268 MFLOP on 0.5 MB of z and the backward's twice that:
// far above the card's operations-per-byte balance, so the work is bound
// by operations: 4.0 / 8.0 us at the 67 TFLOP/s of float32 FMAs, 1.6 /
// 3.3 us as three tf32 products at 495 TFLOP/s. The earlier kernel ran
// float32 FMAs from shared memory on 64 blocks of 16 rows (half the SMs)
// and took 0.149 / 0.291 ms. This one runs the products on the tensor
// cores; what holds it back now is the blocks' serial phases: staging
// from L2 (every block reads its 64 rows and its columns: z 20 times over
// the grid), each tile's products (at the tensor cores' rate in the
// forward, shared-memory bound at N = 32 in the backward), the epilogues,
// and two cluster barriers.
//
// Why 3xTF32. One TF32 product keeps 11 significant bits of each operand:
// emulated at the main path's shape (tests/test_torch_ntxent_geometry.py,
// chip_smoke.py's inputs), it puts the per-row loss 1.8e-4 off the float32
// plain version and dz 5.0e-4 of max|dz| off, against chip_smoke.py's
// tolerances of 2e-5 and 1e-4. Splitting every operand x into
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest (the tensor
// core would truncate), and summing lo*hi + hi*lo + hi*hi into one float32
// accumulator (the small terms first) keeps about 22 bits: 1.4e-6 and
// 1.3e-6 in the same emulation. Three products at 495 TFLOP/s still beat
// one at 67.
//
// Design.
// * Grid: a block owns 64 rows of z (one wgmma M) and runs two warpgroups;
//   a cluster of CL = 4 blocks covers the columns in 4 ranges of
//   ceil(n2 / 4) columns rounded up to the column tile, one range a block
//   (a range past the end contributes nothing). At n2 = 1024 that is 16
//   clusters, 64 blocks of two forward column tiles each. With 192 KB of
//   shared memory a block (one block an SM) an H100 holds only 15 clusters
//   of 8 at once (its GPCs; chip_smoke.py's build phase prints
//   ntxent_max_active_clusters), so clusters of 8 would run 2N = 1024's 16
//   in two waves; all 16 clusters of 4 are resident. The backward adds a
//   grid dimension over 128-wide blocks of dz's features (one at
//   d <= 128); each recomputes S.
// * Staging: z (0.5 MB) stays in L2. A chunk of 128 features of the row
//   tile and of a column tile comes in by TMA (32-float boxes with the
//   128-byte swizzle, zeros outside z) where d % 4 == 0, by scalar loads
//   otherwise; every element then passes once through registers, where it
//   is split into hi and lo and stored as K-major tiles with the 128-byte
//   swizzle (hi in place). A column tile of the backward is also stored
//   transposed ([feature][column]): tf32 wgmma reads shared-memory
//   operands K-major only. The staging is bound by L2: every block reads
//   its 64 rows and its columns, 20 times z over the grid at n2 = 1024.
// * Products: wgmma m64nNk8 tf32, three per k-step, into a fresh
//   accumulator for each chunk of 128 features; the chunks are summed in
//   float32, because the tensor core truncates where it accumulates and a
//   long sum drifts (1.1e-5 of the loss at d = 2048 in one accumulator).
// * Forward: warpgroup w takes columns [64 w, 64 w + 64) of a 128-column
//   tile. On the fragments: inv_t, the diagonal's NEG, -inf past the end
//   (a zero column would add exp(-m)), the positive captured, online row
//   max and sum by quad shuffles. Each warpgroup stores its rows'
//   (m, l, s_pos); after a cluster barrier the block of rank r combines
//   its share of the rows over the cluster's 16 parts through distributed
//   shared memory, in a fixed shuffle tree, and writes loss, correctness
//   and lse: one launch, no atomics, the same bits every run.
// * Backward: warpgroup w takes columns [32 w, 32 w + 32) of a 64-column
//   tile: S recomputed, W formed on the fragments (0 outside the matrix)
//   and split into hi and lo in registers, which are the A operand of
//   dz_part += W Z_cols (N = 128 features, K = its columns, B the
//   transposed tile). The register A fragment pairs columns t and t + 4
//   where the accumulator holds 2 t and 2 t + 1, so the transposed tile
//   stores column 8 j + c at K position 8 j + kpos(c) and no register
//   moves. The two warpgroups' partial dz (64 x 128 float32) are added in
//   shared memory; rank r sums its rows over the ranks in rank order,
//   scales by g inv_t / n2 (g read on the device) and stores dz.
// * Shared memory: forward 64 + 128 KB of hi/lo tiles, backward 3 x 64 KB
//   (rows, columns, transposed columns); one block an SM.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using simclr::aligned16;
using simclr::cluster_rank;
using simclr::cluster_sync;
using simclr::desc_sw128;
using simclr::fence_operands;
using simclr::fence_proxy_async;
using simclr::ld_cluster;
using simclr::ld_cluster_v4;
using simclr::map_rank;
using simclr::mbar_expect_tx;
using simclr::mbar_fence_init;
using simclr::mbar_init;
using simclr::mbar_wait;
using simclr::smem_addr;
using simclr::start_acc;
using simclr::tf32_rna;
using simclr::tma_load_2d;
using simclr::warp_index;
using simclr::wgmma_commit;
using simclr::wgmma_fence;
using simclr::wgmma_tf32;
using simclr::wgmma_tf32_rs;
using simclr::wgmma_wait;

constexpr int BR = 64;        // rows of z per block
constexpr int DK = 128;       // features per staged chunk / dz block
constexpr int WGS = 2;        // warpgroups a block
constexpr int THREADS = 128 * WGS;
constexpr int FWD_BC = 128;   // forward column tile, 64 columns a warpgroup
constexpr int BWD_BC = 64;    // backward column tile, 32 columns a warpgroup
constexpr int CL = 4;         // blocks a cluster, one column range each
constexpr int RANK_ROWS = BR / CL;  // rows a rank combines over the cluster
constexpr int BOX_ROWS = 64;  // rows of a TMA box (32 floats wide)
constexpr float NEG = -1e9f;
constexpr int MAX_DIM = 2048;  // the gate's limit (ops/kernels/ntxent.py)

__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * DK * 4;
}
constexpr int FWD_STATS = 2 * tile_bytes(BR) + 2 * tile_bytes(FWD_BC);
constexpr int FWD_BARS = FWD_STATS + WGS * 3 * BR * 4;
constexpr int FWD_SMEM = FWD_BARS + 16;
constexpr int BWD_BARS = 2 * tile_bytes(BR) + 4 * tile_bytes(BWD_BC);
constexpr int BWD_SMEM = BWD_BARS + 16;
constexpr int RED_LD = DK + 8;  // padded row of the backward's partial dz
static_assert(BR * RED_LD * 4 <= BWD_BARS, "partial dz fits");

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Columns of each of a row tile's CL ranges (one a block of its cluster).
__host__ __device__ inline int range_cols(int n2, int bc) {
  return cdiv(cdiv(n2, CL), bc) * bc;
}

// Byte offset of float4 chunk q (features 4 q .. 4 q + 3) of row m in a
// K-major tile of `rows` rows with the 128-byte swizzle: atom columns of
// 32 floats (rows x 128 bytes each), chunk q % 8 of row m at 16-byte slot
// (q % 8) ^ (m % 8).
__device__ __forceinline__ int sw_offset(int rows, int m, int q) {
  return (q >> 3) * rows * 128 + m * 128 + (((q & 7) ^ (m & 7)) << 4);
}

// K position of column c within the transposed tile (see the header).
__device__ __forceinline__ int kpos(int c) {
  return (c & ~7) | ((c & 7) >> 1) | ((c & 1) << 2);
}

// Four features of z from k on (zeros past the end), by scalar loads:
// the path for d % 4 != 0, where TMA cannot read z.
__device__ __forceinline__ float4 load4(const float* __restrict__ z, int n2,
                                        int d, int row, int k) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < n2 && k < d) {
    const float* p = z + static_cast<size_t>(row) * d + k;
    v.x = __ldg(p);
    if (k + 1 < d) v.y = __ldg(p + 1);
    if (k + 2 < d) v.z = __ldg(p + 2);
    if (k + 3 < d) v.w = __ldg(p + 3);
  }
  return v;
}

// x, as a value the compiler cannot see through: what is computed from it
// after this point stays after it. The tile loops would otherwise hoist
// every staging address and wgmma descriptor they can (two registers a
// descriptor, 48 of them a product) and spill.
template <typename T>
__device__ __forceinline__ T opaque(T x) {
  if constexpr (sizeof(T) == 8)
    asm volatile("" : "+l"(x));
  else
    asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(tf32_rna(x));
}

// Splits a tile of ROWS rows x DK features of z into its K-major hi and lo
// tiles (swizzled as sw_offset), from the float32 values TMA left in hi
// (FROM_Z false) or from z itself (rows [g0, g0 + ROWS), features
// [k0, k0 + DK), by scalar loads); with TRANS also into hi_t and lo_t,
// [feature][row] tiles of DK rows and K = ROWS (K position kpos(row)). A
// warp takes 16 rows x 2 float4 chunks a step, conflict-free in both
// layouts; all warps of the block take part.
template <int ROWS, bool TRANS, bool FROM_Z>
__device__ __forceinline__ void split_tile(
    const float* __restrict__ z, int n2, int d, int g0, int k0, int warp,
    unsigned char* hi, unsigned char* lo, unsigned char* hi_t,
    unsigned char* lo_t) {
  constexpr int GROUPS = ROWS / 16;
  constexpr int ITERS = ROWS / (THREADS / 32);  // ROWS warp steps
  constexpr int BATCH = ITERS < 8 ? ITERS : 8;
  const int lane = opaque(static_cast<int>(threadIdx.x)) & 31;
  const int mi = lane & 15, qi = lane >> 4;
  warp = opaque(warp);
#pragma unroll
  for (int i0 = 0; i0 < ITERS; i0 += BATCH) {
    float4 v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int u = (THREADS / 32) * (i0 + b) + warp;
      const int m = 16 * (u % GROUPS) + mi, q = 2 * (u / GROUPS) + qi;
      v[b] = FROM_Z ? load4(z, n2, d, g0 + m, k0 + 4 * q)
                    : *reinterpret_cast<const float4*>(
                          hi + sw_offset(ROWS, m, q));
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int u = (THREADS / 32) * (i0 + b) + warp;
      const int m = 16 * (u % GROUPS) + mi, q = 2 * (u / GROUPS) + qi;
      const float x[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
      float h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = tf32_hi(x[i]);
        l[i] = tf32_hi(x[i] - h[i]);
      }
      const int off = sw_offset(ROWS, m, q);
      *reinterpret_cast<float4*>(hi + off) =
          make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(lo + off) =
          make_float4(l[0], l[1], l[2], l[3]);
      if (TRANS) {
        const int p = kpos(m);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = 4 * q + i;
          const int t_off = sw_offset(DK, k, p >> 2) + ((p & 3) << 2);
          *reinterpret_cast<float*>(hi_t + t_off) = h[i];
          *reinterpret_cast<float*>(lo_t + t_off) = l[i];
        }
      }
    }
    // No loads of the next batch above these stores: a batch in flight
    // is 32 registers.
    asm volatile("" ::: "memory");
  }
}

// Shared-memory tiles of a block and the barriers of their TMA loads.
struct Tiles {
  unsigned char *row_hi, *row_lo, *col_hi, *col_lo, *colt_hi, *colt_lo;
  uint64_t* bar;    // [0]: the row tile's loads, [1]: the column tile's
  uint32_t phase;   // bit b: the parity bar[b] waits for next
};

// Box loads of rows [r0, r0 + rows) x features [k0, k0 + DK) of z into a
// tile at dst (four atom columns of rows x 128 bytes), one barrier.
__device__ __forceinline__ void load_boxes(const CUtensorMap* zmap,
                                           unsigned char* dst, uint64_t* bar,
                                           int rows, int r0, int k0) {
  mbar_expect_tx(bar, rows * DK * 4);
  for (int a = 0; a < DK / 32; ++a)
    for (int h = 0; h < rows; h += BOX_ROWS)
      tma_load_2d(dst + a * rows * 128 + h * 128, zmap, bar, k0 + 32 * a,
                  r0 + h);
}

// The row tile (where `rows`) and the column tile from c0 of feature chunk
// [k0, k0 + DK), split into hi and lo, the column tile also transposed
// where TRANS; then visible to wgmma. With tma, the chunks come in by TMA
// (d % 4 == 0), otherwise by scalar loads.
template <int ROWS, bool TRANS>
__device__ __forceinline__ void stage(const CUtensorMap* zmap,
                                      const float* __restrict__ z, int n2,
                                      int d, bool tma, bool rows, int row0,
                                      int c0, int k0, int warp, Tiles& tl) {
  if (tma) {
    if (threadIdx.x == 0) {
      if (rows) load_boxes(zmap, tl.row_hi, &tl.bar[0], BR, row0, k0);
      load_boxes(zmap, tl.col_hi, &tl.bar[1], ROWS, c0, k0);
    }
    if (rows) {
      mbar_wait(&tl.bar[0], tl.phase & 1);
      tl.phase ^= 1;
      split_tile<BR, false, false>(z, n2, d, row0, k0, warp, tl.row_hi,
                                   tl.row_lo, nullptr, nullptr);
    }
    mbar_wait(&tl.bar[1], (tl.phase >> 1) & 1);
    tl.phase ^= 2;
    split_tile<ROWS, TRANS, false>(z, n2, d, c0, k0, warp, tl.col_hi,
                                   tl.col_lo, tl.colt_hi, tl.colt_lo);
  } else {
    if (rows)
      split_tile<BR, false, true>(z, n2, d, row0, k0, warp, tl.row_hi,
                                  tl.row_lo, nullptr, nullptr);
    split_tile<ROWS, TRANS, true>(z, n2, d, c0, k0, warp, tl.col_hi,
                                  tl.col_lo, tl.colt_hi, tl.colt_lo);
  }
  fence_proxy_async();
  __syncthreads();
}

// acc = the 3xTF32 product of the 64-row A tile and N rows of a B tile of
// B_ROWS rows (from row b0 on) over their DK features (16 k-steps of 8):
// lo*hi, hi*lo, then hi*hi. acc is a fresh accumulator: the tensor core
// truncates where it adds, so a long sum in one accumulator drifts (by
// 1.1e-5 of the loss at D = 2048); the callers add chunks of DK in float32.
template <int N, int B_ROWS>
__device__ __forceinline__ void product(float (&acc)[N / 2],
                                        const unsigned char* a_hi,
                                        const unsigned char* a_lo,
                                        const unsigned char* b_hi,
                                        const unsigned char* b_lo, int b0) {
  start_acc(acc);
  const uint64_t ah = desc_sw128(a_hi, 16, 1024);
  const uint64_t al = desc_sw128(a_lo, 16, 1024);
  const uint64_t bh = desc_sw128(b_hi + b0 * 128, 16, 1024);
  const uint64_t bl = desc_sw128(b_lo + b0 * 128, 16, 1024);
#pragma unroll
  for (int s = 0; s < DK / 8; ++s) {
    // Descriptor addresses count 16 bytes: atom column s / 4, 32 bytes a
    // k-step within it.
    const int oa = (s >> 2) * BR * 8 + (s & 3) * 2;
    const int ob = (s >> 2) * B_ROWS * 8 + (s & 3) * 2;
    wgmma_tf32(acc, opaque(al) + oa, opaque(bh) + ob, 1);
    wgmma_tf32(acc, opaque(ah) + oa, opaque(bl) + ob, 1);
    wgmma_tf32(acc, opaque(ah) + oa, opaque(bh) + ob, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S (64 rows x N columns of this warpgroup, from column c0 + b0) over all
// of d: chunks of DK staged and multiplied, summed in float32.
template <int N, int B_ROWS, bool TRANS>
__device__ __forceinline__ void similarity(
    float (&sum)[N / 2], const CUtensorMap* zmap, const float* z, int n2,
    int d, bool tma, int row0, int c0, bool first_tile, int fb, int warp,
    int b0, Tiles& tl) {
  const int nk = cdiv(d, DK);
  for (int kc = 0; kc < nk; ++kc) {
    __syncthreads();  // every warpgroup's products of the tiles are done
    const bool rows = nk > 1 || first_tile;
    if (TRANS && kc == fb)
      stage<B_ROWS, true>(zmap, z, n2, d, tma, rows, row0, c0, kc * DK,
                          warp, tl);
    else
      stage<B_ROWS, false>(zmap, z, n2, d, tma, rows, row0, c0, kc * DK,
                           warp, tl);
    float acc[N / 2];
    product<N, B_ROWS>(acc, tl.row_hi, tl.row_lo, tl.col_hi, tl.col_lo, b0);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) sum[e] = kc ? sum[e] + acc[e] : acc[e];
  }
}

// Barriers of the TMA loads, at `at` in shared memory.
__device__ __forceinline__ uint64_t* init_barriers(unsigned char* at) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(at);
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  return bar;
}

__global__ void __launch_bounds__(THREADS, 1)
ntxent_fwd_kernel(const __grid_constant__ CUtensorMap zmap,
                  const float* __restrict__ z, float* __restrict__ row_loss,
                  float* __restrict__ correct, float* __restrict__ lse_out,
                  int n2, int d, float inv_t, int tma) {
  constexpr int N = FWD_BC / WGS;  // columns of a warpgroup
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_addr(smem) & 1023) __trap();
  Tiles tl;
  tl.row_hi = smem;
  tl.row_lo = tl.row_hi + tile_bytes(BR);
  tl.col_hi = tl.row_lo + tile_bytes(BR);
  tl.col_lo = tl.col_hi + tile_bytes(FWD_BC);
  tl.colt_hi = tl.colt_lo = nullptr;
  // (m, l, s_pos) of each warpgroup's columns: [wg][3][BR].
  float* stats = reinterpret_cast<float*>(smem + FWD_STATS);
  tl.bar = init_barriers(smem + FWD_BARS);
  tl.phase = 0;

  const int rank = static_cast<int>(cluster_rank());
  const int row0 = (blockIdx.x / CL) * BR;
  const int range = range_cols(n2, FWD_BC);
  const int c_begin = rank * range, c_end = min(c_begin + range, n2);
  const int warp = warp_index(), wg = warp >> 2, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int row[2], pos[2];
  float m[2], l[2], s_pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = row0 + 16 * (warp & 3) + g + 8 * h;
    pos[h] = (row[h] + n2 / 2) % n2;
    m[h] = -INFINITY;
    l[h] = 0.f;
    s_pos[h] = -INFINITY;
  }

  for (int c0 = c_begin; c0 < c_end; c0 += FWD_BC) {
    float acc[N / 2];
    similarity<N, FWD_BC, false>(acc, &zmap, z, n2, d, tma, row0, c0,
                                 c0 == c_begin, 0, warp, wg * N, tl);
    // acc[4 j + e]: row row[e / 2], column c0 + N wg + 8 j + 2 t + e % 2.
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = c0 + N * wg + 8 * j + 2 * t + (e & 1);
        float s = -INFINITY;  // past the end: contributes nothing
        if (col < c_end) {
          s = col == row[h] ? NEG : acc[4 * j + e] * inv_t;
          if (col == pos[h]) s_pos[h] = s;
        }
        acc[4 * j + e] = s;
        tile_max[h] = fmaxf(tile_max[h], s);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(tile_max[h]));
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        part += expf(acc[4 * j + 2 * h] - m_new) +
                expf(acc[4 * j + 2 * h + 1] - m_new);
      const float tile_sum = quad_sum(part);
      // A warpgroup whose columns all lie past the end keeps m = -inf.
      if (m_new > -INFINITY) {
        l[h] = l[h] * expf(m[h] - m_new) + tile_sum;
        m[h] = m_new;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s_pos[h] = quad_max(s_pos[h]);  // one lane of one rank saw it
    if (t == 0) {
      const int r = 16 * (warp & 3) + g + 8 * h;
      stats[(3 * wg) * BR + r] = m[h];
      stats[(3 * wg + 1) * BR + r] = l[h];
      stats[(3 * wg + 2) * BR + r] = s_pos[h];
    }
  }
  cluster_sync();
  // Rank r combines rows [RANK_ROWS r, RANK_ROWS r + RANK_ROWS): thread
  // (row, p) reads part p (rank p / WGS, warpgroup p % WGS) of its row;
  // the parts meet in a fixed shuffle tree (the same bits every run).
  constexpr int PARTS = CL * WGS;
  static_assert(RANK_ROWS * PARTS <= THREADS && 32 % PARTS == 0, "parts");
  if (threadIdx.x < RANK_ROWS * PARTS) {
    const int p = threadIdx.x % PARTS;
    const int r = rank * RANK_ROWS + threadIdx.x / PARTS, gr = row0 + r;
    const uint32_t at =
        map_rank(smem_addr(stats + (3 * (p % WGS)) * BR + r), p / WGS);
    const float mp = ld_cluster(at), lp = ld_cluster(at + 4 * BR);
    float sp = ld_cluster(at + 8 * BR), mx = mp;
#pragma unroll
    for (int o = PARTS / 2; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      sp = fmaxf(sp, __shfl_xor_sync(0xffffffffu, sp, o));
    }
    float sum = lp * expf(mp - mx);
#pragma unroll
    for (int o = PARTS / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (p == 0 && gr < n2) {
      const float lse = logf(sum) + mx;
      row_loss[gr] = lse - sp;
      correct[gr] = sp >= mx ? 1.f : 0.f;  // ties count as correct
      lse_out[gr] = lse;
    }
  }
  cluster_sync();  // no block leaves while a peer reads its statistics
}

__global__ void __launch_bounds__(THREADS, 1)
ntxent_bwd_kernel(const __grid_constant__ CUtensorMap zmap,
                  const float* __restrict__ z, const float* __restrict__ lse,
                  const float* __restrict__ g_scale, float* __restrict__ dz,
                  int n2, int d, float inv_t, int tma) {
  constexpr int N = BWD_BC / WGS;  // columns of S a warpgroup
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_addr(smem) & 1023) __trap();
  Tiles tl;
  tl.row_hi = smem;
  tl.row_lo = tl.row_hi + tile_bytes(BR);
  tl.col_hi = tl.row_lo + tile_bytes(BR);
  tl.col_lo = tl.col_hi + tile_bytes(BWD_BC);
  tl.colt_hi = tl.col_lo + tile_bytes(BWD_BC);
  tl.colt_lo = tl.colt_hi + tile_bytes(BWD_BC);
  tl.bar = init_barriers(smem + BWD_BARS);
  tl.phase = 0;

  const int rank = static_cast<int>(cluster_rank());
  const int row0 = (blockIdx.x / CL) * BR;
  const int fb = blockIdx.y;  // dz features [fb DK, fb DK + DK)
  const int range = range_cols(n2, BWD_BC);
  const int c_begin = rank * range, c_end = min(c_begin + range, n2);
  const int warp = warp_index(), wg = warp >> 2, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int row[2], pos[2];
  float lse_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = row0 + 16 * (warp & 3) + g + 8 * h;
    pos[h] = (row[h] + n2 / 2) % n2;
    lse_row[h] = row[h] < n2 ? __ldg(lse + row[h]) : 0.f;
  }

  // This warpgroup's partial dz over its columns of every tile: row
  // row[e / 2], feature fb DK + 8 j + 2 t + e % 2.
  float dacc[DK / 2];
  start_acc(dacc);
  for (int c0 = c_begin; c0 < c_end; c0 += BWD_BC) {
    float sacc[N / 2];
    similarity<N, BWD_BC, true>(sacc, &zmap, z, n2, d, tma, row0, c0,
                                c0 == c_begin, fb, warp, wg * N, tl);
    // W on the fragments, split: A fragment of k-step j is columns
    // c0 + N wg + 8 j + 2 t (a[0], a[1]: rows g, g + 8) and + 1 (a[2],
    // a[3]).
    uint32_t a_hi[N / 8][4], a_lo[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int col = c0 + N * wg + 8 * j + 2 * t + b;
        const float lse_col = col < c_end ? __ldg(lse + col) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float w = 0.f;
          if (row[h] < n2 && col < c_end) {
            const float s =
                col == row[h] ? NEG : sacc[4 * j + 2 * h + b] * inv_t;
            w = expf(s - lse_row[h]) + expf(s - lse_col);
            if (col == pos[h]) w -= 2.f;
          }
          const float hi = tf32_hi(w);
          a_hi[j][2 * b + h] = __float_as_uint(hi);
          a_lo[j][2 * b + h] = tf32_rna(w - hi);
        }
      }
    }
    // dz_part += W Z over this warpgroup's columns: K positions
    // [N wg, N wg + N) of the transposed tile, its atom column wg.
    const uint64_t bh = desc_sw128(tl.colt_hi + wg * DK * 128, 16, 1024);
    const uint64_t bl = desc_sw128(tl.colt_lo + wg * DK * 128, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int ob = (j & 3) * 2;
      wgmma_tf32_rs(dacc, a_lo[j], opaque(bh) + ob, 1);
      wgmma_tf32_rs(dacc, a_hi[j], opaque(bl) + ob, 1);
      wgmma_tf32_rs(dacc, a_hi[j], opaque(bh) + ob, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dacc);
  }

  // The block's partial dz, warpgroup 0's plus warpgroup 1's, in shared
  // memory where the tiles were.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int step = 0; step < WGS; ++step) {
    if (wg == step) {
#pragma unroll
      for (int j = 0; j < DK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* p = reinterpret_cast<float2*>(
              red + (16 * (warp & 3) + g + 8 * h) * RED_LD + 8 * j + 2 * t);
          const float2 v = step ? *p : make_float2(0.f, 0.f);
          *p = make_float2(v.x + dacc[4 * j + 2 * h],
                           v.y + dacc[4 * j + 2 * h + 1]);
        }
    }
    __syncthreads();
  }
  cluster_sync();
  // Rank r sums rows [RANK_ROWS r, RANK_ROWS r + RANK_ROWS) over the
  // ranks, in rank order.
  const float scale = __ldg(g_scale) * inv_t / static_cast<float>(n2);
  for (int idx = threadIdx.x; idx < RANK_ROWS * DK / 4; idx += THREADS) {
    const int r = rank * RANK_ROWS + idx / (DK / 4), f4 = idx % (DK / 4);
    const uint32_t at = smem_addr(red + r * RED_LD + 4 * f4);
    float4 v[CL];
#pragma unroll
    for (int q = 0; q < CL; ++q) v[q] = ld_cluster_v4(map_rank(at, q));
    float4 s = v[0];
#pragma unroll
    for (int q = 1; q < CL; ++q) {
      s.x += v[q].x;
      s.y += v[q].y;
      s.z += v[q].z;
      s.w += v[q].w;
    }
    const int gr = row0 + r, k = fb * DK + 4 * f4;
    if (gr < n2 && k < d) {
      float* p = dz + static_cast<size_t>(gr) * d + k;
      const float o[4] = {s.x * scale, s.y * scale, s.z * scale, s.w * scale};
      if (tma) {  // d % 4 == 0, aligned
        *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k + i < d) p[i] = o[i];
      }
    }
  }
  cluster_sync();  // no block leaves while a peer reads its partial dz
}

simclr::SmemOptIn fwd_smem, bwd_smem;

bool valid(int n2, int d) {
  return n2 >= 2 && n2 % 2 == 0 && d >= 1 && d <= MAX_DIM &&
         static_cast<long long>(n2) * d < (1LL << 31);
}

}  // namespace

extern "C" {

int ntxent_max_dim() { return MAX_DIM; }

// The tiling of kernel 0 (forward) or 1 (backward) at (n2, d), as
// ops/kernels/ntxent.py:geometry mirrors it: rows a block, row tiles
// (clusters), blocks a cluster (column ranges), columns a range, column
// tile, features a chunk, feature chunks, grid.y (dz feature blocks).
int ntxent_geometry(int n2, int d, int kernel, int* out) {
  if (!valid(n2, d) || (kernel != 0 && kernel != 1))
    return (int)cudaErrorInvalidValue;
  const int bc = kernel ? BWD_BC : FWD_BC;
  const int v[8] = {BR, cdiv(n2, BR), CL, range_cols(n2, bc),
                    bc, DK, cdiv(d, DK), kernel ? cdiv(d, DK) : 1};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// How many clusters of `cluster` blocks (1-8) of kernel 0 (forward) or 1
// (backward) the current device holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code: the
// launches take clusters of CL; other sizes are asked for comparison.
int ntxent_max_active_clusters(int kernel, int cluster) {
  if ((kernel != 0 && kernel != 1) || cluster < 1 || cluster > 8)
    return -(int)cudaErrorInvalidValue;
  const int smem = kernel ? BWD_SMEM : FWD_SMEM;
  cudaError_t err = kernel ? bwd_smem(ntxent_bwd_kernel, smem)
                           : fwd_smem(ntxent_fwd_kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = kernel ? cudaOccupancyMaxActiveClusters(&n, ntxent_bwd_kernel, &cfg)
               : cudaOccupancyMaxActiveClusters(&n, ntxent_fwd_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Per-row loss (lse - s_pos), correctness (s_pos >= row max) and lse.
int ntxent_fwd(const float* z, float* row_loss, float* correct, float* lse,
               int n2, int d, float inv_t, cudaStream_t stream) {
  if (!valid(n2, d)) return (int)cudaErrorInvalidValue;
  cudaError_t err = fwd_smem(ntxent_fwd_kernel, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap zmap = {};
  const int tma = d % 4 == 0 && aligned16(z);
  if (tma && !simclr::float_matrix_tensor_map(&zmap, z, n2, d, BOX_ROWS))
    return (int)cudaErrorInvalidValue;
  err = simclr::launch_clusters(ntxent_fwd_kernel, dim3(cdiv(n2, BR) * CL),
                                dim3(THREADS), FWD_SMEM, stream, CL, zmap, z,
                                row_loss, correct, lse, n2, d, inv_t, tma);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// dz of g * mean(row_loss); g is a one-element device tensor.
int ntxent_bwd(const float* z, const float* lse, const float* g, float* dz,
               int n2, int d, float inv_t, cudaStream_t stream) {
  if (!valid(n2, d)) return (int)cudaErrorInvalidValue;
  cudaError_t err = bwd_smem(ntxent_bwd_kernel, BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap zmap = {};
  const int tma = d % 4 == 0 && aligned16(z) && aligned16(dz);
  if (tma && !simclr::float_matrix_tensor_map(&zmap, z, n2, d, BOX_ROWS))
    return (int)cudaErrorInvalidValue;
  err = simclr::launch_clusters(ntxent_bwd_kernel,
                                dim3(cdiv(n2, BR) * CL, cdiv(d, DK)),
                                dim3(THREADS), BWD_SMEM, stream, CL, zmap, z,
                                lse, g, dz, n2, d, inv_t, tma);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
