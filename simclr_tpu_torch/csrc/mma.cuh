// Tensor-core and copy helpers shared by conv64.cu, winograd.cu and
// bottleneck.cu (sm_90a): bf16 mma.sync with float32 accumulation,
// ldmatrix, cp.async with zero fill, and the once-per-device shared-memory
// opt-in.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace simclr {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; copies zeros when !valid (src is then
// not read, but must still be a valid global address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two 8x8 matrices, transposed; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d += a * b for one m16n8k16 tile: a row-major 16x16 bf16, b 16x8 bf16
// ("col": each register holds two k-neighbours of one n), d 16x8 float32.
// Thread t holds d[t/4][2(t%4)+{0,1}] in d[0..1] and row t/4 + 8 in d[2..3].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float a,
                                             float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Lets a kernel take more than the default 48 KB of dynamic shared
// memory, once per device. One instance per kernel, in the source file:
//   simclr::SmemOptIn fwd_smem;  ...  fwd_smem(kernel, bytes);
struct SmemOptIn {
  static constexpr int MAX_DEVICES = 64;
  std::atomic<bool> done[MAX_DEVICES];

  template <typename Kernel>
  cudaError_t operator()(Kernel* kernel, int bytes) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[dev].load()) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true);
    return err;
  }
};

}  // namespace simclr
