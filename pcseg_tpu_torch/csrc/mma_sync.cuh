// mma.sync building blocks of the port's gathered and implicit GEMMs
// (resample.cu, conv3d_dgrad.cu) on Hopper (sm_90a): cp.async 16-byte
// copies, ldmatrix (plain and .trans), m16n8k16 / m16n8k8 bf16 products
// with f32 sums, and the fixed-order sum of per-block partial rows that
// keeps their reductions free of float atomics (two calls on the same
// inputs give the same bits). Header-only and free of PyTorch; the build
// hashes it with every source that includes it (ops/_build.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_sync {

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm1(uint32_t& r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];"
               : "=r"(r)
               : "r"(addr)
               : "memory");
}

// m16n8k8: A two registers (rows g and g + 8, k 2t..2t+1), B one
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2],
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ float group_sum(float v) {
  // the 8 lanes that share lane % 4 (the rows of an mma fragment)
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// out[s, j] = sum over g of part[s, g, j], g in order: 8 g-strides a
// column, then their 8 sums in order
__global__ void __launch_bounds__(256) fixed_sum_kernel(
    const float* __restrict__ part, float* __restrict__ out, int G,
    long long L) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const long long j = (long long)blockIdx.x * 32 + tx;
  const float* src = part + (size_t)blockIdx.y * G * L;
  float s = 0.f;
  if (j < L)
    for (int g = ty; g < G; g += 8) s += src[(size_t)g * L + j];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < L) {
    float v = red[0][tx];
#pragma unroll
    for (int k = 1; k < 8; ++k) v += red[k][tx];
    out[(size_t)blockIdx.y * L + j] = v;
  }
}

}  // namespace mma_sync
