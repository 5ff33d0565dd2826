// The first-max pool's 64-bit keys, shared by row 16's forward
// (pointnet_wgmma.cu) and row 19's pool (pointnet_fused.cu): (value, row)
// per (batch row, channel) as one key, combined across blocks with
// atomicMax, so the larger value wins and, among equal values, the
// smaller row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Order-preserving 64-bit key: the float above the inverted row (-0 ==
// +0).
__device__ __forceinline__ unsigned long long pool_key(float v, long long r) {
  if (v == 0.f) v = 0.f;
  uint32_t u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (uint32_t)r);
}

// keys -> (the value, its row), one thread a key
__global__ void pool_finalize_kernel(const unsigned long long* __restrict__ keys,
                                     float* __restrict__ best,
                                     int* __restrict__ idx, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const unsigned long long k = keys[i];
  const uint32_t u = (uint32_t)(k >> 32);
  const uint32_t bits = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  best[i] = __uint_as_float(bits);
  idx[i] = (int)(0xFFFFFFFFu - (uint32_t)(k & 0xFFFFFFFFull));
}

}  // namespace
