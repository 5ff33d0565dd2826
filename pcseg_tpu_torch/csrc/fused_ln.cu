// Fused conv-bias + LayerNorm + affine + ReLU + active-mask for Hopper
// (sm_90a), forward only.
//
//   pcseg_bias_ln_relu_mask  replaces pcseg_tpu/ops/pallas/fused_ln.py
//                            bias_ln_relu_mask / ln_relu_mask (_fwd_kernel,
//                            pallas_call at :178): per row of x (N, C)
//     xb   = f32(x) + pre_bias
//     mean = sum(xb) / C,  var = max(sum(xb^2) / C - mean^2, 0)
//     z    = (xb - mean) * rsqrt(var + eps) * scale + bias
//     out  = active ? max(z, 0) : 0, rounded once to the output type.
//
// The TPU kernel takes a (1024, C) row block a grid step and reduces over
// the lanes. Here one warp takes one row: each lane holds up to four of
// its C <= 128 values in registers (lane k, k + 32, ...: neighbouring
// lanes read neighbouring addresses), the two sums go round the warp with
// shuffles, and the row is written once. The kernel is bound by bytes, one
// read of x and one write of out (4 C bytes a row in bf16): 67 MB at the
// sparse U-Net's 262,144 x 64 level-0 rows, 0.020 ms at 3.35 TB/s.
// Products and sums of the epilogue are written with the _rn intrinsics,
// so nvcc fuses none of them into an FMA: the plain PyTorch version rounds
// at the same points. The row sums are taken in another order than
// torch's mean.
//
// Plain C interface (loaded with ctypes): the entry returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;   // one warp a row
constexpr int kPerLane = 4;            // C <= 32 * kPerLane
constexpr int kMaxC = 32 * kPerLane;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) bias_ln_relu_mask_kernel(
    const Tin* __restrict__ x, const float* __restrict__ pre_bias,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const uint8_t* __restrict__ active, Tout* __restrict__ out, long long n,
    int c, float eps) {
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const Tin* xr = x + row * c;
  float v[kPerLane];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int k = lane + 32 * j;
    v[j] = 0.f;
    if (k < c) {
      v[j] = __fadd_rn(to_float(xr[k]), pre_bias[k]);
      s = __fadd_rn(s, v[j]);
      ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  }
  const float mean = __fdiv_rn(s, (float)c);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(ss, (float)c), __fmul_rn(mean, mean)), 0.f);
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  const bool act = active[row] != 0;
  Tout* o = out + row * c;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int k = lane + 32 * j;
    if (k < c) {
      const float z = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(v[j], mean), rstd), scale[k]),
          bias[k]);
      o[k] = from_float<Tout>(act && z > 0.f ? z : 0.f);
    }
  }
}

template <typename Tin, typename Tout>
void launch(const void* x, const void* pre_bias, const void* scale,
            const void* bias, const void* active, void* out, long long n,
            int c, float eps, cudaStream_t stream) {
  const long long blocks = (n + kRows - 1) / kRows;
  bias_ln_relu_mask_kernel<Tin, Tout><<<(unsigned)blocks, kThreads, 0,
                                        stream>>>(
      (const Tin*)x, (const float*)pre_bias, (const float*)scale,
      (const float*)bias, (const uint8_t*)active, (Tout*)out, n, c, eps);
}

}  // namespace

extern "C" {

// x (N, C) bf16 (x_bf16 = 1) or f32, row-major; pre_bias, scale, bias (C,)
// f32; active (N,) bool (one byte a row); out (N, C) bf16 (out_bf16 = 1)
// or f32. 1 <= C <= 128.
int pcseg_bias_ln_relu_mask(const void* x, const void* pre_bias,
                            const void* scale, const void* bias,
                            const void* active, void* out, long long N,
                            int C, float eps, int x_bf16, int out_bf16,
                            void* stream) {
  if (N <= 0 || C <= 0 || C > kMaxC || (N + kRows - 1) / kRows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, pre_bias, scale, bias, active,
                                         out, N, C, eps, s);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, pre_bias, scale, bias, active, out, N, C,
                                 eps, s);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(x, pre_bias, scale, bias, active, out, N, C,
                                 eps, s);
  else
    launch<float, float>(x, pre_bias, scale, bias, active, out, N, C, eps, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
