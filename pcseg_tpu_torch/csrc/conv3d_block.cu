// Fused voxel U-Net conv blocks for Hopper (sm_90a), NDHWC bf16.
//
// Three kernels, each "relu(x * scale + shift) -> conv -> + bias
// (+ accum) -> bf16 y, plus the next GroupNorm's per-(batch, channel)
// (sum, sumsq) of the f32 value before rounding":
//
//   pcseg_conv3x3_gn_act  replaces pcseg_tpu/ops/pallas/conv3d_block.py
//                         fused_conv3x3_p / fused_conv3x3_add_p (_kernel,
//                         pallas_call at :429): 3^3 SAME conv, Cin -> Cout.
//   pcseg_down2x_gn_act   replaces fused_down2x_p (_down2x_kernel,
//                         pallas_call at :1318): k2 s2 conv, C -> 2C.
//   pcseg_up2x_gn_act     replaces fused_up2x_p (_up2x_kernel,
//                         pallas_call at :1403): k2 s2 transposed conv,
//                         2C -> C, output 2i+d takes x[i] @ w[1-d] per axis.
//
// Rounding points (the contract of the TPU kernels, _prep_slab and
// _kernel): the prologue is computed in f32 and rounded to bf16 before
// the multiply; taps outside the grid contribute 0 (zero padding of the
// ACTIVATED input, not relu(shift)); weights are bf16 values (the wrapper
// passes them widened to f32); products accumulate in f32; bias and then
// the optional bf16 accum are added in f32; y is stored bf16; the stats
// come from the f32 value.
//
// What bounds them on an H100: at the U-Net's shapes every launch moves
// ~67-134 MB and does <= 29 GFLOP, i.e. a bf16 tensor-core kernel would be
// bound by memory (B8 x 64^3 x 16, 3^3 conv: ~134 MB / 3.35 TB/s = 40 us
// against 29 GFLOP / 989 TFLOP/s = 29 us). This first version is a direct
// convolution on the CUDA cores: the activated input patch of a block
// (TH output rows of one depth slice, all W, all Cin, plus the halo) is
// built once in shared memory, and each thread keeps a 4 (w) x 4 (Cout)
// register tile of f32 accumulators, so it reads one shared-memory value
// per 4 FMAs. It is therefore bound by the f32 FMA rate, not by memory;
// tensor cores (mma/wgmma implicit GEMM) are the next step.
//
// Plain C interface (loaded with ctypes): every entry returns
// cudaGetLastError() after its launch; pointers and the stream are
// passed as void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 4;   // output w positions per thread
constexpr int kTileC = 4;   // output channels per thread
constexpr size_t kSmemTarget = 100 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// relu(x * scale + shift) in f32 without FMA contraction (the plain
// version computes the multiply and the add as two rounded operations).
__device__ __forceinline__ float prologue(float v, float sc, float sh) {
  return fmaxf(__fadd_rn(__fmul_rn(v, sc), sh), 0.f);
}

__device__ __forceinline__ void load_bf16x4(const __nv_bfloat16* p,
                                            float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = raw.x;
  *reinterpret_cast<uint32_t*>(&hi) = raw.y;
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p,
                                             const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void fma4(float acc[kTileC], float a,
                                     const float4& w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

// Bias (+ accum) epilogue for one thread's tile: stores bf16 y and adds
// the tile's f32 (sum, sumsq) into the block's shared per-channel stats.
__device__ __forceinline__ void epilogue(
    float acc[kTileW][kTileC], const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ accum, __nv_bfloat16* __restrict__ y,
    size_t off, int cout, int co0, float* sstat, bool want_stats) {
  float bv[kTileC], s1[kTileC] = {}, s2[kTileC] = {};
#pragma unroll
  for (int c = 0; c < kTileC; ++c) bv[c] = bias[co0 + c];
#pragma unroll
  for (int t = 0; t < kTileW; ++t) {
    const size_t o = off + (size_t)t * cout;
    float v[kTileC];
#pragma unroll
    for (int c = 0; c < kTileC; ++c) v[c] = acc[t][c] + bv[c];
    if (accum != nullptr) {
      float a[kTileC];
      load_bf16x4(accum + o, a);
#pragma unroll
      for (int c = 0; c < kTileC; ++c) v[c] += a[c];
    }
    store_bf16x4(y + o, v);
#pragma unroll
    for (int c = 0; c < kTileC; ++c) {
      s1[c] += v[c];
      s2[c] += v[c] * v[c];
    }
  }
  if (want_stats) {
#pragma unroll
    for (int c = 0; c < kTileC; ++c) {
      atomicAdd(&sstat[co0 + c], s1[c]);
      atomicAdd(&sstat[cout + co0 + c], s2[c]);
    }
  }
}

__device__ __forceinline__ void flush_stats(const float* sstat, float* stats,
                                            int b, int cout) {
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * cout; i += blockDim.x)
    atomicAdd(&stats[(size_t)b * 2 * cout + i], sstat[i]);
}

// Direct K^3 conv, stride S, zero padding P (3/1/1: the 3^3 SAME conv;
// 2/2/0: the stride-2 down conv). One block = TH output rows of one
// (batch, depth) slice, all Wo, all Cout.
template <int K, int S, int P>
__global__ void __launch_bounds__(kThreads) conv_gn_act_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ accum,
    __nv_bfloat16* __restrict__ y, float* __restrict__ stats, int D, int H,
    int W, int cin, int Do, int Ho, int Wo, int cout, int TH, int activate) {
  extern __shared__ float smem[];
  const int PH = (TH - 1) * S + K;
  const int PW = (Wo - 1) * S + K;
  float* patch = smem;                          // [K][PH][cin][PW]
  float* sstat = smem + (size_t)K * PH * cin * PW;  // [2][cout]

  const int nht = (Ho + TH - 1) / TH;
  int bid = blockIdx.x;
  const int oh0 = (bid % nht) * TH;
  bid /= nht;
  const int od = bid % Do;
  const int b = bid / Do;
  const int tid = threadIdx.x;

  for (int i = tid; i < 2 * cout; i += blockDim.x) sstat[i] = 0.f;
  const int npatch = K * PH * PW * cin;
  for (int idx = tid; idx < npatch; idx += blockDim.x) {
    const int ci = idx % cin;
    int r = idx / cin;
    const int pw = r % PW;
    r /= PW;
    const int ph = r % PH;
    const int kz = r / PH;
    const int id = od * S + kz - P, ih = oh0 * S + ph - P, iw = pw - P;
    float v = 0.f;
    if (id >= 0 && id < D && ih >= 0 && ih < H && iw >= 0 && iw < W) {
      v = __bfloat162float(
          x[((((size_t)b * D + id) * H + ih) * W + iw) * cin + ci]);
      if (activate)
        v = prologue(v, scale[b * cin + ci], shift[b * cin + ci]);
      v = round_bf16(v);
    }
    patch[((kz * PH + ph) * cin + ci) * PW + pw] = v;
  }
  __syncthreads();

  const int nct = cout / kTileC, nwt = Wo / kTileW;
  const int items = TH * nwt * nct;
  for (int it = tid; it < items; it += blockDim.x) {
    const int ct = it % nct;
    const int rest = it / nct;
    const int ow0 = (rest % nwt) * kTileW;
    const int hl = rest / nwt;
    const int oh = oh0 + hl;
    if (oh >= Ho) continue;
    const int co0 = ct * kTileC;
    float acc[kTileW][kTileC] = {};
    for (int kz = 0; kz < K; ++kz) {
      for (int ky = 0; ky < K; ++ky) {
        const float* prow =
            patch + (size_t)((kz * PH + hl * S + ky) * cin) * PW + ow0 * S;
        const float* wrow = w + (size_t)((kz * K + ky) * K * cin) * cout + co0;
        for (int ci = 0; ci < cin; ++ci) {
          const float* pr = prow + ci * PW;
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            const float4 wv = __ldg(reinterpret_cast<const float4*>(
                wrow + (size_t)(kx * cin + ci) * cout));
#pragma unroll
            for (int t = 0; t < kTileW; ++t) fma4(acc[t], pr[t * S + kx], wv);
          }
        }
      }
    }
    const size_t off =
        ((((size_t)b * Do + od) * Ho + oh) * Wo + ow0) * cout + co0;
    epilogue(acc, bias, accum, y, off, cout, co0, sstat, stats != nullptr);
  }
  if (stats != nullptr) flush_stats(sstat, stats, b, cout);
}

// k2 s2 transposed conv: output (od, oh, ow) reads only its parent
// x[od/2, oh/2, ow/2] through tap w[1 - od%2, 1 - oh%2, 1 - ow%2]. One
// block = TH (even) output rows of one (batch, depth) slice.
__global__ void __launch_bounds__(kThreads) up2x_gn_act_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, __nv_bfloat16* __restrict__ y,
    float* __restrict__ stats, int Hi, int Wi, int cin, int Do, int Ho,
    int Wo, int cout, int TH) {
  extern __shared__ float smem[];
  const int PH = TH / 2;
  float* patch = smem;                          // [PH][cin][Wi]
  float* sstat = smem + (size_t)PH * cin * Wi;  // [2][cout]
  const int Di = Do / 2;

  const int nht = (Ho + TH - 1) / TH;
  int bid = blockIdx.x;
  const int oh0 = (bid % nht) * TH;
  bid /= nht;
  const int od = bid % Do;
  const int b = bid / Do;
  const int tid = threadIdx.x;

  for (int i = tid; i < 2 * cout; i += blockDim.x) sstat[i] = 0.f;
  const int npatch = PH * Wi * cin;
  for (int idx = tid; idx < npatch; idx += blockDim.x) {
    const int ci = idx % cin;
    const int r = idx / cin;
    const int iw = r % Wi;
    const int ph = r / Wi;
    const int ih = oh0 / 2 + ph;
    float v = 0.f;
    if (ih < Hi) {
      v = __bfloat162float(
          x[((((size_t)b * Di + od / 2) * Hi + ih) * Wi + iw) * cin + ci]);
      v = round_bf16(prologue(v, scale[b * cin + ci], shift[b * cin + ci]));
    }
    patch[(ph * cin + ci) * Wi + iw] = v;
  }
  __syncthreads();

  const int nct = cout / kTileC, nwt = Wo / kTileW;
  const int items = TH * nwt * nct;
  const int tz = 1 - (od & 1);
  for (int it = tid; it < items; it += blockDim.x) {
    const int ct = it % nct;
    const int rest = it / nct;
    const int ow0 = (rest % nwt) * kTileW;
    const int hl = rest / nwt;
    const int oh = oh0 + hl;
    if (oh >= Ho) continue;
    const int co0 = ct * kTileC;
    const int ty = 1 - (oh & 1);
    // ow0 is even: outputs ow0, ow0+1 share parent ow0/2, ow0+2, ow0+3
    // share ow0/2+1; even outputs take tap x=1, odd ones tap x=0
    const float* pr = patch + (size_t)(hl / 2) * cin * Wi + ow0 / 2;
    const float* w_even = w + (size_t)(((tz * 2 + ty) * 2 + 1) * cin) * cout + co0;
    const float* w_odd = w + (size_t)(((tz * 2 + ty) * 2 + 0) * cin) * cout + co0;
    float acc[kTileW][kTileC] = {};
    for (int ci = 0; ci < cin; ++ci) {
      const float a0 = pr[ci * Wi], a1 = pr[ci * Wi + 1];
      const float4 we =
          __ldg(reinterpret_cast<const float4*>(w_even + (size_t)ci * cout));
      const float4 wo =
          __ldg(reinterpret_cast<const float4*>(w_odd + (size_t)ci * cout));
      fma4(acc[0], a0, we);
      fma4(acc[1], a0, wo);
      fma4(acc[2], a1, we);
      fma4(acc[3], a1, wo);
    }
    const size_t off =
        ((((size_t)b * Do + od) * Ho + oh) * Wo + ow0) * cout + co0;
    epilogue(acc, bias, nullptr, y, off, cout, co0, sstat, stats != nullptr);
  }
  if (stats != nullptr) flush_stats(sstat, stats, b, cout);
}

// Rows per block: the largest of 4, 2, 1 whose patch fits the target, so
// two blocks share an SM; fails only past the hardware limit.
template <typename Bytes>
int pick_rows(Bytes bytes, int th, int step, size_t* smem) {
  while (th > step && bytes(th) > kSmemTarget) th -= step;
  *smem = bytes(th);
  return *smem > kSmemMax ? 0 : th;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int K, int S, int P>
int launch_conv(const void* x, const void* w, const void* bias,
                const void* scale, const void* shift, const void* accum,
                void* y, void* stats, int B, int D, int H, int W, int cin,
                int cout, int activate, void* stream) {
  const int Do = (D + 2 * P - K) / S + 1;
  const int Ho = (H + 2 * P - K) / S + 1;
  const int Wo = (W + 2 * P - K) / S + 1;
  if (B <= 0 || Do <= 0 || Ho <= 0 || Wo % kTileW || Wo <= 0 ||
      cout % kTileC || cin <= 0)
    return (int)cudaErrorInvalidValue;
  auto bytes = [&](int th) {
    return sizeof(float) *
           ((size_t)K * ((th - 1) * S + K) * cin * ((Wo - 1) * S + K) +
            2 * (size_t)cout);
  };
  size_t smem = 0;
  const int TH = pick_rows(bytes, 4, 1, &smem);
  if (TH == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(conv_gn_act_kernel<K, S, P>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = B * Do * ((Ho + TH - 1) / TH);
  conv_gn_act_kernel<K, S, P><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)w, (const float*)bias,
      (const float*)scale, (const float*)shift, (const __nv_bfloat16*)accum,
      (__nv_bfloat16*)y, (float*)stats, D, H, W, cin, Do, Ho, Wo, cout, TH,
      activate);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pcseg_conv3x3_gn_act(const void* x, const void* w, const void* bias,
                         const void* scale, const void* shift,
                         const void* accum, void* y, void* stats, int B, int D,
                         int H, int W, int cin, int cout, int activate,
                         void* stream) {
  return launch_conv<3, 1, 1>(x, w, bias, scale, shift, accum, y, stats, B, D,
                              H, W, cin, cout, activate, stream);
}

int pcseg_down2x_gn_act(const void* x, const void* w, const void* bias,
                        const void* scale, const void* shift, void* y,
                        void* stats, int B, int D, int H, int W, int cin,
                        int cout, void* stream) {
  if (D % 2 || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  return launch_conv<2, 2, 0>(x, w, bias, scale, shift, nullptr, y, stats, B,
                              D, H, W, cin, cout, 1, stream);
}

int pcseg_up2x_gn_act(const void* x, const void* w, const void* bias,
                      const void* scale, const void* shift, void* y,
                      void* stats, int B, int D, int H, int W, int cin,
                      int cout, void* stream) {
  const int Do = 2 * D, Ho = 2 * H, Wo = 2 * W;
  if (B <= 0 || D <= 0 || H <= 0 || Wo % kTileW || cout % kTileC || cin <= 0)
    return (int)cudaErrorInvalidValue;
  auto bytes = [&](int th) {
    return sizeof(float) * ((size_t)(th / 2) * cin * W + 2 * (size_t)cout);
  };
  size_t smem = 0;
  const int TH = pick_rows(bytes, 4, 2, &smem);
  if (TH == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(up2x_gn_act_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = B * Do * ((Ho + TH - 1) / TH);
  up2x_gn_act_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)w, (const float*)bias,
      (const float*)scale, (const float*)shift, (__nv_bfloat16*)y,
      (float*)stats, H, W, cin, Do, Ho, Wo, cout, TH);
  return (int)cudaGetLastError();
}

}  // extern "C"
