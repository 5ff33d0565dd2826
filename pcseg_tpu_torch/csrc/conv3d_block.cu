// Fused voxel U-Net conv blocks for Hopper (sm_90a), NDHWC bf16, and
// their backward kernels.
//
// Forward, each "relu(x * scale + shift) -> conv -> + bias (+ accum) ->
// bf16 y, plus the next GroupNorm's per-(batch, channel) (sum, sumsq) of
// the f32 value before rounding":
//
//   pcseg_conv3x3_gn_act  replaces pcseg_tpu/ops/pallas/conv3d_block.py
//                         fused_conv3x3_p / fused_conv3x3_add_p (_kernel,
//                         pallas_call at :429): 3^3 SAME conv, Cin -> Cout,
//                         for the shapes csrc/conv3d_dgrad.cu's implicit
//                         GEMM does not take (ops/conv3d_block.py's
//                         _conv_route).
//   pcseg_down2x_gn_act   replaces fused_down2x_p (_down2x_kernel,
//                         pallas_call at :1318): k2 s2 conv, C -> Cout,
//                         for the widths csrc/resample.cu's tensor-core
//                         kernel does not take (C < 8 or above 64, Cout !=
//                         2C; ops/conv3d_block.py's _mma_route).
//   pcseg_up2x_gn_act     replaces fused_up2x_p (_up2x_kernel,
//                         pallas_call at :1403): k2 s2 transposed conv,
//                         2C -> C, output 2i+d takes x[i] @ w[1-d] per axis,
//                         for the widths csrc/resample.cu's gathered GEMM
//                         does not take (_mma_route).
//
// Backward (the custom VJPs of the same file):
//
//   pcseg_conv3x3_dgrad   replaces _dgrad_pallas (_dgrad_kernel, pallas_call
//                         at :546): dx = relu'(pre) * scale * conv(g',
//                         flip(W)^T), dscale = sum dam * x, dshift = sum dam
//                         per (batch, channel), and the bf16 g' itself (the
//                         accum gradient of the add variant), for the shapes
//                         csrc/conv3d_dgrad.cu's implicit GEMM does not
//                         take (ops/conv3d_block.py's _conv_route).
//   pcseg_conv3x3_wgrad   replaces _wgrad_pallas (_wgrad_kernel, pallas_call
//                         at :648): dW (3,3,3,Cin,Cout) and dbias, for the
//                         shapes csrc/conv3d_dgrad.cu's split-K GEMM does
//                         not take (the same _conv_route).
//   pcseg_down2x_bwd      replaces the bwd of fused_down2x_p
//                         (_down2x_bwd_kernel, pallas_call at :1353), for
//                         the widths csrc/resample.cu's one-sweep kernel
//                         does not take (C > 64, coarse width != 2C).
//   pcseg_up2x_bwd        replaces the bwd of fused_up2x_p
//                         (_up2x_bwd_kernel, pallas_call at :1439), for
//                         the widths csrc/resample.cu's one-sweep kernel
//                         does not take (C > 64, coarse width != 2C).
//
// The 1x1 head on the last decoder grid (_head_vjp of the same file):
//
//   pcseg_head_grid2      replaces fused_head_grid2 (_head_kernel,
//                         pallas_call at :1543): y = bf16(bf16(relu(x *
//                         scale + shift)) @ bf16(W) + bias), bf16 out.
//   pcseg_head_grid2_bwd  replaces _head_bwd (_head_bwd_kernel, pallas_call
//                         at :1583): dx = bf16([pre > 0] gy W^T * scale),
//                         dscale = sum dam * x (the raw x), dshift = sum dam
//                         per (batch, channel), dW = sum s gy^T, dbias =
//                         sum gy. The TPU kernel's lane-tiled (B, 128)
//                         dscale/dshift are here (B, C): the sums of the
//                         lane copies of each channel.
//
// The head is one pass over the grid, bound by its bytes (B8 x 64^3 x 16
// -> 4: x 67 MB and y 17 MB forward, x, gy and dx 151 MB backward): one
// thread a voxel with 16-byte loads of x; the backward's sums go through
// shared-memory tiles into registers and leave with one float atomic per
// sum per block.
//
// g' is the cotangent entering the conv: the forward's stats output feeds
// the next GroupNorm, so g' = gy + gs1 + 2 * gs2 * y per (batch, channel),
// with y the STORED bf16 output. It is folded into the gy reads. The 3^3
// kernels compute gy + (gs1 + 2 gs2 y) and round g' to bf16 before both
// products and before dbias (_window_prep_fn, _prep_slab, _wgrad_kernel);
// down/up compute (gy + gs1) + 2 gs2 y, take dbias from the f32 value and
// round only the product operand (_down2x_bwd_kernel, _up2x_bwd_kernel).
//
// Rounding points of the forward (the contract of the TPU kernels,
// _prep_slab and _kernel): the prologue is computed in f32 and rounded to
// bf16 before the multiply; taps outside the grid contribute 0 (zero
// padding of the ACTIVATED input, not relu(shift)); weights are bf16
// values (the wrapper passes them widened to f32); products accumulate in
// f32; bias and then the optional bf16 accum are added in f32; y is stored
// bf16; the stats come from the f32 value. The dgrad epilogue recomputes
// pre = x * scale + shift in f32 (no FMA contraction, like the forward's
// prologue), dam = da * [pre > 0], dx = bf16(dam * scale).
//
// What bounds them on an H100: at the U-Net's shapes every launch moves
// ~67-134 MB and does <= 29 GFLOP, i.e. a bf16 tensor-core kernel would be
// bound by memory (B8 x 64^3 x 16, 3^3 conv: ~134 MB / 3.35 TB/s = 40 us
// against 29 GFLOP / 989 TFLOP/s = 29 us). These first versions are
// direct convolutions on the CUDA cores, bound by the f32 FMA rate:
//
// - forward and dgrad share one kernel per structure (a dgrad is a conv
//   with flipped, IO-swapped weights: the 3^3 dgrad is a 3^3 SAME conv of
//   g', down's dgrad has the transposed conv's structure and up's the
//   strided conv's). The activated (forward) or adjusted (dgrad) input
//   patch of a block (TH output rows of one depth slice, all W, all
//   channels, plus the halo) is built once in shared memory, and each
//   thread keeps a 4 (w) x 4 (channel) register tile of f32 accumulators,
//   reading one shared-memory value per 4 FMAs;
// - wgrad reduces over all B*D*H*W voxels into taps*Cin*Cout weights. A
//   block stages one voxel tile's activated input patch and g' tile in
//   shared memory (f32, channel-minor), 8 channels per 16-byte load with
//   several loads in flight per thread (staged one element at a time, the
//   first version waited on memory latency: 4.1 ms at 64^3 x 16). Each
//   thread owns a 4 (Cin) x 4 (Cout) tile of one (kz, ky) tap pair for all
//   kx taps in registers and walks the tile's voxels with K + 1 16-byte
//   shared loads per 16 K FMAs. Blocks loop over many voxel tiles and add
//   their partial sums to dW once per weight per block with float atomics
//   (~2 blocks per SM), so no weight sees more than a few hundred atomics.
//
// Plain C interface (loaded with ctypes): every entry returns
// cudaGetLastError() after its launches; pointers and the stream are
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

// The stats cotangent folded into a gy read: order 0 is the 3^3 kernels'
// gy + (gs1 + 2 gs2 y), order 1 the down/up kernels' (gy + gs1) + 2 gs2 y.
__device__ __forceinline__ float adjust(float g, float y, float gs1, float gs2,
                                        int order) {
  const float t = __fmul_rn(__fmul_rn(2.f, gs2), y);
  return order == 0 ? __fadd_rn(g, __fadd_rn(gs1, t))
                    : __fadd_rn(__fadd_rn(g, gs1), t);
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

// The dgrad-only arguments of the kernels a dgrad shares with a forward.
// "Input" and "output" are the kernel's own: for a dgrad the input is the
// forward's output cotangent gy and the output is dx.
struct DgradArgs {
  const __nv_bfloat16* yfwd;   // the forward's y at the input positions
  const float* gstats;         // (B, 2, cin) stats cotangent, or null
  const __nv_bfloat16* xfwd;   // the forward's x at the output positions
  __nv_bfloat16* gadj;         // 3^3: optional bf16 g' out (input positions)
  int order;                   // adjust()'s order
};

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

// dgrad epilogue for one thread's tile: da -> dx = bf16(dam * scale) with
// dam = da * [x * scale + shift > 0], and the tile's (sum dam * x,
// sum dam) into the block's shared per-channel sums. Without the
// activation dx = bf16(da) and there are no sums.
__device__ __forceinline__ void epilogue_dgrad(
    float acc[kTileW][kTileC], const __nv_bfloat16* __restrict__ xfwd,
    const float* __restrict__ scale, const float* __restrict__ shift,
    __nv_bfloat16* __restrict__ dx, size_t off, int b, int cout, int co0,
    float* sstat, int activate) {
  if (!activate) {
#pragma unroll
    for (int t = 0; t < kTileW; ++t)
      store_bf16x4(dx + off + (size_t)t * cout, acc[t]);
    return;
  }
  float sc[kTileC], sh[kTileC], s1[kTileC] = {}, s2[kTileC] = {};
#pragma unroll
  for (int c = 0; c < kTileC; ++c) {
    sc[c] = scale[b * cout + co0 + c];
    sh[c] = shift[b * cout + co0 + c];
  }
#pragma unroll
  for (int t = 0; t < kTileW; ++t) {
    const size_t o = off + (size_t)t * cout;
    float xs[kTileC], v[kTileC];
    load_bf16x4(xfwd + o, xs);
#pragma unroll
    for (int c = 0; c < kTileC; ++c) {
      const float pre = __fadd_rn(__fmul_rn(xs[c], sc[c]), sh[c]);
      const float dam = pre > 0.f ? acc[t][c] : 0.f;
      v[c] = __fmul_rn(dam, sc[c]);
      s1[c] += dam * xs[c];
      s2[c] += dam;
    }
    store_bf16x4(dx + o, v);
  }
#pragma unroll
  for (int c = 0; c < kTileC; ++c) {
    atomicAdd(&sstat[co0 + c], s1[c]);
    atomicAdd(&sstat[cout + co0 + c], s2[c]);
  }
}

// One input element of a dgrad as the conv reads it: g' = gy with the
// stats term, rounded to bf16 (the forward's prologue stays inline in the
// kernels).
__device__ __forceinline__ float dgrad_input(float v, const DgradArgs& dg,
                                             size_t idx, int b, int cin,
                                             int ci) {
  if (dg.gstats != nullptr) {
    const float* gs = dg.gstats + (size_t)b * 2 * cin;
    v = adjust(v, __bfloat162float(dg.yfwd[idx]), gs[ci], gs[cin + ci],
               dg.order);
  }
  return v;
}

__device__ __forceinline__ void flush_stats(const float* sstat, float* stats,
                                            int b, int cout) {
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * cout; i += blockDim.x)
    atomicAdd(&stats[(size_t)b * 2 * cout + i], sstat[i]);
}

// Direct K^3 conv, stride S, zero padding P (3/1/1: the 3^3 SAME conv and
// its dgrad; 2/2/0: the stride-2 down conv and up's dgrad). One block =
// TH output rows of one (batch, depth) slice, all Wo, all cout. For a
// dgrad (BWD) x is gy, y is dx and stats are (dscale, dshift).
template <int K, int S, int P, bool BWD>
__global__ void __launch_bounds__(kThreads) conv_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ accum,
    __nv_bfloat16* __restrict__ y, float* __restrict__ stats, int D, int H,
    int W, int cin, int Do, int Ho, int Wo, int cout, int TH, int activate,
    const DgradArgs dg) {
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
      const size_t gi = ((((size_t)b * D + id) * H + ih) * W + iw) * cin + ci;
      v = __bfloat162float(x[gi]);
      if constexpr (BWD) {
        v = round_bf16(dgrad_input(v, dg, gi, b, cin, ci));
        // g' of this block's own rows (the center depth tap) is the add
        // variant's accum gradient
        if (dg.gadj != nullptr && kz == P && ph >= P && ph < TH + P)
          dg.gadj[gi] = __float2bfloat16_rn(v);
      } else {
        if (activate)
          v = prologue(v, scale[b * cin + ci], shift[b * cin + ci]);
        v = round_bf16(v);
      }
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
    if constexpr (BWD)
      epilogue_dgrad(acc, dg.xfwd, scale, shift, y, off, b, cout, co0, sstat,
                     activate);
    else
      epilogue(acc, bias, accum, y, off, cout, co0, sstat, stats != nullptr);
  }
  if (stats != nullptr) flush_stats(sstat, stats, b, cout);
}

// k2 s2 transposed conv (the up conv and down's dgrad): output (od, oh,
// ow) reads only its parent x[od/2, oh/2, ow/2] through tap
// w[1 - od%2, 1 - oh%2, 1 - ow%2]. One block = TH (even) output rows of
// one (batch, depth) slice.
template <bool BWD>
__global__ void __launch_bounds__(kThreads) up_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, __nv_bfloat16* __restrict__ y,
    float* __restrict__ stats, int Hi, int Wi, int cin, int Do, int Ho,
    int Wo, int cout, int TH, const DgradArgs dg) {
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
      const size_t gi =
          ((((size_t)b * Di + od / 2) * Hi + ih) * Wi + iw) * cin + ci;
      v = __bfloat162float(x[gi]);
      if constexpr (BWD)
        v = round_bf16(dgrad_input(v, dg, gi, b, cin, ci));
      else
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
    if constexpr (BWD)
      epilogue_dgrad(acc, dg.xfwd, scale, shift, y, off, b, cout, co0, sstat,
                     1);
    else
      epilogue(acc, bias, nullptr, y, off, cout, co0, sstat, stats != nullptr);
  }
  if (stats != nullptr) flush_stats(sstat, stats, b, cout);
}

// ---------------------------------------------------------------------------
// wgrad: dW[tap][ci][co] = sum a[in][ci] * g'[out][co] over the voxel pairs
// a tap joins, and dbias = sum g' over the outputs.
// ---------------------------------------------------------------------------

enum WgradMode { kConv3 = 0, kDown = 1, kUp = 2 };

struct WgradParams {
  const __nv_bfloat16* x;      // the forward's input (B, D, H, W, cin)
  const float* scale;          // (B, cin) prologue, null without activation
  const float* shift;
  const __nv_bfloat16* gy;     // the forward's output cotangent
  const __nv_bfloat16* y;      // the forward's output (for the stats term)
  const float* gstats;         // (B, 2, cout) stats cotangent, or null
  float* dw;                   // (taps, cin, cout) f32, zeroed
  float* dbias;                // (cout,) f32, zeroed
  int B, D, H, W, cin, Do, Ho, Wo, cout, TH, activate;
  int tile_threads;            // threads per row split (one weight tile each)
};

// Shared-memory tile geometry of one voxel tile: the a-side patch
// (AZ, AH, AW, cin) and the g-side patch (GZ, GH, GW, cout), channel-minor.
// Conv3 and Down tile the output (TH rows of one depth slice); Up tiles the
// input, whose voxels each own a 2x2x2 block of outputs.
template <int MODE>
struct WgradGeom {
  int AZ, AH, AW, GZ, GH, GW, rows, depth;
  __host__ __device__ WgradGeom(const WgradParams& p, int th) {
    if (MODE == kConv3) {
      AZ = 3; AH = th + 2; AW = p.Wo + 2;
      GZ = 1; GH = th; GW = p.Wo;
      rows = p.Ho; depth = p.Do;
    } else if (MODE == kDown) {
      AZ = 2; AH = 2 * th; AW = 2 * p.Wo;
      GZ = 1; GH = th; GW = p.Wo;
      rows = p.Ho; depth = p.Do;
    } else {
      AZ = 1; AH = th; AW = p.W;
      GZ = 2; GH = 2 * th; GW = 2 * p.W;
      rows = p.H; depth = p.D;
    }
  }
  __host__ __device__ size_t floats(int cin, int cout) const {
    return (size_t)AZ * AH * AW * cin + (size_t)GZ * GH * GW * cout;
  }
};

__device__ __forceinline__ void bf16x8_to_f32(const uint4& raw, float v[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_f32x8(float* dst, const float v[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

constexpr int kStageBatch = 4;   // 16-byte loads in flight per thread

// Each thread owns one weight tile, (kz, ky) x 4 input x 4 output channels
// x all K kx taps, in registers, and walks its row split of the tile's
// voxels: per position one 16-byte shared load on the side the taps share
// and K on the other, for 16 K FMAs. A tile's voxels are staged 8
// channels (16 bytes) per load, kStageBatch loads in flight per thread.
template <int MODE>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(const WgradParams p) {
  extern __shared__ float smem[];
  constexpr int K = MODE == kConv3 ? 3 : 2;
  constexpr int S = MODE == kDown ? 2 : 1;   // a-side stride per position
  const int cin = p.cin, cout = p.cout, TH = p.TH;
  const WgradGeom<MODE> g(p, TH);
  float* sa = smem;                                   // [AZ][AH][AW][cin]
  float* sg = smem + (size_t)g.AZ * g.AH * g.AW * cin;  // [GZ][GH][GW][cout]
  const int tid = threadIdx.x, nthreads = blockDim.x;

  const int tt = p.tile_threads;
  const int split = tid / tt, nsplit = nthreads / tt;
  const int nco = cout / 4, nci = cin / 4;
  const int q = blockIdx.x * tt + tid % tt;
  const bool owns = q < K * K * nci * nco;
  const int co0 = (q % nco) * 4;
  const int ci0 = ((q / nco) % nci) * 4;
  const int kzy = q / (nco * nci);
  const int tz = kzy / K, ty = kzy % K;
  const int pw = MODE == kUp ? p.W : p.Wo;   // positions per tile row
  const bool bias_block = blockIdx.x == 0;
  const int order = MODE == kConv3 ? 0 : 1;
  const int ci8 = cin / 8, co8 = cout / 8;

  float acc[K][4][4] = {};
  // dbias partials of this thread's 8 channels: its g-side 8-channel
  // groups all have group index tid % co8 (blockDim % co8 == 0)
  float bsum[8] = {};
  const int nht = (g.rows + TH - 1) / TH;
  const int nvt = p.B * g.depth * nht;
  for (int vt = blockIdx.y; vt < nvt; vt += gridDim.y) {
    const int h0 = (vt % nht) * TH;
    const int z = (vt / nht) % g.depth;
    const int b = vt / (nht * g.depth);
    __syncthreads();  // the previous tile's readers are done
    // a side: the activated forward input, 8 channels per load
    const int na = g.AZ * g.AH * g.AW * ci8;
    for (int i0 = tid; i0 < na; i0 += kStageBatch * nthreads) {
      uint4 raw[kStageBatch];
      bool ok[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int i = i0 + u * nthreads;
        const int cg = i % ci8;
        int r = i / ci8;
        const int aw = r % g.AW;
        r /= g.AW;
        const int ah = r % g.AH;
        const int zz = r / g.AH;
        int id, ih, iw;
        if (MODE == kConv3) {
          id = z + zz - 1; ih = h0 + ah - 1; iw = aw - 1;
        } else if (MODE == kDown) {
          id = 2 * z + zz; ih = 2 * h0 + ah; iw = aw;
        } else {
          id = z; ih = h0 + ah; iw = aw;
        }
        ok[u] = i < na && id >= 0 && id < p.D && ih >= 0 && ih < p.H &&
                iw >= 0 && iw < p.W;
        raw[u] = ok[u] ? *reinterpret_cast<const uint4*>(
                             p.x + ((((size_t)b * p.D + id) * p.H + ih) * p.W +
                                    iw) * cin + cg * 8)
                       : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int i = i0 + u * nthreads;
        if (i >= na) break;
        float v[8] = {};
        if (ok[u]) {
          bf16x8_to_f32(raw[u], v);
          const int c0 = b * cin + (i % ci8) * 8;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (p.activate) v[j] = prologue(v[j], p.scale[c0 + j],
                                            p.shift[c0 + j]);
            v[j] = round_bf16(v[j]);
          }
        }
        store_f32x8(sa + (size_t)i * 8, v);
      }
    }
    // g side: g' at the outputs, 8 channels per load
    const int ng = g.GZ * g.GH * g.GW * co8;
    const float* gs = p.gstats + (size_t)b * 2 * cout;
    for (int i0 = tid; i0 < ng; i0 += kStageBatch * nthreads) {
      uint4 rg[kStageBatch], ry[kStageBatch];
      bool ok[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int i = i0 + u * nthreads;
        const int cg = i % co8;
        int r = i / co8;
        const int ow = r % g.GW;
        r /= g.GW;
        const int gh = r % g.GH;
        const int zz = r / g.GH;
        const int od = MODE == kUp ? 2 * z + zz : z;
        const int oh = MODE == kUp ? 2 * h0 + gh : h0 + gh;
        ok[u] = i < ng && oh < p.Ho;
        const size_t o =
            ((((size_t)b * p.Do + od) * p.Ho + oh) * p.Wo + ow) * cout +
            cg * 8;
        rg[u] = ok[u] ? *reinterpret_cast<const uint4*>(p.gy + o)
                      : make_uint4(0, 0, 0, 0);
        ry[u] = ok[u] && p.gstats != nullptr
                    ? *reinterpret_cast<const uint4*>(p.y + o)
                    : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int i = i0 + u * nthreads;
        if (i >= ng) break;
        float v[8] = {};
        if (ok[u]) {
          float ge[8], yv[8];
          bf16x8_to_f32(rg[u], ge);
          bf16x8_to_f32(ry[u], yv);
          const int c0 = (i % co8) * 8;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (p.gstats != nullptr)
              ge[j] = adjust(ge[j], yv[j], gs[c0 + j], gs[cout + c0 + j],
                             order);
            v[j] = round_bf16(ge[j]);
            // 3^3: dbias of the bf16 g'; down/up: of the f32 value
            bsum[j] += MODE == kConv3 ? v[j] : ge[j];
          }
        }
        store_f32x8(sg + (size_t)i * 8, v);
      }
    }
    __syncthreads();
    if (!owns) continue;
    for (int hl = split; hl < TH; hl += nsplit) {
      if (MODE == kUp) {
        // a at input (hl, x); tap tx pairs it with output 2x + 1 - tx
        const float* pa = sa + (size_t)hl * g.AW * cin + ci0;
        const float* pg =
            sg + ((size_t)((1 - tz) * g.GH + 2 * hl + 1 - ty) * g.GW + 1) *
                     cout + co0;
        for (int x = 0; x < pw; ++x) {
          const float4 av = *reinterpret_cast<const float4*>(pa + x * cin);
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            const float4 gv = *reinterpret_cast<const float4*>(
                pg + (2 * x - kx) * cout);
            fma4(acc[kx][0], av.x, gv);
            fma4(acc[kx][1], av.y, gv);
            fma4(acc[kx][2], av.z, gv);
            fma4(acc[kx][3], av.w, gv);
          }
        }
      } else {
        // g at output (hl, x); tap kx pairs it with input x * S + kx
        const float* pa =
            sa + (size_t)(tz * g.AH + hl * S + ty) * g.AW * cin + ci0;
        const float* pg = sg + (size_t)hl * g.GW * cout + co0;
        for (int x = 0; x < pw; ++x) {
          const float4 gv = *reinterpret_cast<const float4*>(pg + x * cout);
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            const float4 av = *reinterpret_cast<const float4*>(
                pa + (x * S + kx) * cin);
            fma4(acc[kx][0], av.x, gv);
            fma4(acc[kx][1], av.y, gv);
            fma4(acc[kx][2], av.z, gv);
            fma4(acc[kx][3], av.w, gv);
          }
        }
      }
    }
  }
  if (owns) {
#pragma unroll
    for (int kx = 0; kx < K; ++kx)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          atomicAdd(&p.dw[((size_t)(kzy * K + kx) * cin + ci0 + i) * cout +
                          co0 + j],
                    acc[kx][i][j]);
  }
  if (bias_block) {
    const int c0 = (tid % co8) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) atomicAdd(&p.dbias[c0 + j], bsum[j]);
  }
}

// ---------------------------------------------------------------------------
// the 1x1 head on the activated last decoder grid (fused_head_grid2)
// ---------------------------------------------------------------------------

constexpr int kHeadMaxNC = 16;
constexpr int kHeadTile = 128;   // voxels per backward tile = its threads
constexpr int kHeadJobs = 10;    // reduction jobs per backward thread

__device__ __forceinline__ void load_bf16x8(const __nv_bfloat16* p,
                                            float out[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = words[i];
    const float2 f = __bfloat1622float2(h);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_bf16x8(__nv_bfloat16* p,
                                             const float v[8]) {
  uint32_t words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    words[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2],
                                            words[3]);
}

// y[v, k] = bf16(sum_c bf16(relu(x[v, c] * scale[b, c] + shift[b, c]))
// * w[c, k] + bias[k]): one thread a voxel, the weights (bf16 values as
// f32) and bias in shared memory; x read 8 channels per 16-byte load, y
// written 4 classes per 8-byte store when nc fills the NC slots. NC, the
// class slots (4 or 16), is a template argument so that the class loops
// unroll without predication; the slots past nc hold zero weights.
template <int NC>
__global__ void __launch_bounds__(kThreads) head_fwd_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, __nv_bfloat16* __restrict__ y,
    long long n, long long nvox, int c, int nc) {
  extern __shared__ float hs[];   // w (c, NC), then bias (NC), zero-padded
  for (int i = threadIdx.x; i < c * NC + NC; i += blockDim.x) {
    const int ci = i / NC, k = i % NC;
    hs[i] = k >= nc ? 0.f : ci < c ? w[ci * nc + k] : bias[k];
  }
  __syncthreads();
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const long long b = v / nvox;
  const float* sc = scale + b * c;
  const float* sh = shift + b * c;
  float acc[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) acc[k] = 0.f;
  for (int c0 = 0; c0 < c; c0 += 8) {
    float xv[8];
    load_bf16x8(x + v * c + c0, xv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ci = c0 + j;
      const float s = round_bf16(prologue(xv[j], sc[ci], sh[ci]));
#pragma unroll
      for (int k = 0; k < NC; ++k) acc[k] = fmaf(s, hs[ci * NC + k], acc[k]);
    }
  }
  __nv_bfloat16* out = y + v * nc;
  if (nc == NC) {
#pragma unroll
    for (int k = 0; k < NC; k += 4) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          __fadd_rn(acc[k], hs[c * NC + k]),
          __fadd_rn(acc[k + 1], hs[c * NC + k + 1]));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(
          __fadd_rn(acc[k + 2], hs[c * NC + k + 2]),
          __fadd_rn(acc[k + 3], hs[c * NC + k + 3]));
      *reinterpret_cast<uint2*>(out + k) = make_uint2(
          *reinterpret_cast<const uint32_t*>(&lo),
          *reinterpret_cast<const uint32_t*>(&hi));
    }
  } else {
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (k < nc)
        out[k] = __float2bfloat16_rn(__fadd_rn(acc[k], hs[c * NC + k]));
  }
}

// The head's backward. Per voxel: pre = x * scale + shift, s = bf16(relu(
// pre)), da = gy W^T, dam = [pre > 0] da, dx = bf16(dam * scale). Sums:
// dscale[b, c] = sum dam * x, dshift[b, c] = sum dam, dW = sum s gy^T,
// dbias = sum gy. A block walks tiles of kHeadTile voxels of one batch
// element: each thread computes its voxel's dx and writes s, dam * x, dam
// and gy to shared memory; then each thread owns up to kHeadJobs of the
// c * nc + nc + 2c sums, adds the tile's terms to registers, and at the
// end adds them to the outputs with one float atomic each. NC as in the
// forward: gy W^T runs over the NC slots, whose weights past nc are zero.
template <int NC>
__global__ void __launch_bounds__(kHeadTile) head_bwd_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gy,
    const float* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ shift, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ dstats, float* __restrict__ dw,
    float* __restrict__ dbias, long long nvox, int c, int nc) {
  // rows padded by one float so that a warp's row writes spread over banks
  const int cp = c + 1, np = nc + 1;
  extern __shared__ float hs[];
  float* sw = hs;                          // (c, NC), zero-padded
  float* ss = sw + c * NC;                 // kHeadTile rows of c: s
  float* sxm = ss + kHeadTile * cp;        // dam * x
  float* sdm = sxm + kHeadTile * cp;       // dam
  float* sg = sdm + kHeadTile * cp;        // kHeadTile rows of nc: gy
  for (int i = threadIdx.x; i < c * NC; i += blockDim.x)
    sw[i] = i % NC < nc ? w[i / NC * nc + i % NC] : 0.f;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const float* sc = scale + (size_t)b * c;
  const float* sh = shift + (size_t)b * c;
  const int njobs = c * nc + nc + 2 * c;
  float jacc[kHeadJobs];
#pragma unroll
  for (int i = 0; i < kHeadJobs; ++i) jacc[i] = 0.f;
  const long long ntiles = (nvox + kHeadTile - 1) / kHeadTile;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long vb = tile * kHeadTile + t;   // voxel within batch b
    __syncthreads();                             // the last tile is read
    if (vb < nvox) {
      const long long v = (long long)b * nvox + vb;
      float g[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        g[k] = k < nc ? __bfloat162float(gy[v * nc + k]) : 0.f;
        if (k < nc) sg[t * np + k] = g[k];
      }
      for (int c0 = 0; c0 < c; c0 += 8) {
        float xv[8], dv[8];
        load_bf16x8(x + v * c + c0, xv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ci = c0 + j;
          const float pre = __fadd_rn(__fmul_rn(xv[j], sc[ci]), sh[ci]);
          float da = 0.f;
#pragma unroll
          for (int k = 0; k < NC; ++k) da = fmaf(g[k], sw[ci * NC + k], da);
          const float dam = pre > 0.f ? da : 0.f;
          dv[j] = __fmul_rn(dam, sc[ci]);
          ss[t * cp + ci] = round_bf16(fmaxf(pre, 0.f));
          sxm[t * cp + ci] = __fmul_rn(dam, xv[j]);
          sdm[t * cp + ci] = dam;
        }
        store_bf16x8(dx + v * c + c0, dv);
      }
    } else {
      for (int k = 0; k < nc; ++k) sg[t * np + k] = 0.f;
      for (int ci = 0; ci < c; ++ci)
        ss[t * cp + ci] = sxm[t * cp + ci] = sdm[t * cp + ci] = 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kHeadJobs; ++i) {
      const int j = t + i * kHeadTile;
      if (j >= njobs) continue;
      float p = 0.f;
      if (j < c * nc) {
        const int ci = j / nc, k = j % nc;
        for (int q = 0; q < kHeadTile; ++q)
          p = fmaf(ss[q * cp + ci], sg[q * np + k], p);
      } else if (j < c * nc + nc) {
        const int k = j - c * nc;
        for (int q = 0; q < kHeadTile; ++q) p += sg[q * np + k];
      } else {
        const int ci = (j - c * nc - nc) % c;
        const float* src = j < c * nc + nc + c ? sxm : sdm;
        for (int q = 0; q < kHeadTile; ++q) p += src[q * cp + ci];
      }
      jacc[i] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < kHeadJobs; ++i) {
    const int j = t + i * kHeadTile;
    if (j >= njobs) continue;
    if (j < c * nc) {
      atomicAdd(&dw[j], jacc[i]);
    } else if (j < c * nc + nc) {
      atomicAdd(&dbias[j - c * nc], jacc[i]);
    } else {
      const int r = j - c * nc - nc;   // dscale (r < c), then dshift
      atomicAdd(&dstats[(size_t)b * 2 * c + r], jacc[i]);
    }
  }
}

bool head_shape_ok(long long nvox, int B, int c, int nc) {
  return nvox > 0 && B > 0 && c > 0 && c % 8 == 0 && nc > 0 &&
         nc <= kHeadMaxNC && c * nc + nc + 2 * c <= kHeadJobs * kHeadTile;
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

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// The head kernels' class slots for nc classes: 4 (the repo's class
// count) or 16, each a compiled instantiation.
constexpr int head_slots(int nc) { return nc <= 4 ? 4 : kHeadMaxNC; }

template <int NC>
int head_fwd_launch(const __nv_bfloat16* x, const float* w, const float* bias,
                    const float* scale, const float* shift, __nv_bfloat16* y,
                    int B, int V, int C, int nc, cudaStream_t stream) {
  const long long n = (long long)B * V;
  const size_t smem = sizeof(float) * ((size_t)C * NC + NC);
  head_fwd_kernel<NC><<<(int)((n + kThreads - 1) / kThreads), kThreads, smem,
                        stream>>>(x, w, bias, scale, shift, y, n, V, C, nc);
  return (int)cudaGetLastError();
}

// The backward's grid: per batch element, enough blocks of kHeadTile
// voxels to fill the card about 16 blocks an SM deep, each walking its
// share of the tiles; its sums leave with one atomic per block.
template <int NC>
int head_bwd_launch(const __nv_bfloat16* x, const __nv_bfloat16* gy,
                    const float* w, const float* scale, const float* shift,
                    __nv_bfloat16* dx, float* dstats, float* dw, float* dbias,
                    int B, int V, int C, int nc, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)C * NC + (size_t)kHeadTile * (3 * (C + 1) + nc + 1));
  cudaError_t err = allow_smem(head_bwd_kernel<NC>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = ((long long)V + kHeadTile - 1) / kHeadTile;
  long long per_batch = (16LL * num_sms() + B - 1) / B;
  if (per_batch > ntiles) per_batch = ntiles;
  head_bwd_kernel<NC><<<dim3((unsigned)per_batch, B), kHeadTile, smem,
                        stream>>>(x, gy, w, scale, shift, dx, dstats, dw,
                                  dbias, V, C, nc);
  return (int)cudaGetLastError();
}

// Host-side arguments of one forward or dgrad launch (see the kernels
// and DgradArgs for the meaning of each).
struct ConvParams {
  const __nv_bfloat16* x;
  const float* w;
  const float* bias;
  const float* scale;
  const float* shift;
  const __nv_bfloat16* accum;
  __nv_bfloat16* y;
  float* stats;
  const __nv_bfloat16* yfwd;
  const float* gstats;
  const __nv_bfloat16* xfwd;
  __nv_bfloat16* gadj;
  int D, H, W, cin, cout, activate, order;

  DgradArgs dgrad() const {
    return DgradArgs{yfwd, gstats, xfwd, gadj, order};
  }
};

// Forward or dgrad through the strided/SAME conv kernel; p.D/H/W are the
// input dims, the output dims are derived here.
template <int K, int S, int P, bool BWD>
int launch_conv(const ConvParams& p, int B, void* stream) {
  const int Do = (p.D + 2 * P - K) / S + 1;
  const int Ho = (p.H + 2 * P - K) / S + 1;
  const int Wo = (p.W + 2 * P - K) / S + 1;
  if (B <= 0 || Do <= 0 || Ho <= 0 || Wo % kTileW || Wo <= 0 ||
      p.cout % kTileC || p.cin <= 0)
    return (int)cudaErrorInvalidValue;
  auto bytes = [&](int th) {
    return sizeof(float) *
           ((size_t)K * ((th - 1) * S + K) * p.cin * ((Wo - 1) * S + K) +
            2 * (size_t)p.cout);
  };
  size_t smem = 0;
  const int TH = pick_rows(bytes, 4, 1, &smem);
  if (TH == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(conv_kernel<K, S, P, BWD>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = B * Do * ((Ho + TH - 1) / TH);
  conv_kernel<K, S, P, BWD><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      p.x, p.w, p.bias, p.scale, p.shift, p.accum, p.y, p.stats, p.D, p.H,
      p.W, p.cin, Do, Ho, Wo, p.cout, TH, p.activate, p.dgrad());
  return (int)cudaGetLastError();
}

// Forward or dgrad through the transposed-conv kernel; p.D/H/W are the
// input dims.
template <bool BWD>
int launch_up(const ConvParams& p, int B, void* stream) {
  const int Do = 2 * p.D, Ho = 2 * p.H, Wo = 2 * p.W;
  if (B <= 0 || p.D <= 0 || p.H <= 0 || Wo % kTileW || p.cout % kTileC ||
      p.cin <= 0)
    return (int)cudaErrorInvalidValue;
  auto bytes = [&](int th) {
    return sizeof(float) *
           ((size_t)(th / 2) * p.cin * p.W + 2 * (size_t)p.cout);
  };
  size_t smem = 0;
  const int TH = pick_rows(bytes, 4, 2, &smem);
  if (TH == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(up_kernel<BWD>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = B * Do * ((Ho + TH - 1) / TH);
  up_kernel<BWD><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      p.x, p.w, p.bias, p.scale, p.shift, p.y, p.stats, p.H, p.W, p.cin, Do,
      Ho, Wo, p.cout, TH, p.dgrad());
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_wgrad(WgradParams p, void* stream) {
  constexpr int K = MODE == kConv3 ? 3 : 2;
  // 8-channel groups; the threads' fixed dbias groups need
  // blockDim % (cout / 8) == 0 for every block size (a multiple of 32)
  if (p.B <= 0 || p.cin <= 0 || p.cout <= 0 || p.cin % 8 || p.cout % 8 ||
      32 % (p.cout / 8))
    return (int)cudaErrorInvalidValue;
  auto bytes = [&](int th) {
    return sizeof(float) * WgradGeom<MODE>(p, th).floats(p.cin, p.cout);
  };
  size_t smem = 0;
  p.TH = pick_rows(bytes, 4, 1, &smem);
  if (p.TH == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(wgrad_kernel<MODE>, smem);
  if (err != cudaSuccess) return (int)err;
  // weight tiles over blocks of at most kThreads threads; where a block
  // has tiles for half of its threads or fewer, its threads split the rows
  const int ntiles = K * K * (p.cin / 4) * (p.cout / 4);
  const int chunks = (ntiles + kThreads - 1) / kThreads;
  const int per = (ntiles + chunks - 1) / chunks;
  p.tile_threads = (per + 31) / 32 * 32;
  const int threads = p.tile_threads * (kThreads / p.tile_threads);
  const WgradGeom<MODE> g(p, p.TH);
  const int nvt = p.B * g.depth * ((g.rows + p.TH - 1) / p.TH);
  int gy = (2 * num_sms() + chunks - 1) / chunks;
  if (gy > nvt) gy = nvt;
  if (gy < 1) gy = 1;
  wgrad_kernel<MODE>
      <<<dim3(chunks, gy), threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

WgradParams wgrad_params(const void* x, const void* scale, const void* shift,
                         const void* gy, const void* y, const void* gstats,
                         void* dw, void* dbias, int B, int D, int H, int W,
                         int cin, int Do, int Ho, int Wo, int cout,
                         int activate) {
  WgradParams p{};
  p.x = (const __nv_bfloat16*)x;
  p.scale = (const float*)scale;
  p.shift = (const float*)shift;
  p.gy = (const __nv_bfloat16*)gy;
  p.y = (const __nv_bfloat16*)y;
  p.gstats = (const float*)gstats;
  p.dw = (float*)dw;
  p.dbias = (float*)dbias;
  p.B = B; p.D = D; p.H = H; p.W = W; p.cin = cin;
  p.Do = Do; p.Ho = Ho; p.Wo = Wo; p.cout = cout;
  p.activate = activate;
  return p;
}

}  // namespace

extern "C" {

int pcseg_conv3x3_gn_act(const void* x, const void* w, const void* bias,
                         const void* scale, const void* shift,
                         const void* accum, void* y, void* stats, int B, int D,
                         int H, int W, int cin, int cout, int activate,
                         void* stream) {
  ConvParams p{};
  p.x = (const __nv_bfloat16*)x;
  p.w = (const float*)w;
  p.bias = (const float*)bias;
  p.scale = (const float*)scale;
  p.shift = (const float*)shift;
  p.accum = (const __nv_bfloat16*)accum;
  p.y = (__nv_bfloat16*)y;
  p.stats = (float*)stats;
  p.D = D; p.H = H; p.W = W; p.cin = cin; p.cout = cout;
  p.activate = activate;
  return launch_conv<3, 1, 1, false>(p, B, stream);
}

int pcseg_down2x_gn_act(const void* x, const void* w, const void* bias,
                        const void* scale, const void* shift, void* y,
                        void* stats, int B, int D, int H, int W, int cin,
                        int cout, void* stream) {
  if (D % 2 || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  ConvParams p{};
  p.x = (const __nv_bfloat16*)x;
  p.w = (const float*)w;
  p.bias = (const float*)bias;
  p.scale = (const float*)scale;
  p.shift = (const float*)shift;
  p.y = (__nv_bfloat16*)y;
  p.stats = (float*)stats;
  p.D = D; p.H = H; p.W = W; p.cin = cin; p.cout = cout;
  p.activate = 1;
  return launch_conv<2, 2, 0, false>(p, B, stream);
}

int pcseg_up2x_gn_act(const void* x, const void* w, const void* bias,
                      const void* scale, const void* shift, void* y,
                      void* stats, int B, int D, int H, int W, int cin,
                      int cout, void* stream) {
  ConvParams p{};
  p.x = (const __nv_bfloat16*)x;
  p.w = (const float*)w;
  p.bias = (const float*)bias;
  p.scale = (const float*)scale;
  p.shift = (const float*)shift;
  p.y = (__nv_bfloat16*)y;
  p.stats = (float*)stats;
  p.D = D; p.H = H; p.W = W; p.cin = cin; p.cout = cout;
  p.activate = 1;
  return launch_up<false>(p, B, stream);
}

// 3^3 dgrad. gy/y (B, D, H, W, cout) bf16 (the forward's output and its
// cotangent; y unread without gstats); gstats (B, 2, cout) or null;
// x (B, D, H, W, cin) bf16 the forward's input; wt (3, 3, 3, cout, cin)
// f32, the forward's bf16 weights flipped and IO-swapped; scale/shift
// (B, cin), null without activation. Writes dx (B, D, H, W, cin) bf16,
// dstats (B, 2, cin) (zeroed; null without activation) and, if gadj is
// not null, the bf16 g' (B, D, H, W, cout).
int pcseg_conv3x3_dgrad(const void* gy, const void* y, const void* gstats,
                        const void* x, const void* wt, const void* scale,
                        const void* shift, void* dx, void* dstats, void* gadj,
                        int B, int D, int H, int W, int cin, int cout,
                        int activate, void* stream) {
  ConvParams p{};
  p.x = (const __nv_bfloat16*)gy;
  p.yfwd = (const __nv_bfloat16*)y;
  p.gstats = (const float*)gstats;
  p.xfwd = (const __nv_bfloat16*)x;
  p.w = (const float*)wt;
  p.scale = (const float*)scale;
  p.shift = (const float*)shift;
  p.y = (__nv_bfloat16*)dx;
  p.stats = activate ? (float*)dstats : nullptr;
  p.gadj = (__nv_bfloat16*)gadj;
  p.D = D; p.H = H; p.W = W; p.cin = cout; p.cout = cin;
  p.activate = activate;
  p.order = 0;
  return launch_conv<3, 1, 1, true>(p, B, stream);
}

// 3^3 wgrad: x (B, D, H, W, cin), gy/y (B, D, H, W, cout), gstats as in
// dgrad; writes dw (3, 3, 3, cin, cout) and dbias (cout,), both f32 and
// zeroed by the caller.
int pcseg_conv3x3_wgrad(const void* x, const void* scale, const void* shift,
                        const void* gy, const void* y, const void* gstats,
                        void* dw, void* dbias, int B, int D, int H, int W,
                        int cin, int cout, int activate, void* stream) {
  return launch_wgrad<kConv3>(
      wgrad_params(x, scale, shift, gy, y, gstats, dw, dbias, B, D, H, W,
                   cin, D, H, W, cout, activate),
      stream);
}

// down2x backward: x (B, D, H, W, cin); gy/y (B, D/2, H/2, W/2, cout);
// gstats (B, 2, cout); wt (2, 2, 2, cout, cin) = flip(W)^T; writes dx
// (B, D, H, W, cin) bf16, dstats (B, 2, cin), dw (2, 2, 2, cin, cout),
// dbias (cout,) (the last three zeroed). Two launches: dgrad through the
// transposed-conv kernel, then wgrad.
int pcseg_down2x_bwd(const void* x, const void* wt, const void* scale,
                     const void* shift, const void* gy, const void* y,
                     const void* gstats, void* dx, void* dstats, void* dw,
                     void* dbias, int B, int D, int H, int W, int cin,
                     int cout, void* stream) {
  if (D % 2 || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  ConvParams p{};
  p.x = (const __nv_bfloat16*)gy;
  p.yfwd = (const __nv_bfloat16*)y;
  p.gstats = (const float*)gstats;
  p.xfwd = (const __nv_bfloat16*)x;
  p.w = (const float*)wt;
  p.scale = (const float*)scale;
  p.shift = (const float*)shift;
  p.y = (__nv_bfloat16*)dx;
  p.stats = (float*)dstats;
  p.D = D / 2; p.H = H / 2; p.W = W / 2; p.cin = cout; p.cout = cin;
  p.activate = 1;
  p.order = 1;
  int rc = launch_up<true>(p, B, stream);
  if (rc != 0) return rc;
  return launch_wgrad<kDown>(
      wgrad_params(x, scale, shift, gy, y, gstats, dw, dbias, B, D, H, W,
                   cin, D / 2, H / 2, W / 2, cout, 1),
      stream);
}

// up2x backward: x (B, D, H, W, cin); gy/y (B, 2D, 2H, 2W, cout); gstats
// (B, 2, cout); wt (2, 2, 2, cout, cin) = flip(W)^T; writes dx, dstats,
// dw (2, 2, 2, cin, cout) with the forward's tap order, dbias. Two
// launches: dgrad through the strided-conv kernel, then wgrad.
int pcseg_up2x_bwd(const void* x, const void* wt, const void* scale,
                   const void* shift, const void* gy, const void* y,
                   const void* gstats, void* dx, void* dstats, void* dw,
                   void* dbias, int B, int D, int H, int W, int cin, int cout,
                   void* stream) {
  ConvParams p{};
  p.x = (const __nv_bfloat16*)gy;
  p.yfwd = (const __nv_bfloat16*)y;
  p.gstats = (const float*)gstats;
  p.xfwd = (const __nv_bfloat16*)x;
  p.w = (const float*)wt;
  p.scale = (const float*)scale;
  p.shift = (const float*)shift;
  p.y = (__nv_bfloat16*)dx;
  p.stats = (float*)dstats;
  p.D = 2 * D; p.H = 2 * H; p.W = 2 * W; p.cin = cout; p.cout = cin;
  p.activate = 1;
  p.order = 1;
  int rc = launch_conv<2, 2, 0, true>(p, B, stream);
  if (rc != 0) return rc;
  return launch_wgrad<kUp>(
      wgrad_params(x, scale, shift, gy, y, gstats, dw, dbias, B, D, H, W,
                   cin, 2 * D, 2 * H, 2 * W, cout, 1),
      stream);
}

// The 1x1 head of fused_head_grid2: x (B, V, C) bf16 (V voxels an event,
// C a multiple of 8, 16-byte aligned); w (C, NC) f32 holding bf16 values;
// bias (NC,) f32; scale/shift (B, C) f32. Writes y (B, V, NC) bf16.
int pcseg_head_grid2(const void* x, const void* w, const void* bias,
                     const void* scale, const void* shift, void* y, int B,
                     int V, int C, int NC, void* stream) {
  if (!head_shape_ok(V, B, C, NC)) return (int)cudaErrorInvalidValue;
  const auto xb = (const __nv_bfloat16*)x;
  const auto wf = (const float*)w, bf = (const float*)bias;
  const auto sc = (const float*)scale, sh = (const float*)shift;
  const auto st = (cudaStream_t)stream;
  if (head_slots(NC) == 4)
    return head_fwd_launch<4>(xb, wf, bf, sc, sh, (__nv_bfloat16*)y, B, V, C,
                              NC, st);
  return head_fwd_launch<kHeadMaxNC>(xb, wf, bf, sc, sh, (__nv_bfloat16*)y,
                                     B, V, C, NC, st);
}

// Its backward: x, w, scale, shift as in the forward; gy (B, V, NC) bf16.
// Writes dx (B, V, C) bf16 and adds into dstats (B, 2, C) = (dscale,
// dshift), dw (C, NC) and dbias (NC,), all f32 and zeroed by the caller.
int pcseg_head_grid2_bwd(const void* x, const void* gy, const void* w,
                         const void* scale, const void* shift, void* dx,
                         void* dstats, void* dw, void* dbias, int B, int V,
                         int C, int NC, void* stream) {
  if (!head_shape_ok(V, B, C, NC)) return (int)cudaErrorInvalidValue;
  const auto xb = (const __nv_bfloat16*)x, gb = (const __nv_bfloat16*)gy;
  const auto wf = (const float*)w;
  const auto sc = (const float*)scale, sh = (const float*)shift;
  const auto dxb = (__nv_bfloat16*)dx;
  const auto ds = (float*)dstats, dwf = (float*)dw, db = (float*)dbias;
  const auto st = (cudaStream_t)stream;
  if (head_slots(NC) == 4)
    return head_bwd_launch<4>(xb, gb, wf, sc, sh, dxb, ds, dwf, db, B, V, C,
                              NC, st);
  return head_bwd_launch<kHeadMaxNC>(xb, gb, wf, sc, sh, dxb, ds, dwf, db, B,
                                     V, C, NC, st);
}

}  // extern "C"
