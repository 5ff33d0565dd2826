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
//                         _conv_route: Cin != Cout, C not 8, 16, 32 or 64,
//                         W not 16, 32 or a multiple of 64 (of 32 at 64
//                         channels), or H not a multiple of the ring
//                         tile's rows).
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
//                         take (the forward's rule, _conv_route).
//   pcseg_conv3x3_wgrad   replaces _wgrad_pallas (_wgrad_kernel, pallas_call
//                         at :648): dW (3,3,3,Cin,Cout) and dbias, for the
//                         shapes csrc/conv3d_dgrad.cu's split-K GEMM does
//                         not take (the forward's rule, _conv_route).
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
// The head takes C a multiple of 8 up to 128 and 1 to 128 classes (every
// width the JAX package's fused head takes on the port's routing). It is
// one pass over the grid, bound by its bytes (B8 x 64^3 x 16 -> 4: x 67
// MB and y 17 MB forward, x, gy and dx 151 MB backward). Forward: a
// warp a run of m16 tiles of voxels on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 sums), its A fragments loaded straight
// from x (8 bytes a row and lane, a run ahead), the prologue applied to
// them in registers, W^T in shared memory as bf16, y staged a tile at a
// time and written as one span. Backward:
// 8 channels a lane (one 16-byte load of x and store of dx), x and gy a
// tile ahead by cp.async, dW and dbias on the tensor cores (mma.sync) in
// the warps' registers, dscale / dshift in the lanes' registers, and a
// partial row a block summed in a fixed order: no float atomics.
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

#include <type_traits>

#include "mma_sync.cuh"

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

constexpr int kHeadMaxC = 128;     // channels: a multiple of 8 up to this
constexpr int kHeadMaxNC = 128;    // classes: 1 up to this
constexpr int kFwdWarps = 8;       // forward: warps a block
constexpr int kHeadThreads = 256;  // backward: threads a block
constexpr int kHeadWarps = kHeadThreads / 32;
constexpr int kHeadMaxTile = 256;  // backward: voxels a tile at most
constexpr int kHeadStages = 4;     // backward: x / gy tiles in the ring
constexpr int kHeadSmallNC = 4;    // backward: weights in registers up to
constexpr size_t kHeadSmemTarget = 110 * 1024;  // two blocks an SM

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

// The forward's plan at (c, nc): the k16 steps over the channels and the
// steps the loads cover (kp: ks, or ks rounded up to pairs where two
// steps load together), the n8 tiles over the classes, W^T's shared row
// stride in bf16 (so that a quarter warp's 8- or 16-byte reads of its
// class rows fall on distinct banks: 16 ks + 8 at one step, else the
// least multiple of 32 past 16 kp that is 32 mod 64), a warp's y staging
// in bf16 (16 rows of nc, whole 16-byte units), and the shared bytes of a
// block (W^T, scale and shift, the warps' staging).
struct HeadFwdPlan {
  int ks, kp, nt, ws, ys;
  size_t smem;
};

struct HeadFwdArgs {
  const __nv_bfloat16* x;
  const float* w;
  const float* bias;
  const float* scale;
  const float* shift;
  __nv_bfloat16* y;
  long long nvox;
  int c, nc, kp, nt, ws, ys;
};

__device__ __forceinline__ uint32_t head_smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// a 16-byte cp.async reading its first ``bytes`` (0 to 16) and zeroing
// the rest
__device__ __forceinline__ void cp16n(uint32_t dst, const void* src,
                                      int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// the prologue on one A fragment register: two bf16 x values of channels
// k, k + 1 -> bf16(relu(x * scale + shift)) of each; p = (scale_k,
// shift_k, scale_k+1, shift_k+1)
__device__ __forceinline__ uint32_t act_pair(uint32_t w, const float4& p) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      prologue(__uint_as_float(w << 16), p.x, p.y),
      prologue(__uint_as_float(w & 0xffff0000u), p.z, p.w));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The lane's channels of k16 step s, as the A and B fragments hold them:
// k slots 2 t, 2 t + 1 and 2 t + 8, 2 t + 9 of lane t (t = lane % 4) are
// channels ch, ch + 1 and ch + 2, ch + 3 with ch = 4 t at one k16 step (a
// row's 4 channels in one 8-byte load), or, where two steps are loaded
// together (KSM >= 2), ch = 32 (s / 2) + 8 t + 4 (s % 2) (a row's 8
// channels of the two steps in one 16-byte load). Either map is a
// permutation of the step's channels, the same for A and B.
template <int KSM>
__device__ __forceinline__ int head_fwd_ch(int s, int t4) {
  return KSM == 1 ? 4 * t4 : 32 * (s / 2) + 8 * t4 + 4 * (s % 2);
}

// y[v, k] = bf16(sum_c bf16(relu(x[v, c] * scale[b, c] + shift[b, c]))
// * w[c, k] + bias[k]) on the tensor cores, mma.sync m16n8k16 with bf16
// operands and f32 sums. A warp takes m16 tiles (16 voxels each) of one
// batch element (grid y), every (gridDim.x x kFwdWarps)-th one, and loads
// its A fragments straight from x on the channel map of head_fwd_ch:
// lane (g, t) loads rows g and g + 8 with one 8-byte (one k16 step) or
// 16-byte (two steps) load a row, and a warp's load reads whole 32-byte
// sectors. W^T's B fragments follow the same map (one 8- or 16-byte
// shared load a class row), so the product is the same sum. D tiles of x
// are in flight a warp, loaded D tiles ahead into registers: no shared
// memory for x, no barrier. The prologue is applied to the fragment's
// registers, each lane knowing its channels from its lane; channels past
// C load as zeros with zero weights. The epilogue adds the f32 bias,
// rounds once to bf16 and stages the tile's 16 rows in the warp's shared
// memory, which the warp writes as one span with 16-byte stores. The
// sums' order is fixed by the shapes: two calls give the same bits. KSM
// bounds the k16 steps and NTM the n8 tiles.
template <int KSM, int NTM>
__global__ void __launch_bounds__(kFwdWarps * 32) head_fwd_kernel(
    const HeadFwdArgs a) {
  extern __shared__ __align__(16) unsigned char hsm[];
  constexpr int D = KSM <= 2 ? 4 : 2;         // m16 tiles in flight
  constexpr int L = KSM == 1 ? 1 : KSM / 2;   // x loads a row and tile
  using XW = typename std::conditional<KSM == 1, uint2, uint4>::type;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = a.c, nc = a.nc, ws = a.ws, b = blockIdx.y;
  // W^T [nt 8][ws] bf16, zero past nc and C; (scale, shift) [16 kp][2]
  // zero past C; then each warp's y staging (ys bf16)
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(hsm);
  float* sst = reinterpret_cast<float*>(wt + a.nt * 8 * ws);
  __nv_bfloat16* ys =
      reinterpret_cast<__nv_bfloat16*>(sst + 32 * a.kp) + warp * a.ys;
  for (int i = tid; i < a.nt * 8 * 16 * a.kp; i += blockDim.x) {
    const int k = i / (16 * a.kp), ci = i - k * 16 * a.kp;
    wt[k * ws + ci] = __float2bfloat16_rn(k < nc && ci < c ? a.w[ci * nc + k]
                                                           : 0.f);
  }
  for (int i = tid; i < 16 * a.kp; i += blockDim.x) {
    sst[2 * i] = i < c ? a.scale[(size_t)b * c + i] : 0.f;
    sst[2 * i + 1] = i < c ? a.shift[(size_t)b * c + i] : 0.f;
  }
  float bv[NTM][2];
#pragma unroll
  for (int j = 0; j < NTM; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 8 * j + 2 * t4 + e;
      bv[j][e] = k < nc ? a.bias[k] : 0.f;
    }
  __syncthreads();
  const long long nm = (a.nvox + 15) / 16;
  const long long stride = (long long)gridDim.x * kFwdWarps;
  const long long first = (long long)blockIdx.x * kFwdWarps + warp;
  const __nv_bfloat16* xb = a.x + (long long)b * a.nvox * c;
  __nv_bfloat16* yb = a.y + (long long)b * a.nvox * nc;
  // y spans start on 16 bytes where the batch element's rows do
  const bool vec = ((reinterpret_cast<size_t>(yb)) & 15) == 0;

  // the lane's x words of m16 tile mt: rows g and g + 8, load l's
  // channels (zeros past the grid and past C)
  auto load = [&](long long mt, XW (&r)[L][2]) {
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = mt * 16 + g + 8 * h;
        const int ch = head_fwd_ch<KSM>(2 * l, t4);
        r[l][h] = row < a.nvox && ch < c
                      ? *reinterpret_cast<const XW*>(xb + row * c + ch)
                      : XW{};
      }
  };

  XW xr[D][L][2];
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (first + d * stride < nm) load(first + d * stride, xr[d]);
  for (long long base = first; base < nm; base += D * stride) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const long long mt = base + d * stride;
      if (mt >= nm) break;
      float acc[NTM][4];
#pragma unroll
      for (int j = 0; j < NTM; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KSM; ++s) {
        if (s < a.kp) {   // (a pair's second step may hold real channels)
          const int ch = head_fwd_ch<KSM>(s, t4);
          const float4 p0 = *reinterpret_cast<const float4*>(sst + 2 * ch);
          const float4 p1 =
              *reinterpret_cast<const float4*>(sst + 2 * ch + 4);
          const uint32_t* r0 =
              reinterpret_cast<const uint32_t*>(&xr[d][s / 2][0]);
          const uint32_t* r1 =
              reinterpret_cast<const uint32_t*>(&xr[d][s / 2][1]);
          const int o = KSM == 1 ? 0 : 2 * (s % 2);
          const uint32_t af[4] = {act_pair(r0[o], p0), act_pair(r1[o], p0),
                                  act_pair(r0[o + 1], p1),
                                  act_pair(r1[o + 1], p1)};
#pragma unroll
          for (int j = 0; j < NTM; ++j) {
            if (j < a.nt) {
              const uint2 bw = *reinterpret_cast<const uint2*>(
                  wt + (8 * j + g) * ws + ch);
              mma_sync::mma(acc[j], af, bw.x, bw.y);
            }
          }
        }
      }
      // the slot's next tile, D tiles ahead
      if (mt + D * stride < nm) load(mt + D * stride, xr[d]);
      // rows g and g + 8, classes 8 j + 2 t4 + {0, 1}, into the staging
#pragma unroll
      for (int j = 0; j < NTM; ++j) {
        const int k = 8 * j + 2 * t4;
        if (j < a.nt && k < nc) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float lo = __fadd_rn(acc[j][2 * h], bv[j][0]);
            const float hi = __fadd_rn(acc[j][2 * h + 1], bv[j][1]);
            __nv_bfloat16* o = ys + (g + 8 * h) * nc + k;
            if ((nc & 1) == 0) {
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __floats2bfloat162_rn(lo, hi);
            } else {
              o[0] = __float2bfloat16_rn(lo);
              if (k + 1 < nc) o[1] = __float2bfloat16_rn(hi);
            }
          }
        }
      }
      __syncwarp();
      // the tile's valid rows: one span of y
      const int n = (int)min(16LL, a.nvox - mt * 16) * nc;
      __nv_bfloat16* dst = yb + mt * 16 * nc;
      const int done = vec ? n / 8 * 8 : 0;
      for (int i = lane; i < done / 8; i += 32)
        reinterpret_cast<uint4*>(dst)[i] =
            reinterpret_cast<const uint4*>(ys)[i];
      for (int i = done + lane; i < n; i += 32) dst[i] = ys[i];
      __syncwarp();
    }
  }
}

// The byte-streaming route of the 1x1 head, at up to 4 classes (the
// default 64^3 x 16 -> 4, where the tensor-core kernel reads x at a
// lower rate: PERF.md section 6): one thread a voxel, x read 8 channels
// per 16-byte load, the weights (bf16 values as f32) and bias in shared
// memory, each class's sum over the channels in order with f32 FMAs, y
// written 4 classes per 8-byte store where nc is 4.
__global__ void __launch_bounds__(kThreads) head_fwd_stream_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, __nv_bfloat16* __restrict__ y,
    long long n, long long nvox, int c, int nc) {
  constexpr int NC = 4;
  __shared__ float hs[kHeadMaxC * NC + NC];   // w (c, 4), then bias (4)
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
  const float* hb = hs + c * NC;
  __nv_bfloat16* out = y + v * nc;
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
  if (nc == NC) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(
        __fadd_rn(acc[0], hb[0]), __fadd_rn(acc[1], hb[1]));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(
        __fadd_rn(acc[2], hb[2]), __fadd_rn(acc[3], hb[3]));
    *reinterpret_cast<uint2*>(out) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  } else {
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (k < nc) out[k] = __float2bfloat16_rn(__fadd_rn(acc[k], hb[k]));
  }
}

// The backward's plan at (c, nc), the same for every launch of that
// width: lanes a voxel (a power of two >= c / 8, each lane on 8
// consecutive channels), voxels a tile, the m16 tiles over the c + 1 rows
// of dW^T's product (the last row is dbias: a column of ones beside s)
// and the n8 tiles over the classes, the (m, n) tile pairs a warp, the
// warps that share one pair's K steps (where there are fewer pairs than
// warps, so that every warp takes part in the products), the shared
// tiles' row strides in bf16 (an odd number of 16-byte units, so
// that ldmatrix's eight rows fall in distinct banks), the raw gy span's
// length, and the shared bytes a block.
struct HeadBwdPlan {
  int lanes, tile, mt, nt, pw, ksplit, sp, gp, raw;
  bool small;
  size_t smem;
};

// Arguments of one backward launch; part is the partial table, a row of
// c nc + nc + 2 c floats a block (dW, dbias, dscale, dshift).
struct HeadBwdArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* gy;
  const float* w;
  const float* scale;
  const float* shift;
  __nv_bfloat16* dx;
  float* part;
  long long nvox;
  int c, nc, lanes, tile, mt, nt, ksplit, sp, gp, raw;
};

// The head's backward. Per voxel: pre = x * scale + shift, s = bf16(relu(
// pre)), da = gy W^T, dam = [pre > 0] da, dx = bf16(dam * scale). Sums:
// dscale[b, c] = sum dam * x, dshift[b, c] = sum dam, dW = sum s gy^T,
// dbias = sum gy.
//
// A block of 8 warps walks the tiles of ``tile`` voxels of one batch
// element (grid y) that are its by a static assignment (tile t to block
// t mod gridDim.x), so the order of every sum is fixed. Each tile's x and
// gy come by cp.async through a ring of kHeadStages tiles, three tiles
// ahead (x as it lies, gy as the raw span of its rows from the 16-byte
// boundary below it). Per voxel, its lanes each take 8 channels: one
// 16-byte shared load of x, da from FMAs over the classes, one 16-byte
// store of dx, and dscale / dshift in the lane's registers.
//
// The voxel's gy row goes into a gy tile (classes padded to n8 tiles); W
// sits in the lane's registers up to kHeadSmallNC classes (SMALL; the
// repo's 4), else W^T in shared memory; s goes to an s tile beside a
// column of ones (written once), and the warps run dW^T
// (and dbias, the ones row) += [s | 1]^T gy with mma.sync m16n8k16 (bf16
// s and gy, f32 sums), each warp on its (m, n) tile pairs, whose sums
// stay in its registers over the block's tiles; with fewer pairs than
// warps, ksplit warps share a pair, each on every ksplit-th K step, and
// their sums are added in warp order at the end. The s and gy tiles have
// two slots, so the products of tile t - 1 run after step 1 of tile t
// with one barrier a tile.
//
// At the end each block writes its row of the partial table (sums over
// the warp's voxel groups by shuffles, then the warps in order);
// head_bwd_sum_kernel adds the rows in a fixed order. No float atomics,
// no zero fills: two calls give the same bits.
template <int PW, bool SMALL>
__global__ void __launch_bounds__(kHeadThreads, PW <= 4 ? 2 : 1)
    head_bwd_kernel(const HeadBwdArgs a) {
  extern __shared__ __align__(16) unsigned char hsm[];
  const int c = a.c, nc = a.nc, L = a.lanes, R = 32 / L, tv = a.tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sl = lane % L, grp = lane / L, k0 = 8 * sl;
  const bool on = k0 < c;   // lanes past c / 8 hold no channels
  const int b = blockIdx.y;
  // x tiles [S][tv][c], raw gy spans [S][raw], s tiles [2][tv][sp], gy
  // tiles [2][tv][gp], then (above kHeadSmallNC classes) W^T [nc][c] f32
  constexpr int S = kHeadStages;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(hsm);
  __nv_bfloat16* gr = xs + S * tv * c;
  __nv_bfloat16* ss = gr + S * a.raw;
  __nv_bfloat16* gt = ss + 2 * tv * a.sp;
  float* wt = reinterpret_cast<float*>(gt + 2 * tv * a.gp);
  const uint32_t xs_u = head_smem_u32(xs), gr_u = head_smem_u32(gr);
  const uint32_t ss_u = head_smem_u32(ss), gt_u = head_smem_u32(gt);
  // the s and gy tiles' pad columns (zeros) and the ones column beside s
  // (dbias's row of the products; a voxel past the tile's end has gy = 0)
  // are written here and never again
  for (int i = tid; i < 2 * tv * (a.sp + a.gp) / 8; i += kHeadThreads)
    reinterpret_cast<uint4*>(ss)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int v = tid; v < 2 * tv; v += kHeadThreads)
    ss[v * a.sp + c] = __float2bfloat16_rn(1.f);
  // up to kHeadSmallNC classes, W in the lane's registers
  float wr[SMALL ? 8 : 1][kHeadSmallNC];
  if constexpr (SMALL) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < kHeadSmallNC; ++k)
        wr[j][k] = on && k < nc ? a.w[(k0 + j) * nc + k] : 0.f;
  } else {
    for (int i = tid; i < nc * c; i += kHeadThreads)
      wt[i] = a.w[(i % c) * nc + i / c];
  }
  float scv[8], shv[8], ds[8], dh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    scv[j] = on ? a.scale[(size_t)b * c + k0 + j] : 0.f;
    shv[j] = on ? a.shift[(size_t)b * c + k0 + j] : 0.f;
    ds[j] = dh[j] = 0.f;
  }
  float acc[PW][4];
#pragma unroll
  for (int i = 0; i < PW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int pairs = a.mt * a.nt, ks_n = a.ksplit;
  // the warp's first pair and K phase: ksplit > 1 gives warp w pair w mod
  // pairs at phase w / pairs (one pair a warp), else pairs w PW + i
  const int p0 = ks_n > 1 ? warp % pairs : warp * PW;
  const int kp = ks_n > 1 ? warp / pairs : 0;
  const long long ntiles = (a.nvox + tv - 1) / tv;
  const long long etot = (long long)gridDim.y * a.nvox * nc;

  // tile t into ring slot buf; a commit group either way, so that every
  // thread's groups count one a tile
  auto issue = [&](long long t, int buf) {
    if (t >= ntiles) {
      mma_sync::cp_commit();
      return;
    }
    const long long v0 = t * tv;
    const long long cnt = min((long long)tv, a.nvox - v0);
    const __nv_bfloat16* xsrc = a.x + ((long long)b * a.nvox + v0) * c;
    const int xok = (int)cnt * c / 8;
    for (int i = tid; i < tv * c / 8; i += kHeadThreads)
      cp16n(xs_u + (uint32_t)(buf * tv * c + 8 * i) * 2,
            i < xok ? xsrc + 8 * i : xsrc, i < xok ? 16 : 0);
    const long long e0 = ((long long)b * a.nvox + v0) * nc;
    const long long a0 = e0 & ~7LL, e1 = e0 + cnt * nc;
    for (int i = tid; i < (int)((e1 - a0 + 7) / 8); i += kHeadThreads) {
      const long long e = a0 + 8LL * i;
      const long long left = (etot - e) * 2;
      cp16n(gr_u + (uint32_t)(buf * a.raw + 8 * i) * 2, a.gy + e,
            left >= 16 ? 16 : (int)left);
    }
    mma_sync::cp_commit();
  };

  // the warp's pairs: whether each is its, and the byte offsets of the
  // lane's ldmatrix rows in the s and gy tiles at its first K step, so
  // that a K step costs two ldmatrix, one mma and two adds (the kernel is
  // bound by issued instructions as much as by bytes)
  bool use[PW];
  uint32_t a_off[PW], b_off[PW];
#pragma unroll
  for (int i = 0; i < PW; ++i) {
    const int p = p0 + i;
    use[i] = ks_n > 1 ? i == 0 && kp < ks_n : p < pairs;
    const int mt = use[i] ? p / a.nt : 0, nt = use[i] ? p % a.nt : 0;
    a_off[i] = (uint32_t)(((16 * kp + (lane & 7) + (lane >> 4) * 8) * a.sp
                           + (2 * mt + ((lane >> 3) & 1)) * 8) * 2);
    b_off[i] = (uint32_t)(((16 * kp + (lane & 15)) * a.gp + 8 * nt) * 2);
  }
  const int nks = kp < tv / 16 ? (tv / 16 - kp + ks_n - 1) / ks_n : 0;
  const uint32_t a_step = (uint32_t)(16 * ks_n * a.sp * 2);
  const uint32_t b_step = (uint32_t)(16 * ks_n * a.gp * 2);
  // dW^T and dbias += [s | 1]^T gy over a tile's voxels, from s / gy
  // tile slot sb
  auto products = [&](int sb) {
    uint32_t s_u = ss_u + (uint32_t)(sb * tv * a.sp) * 2;
    uint32_t g_u = gt_u + (uint32_t)(sb * tv * a.gp) * 2;
    for (int k = 0; k < nks; ++k, s_u += a_step, g_u += b_step) {
#pragma unroll
      for (int i = 0; i < PW; ++i) {
        if (use[i]) {
          uint32_t af[4], bf[2];
          mma_sync::ldsm4t(af, s_u + a_off[i]);
          mma_sync::ldsm2t(bf, g_u + b_off[i]);
          mma_sync::mma(acc[i], af, bf[0], bf[1]);
        }
      }
    }
  };

  long long t = blockIdx.x;
#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue(t + (long long)i * gridDim.x, i);
  int it = 0;   // tiles done
  for (int buf = 0; t < ntiles; t += gridDim.x, buf = (buf + 1) % S, ++it) {
    mma_sync::cp_wait<S - 2>();
    // tile t is in; step 1 of the last tile and the products of the one
    // before it are done, so their s / gy tile slot is free
    __syncthreads();
    issue(t + (long long)(S - 1) * gridDim.x, (buf + S - 1) % S);
    const int sb = it & 1;   // this tile's s / gy tile slot
    __nv_bfloat16* st = ss + sb * tv * a.sp;
    __nv_bfloat16* gtt = gt + sb * tv * a.gp;
    const long long v0 = t * tv;
    const int cnt = (int)min((long long)tv, a.nvox - v0);
    // (where nc % 4 == 0, e0 and so this offset are multiples of 4)
    const __nv_bfloat16* graw =
        gr + buf * a.raw + (int)((((long long)b * a.nvox + v0) * nc) & 7);
    const __nv_bfloat16* xt = xs + buf * tv * c;
    // 1. per voxel: the gy tile's row (zeros past the tile's end), dx, s
    // and the dstats terms
    for (int vw = warp * R; vw < tv; vw += kHeadWarps * R) {
      const int v = vw + grp;
      const bool in = v < tv, valid = v < cnt;
      // the voxel's gy row into the gy tile, 8 classes a lane a step
      if (in) {
        for (int q = sl; q < a.nt; q += L) {
          uint32_t u[4] = {0, 0, 0, 0};
          if (nc % 4 == 0) {   // the span's rows start 8-byte aligned
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (valid && 8 * q + 4 * h < nc) {
                const uint2 w2 = *reinterpret_cast<const uint2*>(
                    graw + v * nc + 8 * q + 4 * h);
                u[2 * h] = w2.x;
                u[2 * h + 1] = w2.y;
              }
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int k = 8 * q + j;
              if (valid && k < nc)
                u[j / 2] |=
                    (uint32_t)__bfloat16_as_ushort(graw[v * nc + k])
                    << (16 * (j & 1));
            }
          }
          *reinterpret_cast<uint4*>(gtt + v * a.gp + 8 * q) =
              make_uint4(u[0], u[1], u[2], u[3]);
        }
      }
      __syncwarp();
      if (in && on) {
        float xv[8], da[8];
        load_bf16x8(xt + v * c + k0, xv);
#pragma unroll
        for (int j = 0; j < 8; ++j) da[j] = 0.f;
        if constexpr (SMALL) {
          float g8[8];
          load_bf16x8(gtt + v * a.gp, g8);
#pragma unroll
          for (int k = 0; k < kHeadSmallNC; ++k)
#pragma unroll
            for (int j = 0; j < 8; ++j) da[j] = fmaf(g8[k], wr[j][k], da[j]);
        } else {
          for (int q = 0; q < a.nt; ++q) {
            float g8[8];
            load_bf16x8(gtt + v * a.gp + 8 * q, g8);
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              const int k = 8 * q + kk;
              if (k < nc) {
                const float4 w0 =
                    *reinterpret_cast<const float4*>(wt + k * c + k0);
                const float4 w1 =
                    *reinterpret_cast<const float4*>(wt + k * c + k0 + 4);
                const float wk[8] = {w0.x, w0.y, w0.z, w0.w,
                                     w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                for (int j = 0; j < 8; ++j)
                  da[j] = fmaf(g8[kk], wk[j], da[j]);
              }
            }
          }
        }
        // (a voxel past the tile's end has x = 0 and gy = 0, so da = dam
        // = 0 and its s meets only zeros in the products: no test a term)
        float sv[8], dv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float pre = __fadd_rn(__fmul_rn(xv[j], scv[j]), shv[j]);
          const float dam = pre > 0.f ? da[j] : 0.f;
          dv[j] = __fmul_rn(dam, scv[j]);
          sv[j] = fmaxf(pre, 0.f);   // rounded once below
          ds[j] = __fadd_rn(ds[j], __fmul_rn(dam, xv[j]));
          dh[j] = __fadd_rn(dh[j], dam);
        }
        store_bf16x8(st + v * a.sp + k0, sv);
        if (valid)
          store_bf16x8(a.dx + ((long long)b * a.nvox + v0 + v) * c + k0,
                       dv);
      }
    }
    // 2. the last tile's products, while other warps are still in this
    // tile's step 1
    if (it > 0) products(sb ^ 1);
  }
  __syncthreads();
  if (it > 0) products((it - 1) & 1);
  // 3. this block's row of the partial table
  const int wl = c * nc + nc;
  float* prow =
      a.part + ((long long)b * gridDim.x + blockIdx.x) * (wl + 2 * c);
  const int g = lane >> 2, t4 = lane & 3;
  __syncthreads();   // the ring is free (only empty groups are in flight)
  float* red = reinterpret_cast<float*>(hsm);   // [warps][2 c], then
  float* kred = red + kHeadWarps * 2 * c;       // [warps][32 lanes][4]
  if (ks_n > 1) {   // the K phases of a pair, in warp order
#pragma unroll
    for (int e = 0; e < 4; ++e)
      kred[(warp * 32 + lane) * 4 + e] = acc[0][e];
    __syncthreads();
    if (warp < pairs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = kred[(warp * 32 + lane) * 4 + e];
        for (int q = 1; q < ks_n; ++q)
          sum = __fadd_rn(sum,
                          kred[((warp + q * pairs) * 32 + lane) * 4 + e]);
        acc[0][e] = sum;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PW; ++i) {
    const int p = p0 + i;
    if (ks_n > 1 ? i == 0 && warp < pairs : p < pairs) {
      const int mt = p / a.nt, nt = p % a.nt;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * mt + g + 8 * (e >> 1);
        const int n = 8 * nt + 2 * t4 + (e & 1);
        if (n < nc && m <= c)
          prow[m < c ? m * nc + n : c * nc + n] = acc[i][e];
      }
    }
  }
  // dscale / dshift: the lanes of one channel chunk across the warp's
  // voxel groups (butterfly), then the warps in order
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ds[j] = __fadd_rn(ds[j], __shfl_xor_sync(0xffffffffu, ds[j], off));
      dh[j] = __fadd_rn(dh[j], __shfl_xor_sync(0xffffffffu, dh[j], off));
    }
  }
  if (grp == 0 && on) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[warp * 2 * c + k0 + j] = ds[j];
      red[warp * 2 * c + c + k0 + j] = dh[j];
    }
  }
  __syncthreads();
  for (int k = tid; k < 2 * c; k += kHeadThreads) {
    float s = 0.f;
    for (int w = 0; w < kHeadWarps; ++w) s = __fadd_rn(s, red[w * 2 * c + k]);
    prow[wl + k] = s;
  }
}

// The backward's sums from its partial table (rows b gb + i: batch
// element b's blocks): dW and dbias over every row, dscale / dshift of b
// over its gb rows. 32 outputs a block, 32 row lanes each adding every
// 32nd row in order, then the lanes in order.
__global__ void __launch_bounds__(1024) head_bwd_sum_kernel(
    const float* __restrict__ part, int gb, int nb, int c, int nc,
    float* __restrict__ dw, float* __restrict__ dbias,
    float* __restrict__ dstats) {
  __shared__ float red[32][33];
  const int wl = c * nc + nc, rl = wl + 2 * c;
  const long long outs = wl + (long long)nb * 2 * c;
  const long long o = (long long)blockIdx.x * 32 + threadIdx.x;
  long long col = o, r0 = 0, r1 = (long long)nb * gb;
  if (o >= wl) {
    const long long j = o - wl, b = j / (2 * c);
    col = wl + j % (2 * c);
    r0 = b * gb;
    r1 = r0 + gb;
  }
  float acc = 0.f;
  if (o < outs)
    for (long long r = r0 + threadIdx.y; r < r1; r += 32)
      acc = __fadd_rn(acc, part[r * rl + col]);
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && o < outs) {
    float s = 0.f;
    for (int r = 0; r < 32; ++r) s = __fadd_rn(s, red[r][threadIdx.x]);
    if (o < (long long)c * nc) dw[o] = s;
    else if (o < wl) dbias[o - (long long)c * nc] = s;
    else dstats[o - wl] = s;
  }
}

bool head_shape_ok(long long nvox, int B, int c, int nc) {
  return nvox > 0 && B > 0 && B <= 65535 && c >= 8 && c <= kHeadMaxC &&
         c % 8 == 0 && nc >= 1 && nc <= kHeadMaxNC;
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

// The forward's plan at (c, nc) (see HeadFwdPlan).
void head_fwd_plan(int c, int nc, HeadFwdPlan* p) {
  p->ks = (c + 15) / 16;
  p->kp = p->ks == 1 ? 1 : (p->ks + 1) / 2 * 2;
  p->nt = (nc + 7) / 8;
  p->ws = p->ks == 1 ? 24 : (16 * p->kp + 31) / 64 * 64 + 32;
  p->ys = (16 * nc + 7) / 8 * 8;
  p->smem = 2 * (size_t)p->nt * 8 * p->ws + 8 * 16 * (size_t)p->kp +
            2 * (size_t)kFwdWarps * p->ys;
}

// a grid of as many blocks as the card holds at once, split over the
// batch elements, no more than the m16 tiles need
template <int KSM, int NTM>
int head_fwd_launch(const HeadFwdArgs& a, const HeadFwdPlan& p, int B,
                    cudaStream_t stream) {
  cudaError_t err = allow_smem(head_fwd_kernel<KSM, NTM>, p.smem);
  if (err != cudaSuccess) return (int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, head_fwd_kernel<KSM, NTM>, kFwdWarps * 32, p.smem);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((a.nvox + 15) / 16 + kFwdWarps - 1) / kFwdWarps;
  long long gx = ((long long)(occ < 1 ? 1 : occ) * num_sms() + B - 1) / B;
  gx = gx > need ? need : gx < 1 ? 1 : gx;
  head_fwd_kernel<KSM, NTM><<<dim3((unsigned)gx, (unsigned)B),
                              kFwdWarps * 32, p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KSM>
int head_fwd_nt(const HeadFwdArgs& a, const HeadFwdPlan& p, int B,
                cudaStream_t st) {
  if (p.nt <= 1) return head_fwd_launch<KSM, 1>(a, p, B, st);
  if (p.nt <= 2) return head_fwd_launch<KSM, 2>(a, p, B, st);
  if (p.nt <= 4) return head_fwd_launch<KSM, 4>(a, p, B, st);
  if (p.nt <= 8) return head_fwd_launch<KSM, 8>(a, p, B, st);
  return head_fwd_launch<KSM, 16>(a, p, B, st);
}

// The backward's plan at (c, nc) (see HeadBwdPlan): the largest tile of
// 256, 128, ... 16 voxels whose shared memory lets two blocks share an
// SM, else the largest that fits one; false past the hardware limit.
bool head_bwd_plan(int c, int nc, HeadBwdPlan* p) {
  p->lanes = 1;
  while (p->lanes * 8 < c) p->lanes *= 2;
  p->mt = (c + 16) / 16;   // c + 1 rows: the channels, then the ones row
  p->nt = (nc + 7) / 8;
  const int pairs = p->mt * p->nt;
  p->pw = (pairs + kHeadWarps - 1) / kHeadWarps;
  p->ksplit = pairs < kHeadWarps ? kHeadWarps / pairs : 1;
  p->sp = 16 * p->mt + 8;
  p->gp = 8 * (p->nt | 1);
  p->small = nc <= kHeadSmallNC;
  auto bytes = [&](int tv) {
    const int raw = 8 * ((tv * nc + 14) / 8);
    const size_t ring =
        (size_t)2 * (kHeadStages * (tv * c + raw) +
                     2 * tv * (p->sp + p->gp)) +
        (p->small ? 0 : (size_t)4 * nc * c);
    // the end's sums reuse it: dscale / dshift and the K phases a warp
    const size_t sums = (size_t)4 * kHeadWarps * (2 * c + 128);
    return ring > sums ? ring : sums;
  };
  int fit = 0;
  for (int tv = kHeadMaxTile; tv >= 16 && !fit; tv /= 2)
    if (bytes(tv) <= kHeadSmemTarget) fit = tv;
  for (int tv = kHeadMaxTile; tv >= 16 && !fit; tv /= 2)
    if (bytes(tv) <= kSmemMax) fit = tv;
  if (!fit) return false;
  p->tile = fit;
  p->raw = 8 * ((fit * nc + 14) / 8);
  p->smem = bytes(fit);
  return true;
}

using HeadBwdKernel = void (*)(const HeadBwdArgs);

HeadBwdKernel head_bwd_kernel_for(const HeadBwdPlan& p) {
  if (p.small) return p.pw <= 1 ? head_bwd_kernel<1, true>
                                : head_bwd_kernel<2, true>;
  if (p.pw <= 1) return head_bwd_kernel<1, false>;
  if (p.pw <= 2) return head_bwd_kernel<2, false>;
  if (p.pw <= 4) return head_bwd_kernel<4, false>;
  if (p.pw <= 8) return head_bwd_kernel<8, false>;
  return head_bwd_kernel<18, false>;   // 9 x 16 pairs at 128 x 128
}

// Blocks a batch element: the card's SMs times the blocks an SM holds,
// shared out over the batch, at most one a tile; 0 on an error.
int head_bwd_blocks(const HeadBwdPlan& p, HeadBwdKernel k, int B,
                    long long V) {
  if (allow_smem(k, p.smem) != cudaSuccess) return 0;
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, kHeadThreads,
                                                    p.smem) != cudaSuccess)
    return 0;
  if (occ < 1) occ = 1;
  const long long ntiles = (V + p.tile - 1) / p.tile;
  long long gb = ((long long)num_sms() * occ + B - 1) / B;
  if (gb > ntiles) gb = ntiles;
  return (int)gb;
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
  const auto st = (cudaStream_t)stream;
  if (NC <= 4) {   // the byte-streaming route
    const long long n = (long long)B * V;
    head_fwd_stream_kernel<<<(int)((n + kThreads - 1) / kThreads), kThreads,
                             0, st>>>(
        (const __nv_bfloat16*)x, (const float*)w, (const float*)bias,
        (const float*)scale, (const float*)shift, (__nv_bfloat16*)y, n, V,
        C, NC);
    return (int)cudaGetLastError();
  }
  HeadFwdPlan p;
  head_fwd_plan(C, NC, &p);
  const HeadFwdArgs a{(const __nv_bfloat16*)x, (const float*)w,
                      (const float*)bias, (const float*)scale,
                      (const float*)shift, (__nv_bfloat16*)y, V, C, NC,
                      p.kp, p.nt, p.ws, p.ys};
  if (p.ks <= 1) return head_fwd_nt<1>(a, p, B, st);
  if (p.ks <= 2) return head_fwd_nt<2>(a, p, B, st);
  if (p.ks <= 4) return head_fwd_nt<4>(a, p, B, st);
  return head_fwd_nt<8>(a, p, B, st);
}

// The scratch pcseg_head_grid2_bwd needs at (B, V, C, NC), in floats
// (its partial table: a row of C NC + NC + 2 C a block), or -1 for a
// shape it does not take.
int pcseg_head_grid2_bwd_scratch(int B, int V, int C, int NC) {
  HeadBwdPlan p;
  if (!head_shape_ok(V, B, C, NC) || !head_bwd_plan(C, NC, &p)) return -1;
  const int gb = head_bwd_blocks(p, head_bwd_kernel_for(p), B, V);
  const long long n = (long long)B * gb * (C * NC + NC + 2 * C);
  return gb < 1 || n > 0x7fffffffLL ? -1 : (int)n;
}

// Its backward: x, w, scale, shift as in the forward (x and gy 16-byte
// aligned); gy (B, V, NC) bf16. Writes dx (B, V, C) bf16, dstats (B, 2,
// C) = (dscale, dshift), dw (C, NC) and dbias (NC,), all f32 and every
// value; scratch pcseg_head_grid2_bwd_scratch floats.
int pcseg_head_grid2_bwd(const void* x, const void* gy, const void* w,
                         const void* scale, const void* shift, void* dx,
                         void* dstats, void* dw, void* dbias, void* scratch,
                         int B, int V, int C, int NC, void* stream) {
  HeadBwdPlan p;
  if (!head_shape_ok(V, B, C, NC) || !head_bwd_plan(C, NC, &p))
    return (int)cudaErrorInvalidValue;
  const HeadBwdKernel k = head_bwd_kernel_for(p);
  const int gb = head_bwd_blocks(p, k, B, V);
  if (gb < 1) return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  const HeadBwdArgs a{(const __nv_bfloat16*)x, (const __nv_bfloat16*)gy,
                      (const float*)w, (const float*)scale,
                      (const float*)shift, (__nv_bfloat16*)dx,
                      (float*)scratch, V, C, NC, p.lanes, p.tile, p.mt,
                      p.nt, p.ksplit, p.sp, p.gp, p.raw};
  k<<<dim3((unsigned)gb, (unsigned)B), kHeadThreads, p.smem, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long outs = (long long)C * NC + NC + 2LL * B * C;
  head_bwd_sum_kernel<<<(unsigned)((outs + 31) / 32), dim3(32, 32), 0, st>>>(
      (const float*)scratch, gb, B, C, NC, (float*)dw, (float*)dbias,
      (float*)dstats);
  return (int)cudaGetLastError();
}

}  // extern "C"
