// Fused conv-bias + LayerNorm + affine + ReLU + active-mask for Hopper
// (sm_90a), forward and backward.
//
//   pcseg_bias_ln_relu_mask      replaces pcseg_tpu/ops/pallas/fused_ln.py
//                                bias_ln_relu_mask / ln_relu_mask
//                                (_fwd_kernel, pallas_call at :178): per row
//                                of x (N, C)
//     xb   = f32(x) + pre_bias
//     mean = sum(xb) / C,  var = max(sum(xb^2) / C - mean^2, 0)
//     z    = (xb - mean) * rsqrt(var + eps) * scale + bias
//     out  = active ? max(z, 0) : 0, rounded once to the output type.
//   pcseg_bias_ln_relu_mask_bwd  replaces its backward (_bwd_kernel,
//                                pallas_call at :198): per row, from x and
//                                the cotangent g of out,
//     x_hat = (xb - mean) * rstd (moments recomputed as in the forward)
//     dz    = active && z > 0 ? g : 0,   dxhat = dz * scale
//     dx    = rstd * (dxhat - mean(dxhat) - x_hat * mean(dxhat * x_hat)),
//             rounded once to x's type,
//   and the column sums over all N rows, in f32: dscale = sum dz * x_hat,
//   dbias = sum dz, dpre_bias = sum dx (the f32 dx, before its rounding).
//
// The TPU kernels take a (1024, C) row block a grid step, reduce over the
// lanes and carry the column sums from one grid step to the next. Here a
// group of L lanes takes one row, 32 / L rows a warp (L the least power
// of two from 4 to 32 with C <= 8 L: C = 64 takes 8 lanes, four rows a
// warp), so that a warp has several rows' loads in flight and its
// shuffle reductions take log2(L) steps. Lane l of a group holds the
// channels l, l + L, ... of its row in registers, 8 a chunk of 8 L
// channels; a row wider than 256 channels is walked in chunks and read
// again for its second pass (from L1). Blocks run in parallel, so the
// backward's column sums take two passes: each block writes one row of a
// (blocks, 3, C) partial table, and a second kernel (column_sum_kernel)
// adds the rows of that table in a fixed order. The backward has two
// routes, chosen by shape before the launch. The vector route (C a
// multiple of 8 up to 256, 16-byte aligned rows: the sparse U-Net's 64
// and 128) gives each lane 8 consecutive channels, vector loads and
// stores, the vectors and column partials in registers and a persistent
// grid (ln_bwd_vec_kernel). The strided route takes every other C: lane
// groups as in the forward, each adding its rows' terms into its own
// slice of shared memory (lane l owns its columns, so no atomics), at
// most 4 rows a group (bias_ln_relu_mask_bwd_kernel). Both
// directions are bound by bytes: one read of x (and g) and one write of
// out (dx): 67 / 100 MB at the sparse U-Net's 262,144 x 64 level-0 rows,
// 0.020 / 0.030 ms at 3.35 TB/s.
// Products and sums are written with the _rn intrinsics, so nvcc fuses
// none of them into an FMA: the plain PyTorch version rounds at the same
// points. Row and column sums are taken in another order than torch's.
//
// Plain C interface (loaded with ctypes): each entry returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                // channels a lane holds a chunk
constexpr int kRowsPerGroup = 4;       // backward: rows a lane group at most
constexpr int kColSmem = 200 * 1024;   // backward: column sums' budget

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

// sum over the L lanes of an aligned lane group (all 32 lanes take part)
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Lanes a row: the least power of two from 4 to 32 that holds C in
// chunks of kPer a lane; 32 / L rows a warp.
int lanes_for(int c) {
  int l = 4;
  while (l < 32 && l * kPer < c) l *= 2;
  return l;
}

// mean and rstd of one row of xb = x + pre_bias (single-pass moments) by
// its group of L lanes, lane ``sl`` of the group taking channels sl,
// sl + L, ...; fills v with xb of the row's first chunk (all of it when
// c <= L kPer). ``valid`` false (a row past n): no loads, the shuffles
// still taken.
template <typename Tin, int L>
__device__ __forceinline__ void row_moments(
    const Tin* __restrict__ xr, const float* __restrict__ pre_bias, int c,
    int sl, bool valid, float eps, float (&v)[kPer], float& mean,
    float& rstd) {
  float s = 0.f, ss = 0.f;
  for (int c0 = 0; c0 < c; c0 += L * kPer) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = c0 + sl + L * j;
      const bool in = valid && k < c;
      const float xv = in ? __fadd_rn(to_float(xr[k]), pre_bias[k]) : 0.f;
      if (c0 == 0) v[j] = xv;
      if (in) {
        s = __fadd_rn(s, xv);
        ss = __fadd_rn(ss, __fmul_rn(xv, xv));
      }
    }
  }
  s = group_sum<L>(s);
  ss = group_sum<L>(ss);
  mean = __fdiv_rn(s, (float)c);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(ss, (float)c), __fmul_rn(mean, mean)), 0.f);
  rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// Forward: 32 / L rows a warp, one a lane group.
template <typename Tin, typename Tout, int L>
__global__ void __launch_bounds__(kThreads) bias_ln_relu_mask_kernel(
    const Tin* __restrict__ x, const float* __restrict__ pre_bias,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const uint8_t* __restrict__ active, Tout* __restrict__ out, long long n,
    int c, float eps) {
  constexpr int R = 32 / L;
  const int lane = threadIdx.x & 31;
  const long long row =
      ((long long)blockIdx.x * kWarps + threadIdx.x / 32) * R + lane / L;
  const int sl = lane % L;
  const bool valid = row < n;
  const Tin* xr = x + (valid ? row : 0) * c;
  const bool one = c <= L * kPer;
  float v[kPer], mean, rstd;
  row_moments<Tin, L>(xr, pre_bias, c, sl, valid, eps, v, mean, rstd);
  if (!valid) return;
  const bool act = active[row] != 0;
  Tout* o = out + row * c;
  for (int c0 = 0; c0 < c; c0 += L * kPer) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = c0 + sl + L * j;
      if (k < c) {
        const float xv =
            one ? v[j] : __fadd_rn(to_float(xr[k]), pre_bias[k]);
        const float z = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(xv, mean), rstd), scale[k]),
            bias[k]);
        o[k] = from_float<Tout>(act && z > 0.f ? z : 0.f);
      }
    }
  }
}

// Backward: 32 / L rows a warp at a time, one a lane group, at most
// kRowsPerGroup rows a group (rows strided over the grid), so that many
// blocks are in flight. Column partial sums in shared memory, one slice
// [dscale | dbias | dpre_bias][C] per lane group (lane sl of a group owns
// the columns sl + L j of its slice: no atomics), then one row of
// ``partial`` per block, the slices summed in order.
template <typename Tin, typename Tg, int L>
__global__ void __launch_bounds__(kThreads) bias_ln_relu_mask_bwd_kernel(
    const Tin* __restrict__ x, const float* __restrict__ pre_bias,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const uint8_t* __restrict__ active, const Tg* __restrict__ g,
    Tin* __restrict__ dx, float* __restrict__ partial, long long n, int c,
    float eps) {
  constexpr int R = 32 / L;
  extern __shared__ float cols[];
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x & 31, sl = lane % L;
  const int grp = (threadIdx.x / 32) * R + lane / L;
  float* my = cols + (long long)grp * 3 * c;
  for (int k = sl; k < 3 * c; k += L) my[k] = 0.f;
  __syncwarp();
  const bool one = c <= L * kPer;
  for (long long base = ((long long)blockIdx.x * warps + threadIdx.x / 32)
                        * R;
       base < n; base += (long long)gridDim.x * warps * R) {
    const long long row = base + lane / L;
    const bool valid = row < n;
    const Tin* xr = x + (valid ? row : 0) * c;
    const Tg* gr = g + (valid ? row : 0) * c;
    float v[kPer], gv[kPer], mean, rstd;
    row_moments<Tin, L>(xr, pre_bias, c, sl, valid, eps, v, mean, rstd);
    if (one) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int k = sl + L * j;
        gv[j] = valid && k < c ? to_float(gr[k]) : 0.f;
      }
    }
    const bool act = valid && active[row] != 0;
    // pass 1: dz, the dscale / dbias columns and the two row means
    float a1 = 0.f, a2 = 0.f;
    for (int c0 = 0; c0 < c; c0 += L * kPer) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int k = c0 + sl + L * j;
        if (valid && k < c) {
          const float xv =
              one ? v[j] : __fadd_rn(to_float(xr[k]), pre_bias[k]);
          const float gk = one ? gv[j] : to_float(gr[k]);
          const float xh = __fmul_rn(__fsub_rn(xv, mean), rstd);
          const float z = __fadd_rn(__fmul_rn(xh, scale[k]), bias[k]);
          const float dz = act && z > 0.f ? gk : 0.f;
          my[k] = __fadd_rn(my[k], __fmul_rn(dz, xh));
          my[c + k] = __fadd_rn(my[c + k], dz);
          const float dxh = __fmul_rn(dz, scale[k]);
          a1 = __fadd_rn(a1, dxh);
          a2 = __fadd_rn(a2, __fmul_rn(dxh, xh));
        }
      }
    }
    const float m1 = __fdiv_rn(group_sum<L>(a1), (float)c);
    const float m2 = __fdiv_rn(group_sum<L>(a2), (float)c);
    if (!valid) continue;
    // pass 2: dx and the dpre_bias column
    Tin* dr = dx + row * c;
    for (int c0 = 0; c0 < c; c0 += L * kPer) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int k = c0 + sl + L * j;
        if (k < c) {
          const float xv =
              one ? v[j] : __fadd_rn(to_float(xr[k]), pre_bias[k]);
          const float gk = one ? gv[j] : to_float(gr[k]);
          const float xh = __fmul_rn(__fsub_rn(xv, mean), rstd);
          const float z = __fadd_rn(__fmul_rn(xh, scale[k]), bias[k]);
          const float dz = act && z > 0.f ? gk : 0.f;
          const float dxh = __fmul_rn(dz, scale[k]);
          const float d = __fmul_rn(
              rstd, __fsub_rn(__fsub_rn(dxh, m1), __fmul_rn(xh, m2)));
          dr[k] = from_float<Tin>(d);
          my[2 * c + k] = __fadd_rn(my[2 * c + k], d);
        }
      }
    }
  }
  __syncthreads();
  const int groups = warps * R;
  for (int k = threadIdx.x; k < 3 * c; k += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < groups; ++w)
      acc = __fadd_rn(acc, cols[(long long)w * 3 * c + k]);
    partial[(long long)blockIdx.x * 3 * c + k] = acc;
  }
}

// sums[k] = sum over the partial table's rows, in row order: 32 columns a
// block, 32 row lanes each summing every 32nd row, then the lanes in order
__global__ void __launch_bounds__(1024) column_sum_kernel(
    const float* __restrict__ partial, int rows, int c3,
    float* __restrict__ sums) {
  __shared__ float part[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (col < c3) {
#pragma unroll 8
    for (int r = threadIdx.y; r < rows; r += 32)
      acc = __fadd_rn(acc, partial[(long long)r * c3 + col]);
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < c3) {
    float s = 0.f;
    for (int r = 0; r < 32; ++r) s = __fadd_rn(s, part[r][threadIdx.x]);
    sums[col] = s;
  }
}

// ---------------------------------------------------------------------------
// The backward's vector route: C a multiple of 8 up to 256, 16-byte
// aligned rows (bias_ln_relu_mask_bwd_vec_ok). A lane holds 8 consecutive
// channels of its row: one 16-byte load of x and of g (two each in f32),
// one 16-byte store of dx (two in f32); L = the least power of two >= C /
// 8 lanes a row (lanes past C / 8 hold none), R = 32 / L rows a warp at a
// time. pre_bias, scale and bias of the lane's channels stay in registers,
// and so do the lane's three column partials (dscale, dbias, dpre_bias)
// over all its rows. The grid is persistent, a few blocks an SM, and the
// rows are dealt statically: warp w of block i takes rows base + r (r <
// R, one a lane group) for base = (i W + w) R + k W R gridDim.x, so the
// order of every sum is fixed. The lane's rows two sweeps ahead (x, g and
// the mask) are loaded before the current row's reductions. At the end
// the lanes of a channel chunk are summed across the warp's row groups by
// shuffles, the warps in order through shared memory, and each block
// writes one row of the (blocks, 3, C) partial table, which
// column_sum_kernel adds in row order. Where C is a power of two, the row
// means multiply by 1 / C (the same bits as the division, fewer
// instructions: the kernel is close to bound by issued instructions).
// ---------------------------------------------------------------------------

constexpr int kVecThreads = 256;
constexpr int kVecWarps = kVecThreads / 32;
constexpr int kVecMaxC = 256;

// a row's 8 values of one lane, as loaded: one 16-byte word (bf16) or two
template <typename T> struct Raw8;
template <> struct Raw8<__nv_bfloat16> {
  uint4 w = make_uint4(0, 0, 0, 0);
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = u[i];
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <> struct Raw8<float> {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename Tin, typename Tg, int L>
__global__ void __launch_bounds__(kVecThreads, 2) ln_bwd_vec_kernel(
    const Tin* __restrict__ x, const float* __restrict__ pre_bias,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const uint8_t* __restrict__ active, const Tg* __restrict__ g,
    Tin* __restrict__ dx, float* __restrict__ partial, long long n, int c,
    float eps) {
  constexpr int R = 32 / L;
  __shared__ float red[kVecWarps][3 * kVecMaxC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sl = lane % L, grp = lane / L, k0 = 8 * sl;
  const bool on = k0 < c;
  float pb[8], sc[8], bi[8], cs[8], cb[8], cp[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pb[j] = on ? pre_bias[k0 + j] : 0.f;
    sc[j] = on ? scale[k0 + j] : 0.f;
    bi[j] = on ? bias[k0 + j] : 0.f;
    cs[j] = cb[j] = cp[j] = 0.f;
  }
  // a row mean: x / c, or x * (1 / c) where c is a power of two (the
  // same bits, without the division's instruction sequence)
  const float fc = (float)c, rc = 1.f / fc;
  const bool pow2 = (c & (c - 1)) == 0;
  auto mean_of = [&](float v) {
    return pow2 ? __fmul_rn(v, rc) : __fdiv_rn(v, fc);
  };
  const long long step = (long long)gridDim.x * kVecWarps * R;
  long long base = ((long long)blockIdx.x * kVecWarps + warp) * R;
  // the lane's rows two sweeps ahead: (rx, rg, act) the current row's,
  // (nx, ng, nact) the next one's
  long long row = base + grp;
  Raw8<Tin> rx, nx;
  Raw8<Tg> rg, ng;
  bool act = false, nact = false;
  if (on && row < n) {
    rx.load(x + row * c + k0);
    rg.load(g + row * c + k0);
    act = active[row] != 0;
  }
  if (on && row + step < n) {
    nx.load(x + (row + step) * c + k0);
    ng.load(g + (row + step) * c + k0);
    nact = active[row + step] != 0;
  }
  for (; base < n; base += step, row += step) {
    const bool valid = on && row < n;
    const long long frow = row + 2 * step;
    Raw8<Tin> fx;
    Raw8<Tg> fg;
    bool fact = false;
    if (on && frow < n) {
      fx.load(x + frow * c + k0);
      fg.load(g + frow * c + k0);
      fact = active[frow] != 0;
    }
    float xv[8], gv[8];
    rx.get(xv);
    rg.get(gv);
    // the row's moments (xv becomes xb = x + pre_bias, then x_hat)
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xv[j] = valid ? __fadd_rn(xv[j], pb[j]) : 0.f;
      s = __fadd_rn(s, xv[j]);
      ss = __fadd_rn(ss, __fmul_rn(xv[j], xv[j]));
    }
    s = group_sum<L>(s);
    ss = group_sum<L>(ss);
    const float mean = mean_of(s);
    const float var =
        fmaxf(__fsub_rn(mean_of(ss), __fmul_rn(mean, mean)), 0.f);
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    // dz, the dscale / dbias columns and the two row means (gv becomes
    // dxhat = dz * scale)
    const bool a = valid && act;
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xv[j] = __fmul_rn(__fsub_rn(xv[j], mean), rstd);
      const float z = __fadd_rn(__fmul_rn(xv[j], sc[j]), bi[j]);
      const float dz = a && z > 0.f ? gv[j] : 0.f;
      cs[j] = __fadd_rn(cs[j], __fmul_rn(dz, xv[j]));
      cb[j] = __fadd_rn(cb[j], dz);
      gv[j] = __fmul_rn(dz, sc[j]);
      a1 = __fadd_rn(a1, gv[j]);
      a2 = __fadd_rn(a2, __fmul_rn(gv[j], xv[j]));
    }
    const float m1 = mean_of(group_sum<L>(a1));
    const float m2 = mean_of(group_sum<L>(a2));
    if (valid) {
      float d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d[j] = __fmul_rn(rstd,
                         __fsub_rn(__fsub_rn(gv[j], m1), __fmul_rn(xv[j], m2)));
        cp[j] = __fadd_rn(cp[j], d[j]);
      }
      store8(dx + row * c + k0, d);
    }
    rx = nx;
    rg = ng;
    act = nact;
    nx = fx;
    ng = fg;
    nact = fact;
  }
  // the lanes of one channel chunk across the warp's R row groups
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cs[j] = __fadd_rn(cs[j], __shfl_xor_sync(0xffffffffu, cs[j], off));
      cb[j] = __fadd_rn(cb[j], __shfl_xor_sync(0xffffffffu, cb[j], off));
      cp[j] = __fadd_rn(cp[j], __shfl_xor_sync(0xffffffffu, cp[j], off));
    }
  }
  if (grp == 0 && on) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[warp][k0 + j] = cs[j];
      red[warp][c + k0 + j] = cb[j];
      red[warp][2 * c + k0 + j] = cp[j];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 3 * c; k += kVecThreads) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kVecWarps; ++w) acc = __fadd_rn(acc, red[w][k]);
    partial[(long long)blockIdx.x * 3 * c + k] = acc;
  }
}

bool bwd_vec_ok(int c) { return c > 0 && c % 8 == 0 && c <= kVecMaxC; }

// lanes a row on the vector route: the least power of two >= c / 8
int vec_lanes(int c) {
  int l = 1;
  while (l * 8 < c) l *= 2;
  return l;
}

// the vector route's kernel at (x, g) types and c
template <typename Tin, typename Tg>
void (*vec_kernel_for(int c))(const Tin*, const float*, const float*,
                              const float*, const uint8_t*, const Tg*, Tin*,
                              float*, long long, int, float) {
  switch (vec_lanes(c)) {
    case 1: return ln_bwd_vec_kernel<Tin, Tg, 1>;
    case 2: return ln_bwd_vec_kernel<Tin, Tg, 2>;
    case 4: return ln_bwd_vec_kernel<Tin, Tg, 4>;
    case 8: return ln_bwd_vec_kernel<Tin, Tg, 8>;
    case 16: return ln_bwd_vec_kernel<Tin, Tg, 16>;
    default: return ln_bwd_vec_kernel<Tin, Tg, 32>;
  }
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

// blocks of the vector route: the SMs times the blocks an SM holds, at
// most one a warp-sweep of rows (kVecWarps R rows); 0 on an error
template <typename Tin, typename Tg>
int vec_blocks(long long n, int c) {
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, vec_kernel_for<Tin, Tg>(c), kVecThreads, 0) != cudaSuccess)
    return 0;
  if (occ < 1) occ = 1;
  const long long per = (long long)kVecWarps * (32 / vec_lanes(c));
  const long long need = (n + per - 1) / per;
  const long long cap = (long long)num_sms() * occ;
  return (int)(need < cap ? need : cap);
}

template <typename Tin, typename Tout, int L>
void launch(const void* x, const void* pre_bias, const void* scale,
            const void* bias, const void* active, void* out, long long n,
            int c, float eps, cudaStream_t stream) {
  const long long rows = (long long)kWarps * (32 / L);
  bias_ln_relu_mask_kernel<Tin, Tout, L><<<(unsigned)((n + rows - 1) / rows),
                                           kThreads, 0, stream>>>(
      (const Tin*)x, (const float*)pre_bias, (const float*)scale,
      (const float*)bias, (const uint8_t*)active, (Tout*)out, n, c, eps);
}

template <typename Tin, typename Tout>
void launch_any(const void* x, const void* pre_bias, const void* scale,
                const void* bias, const void* active, void* out, long long n,
                int c, float eps, cudaStream_t s) {
  switch (lanes_for(c)) {
    case 4:
      return launch<Tin, Tout, 4>(x, pre_bias, scale, bias, active, out, n,
                                  c, eps, s);
    case 8:
      return launch<Tin, Tout, 8>(x, pre_bias, scale, bias, active, out, n,
                                  c, eps, s);
    case 16:
      return launch<Tin, Tout, 16>(x, pre_bias, scale, bias, active, out, n,
                                   c, eps, s);
    default:
      return launch<Tin, Tout, 32>(x, pre_bias, scale, bias, active, out, n,
                                   c, eps, s);
  }
}

// warps a block of the backward: as many as the column sums' shared memory
// allows (12 C bytes a lane group), at most kWarps
int bwd_warps(int c) {
  const long long groups = 32 / lanes_for(c);
  const long long w = kColSmem / (12LL * c * groups);
  return (int)(w < kWarps ? w : kWarps);
}

int bwd_smem(int c) { return bwd_warps(c) * (32 / lanes_for(c)) * 12 * c; }

template <typename Tin, typename Tg, int L>
int launch_bwd(const void* x, const void* pre_bias, const void* scale,
               const void* bias, const void* active, const void* g, void* dx,
               float* partial, long long n, int c, float eps, int blocks,
               cudaStream_t stream) {
  auto kern = bias_ln_relu_mask_bwd_kernel<Tin, Tg, L>;
  const int smem = bwd_smem(c);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, bwd_warps(c) * 32, smem, stream>>>(
      (const Tin*)x, (const float*)pre_bias, (const float*)scale,
      (const float*)bias, (const uint8_t*)active, (const Tg*)g, (Tin*)dx,
      partial, n, c, eps);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tg>
int launch_bwd_any(const void* x, const void* pre_bias, const void* scale,
                   const void* bias, const void* active, const void* g,
                   void* dx, float* partial, long long n, int c, float eps,
                   int blocks, cudaStream_t s) {
  switch (lanes_for(c)) {
    case 4:
      return launch_bwd<Tin, Tg, 4>(x, pre_bias, scale, bias, active, g, dx,
                                    partial, n, c, eps, blocks, s);
    case 8:
      return launch_bwd<Tin, Tg, 8>(x, pre_bias, scale, bias, active, g, dx,
                                    partial, n, c, eps, blocks, s);
    case 16:
      return launch_bwd<Tin, Tg, 16>(x, pre_bias, scale, bias, active, g, dx,
                                     partial, n, c, eps, blocks, s);
    default:
      return launch_bwd<Tin, Tg, 32>(x, pre_bias, scale, bias, active, g, dx,
                                     partial, n, c, eps, blocks, s);
  }
}

}  // namespace

extern "C" {

// x (N, C) bf16 (x_bf16 = 1) or f32, row-major; pre_bias, scale, bias (C,)
// f32; active (N,) bool (one byte a row); out (N, C) bf16 (out_bf16 = 1)
// or f32. C >= 1.
int pcseg_bias_ln_relu_mask(const void* x, const void* pre_bias,
                            const void* scale, const void* bias,
                            const void* active, void* out, long long N,
                            int C, float eps, int x_bf16, int out_bf16,
                            void* stream) {
  if (N <= 0 || C <= 0 || N / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16 && out_bf16)
    launch_any<__nv_bfloat16, __nv_bfloat16>(x, pre_bias, scale, bias,
                                             active, out, N, C, eps, s);
  else if (x_bf16)
    launch_any<__nv_bfloat16, float>(x, pre_bias, scale, bias, active, out,
                                     N, C, eps, s);
  else if (out_bf16)
    launch_any<float, __nv_bfloat16>(x, pre_bias, scale, bias, active, out,
                                     N, C, eps, s);
  else
    launch_any<float, float>(x, pre_bias, scale, bias, active, out, N, C,
                             eps, s);
  return (int)cudaGetLastError();
}

// The largest C the backward takes (its column sums live in shared
// memory, 12 C bytes a lane group, at least one warp a block; above 256
// channels a group is the whole warp).
int pcseg_bias_ln_relu_mask_bwd_max_c(void) {
  return kColSmem / (3 * (int)sizeof(float));
}

// 1 where the backward takes the vector route at C (16-byte aligned x, g
// and dx are the caller's to check), else 0.
int pcseg_bias_ln_relu_mask_bwd_vec_ok(int C) { return bwd_vec_ok(C) ? 1 : 0; }

// Blocks of the backward at (N, C) on the route ``vec`` with these x and
// g types: the rows of its partial table (0 for a shape it does not take).
int pcseg_bias_ln_relu_mask_bwd_blocks(long long N, int C, int vec,
                                       int x_bf16, int g_bf16) {
  if (N <= 0 || C <= 0) return 0;
  if (vec) {
    if (!bwd_vec_ok(C)) return 0;
    if (x_bf16 && g_bf16) return vec_blocks<__nv_bfloat16, __nv_bfloat16>(N, C);
    if (x_bf16) return vec_blocks<__nv_bfloat16, float>(N, C);
    if (g_bf16) return vec_blocks<float, __nv_bfloat16>(N, C);
    return vec_blocks<float, float>(N, C);
  }
  const long long per =
      (long long)bwd_warps(C) * (32 / lanes_for(C)) * kRowsPerGroup;
  const long long nb = per > 0 ? (N + per - 1) / per : 0;
  return nb <= 0x7fffffffLL ? (int)nb : 0;
}

// x (N, C) bf16 (x_bf16 = 1) or f32; pre_bias, scale, bias (C,) f32;
// active (N,) bool; g (N, C) bf16 (g_bf16 = 1) or f32, the cotangent of
// the forward's output; dx (N, C) in x's type; partial scratch of
// pcseg_bias_ln_relu_mask_bwd_blocks(N, C, vec, ...) * 3 * C f32; sums
// (3, C) f32: dscale, dbias, dpre_bias. 1 <= C <=
// pcseg_bias_ln_relu_mask_bwd_max_c(); vec = 1 takes the vector route
// (C a multiple of 8 up to 256, x, g and dx 16-byte aligned).
int pcseg_bias_ln_relu_mask_bwd(const void* x, const void* pre_bias,
                                const void* scale, const void* bias,
                                const void* active, const void* g, void* dx,
                                void* partial, void* sums, long long N, int C,
                                float eps, int x_bf16, int g_bf16, int vec,
                                void* stream) {
  const int blocks =
      pcseg_bias_ln_relu_mask_bwd_blocks(N, C, vec, x_bf16, g_bf16);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* part = (float*)partial;
  int rc;
  if (vec) {
#define PCSEG_VEC(TI, TG)                                                   \
  do {                                                                      \
    const auto kern = vec_kernel_for<TI, TG>(C);                            \
    kern<<<blocks, kVecThreads, 0, s>>>(                                    \
        (const TI*)x, (const float*)pre_bias, (const float*)scale,          \
        (const float*)bias, (const uint8_t*)active, (const TG*)g, (TI*)dx,  \
        part, N, C, eps);                                                   \
  } while (0)
    if (x_bf16 && g_bf16) PCSEG_VEC(__nv_bfloat16, __nv_bfloat16);
    else if (x_bf16) PCSEG_VEC(__nv_bfloat16, float);
    else if (g_bf16) PCSEG_VEC(float, __nv_bfloat16);
    else PCSEG_VEC(float, float);
#undef PCSEG_VEC
    rc = (int)cudaGetLastError();
  } else if (x_bf16 && g_bf16) {
    rc = launch_bwd_any<__nv_bfloat16, __nv_bfloat16>(
        x, pre_bias, scale, bias, active, g, dx, part, N, C, eps, blocks, s);
  } else if (x_bf16) {
    rc = launch_bwd_any<__nv_bfloat16, float>(
        x, pre_bias, scale, bias, active, g, dx, part, N, C, eps, blocks, s);
  } else if (g_bf16) {
    rc = launch_bwd_any<float, __nv_bfloat16>(
        x, pre_bias, scale, bias, active, g, dx, part, N, C, eps, blocks, s);
  } else {
    rc = launch_bwd_any<float, float>(x, pre_bias, scale, bias, active, g,
                                      dx, part, N, C, eps, blocks, s);
  }
  if (rc != 0) return rc;
  const int c3 = 3 * C;
  column_sum_kernel<<<(c3 + 31) / 32, dim3(32, 32), 0, s>>>(part, blocks,
                                                             c3,
                                                             (float*)sums);
  return (int)cudaGetLastError();
}

}  // extern "C"
