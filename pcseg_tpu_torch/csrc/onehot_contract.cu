// One-hot plane kernels of voxelize / devoxelize for Hopper (sm_90a).
//
//   pcseg_trilinear_scatter  replaces pcseg_tpu/ops/pallas/onehot_contract.py
//                            trilinear_scatter (_tri_scatter_kernel,
//                            pallas_call at :245): the devoxelize backward's
//                            grid cotangent
//                            dgrid[b, zy, x, k] = sum_p A[p, zy] Wx[p, x] go[p, k].
//
// The TPU kernel builds the one-hot zy plane (R^2, Mc) and the x/channel
// line (Mc, R*C) of a chunk of points in VMEM and contracts the point axis
// on the MXU, because the MXU is the TPU's fast path and a scatter is not.
// On the card a point touches at most 8 voxels, so the contraction is a
// scatter: one thread per point computes its taps and adds its at most
// 8 * C products into the f32 grid with float atomics. It is bound by
// bytes (the f32 grid it writes, 33.5 MB at B8 x R64 x C4, zeroed by the
// caller) and by atomic throughput, not by operations.
//
// Rounding points (onehot_contract.py _axis_taps, _zy_plane,
// _xline_weights, _tri_scatter_kernel): per axis the two taps floor(u) and
// floor(u) + 1 are clipped to [0, R-1], with weights 1 - frac and frac;
// the zy weight is wz * wy in f32, duplicate clipped taps summed in f32 in
// the kernel's loop order, rounded to bf16 once; the x weights likewise
// summed in f32 and rounded to bf16; the operand is bf16(wx * go) of bf16
// values; products and sums in f32. Points whose cotangent row is zero
// (masked points) add nothing and are skipped.
//
// Plain C interface (loaded with ctypes): the entry returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 32;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void axis_taps(float u, int r, int idx[2],
                                          float w[2]) {
  const float f = floorf(u);
  const float frac = __fsub_rn(u, f);
  const int i0 = (int)f;
  idx[0] = min(max(i0, 0), r - 1);
  idx[1] = min(max(i0 + 1, 0), r - 1);
  w[0] = __fsub_rn(1.f, frac);
  w[1] = frac;
}

__global__ void __launch_bounds__(kThreads) trilinear_scatter_kernel(
    const float* __restrict__ u, const float* __restrict__ go,
    float* __restrict__ out, long long n, int m, int r, int c) {
  const long long pt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= n) return;
  const float* g = go + pt * c;
  float gb[kMaxC];
  bool any = false;
  for (int k = 0; k < c; ++k) {
    gb[k] = round_bf16(g[k]);
    any |= g[k] != 0.f;
  }
  if (!any) return;
  const long long b = pt / m;
  int iz[2], iy[2], ix[2];
  float wz[2], wy[2], wx[2];
  axis_taps(u[pt * 3 + 0], r, iz, wz);
  axis_taps(u[pt * 3 + 1], r, iy, wy);
  axis_taps(u[pt * 3 + 2], r, ix, wx);

  // the four zy taps in the TPU kernel's loop order (z outer)
  int zi[4];
  float zw[4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      zi[2 * a + e] = iz[a] * r + iy[e];
      zw[2 * a + e] = __fmul_rn(wz[a], wy[e]);
    }
  // x taps: a duplicate (clipped edge) folds into the first
  const int nx = ix[0] == ix[1] ? 1 : 2;
  float xw[2];
  xw[0] = round_bf16(nx == 1 ? __fadd_rn(wx[0], wx[1]) : wx[0]);
  xw[1] = round_bf16(wx[1]);

  float* grid = out + b * (long long)r * r * r * c;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    bool first = true;
    for (int s = 0; s < t; ++s) first &= zi[s] != zi[t];
    if (!first) continue;
    float sum = 0.f;
    for (int s = 0; s < 4; ++s)
      if (zi[s] == zi[t]) sum = __fadd_rn(sum, zw[s]);
    const float a = round_bf16(sum);
    for (int e = 0; e < nx; ++e) {
      float* row = grid + ((long long)zi[t] * r + ix[e]) * c;
      for (int k = 0; k < c; ++k)
        atomicAdd(row + k, a * round_bf16(__fmul_rn(xw[e], gb[k])));
    }
  }
}

}  // namespace

extern "C" {

// u (B, M, 3) f32 continuous voxel coords (masked points finite); go
// (B, M, C) f32 point cotangents, masked rows zero; out (B, R^3, C) f32,
// zeroed by the caller, NDHWC order (z * R + y) * R * C + x * C + k.
int pcseg_trilinear_scatter(const void* u, const void* go, void* out, int B,
                            int M, int R, int C, void* stream) {
  if (B <= 0 || M <= 0 || R <= 0 || C <= 0 || C > kMaxC)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * M;
  const int grid = (int)((n + kThreads - 1) / kThreads);
  trilinear_scatter_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)go, (float*)out, n, M, R, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
