// One-hot plane kernels of voxelize / devoxelize for Hopper (sm_90a).
//
//   pcseg_voxelize_contract  replaces pcseg_tpu/ops/pallas/onehot_contract.py
//                            voxelize_contract (_vox_contract_kernel,
//                            pallas_call at :191): the matmul voxelizer's
//                            sums[b, v, k] = sum_p [flat_p == v] bf16(ext[p, k]).
//   pcseg_trilinear_scatter  replaces trilinear_scatter (_tri_scatter_kernel,
//                            pallas_call at :245): the devoxelize backward's
//                            grid cotangent
//                            dgrid[b, zy, x, k] = sum_p A[p, zy] Wx[p, x] go[p, k].
//   pcseg_trilinear_gather   replaces trilinear_gather (_tri_gather_kernel,
//                            pallas_call at :376): the matmul devoxelize
//                            forward out[p, k] = mask_p sum_x Wx[p, x]
//                            sum_zy A[p, zy] g2[zy, x, k].
//   pcseg_rowcol_scatter     replaces rowcol_scatter (_rowcol_scatter_kernel,
//                            pallas_call at :309): the block-sparse
//                            readout's backward
//                            out[b, row_p, col_p * C + k] += bf16(vals[p, k]),
//                            a row >= nrows (the sentinel) adding nothing.
//   pcseg_segment_scatter    replaces pcseg_tpu/ops/pallas/voxel_scatter.py
//                            pallas_segment_scatter (pallas_call at :67):
//                            out[b, id_p, k] += feats[p, k] for ids in
//                            [0, nseg); the spill id nseg, and any other
//                            id outside the range, adds nothing.
//
// The TPU kernels build one-hot planes of a chunk of points in VMEM and
// contract the point axis on the MXU, because the MXU is the TPU's fast
// path and a scatter or a gather is not. On the card a point touches at
// most 8 voxels (1 for voxelize), so each kernel is one thread per point:
// voxelize and the scatter add their products into an f32 grid that the
// caller zeroed with float atomics, the gather reads its at most 8 taps x C
// bf16 values; rowcol_scatter adds a point's C values into its (row, col)
// cell, the points of a warp that share a cell summed first in lane order
// (consecutive track points share cells: about 30 a cell at R64), one
// vector reduction for 4 channels by the group's leader. All four are
// bound by bytes, not operations:
// the scatter and voxelize by the f32 grid they write (33.5 / 25.2 MB at
// B8 x R64 with C 4 / 3) and by atomic throughput, the gather by the
// per-point rows it reads and writes (the taps of neighbouring points
// share cache lines), rowcol_scatter by its point rows and the f32 table
// (8.4 MB at B8 x NT64 x 512 x 4).
// The segment scatter keeps its whole grid in VMEM on the TPU and adds
// the points one after another; here a thread takes one (point, channel)
// value, so the point rows are read coalesced and the float atomics of
// neighbouring channels land on one cache line. It is bound by the f32
// grid it writes (33.6 MB at B8 x R64^3 x C4, zero-filled by the caller)
// and, where many points share a segment, by that segment's atomics.
//
// Rounding points (onehot_contract.py _axis_taps, _zy_plane,
// _xline_weights and the three kernels): per axis the two taps floor(u)
// and floor(u) + 1 are clipped to [0, R-1], with weights 1 - frac and frac;
// the zy weight is wz * wy in f32, duplicate clipped taps summed in f32 in
// the kernels' loop order (z outer), rounded to bf16 once. The x weights'
// duplicates are summed in f32; the scatter rounds them to bf16 and its
// operand is bf16(wx * go) of bf16 values, the gather keeps them f32 and
// takes, for each x tap, the zy sum of A * bf16(g2) first, then multiplies
// by the x weight and sums over x, all in f32. voxelize rounds each ext
// value to bf16 and sums in f32 (counts, a column of ones, are exact).
// Points whose cotangent row is zero (masked points) add nothing to the
// scatter and are skipped; voxelize skips the sentinel id R^3 of masked
// points; the gather writes 0 for masked points.
//
// Plain C interface (loaded with ctypes): each entry returns
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

// The four zy taps of a point in the TPU kernels' loop order (z outer):
// zi their flat z * R + y ids; first[t] marks the first copy of each
// distinct id, whose a[t] is the bf16-rounded f32 sum of the weights
// wz * wy of all its copies (later copies: first false, a 0).
__device__ __forceinline__ void zy_taps(float uz, float uy, int r, int zi[4],
                                        float a[4], bool first[4]) {
  int iz[2], iy[2];
  float wz[2], wy[2], zw[4];
  axis_taps(uz, r, iz, wz);
  axis_taps(uy, r, iy, wy);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      zi[2 * i + e] = iz[i] * r + iy[e];
      zw[2 * i + e] = __fmul_rn(wz[i], wy[e]);
    }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    first[t] = true;
    for (int s = 0; s < t; ++s) first[t] &= zi[s] != zi[t];
    float sum = 0.f;
    for (int s = 0; s < 4; ++s)
      if (zi[s] == zi[t]) sum = __fadd_rn(sum, zw[s]);
    a[t] = first[t] ? round_bf16(sum) : 0.f;
  }
}

// The x taps of a point: a duplicate (clipped edge) folds its weight into
// the first, summed in f32. Returns the number of distinct taps (1 or 2).
__device__ __forceinline__ int x_taps(float ux, int r, int ix[2],
                                      float xw[2]) {
  axis_taps(ux, r, ix, xw);
  if (ix[0] != ix[1]) return 2;
  xw[0] = __fadd_rn(xw[0], xw[1]);
  xw[1] = 0.f;
  return 1;
}

__global__ void __launch_bounds__(kThreads) voxelize_contract_kernel(
    const int* __restrict__ flat, const float* __restrict__ ext,
    float* __restrict__ out, long long n, int m, int r3, int c1) {
  const long long pt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= n) return;
  const int f = flat[pt];
  if (f < 0 || f >= r3) return;            // the masked points' sentinel
  const long long b = pt / m;
  float* row = out + (b * r3 + f) * c1;
  const float* e = ext + pt * c1;
  for (int k = 0; k < c1; ++k) atomicAdd(row + k, round_bf16(e[k]));
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
  int zi[4], ix[2];
  float a[4], xw[2];
  bool first[4];
  zy_taps(u[pt * 3 + 0], u[pt * 3 + 1], r, zi, a, first);
  const int nx = x_taps(u[pt * 3 + 2], r, ix, xw);
  xw[0] = round_bf16(xw[0]);
  xw[1] = round_bf16(xw[1]);

  float* grid = out + b * (long long)r * r * r * c;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (!first[t]) continue;
    for (int e = 0; e < nx; ++e) {
      float* row = grid + ((long long)zi[t] * r + ix[e]) * c;
      for (int k = 0; k < c; ++k)
        atomicAdd(row + k, a[t] * round_bf16(__fmul_rn(xw[e], gb[k])));
    }
  }
}

__global__ void __launch_bounds__(kThreads) trilinear_gather_kernel(
    const float* __restrict__ u, const uint8_t* __restrict__ mask,
    const __nv_bfloat16* __restrict__ g2, float* __restrict__ out,
    long long n, int m, int r, int c) {
  const long long pt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= n) return;
  float* o = out + pt * c;
  if (!mask[pt]) {
    for (int k = 0; k < c; ++k) o[k] = 0.f;
    return;
  }
  const long long b = pt / m;
  int zi[4], ix[2];
  float a[4], xw[2];
  bool first[4];
  zy_taps(u[pt * 3 + 0], u[pt * 3 + 1], r, zi, a, first);
  const int nx = x_taps(u[pt * 3 + 2], r, ix, xw);

  const __nv_bfloat16* grid = g2 + b * (long long)r * r * r * c;
  float acc[kMaxC];
#pragma unroll
  for (int k = 0; k < kMaxC; ++k) acc[k] = 0.f;
  for (int e = 0; e < nx; ++e) {
    float s[kMaxC];
#pragma unroll
    for (int k = 0; k < kMaxC; ++k) s[k] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!first[t]) continue;
      const __nv_bfloat16* row = grid + ((long long)zi[t] * r + ix[e]) * c;
#pragma unroll
      for (int k = 0; k < kMaxC; ++k)
        if (k < c)
          s[k] = __fadd_rn(s[k], __fmul_rn(a[t], __bfloat162float(row[k])));
    }
#pragma unroll
    for (int k = 0; k < kMaxC; ++k)
      if (k < c) acc[k] = __fadd_rn(acc[k], __fmul_rn(xw[e], s[k]));
  }
#pragma unroll
  for (int k = 0; k < kMaxC; ++k)
    if (k < c) o[k] = acc[k];
}

// out[0..3] += v with one vector reduction (sm_90; out 16-byte aligned)
__device__ __forceinline__ void red_add_v4(float* out, const float (&v)[4]) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(out),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// rows / cols (B, M) int32, vals (B, M, C) f32 rounded to bf16 here; out
// (B, nrows, ncols * C) f32 zeroed by the caller. A thread a point reads
// its values 4 channels at a time (one 16-byte load where C % 4 == 0, a
// scalar tail otherwise). The lanes of a warp whose points fall in one
// (b, row, col) cell (__match_any_sync) sum their values in lane order,
// and the group's lowest lane adds the sum: one red.global.add.v4.f32 for
// 4 channels where C % 4 == 0, else a scalar atomic a channel. A point
// outside the table (the sentinel row) joins no group, and a zero sum (a
// masked point's cotangent) is not added.
__global__ void __launch_bounds__(kThreads) rowcol_scatter_kernel(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const float* __restrict__ vals, float* __restrict__ out, long long n,
    int m, int nrows, int ncols, int c) {
  constexpr unsigned kAll = 0xffffffffu;
  const long long pt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool vec = (c & 3) == 0;
  long long cell = -1;   // (b nrows + row) ncols + col, or -1: none
  if (pt < n) {
    const int r = rows[pt], col = cols[pt];
    if (r >= 0 && r < nrows && col >= 0 && col < ncols)
      cell = (pt / m * nrows + r) * ncols + col;
  }
  const unsigned grp = __match_any_sync(kAll, (unsigned long long)cell);
  const int size = cell >= 0 ? __popc(grp) : 0;
  const int most = (int)__reduce_max_sync(kAll, (unsigned)size);
  const bool lead = cell >= 0 && __ffs(grp) - 1 == lane;
  const float* v = vals + (cell >= 0 ? pt * c : 0);
  float* o = out + (cell >= 0 ? cell * c : 0);
  for (int k0 = 0; k0 < c; k0 += 4) {
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (cell >= 0) {
      if (vec) {
        const float4 q = *reinterpret_cast<const float4*>(v + k0);
        x[0] = q.x;
        x[1] = q.y;
        x[2] = q.z;
        x[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + j < c) x[j] = v[k0 + j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = round_bf16(x[j]);
    }
    // the group's sum, its lanes in ascending order: step i reads the
    // lane of the i-th set bit of the group's mask
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    unsigned rest = grp;
    for (int i = 0; i < most; ++i) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      rest &= rest - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = __shfl_sync(kAll, x[j], src);
        if (i < size) sum[j] += y;
      }
    }
    if (!lead) continue;
    if (vec) {
      if (sum[0] != 0.f || sum[1] != 0.f || sum[2] != 0.f || sum[3] != 0.f)
        red_add_v4(o + k0, sum);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + j < c && sum[j] != 0.f) atomicAdd(o + k0 + j, sum[j]);
    }
  }
}

// ids (B, M) int32, feats (B, M, C) f32; out (B, nseg, C) f32 zeroed by
// the caller. A thread per (point, channel).
__global__ void __launch_bounds__(kThreads) segment_scatter_kernel(
    const int* __restrict__ ids, const float* __restrict__ feats,
    float* __restrict__ out, long long total, int m, int nseg, int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long pt = i / c;
  const int id = ids[pt];
  if (id < 0 || id >= nseg) return;          // the spill id, or worse
  const long long b = pt / m;
  atomicAdd(out + (b * nseg + id) * c + (i - pt * c), feats[i]);
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// flat (B, M) int32 voxel ids, R^3 for masked points; ext (B, M, C1) f32
// point rows, masked rows zero; out (B, R^3, C1) f32, zeroed by the caller.
int pcseg_voxelize_contract(const void* flat, const void* ext, void* out,
                            int B, int M, int R, int C1, void* stream) {
  if (B <= 0 || M <= 0 || R <= 0 || C1 <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * M;
  voxelize_contract_kernel<<<blocks_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const int*)flat, (const float*)ext, (float*)out, n, M, R * R * R, C1);
  return (int)cudaGetLastError();
}

// u (B, M, 3) f32 continuous voxel coords (masked points finite); go
// (B, M, C) f32 point cotangents, masked rows zero; out (B, R^3, C) f32,
// zeroed by the caller, NDHWC order (z * R + y) * R * C + x * C + k.
int pcseg_trilinear_scatter(const void* u, const void* go, void* out, int B,
                            int M, int R, int C, void* stream) {
  if (B <= 0 || M <= 0 || R <= 0 || C <= 0 || C > kMaxC)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * M;
  trilinear_scatter_kernel<<<blocks_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)u, (const float*)go, (float*)out, n, M, R, C);
  return (int)cudaGetLastError();
}

// u (B, M, 3) f32 continuous voxel coords; mask (B, M) bool (one byte a
// point); g2 (B, R^3, C) bf16 in the same NDHWC order; out (B, M, C) f32.
int pcseg_trilinear_gather(const void* u, const void* mask, const void* g2,
                           void* out, int B, int M, int R, int C,
                           void* stream) {
  if (B <= 0 || M <= 0 || R <= 0 || C <= 0 || C > kMaxC)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * M;
  trilinear_gather_kernel<<<blocks_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)u, (const uint8_t*)mask, (const __nv_bfloat16*)g2,
      (float*)out, n, M, R, C);
  return (int)cudaGetLastError();
}

// rows / cols (B, M) int32 (a row >= nrows adds nothing); vals (B, M, C)
// f32; out (B, nrows, ncols * C) f32, zeroed by the caller.
int pcseg_rowcol_scatter(const void* rows, const void* cols, const void* vals,
                         void* out, int B, int M, int nrows, int ncols, int C,
                         void* stream) {
  if (B <= 0 || M <= 0 || nrows <= 0 || ncols <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * M;
  rowcol_scatter_kernel<<<blocks_for(n), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int*)rows, (const int*)cols, (const float*)vals, (float*)out, n,
      M, nrows, ncols, C);
  return (int)cudaGetLastError();
}

// ids (B, M) int32 (nseg is the spill id; any id outside [0, nseg) adds
// nothing); feats (B, M, C) f32; out (B, nseg, C) f32, zeroed by the
// caller.
int pcseg_segment_scatter(const void* ids, const void* feats, void* out,
                          int B, int M, int nseg, int C, void* stream) {
  if (B <= 0 || M <= 0 || nseg <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * M * C;
  segment_scatter_kernel<<<blocks_for(total), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)feats, (float*)out, total, M, nseg, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
