// The voxel U-Net's stride-2 resampling on Hopper's tensor cores (sm_90a):
// gathered GEMMs with fixed-order sums.
//
//   pcseg_down2x_mma   replaces pcseg_tpu/ops/pallas/conv3d_block.py
//                      fused_down2x_p (_down2x_kernel, pallas_call at
//                      :1318): a = bf16(relu(x * scale + shift)), the k2 s2
//                      conv C -> 2C, + bias, bf16 y and the next GroupNorm's
//                      per-(batch, channel) (sum, sumsq) of the f32 value.
//   pcseg_up2x_mma     replaces fused_up2x_p (_up2x_kernel, pallas_call at
//                      :1403): a = bf16(relu(x * scale + shift)) on the
//                      coarse grid (2C channels), child 2i + d of coarse
//                      voxel i gets a[i] @ w[1 - d] + bias (f32), bf16 y and
//                      the per-(batch, channel) (sum, sumsq) of the f32
//                      value.
//   pcseg_up2x_bwd_mma replaces the backward of fused_up2x_p
//                      (_up2x_bwd_kernel, pallas_call at :1439): g' = (gy +
//                      gs1) + 2 gs2 y, dbias = sum g' (f32), da = bf16(g') @
//                      flipped W^T, dx = bf16([pre > 0] da * scale), dscale
//                      = sum dam * x, dshift = sum dam, dW = sum
//                      bf16(relu(pre))^T bf16(g') in the forward's tap order.
//   pcseg_down2x_bwd_mma replaces the backward of fused_down2x_p
//                      (_down2x_bwd_kernel, pallas_call at :1353): the same
//                      g', dbias and epilogue on the coarse side's G =
//                      bf16(g'), da = G @ W^T scattered to the children, dW
//                      = A^T @ G with A = bf16(relu(pre)) gathered.
//
// A k2 s2 conv pairs each coarse voxel with its 2 x 2 x 2 fine children and
// nothing else, so both are one GEMM over rows of coarse voxels. A row is
// the eight children's C channels, k = ((dz * 2 + dy) * 2 + dx) * C + c
// (``gather_rows`` in ops/conv3d_block.py): for each (dz, dy) the 2C
// contiguous bf16 of the fine pair (2w, 2w + 1), four 16-byte aligned
// segments a row, each fine byte read once.
//
// - down2x: y (M x 2C) = A (M x 8C) @ W (8C x 2C), W the (2, 2, 2, C, 2C)
//   weights as rows (``pack_down_w``); the prologue runs on A's fragments
//   in registers, once an element.
// - up2x, the transposed half of down2x's backward: Y (M x 8C) = A (M x
//   2C, coarse, contiguous) @ Wu with Wu[i][(d, o)] = w[1 - d][i][o]
//   (``pack_up_w``); the prologue runs on A's fragments, once an element;
//   the epilogue adds the bias and sums the stats of channel o over the
//   eight children's columns, and y leaves through the gather's inverse
//   (``ungather_rows``) in 16-byte units. 84 MB at 32^3 x 32 -> 64^3 x 16
//   (x read once, y written once), 0.025 ms.
// - up2x's backward: the same gather of gy and y gives G = bf16(g') (M x
//   8C); da (M x 2C) = G @ Wd with Wd[(d, o)][i] = w[1 - d][i][o]
//   (``pack_up_wt``), and dW^T (8C x 2C) += G^T @ a over the same tile,
//   kept in the accumulators across a block's tiles.
// - down2x's backward, the transposed pair of its forward: G = bf16(g')
//   (M x 2C, coarse, contiguous), dA (M x 8C) = G @ Wd^T (Wd =
//   ``pack_down_w``) whose epilogue reads pre from the gathered x tile and
//   writes dx over it, the tile going back through the gather's inverse
//   (``ungather_rows``); dW (8C x 2C) += A^T @ G with A = bf16(relu(pre))
//   formed on the x tile's fragments, kept in the accumulators (at C = 64
//   in four slices of the 8C columns, one a block). 168 MB at 64^3 x 16
//   -> 32^3 x 32 (x, gy and y read once, dx written once), 0.050 ms.
//
// What bounds them on an H100: bytes. B8 64^3 x 16 -> 32^3 x 32 moves 84
// MB (x read once, y written once) for 2.1 GFLOP, 0.025 ms at 3.35 TB/s;
// up2x's backward 168 MB (gy, y and x read once, dx written once), 0.050
// ms. The products run on mma.sync m16n8k16 (bf16 in, f32 sums) only to
// keep the FMAs off the critical path. The design keeps the loads going:
//
// - persistent blocks over tiles of 64 coarse voxels of one batch element
//   (grid (blocks a batch element, B)), two an SM so that one block's
//   syncs and loads overlap the other's work (up to four for up2x, whose
//   warps store 4x the bytes they load, each on its own after a
//   __syncwarp; one for the backward sweeps at C >= 32, whose dW takes 64
//   registers a thread); cp.async 16-byte
//   copies with computed addresses into a ring of 1-4 shared-memory
//   stages, so one tile's loads overlap the products and stores of the
//   ones before it; rows past the grid's end read zeros and are masked
//   at the stores;
// - tiles in shared memory swizzled in 16-byte units (``swz``) so that
//   ldmatrix (plain and .trans) reads them without bank conflicts;
// - W (bf16, in the layout the wrapper packs: ``pack_down_w``,
//   ``pack_up_w``, ``pack_up_wt``) staged once a block; scale/shift, bias
//   and the stats in registers or shared vectors;
// - outputs staged through shared memory for 16-byte stores;
// - no float atomics: each block writes its sums as one row of a partial
//   table (scratch the wrapper allocates) and fixed_sum_kernel adds the
//   rows in a fixed order, so two calls on the same inputs give the same
//   bits.
//
// Widths: C in {8, 16, 32, 64} with 2C on the coarse side, the widths the
// JAX fused core allows (pcseg_tpu/models/voxel_unet.py:234-240); other
// shapes keep conv3d_block.cu's CUDA-core kernels (ops/conv3d_block.py
// chooses by shape before the launch). up2x's backward at C = 64 holds dW
// (512 x 128) as four 32-column slices, one a block (grid z): each slice
// block gathers the whole G and computes its columns of dx and dW.
//
// Plain C interface (loaded with ctypes): every entry returns
// cudaGetLastError() after its launches.

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

using namespace mma_sync;
using hopper::bf16_hi;
using hopper::bf16_lo;
using hopper::pack_bf16x2;
using hopper::smem_u32;

constexpr int kRows = 64;            // coarse voxels a tile
constexpr int kDownThreads = 128;    // down2x, up2x: 4 warps of 16 rows
constexpr int kBwdThreads = 256;     // the backward sweeps: 8 warps
constexpr int kSmemMax = 227 * 1024;

// ---------------------------------------------------------------- pieces

// Byte offset of 16-byte unit c of row r in a tile of rows of cpr units:
// the unit's column XOR the row (cpr >= 8), or the unit index XOR its
// 128-byte line (narrower rows), so the 8 rows an ldmatrix matrix reads
// at one column fall in 8 distinct bank groups.
__device__ __forceinline__ uint32_t swz(int r, int c, int cpr) {
  if (cpr >= 8) return (uint32_t)(r * cpr + (c ^ (r & 7))) * 16u;
  const int u = r * cpr + c;
  return (uint32_t)(u ^ ((u >> 3) & 7)) * 16u;
}

// lane's row / unit for ldmatrix x4 of the 16 x 16 block at (r0, unit c0)
// in the order a0..a3 of an mma A fragment (rows major) or, with .trans
// on a [k][n] tile, b0, b1 of the n8 tiles at units c0 and c0 + 1
__device__ __forceinline__ int lrow(int r0, int lane) {
  return r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int lcol(int c0, int lane) { return c0 + (lane >> 4); }

// relu(v * sc + sh) of a bf16 pair in f32 without FMA contraction, rounded
// back to a bf16 pair (conv3d_block.cu's prologue, then round_bf16)
__device__ __forceinline__ uint32_t act2(uint32_t v, float sc0, float sc1,
                                         float sh0, float sh1) {
  return pack_bf16x2(fmaxf(__fadd_rn(__fmul_rn(bf16_lo(v), sc0), sh0), 0.f),
                     fmaxf(__fadd_rn(__fmul_rn(bf16_hi(v), sc1), sh1), 0.f));
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf16_lo(w[i]);
    f[2 * i + 1] = bf16_hi(w[i]);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

// A tile's rows walk coarse voxels m = tile * 64 + r of one batch element;
// a thread keeps one row's coarse (z, y, x) and steps it by `step` rows.
struct RowWalk {
  long long m;
  int z, y, x;
  __device__ RowWalk(long long m0, int H2, int W2) : m(m0) {
    const long long q = m0 / W2;
    x = (int)(m0 - q * W2);
    y = (int)(q % H2);
    z = (int)(q / H2);
  }
  __device__ void step(int rows, int H2, int W2) {
    m += rows;
    x += rows;
    while (x >= W2) {
      x -= W2;
      if (++y == H2) {
        y = 0;
        ++z;
      }
    }
  }
};

// Address of the 16-byte unit J (of a gathered row's C) of coarse voxel
// (z, y, x) in a fine grid (B, 2 D2, 2 H2, 2 W2, C): segment J / (C / 4)
// is the fine pair (dz, dy), unit J % (C / 4) of its 2C contiguous values.
template <int C>
__device__ __forceinline__ const __nv_bfloat16* fine_unit(
    const __nv_bfloat16* src, int b, const RowWalk& w, int D2, int H2,
    int W2, int J) {
  const int seg = J / (C / 4), ju = J % (C / 4);
  const int dz = seg >> 1, dy = seg & 1;
  return src + ((((size_t)b * 2 * D2 + 2 * w.z + dz) * 2 * H2 + 2 * w.y +
                 dy) * 2 * W2 + 2 * w.x) * C + ju * 8;
}

// Stages the gathered rows of a tile of a fine grid (B, 2 D2, 2 H2, 2 W2, C)
// bf16 into a swizzled [64][8C / S] tile, slice z of S of each row (units
// z C / S ..): the thread's 16-byte unit column j of rows r0, r0 + step,
// ... (step = threads / (C / S)).
template <int C, int S = 1>
__device__ __forceinline__ void gather_tile(uint32_t dst,
                                            const __nv_bfloat16* src, int b,
                                            long long tile, long long Mb,
                                            int D2, int H2, int W2, int tid,
                                            int threads, int z = 0) {
  constexpr int U = C / S;
  const int j = tid % U;
  const int step = threads / U;
  RowWalk w(tile * kRows + tid / U, H2, W2);
  for (int r = tid / U; r < kRows; r += step) {
    const bool ok = w.m < Mb;
    cp16(dst + swz(r, j, U),
         ok ? fine_unit<C>(src, b, w, D2, H2, W2, z * U + j) : src, ok);
    w.step(step, H2, W2);
  }
}

// The inverse: a swizzled [64][8C / S] tile back to its places in the fine
// grid (rows past the grid's end are not stored), 16 bytes a copy.
template <int C, int S>
__device__ __forceinline__ void scatter_tile(__nv_bfloat16* dst,
                                             const uint8_t* tile_s, int b,
                                             long long tile, long long Mb,
                                             int D2, int H2, int W2, int tid,
                                             int threads, int z) {
  constexpr int U = C / S;
  const int j = tid % U;
  const int step = threads / U;
  RowWalk w(tile * kRows + tid / U, H2, W2);
  for (int r = tid / U; r < kRows; r += step) {
    if (w.m < Mb)
      *reinterpret_cast<uint4*>(const_cast<__nv_bfloat16*>(
          fine_unit<C>(dst, b, w, D2, H2, W2, z * U + j))) =
          *reinterpret_cast<const uint4*>(tile_s + swz(r, j, U));
    w.step(step, H2, W2);
  }
}

// ---------------------------------------------------------------- down2x

struct DownArgs {
  const __nv_bfloat16* x;   // (B, D, H, W, C) fine
  const __nv_bfloat16* w;   // (8C, 2C) bf16: pack_down_w
  const float* bias;        // (2C,)
  const float* scale;       // (B, C)
  const float* shift;
  __nv_bfloat16* y;         // (B, D/2, H/2, W/2, 2C)
  float* part;              // (B, gridDim.x, 2, 2C) block sums
  int D2, H2, W2, tiles;
};

template <int C>
struct DownCfg {
  static constexpr int N = 2 * C, K = 8 * C, NT = N / 8, KS = K / 16;
  static constexpr int kW = K * N * 2;
  static constexpr int kStage = kRows * K * 2;
  static constexpr int kFit = (110 * 1024 - kW) / kStage;
  static constexpr int kStages = kFit >= 4 ? 4 : kFit >= 1 ? kFit : 1;
  static constexpr int kSmem = kW + kStages * kStage;
  // k-steps whose channels (k % C) differ: C / 16, or 1 at C = 8
  static constexpr int P = C >= 16 ? C / 16 : 1;
  static constexpr int kPitch = (2 * N + 16) | 16;   // staged y row, bytes
};

// One block: tiles blockIdx.x, blockIdx.x + gridDim.x, ... of batch element
// blockIdx.y. Warp w computes rows 16w..16w+15 of a tile against all of W:
// per k-step one ldmatrix of A (then the prologue on the fragment) and one
// .trans ldmatrix of W a pair of n8 tiles.
template <int C>
__global__ void __launch_bounds__(kDownThreads) down2x_mma_kernel(
    const DownArgs p) {
  using Cfg = DownCfg<C>;
  constexpr int N = Cfg::N, K = Cfg::K, NT = Cfg::NT, P = Cfg::P;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sw = smem;
  uint8_t* stages = smem + Cfg::kW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const long long Mb = (long long)p.D2 * p.H2 * p.W2;
  const int ntile = blockIdx.x < p.tiles
                        ? (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                        : 0;

  // W, [k][n] in units of 8 n
  for (int i = tid; i < K * N / 8; i += kDownThreads) {
    const int k = i / (N / 8), cu = i % (N / 8);
    *reinterpret_cast<uint4*>(sw + swz(k, cu, N / 8)) =
        *reinterpret_cast<const uint4*>(p.w + (size_t)k * N + cu * 8);
  }
  // the prologue's scale/shift of this lane's fragment columns: k-step s
  // reads channels 16 (s % P) + 2t (+1) and (16 (s % P) + 8 + 2t) % C (+1)
  float sc[P][4], sh[P][4];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int c0 = (16 * q + 2 * t) % C, c1 = (16 * q + 8 + 2 * t) % C;
    const float* s = p.scale + (size_t)b * C;
    const float* h = p.shift + (size_t)b * C;
    sc[q][0] = s[c0]; sc[q][1] = s[c0 + 1]; sc[q][2] = s[c1]; sc[q][3] = s[c1 + 1];
    sh[q][0] = h[c0]; sh[q][1] = h[c0 + 1]; sh[q][2] = h[c1]; sh[q][3] = h[c1 + 1];
  }
  float bv[NT][2], s1[NT][2], s2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bv[nt][j] = p.bias[8 * nt + 2 * t + j];
      s1[nt][j] = s2[nt][j] = 0.f;
    }

  auto load = [&](int i) {
    if (i < ntile)
      gather_tile<C>(smem_u32(stages + (i % Cfg::kStages) * Cfg::kStage), p.x,
                     b, blockIdx.x + (long long)i * gridDim.x, Mb, p.D2, p.H2,
                     p.W2, tid, kDownThreads);
    cp_commit();
  };
  for (int i = 0; i < Cfg::kStages - 1; ++i) load(i);

  const uint32_t sw_u = smem_u32(sw);
  for (int i = 0; i < ntile; ++i) {
    load(i + Cfg::kStages - 1);
    cp_wait<Cfg::kStages - 1>();
    __syncthreads();
    uint8_t* sa = stages + (i % Cfg::kStages) * Cfg::kStage;
    const uint32_t sa_u = smem_u32(sa);
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int s = 0; s < Cfg::KS; ++s) {
      uint32_t a[4];
      ldsm4(a, sa_u + swz(lrow(16 * warp, lane), lcol(2 * s, lane), C));
      const int q = s % P;
      a[0] = act2(a[0], sc[q][0], sc[q][1], sh[q][0], sh[q][1]);
      a[1] = act2(a[1], sc[q][0], sc[q][1], sh[q][0], sh[q][1]);
      a[2] = act2(a[2], sc[q][2], sc[q][3], sh[q][2], sh[q][3]);
      a[3] = act2(a[3], sc[q][2], sc[q][3], sh[q][2], sh[q][3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm4t(bb, sw_u + swz(lrow(16 * s, lane), lcol(2 * np, lane), N / 8));
        mma(acc[2 * np], a, bb[0], bb[1]);
        mma(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    // epilogue: + bias, stats of the f32 value, bf16 staged in this warp's
    // own (now read) rows of the A tile, then 16-byte stores
    const long long m0 =
        (blockIdx.x + (long long)i * gridDim.x) * kRows + 16 * warp;
    const bool va = m0 + g < Mb, vb = m0 + g + 8 < Mb;
    uint8_t* st = sa + warp * 16 * K * 2;
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float y0 = acc[nt][0] + bv[nt][0], y1 = acc[nt][1] + bv[nt][1];
      const float y2 = acc[nt][2] + bv[nt][0], y3 = acc[nt][3] + bv[nt][1];
      if (va) {
        s1[nt][0] += y0; s2[nt][0] += y0 * y0;
        s1[nt][1] += y1; s2[nt][1] += y1 * y1;
      }
      if (vb) {
        s1[nt][0] += y2; s2[nt][0] += y2 * y2;
        s1[nt][1] += y3; s2[nt][1] += y3 * y3;
      }
      *reinterpret_cast<uint32_t*>(st + g * Cfg::kPitch + (8 * nt + 2 * t) * 2) =
          pack_bf16x2(y0, y1);
      *reinterpret_cast<uint32_t*>(st + (g + 8) * Cfg::kPitch +
                                   (8 * nt + 2 * t) * 2) = pack_bf16x2(y2, y3);
    }
    __syncwarp();
    for (int u = lane; u < 16 * NT; u += 32) {
      const int row = u / NT, cu = u % NT;
      if (m0 + row < Mb)
        *reinterpret_cast<uint4*>(p.y + ((size_t)b * Mb + m0 + row) * N +
                                  cu * 8) =
            *reinterpret_cast<const uint4*>(st + row * Cfg::kPitch + cu * 16);
    }
    __syncthreads();   // the stage is refilled by a later load
  }

  // the block's sums: the 8 row lanes of each warp, then the 4 warps, in
  // a fixed order
  cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(stages);   // [4][2][N]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float a = group_sum(s1[nt][j]), c = group_sum(s2[nt][j]);
      if (g == 0) {
        red[warp * 2 * N + 8 * nt + 2 * t + j] = a;
        red[warp * 2 * N + N + 8 * nt + 2 * t + j] = c;
      }
    }
  __syncthreads();
  for (int j = tid; j < 2 * N; j += kDownThreads) {
    float v = red[j];
#pragma unroll
    for (int w = 1; w < kDownThreads / 32; ++w) v += red[w * 2 * N + j];
    p.part[((size_t)b * gridDim.x + blockIdx.x) * 2 * N + j] = v;
  }
}

// ---------------------------------------------------------------- up2x

struct UpArgs {
  const __nv_bfloat16* x;   // (B, D2, H2, W2, 2C) coarse
  const __nv_bfloat16* w;   // (2C, 8C) bf16: pack_up_w
  const float* bias;        // (C,)
  const float* scale;       // (B, 2C)
  const float* shift;
  __nv_bfloat16* y;         // (B, 2 D2, 2 H2, 2 W2, C)
  float* part;              // (B, gridDim.x, 2, C) block sums
  int D2, H2, W2, tiles;
};

template <int C>
struct UpFwdCfg {
  static constexpr int K = 2 * C, N = 8 * C, KS = K / 16;
  static constexpr int NC = 64;           // columns a chunk: 8 units a row
  static constexpr int NCH = N / NC, NT = NC / 8;
  static constexpr int Q = C / 8;         // the n8 tiles' channel groups
  static constexpr int kW = K * N * 2;
  static constexpr int kStage = kRows * K * 2;
  static constexpr int kPitch = (2 * NC + 16) | 16;   // staged y row, bytes
  static constexpr int kStaging = 4 * 16 * kPitch;
  static constexpr int kVec = 2 * K * 4;
  static constexpr int kFit = (200 * 1024 - kW - kStaging - kVec) / kStage;
  static constexpr int kStages = kFit >= 4 ? 4 : kFit >= 2 ? kFit : 2;
  static constexpr int kSmem = kW + kStaging + kVec + kStages * kStage;
  static_assert(kSmem <= kSmemMax, "up2x tile exceeds shared memory");
  static_assert(kStage >= 4 * 2 * C * 4, "reduction scratch");
};

// One block: tiles blockIdx.x, blockIdx.x + gridDim.x, ... of batch element
// blockIdx.y. Warp w takes rows 16w..16w+15 of a tile: their A fragments
// (all of K = 2C) by ldmatrix, activated in registers once an element,
// then the 8C columns of Wu in chunks of 64: products, + bias, the stats
// of the f32 value, bf16 staged in the warp's own rows and stored to the
// fine grid through the gather's inverse, 16 bytes a copy.
template <int C>
__global__ void __launch_bounds__(kDownThreads) up2x_mma_kernel(
    const UpArgs p) {
  using Cfg = UpFwdCfg<C>;
  constexpr int K = Cfg::K, N = Cfg::N, KS = Cfg::KS, NC = Cfg::NC;
  constexpr int NT = Cfg::NT, Q = Cfg::Q;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sw = smem;                                 // Wu [K][N]
  uint8_t* sst = sw + Cfg::kW;                        // y staging
  float* vsc = reinterpret_cast<float*>(sst + Cfg::kStaging);
  float* vsh = vsc + K;
  uint8_t* stages = reinterpret_cast<uint8_t*>(vsh + K);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int H2 = p.H2, W2 = p.W2;
  const long long Mb = (long long)p.D2 * H2 * W2;
  const int ntile = blockIdx.x < p.tiles
                        ? (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                        : 0;

  // Wu by cp.async, in the first tile's copy group
  for (int i = tid; i < K * N / 8; i += kDownThreads) {
    const int k = i / (N / 8), cu = i % (N / 8);
    cp16(smem_u32(sw) + swz(k, cu, N / 8), p.w + (size_t)k * N + cu * 8,
         true);
  }
  for (int i = tid; i < K; i += kDownThreads) {
    vsc[i] = p.scale[(size_t)b * K + i];
    vsh[i] = p.shift[(size_t)b * K + i];
  }
  // a column n = (child) C + o of chunk ch is 64 ch + 8 nt + 2 t (+1), so
  // its channel o is 8 (nt % Q) + 2 t (+1): bias and sums by (nt % Q)
  float bv[Q][2], s1[Q][2], s2[Q][2];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bv[q][j] = p.bias[8 * q + 2 * t + j];
      s1[q][j] = s2[q][j] = 0.f;
    }

  auto load = [&](int i) {
    if (i < ntile) {
      const uint32_t dst =
          smem_u32(stages + (i % Cfg::kStages) * Cfg::kStage);
      const long long m0 = (blockIdx.x + (long long)i * gridDim.x) * kRows;
      for (int e = tid; e < kRows * K / 8; e += kDownThreads) {
        const int r = e / (K / 8), cu = e % (K / 8);
        const bool ok = m0 + r < Mb;
        cp16(dst + swz(r, cu, K / 8),
             ok ? p.x + ((size_t)b * Mb + m0 + r) * K + cu * 8 : p.x, ok);
      }
    }
    cp_commit();
  };
  for (int i = 0; i < Cfg::kStages - 1; ++i) load(i);

  const uint32_t sw_u = smem_u32(sw);
  uint8_t* my_st = sst + warp * 16 * Cfg::kPitch;
  // the lane's store column (8 units a chunk row) and rows lane / 8 + 4 i
  const int su = lane & 7, sr0 = lane >> 3;
  for (int i = 0; i < ntile; ++i) {
    cp_wait<Cfg::kStages - 2>();
    __syncthreads();   // tile i (and Wu, the vectors) are in; every warp
                       // is done with tile i - 1
    load(i + Cfg::kStages - 1);
    const long long tile = blockIdx.x + (long long)i * gridDim.x;
    const uint32_t sa_u =
        smem_u32(stages + (i % Cfg::kStages) * Cfg::kStage);
    // A = bf16(relu(x scale + shift)): k-step s holds channels 16 s + 2 t
    // (+1) in a[0], a[1] and 16 s + 8 + 2 t (+1) in a[2], a[3]
    uint32_t ga[KS][4];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      ldsm4(ga[s], sa_u + swz(lrow(16 * warp, lane), lcol(2 * s, lane),
                              K / 8));
      const int c0 = 16 * s + 2 * t, c1 = c0 + 8;
      ga[s][0] = act2(ga[s][0], vsc[c0], vsc[c0 + 1], vsh[c0], vsh[c0 + 1]);
      ga[s][1] = act2(ga[s][1], vsc[c0], vsc[c0 + 1], vsh[c0], vsh[c0 + 1]);
      ga[s][2] = act2(ga[s][2], vsc[c1], vsc[c1 + 1], vsh[c1], vsh[c1 + 1]);
      ga[s][3] = act2(ga[s][3], vsc[c1], vsc[c1 + 1], vsh[c1], vsh[c1 + 1]);
    }
    const long long m0 = tile * kRows + 16 * warp;
    const bool va = m0 + g < Mb, vb = m0 + g + 8 < Mb;
    // the fine grid's (2z, 2y, 2x) voxel of the lane's store rows
    __nv_bfloat16* dst[4];
    bool dok[4];
    {
      RowWalk w(m0 + sr0, H2, W2);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dok[r] = w.m < Mb;
        dst[r] = p.y + ((((size_t)b * 2 * p.D2 + 2 * w.z) * 2 * H2 +
                         2 * w.y) * 2 * W2 + 2 * w.x) * C;
        w.step(4, H2, W2);
      }
    }
#pragma unroll
    for (int ch = 0; ch < Cfg::NCH; ++ch) {
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          ldsm4t(bb, sw_u + swz(lrow(16 * s, lane),
                                lcol(NC / 8 * ch + 2 * np, lane), N / 8));
          mma(acc[2 * np], ga[s], bb[0], bb[1]);
          mma(acc[2 * np + 1], ga[s], bb[2], bb[3]);
        }
      // + bias, the stats of the f32 value of real rows, bf16 staged
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int q = nt % Q;
        const float y0 = acc[nt][0] + bv[q][0], y1 = acc[nt][1] + bv[q][1];
        const float y2 = acc[nt][2] + bv[q][0], y3 = acc[nt][3] + bv[q][1];
        if (va) {
          s1[q][0] += y0; s2[q][0] += y0 * y0;
          s1[q][1] += y1; s2[q][1] += y1 * y1;
        }
        if (vb) {
          s1[q][0] += y2; s2[q][0] += y2 * y2;
          s1[q][1] += y3; s2[q][1] += y3 * y3;
        }
        *reinterpret_cast<uint32_t*>(my_st + g * Cfg::kPitch +
                                     (8 * nt + 2 * t) * 2) =
            pack_bf16x2(y0, y1);
        *reinterpret_cast<uint32_t*>(my_st + (g + 8) * Cfg::kPitch +
                                     (8 * nt + 2 * t) * 2) =
            pack_bf16x2(y2, y3);
      }
      __syncwarp();
      // unit J = 8 ch + su of a row: fine pair (dz, dy) = J / (C / 4),
      // unit J % (C / 4) of its 2C contiguous values
      const int J = NC / 8 * ch + su, seg = J / (C / 4);
      const size_t off =
          ((size_t)(seg >> 1) * 2 * H2 * 2 * W2 + (seg & 1) * 2 * W2) * C +
          (J % (C / 4)) * 8;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (dok[r])
          *reinterpret_cast<uint4*>(dst[r] + off) =
              *reinterpret_cast<const uint4*>(
                  my_st + (sr0 + 4 * r) * Cfg::kPitch + su * 16);
      __syncwarp();
    }
  }

  // the block's sums: the 8 row lanes of each warp, then the 4 warps, in
  // a fixed order
  cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(stages);   // [4][2][C]
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float a = group_sum(s1[q][j]), c = group_sum(s2[q][j]);
      if (g == 0) {
        red[warp * 2 * C + 8 * q + 2 * t + j] = a;
        red[warp * 2 * C + C + 8 * q + 2 * t + j] = c;
      }
    }
  __syncthreads();
  for (int j = tid; j < 2 * C; j += kDownThreads) {
    float v = red[j];
#pragma unroll
    for (int w = 1; w < kDownThreads / 32; ++w) v += red[w * 2 * C + j];
    p.part[((size_t)b * gridDim.x + blockIdx.x) * 2 * C + j] = v;
  }
}

// ---------------------------------------------------------------- up2x bwd

struct UpBwdArgs {
  const __nv_bfloat16* x;    // (B, D, H, W, 2C) coarse: the forward's input
  const __nv_bfloat16* w;    // (8C, 2C) bf16: pack_up_wt
  const float* scale;        // (B, 2C)
  const float* shift;
  const __nv_bfloat16* gy;   // (B, 2D, 2H, 2W, C)
  const __nv_bfloat16* y;    // the forward's y (read with gstats only)
  const float* gstats;       // (B, 2, C) or null
  __nv_bfloat16* dx;         // (B, D, H, W, 2C)
  float* part;               // (B * gridDim.x, L) block sums, L below
  int B, D2, H2, W2, tiles;
};

// a block's row of the partial table: dW (2, 2, 2, 2C, C) | dbias (C) |
// dstats (B, 2, 2C), zeros for the other batch elements
__host__ __device__ constexpr long long up_row(int C, int B) {
  return 16LL * C * C + C + 4LL * B * C;
}

template <int C, int NS>
struct UpCfg {
  static constexpr int C2 = 2 * C, K = 8 * C, KS = K / 16;
  static constexpr int NTW = NS / 16;   // dx: n8 tiles a warp (2 along NS)
  static constexpr int MTW = C / 8;     // dW: m16 tiles of K a warp (4 along K)
  static constexpr int kW = K * NS * 2;
  static constexpr int kA = kRows * NS * 2;
  static constexpr int kPitch = (NS + 16) | 16;   // staged dx half row
  static constexpr int kStaging = 8 * 16 * kPitch;
  static constexpr int kVec = (2 * NS + 2 * C) * 4;
  static constexpr int kFixed = kW + kA + kStaging + kVec;
  static constexpr int kG = kRows * K * 2;
  static constexpr int kStage = 2 * kG + kRows * NS * 2;   // gy/G, y, x
  // two blocks an SM where dW takes <= 16 registers a thread (C <= 16),
  // so that one block's loads and syncs overlap the other's work
  static constexpr int kBlocks = K * NS <= 128 * 32 ? 2 : 1;
  static constexpr int kFit = (220 * 1024 / kBlocks - kFixed) / kStage;
  static constexpr int kStages = kFit >= 3 ? 3 : kFit >= 1 ? kFit : 1;
  static constexpr int kSmem = kFixed + kStages * kStage;
  static_assert(kSmem <= kSmemMax, "up2x bwd tile exceeds shared memory");
  static_assert(kStage >= kBwdThreads * 8 * 4 + 4 * 2 * NS * 4,
                "reduction scratch");
};

// One block: tiles of batch element blockIdx.y, coarse channels [i0, i0 +
// NS) with i0 = blockIdx.z * NS. Per tile: g' formed in place over the
// staged gy (dbias partial from its f32 value), a = bf16(relu(pre)) of the
// slice, then dx = epilogue(G @ Wd) (warps 4 along rows x 2 along NS) and
// dW^T += G^T @ a (warps 4 along K x 2 along NS).
template <int C, int NS>
__global__ void __launch_bounds__(kBwdThreads, (UpCfg<C, NS>::kBlocks))
    up2x_bwd_mma_kernel(
    const UpBwdArgs p) {
  using Cfg = UpCfg<C, NS>;
  constexpr int C2 = Cfg::C2, K = Cfg::K, NTW = Cfg::NTW, MTW = Cfg::MTW;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sw = smem;                         // Wd slice [K][NS]
  uint8_t* sa = sw + Cfg::kW;                 // a [64][NS]
  uint8_t* sst = sa + Cfg::kA;                // dx staging, 16 rows a warp
  float* vsc = reinterpret_cast<float*>(sst + Cfg::kStaging);
  float* vsh = vsc + NS;
  float* vg1 = vsh + NS;                      // gs1
  float* vg2 = vg1 + C;                       // 2 gs2 (exact)
  uint8_t* stages = reinterpret_cast<uint8_t*>(vg2 + C);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int b = blockIdx.y, i0 = blockIdx.z * NS;
  const long long Mb = (long long)p.D2 * p.H2 * p.W2;
  const int ntile = blockIdx.x < p.tiles
                        ? (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                        : 0;
  const bool stats = p.gstats != nullptr;

  // Wd[k = d C + o][ii] = w[7 - d][i0 + ii][o] (pack_up_wt's row k)
  for (int e = tid; e < K * NS / 8; e += kBwdThreads) {
    const int k = e / (NS / 8), cu = e % (NS / 8);
    *reinterpret_cast<uint4*>(sw + swz(k, cu, NS / 8)) =
        *reinterpret_cast<const uint4*>(p.w + (size_t)k * C2 + i0 + cu * 8);
  }
  for (int e = tid; e < NS; e += kBwdThreads) {
    vsc[e] = p.scale[(size_t)b * C2 + i0 + e];
    vsh[e] = p.shift[(size_t)b * C2 + i0 + e];
  }
  for (int e = tid; e < C; e += kBwdThreads) {
    vg1[e] = stats ? p.gstats[(size_t)b * 2 * C + e] : 0.f;
    vg2[e] = stats ? 2.f * p.gstats[(size_t)b * 2 * C + C + e] : 0.f;
  }
  __syncthreads();
  // the dx epilogue's scale/shift of this lane's columns
  float scv[NTW][2], shv[NTW][2];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      scv[nt][j] = vsc[wn * NS / 2 + 8 * nt + 2 * t + j];
      shv[nt][j] = vsh[wn * NS / 2 + 8 * nt + 2 * t + j];
    }

  auto load = [&](int i) {
    if (i < ntile) {
      uint8_t* st = stages + (i % Cfg::kStages) * Cfg::kStage;
      const long long tile = blockIdx.x + (long long)i * gridDim.x;
      gather_tile<C>(smem_u32(st), p.gy, b, tile, Mb, p.D2, p.H2, p.W2, tid,
                     kBwdThreads);
      if (stats)
        gather_tile<C>(smem_u32(st + Cfg::kG), p.y, b, tile, Mb, p.D2, p.H2,
                       p.W2, tid, kBwdThreads);
      const uint32_t sx = smem_u32(st + 2 * Cfg::kG);
      for (int e = tid; e < kRows * NS / 8; e += kBwdThreads) {
        const int r = e / (NS / 8), cu = e % (NS / 8);
        const long long m = tile * kRows + r;
        const bool ok = m < Mb;
        const __nv_bfloat16* src =
            p.x + ((size_t)b * Mb + m) * C2 + i0 + cu * 8;
        cp16(sx + swz(r, cu, NS / 8), ok ? src : p.x, ok);
      }
    }
    cp_commit();
  };
  for (int i = 0; i < Cfg::kStages - 1; ++i) load(i);

  float db[8] = {};                       // dbias of channels o0..o0+7
  const int o0 = 8 * (tid % (C / 8));     // this thread's unit column's
  float ds1[NTW][2] = {}, ds2[NTW][2] = {};
  float dw[MTW][NTW][4] = {};
  const uint32_t sw_u = smem_u32(sw), sa_u = smem_u32(sa);
  uint8_t* my_st = sst + warp * 16 * Cfg::kPitch;

  for (int i = 0; i < ntile; ++i) {
    load(i + Cfg::kStages - 1);
    cp_wait<Cfg::kStages - 1>();
    __syncthreads();
    uint8_t* sg = stages + (i % Cfg::kStages) * Cfg::kStage;
    const uint8_t* sy = sg + Cfg::kG;
    const uint8_t* sx = sg + 2 * Cfg::kG;
    const long long mt0 = (blockIdx.x + (long long)i * gridDim.x) * kRows;

    // 1. G = bf16(g') in place; dbias from the f32 g' of real rows
    {
      const int j = tid % C;
      for (int r = tid / C; r < kRows; r += kBwdThreads / C) {
        uint4* pg = reinterpret_cast<uint4*>(sg + swz(r, j, C));
        if (mt0 + r >= Mb) {
          *pg = make_uint4(0, 0, 0, 0);
          continue;
        }
        float f[8];
        unpack8(*pg, f);
        if (stats) {
          float yv[8];
          unpack8(*reinterpret_cast<const uint4*>(sy + swz(r, j, C)), yv);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            f[e] = __fadd_rn(__fadd_rn(f[e], vg1[o0 + e]),
                             __fmul_rn(vg2[o0 + e], yv[e]));
          *pg = pack8(f);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) db[e] += f[e];
      }
    }
    // 2. a = bf16(relu(x * scale + shift)) of the slice
    for (int e = tid; e < kRows * NS / 8; e += kBwdThreads) {
      const int r = e / (NS / 8), cu = e % (NS / 8);
      const uint4 xv = *reinterpret_cast<const uint4*>(sx + swz(r, cu, NS / 8));
      const uint32_t w4[4] = {xv.x, xv.y, xv.z, xv.w};
      uint32_t o4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = cu * 8 + 2 * q;
        o4[q] = act2(w4[q], vsc[c], vsc[c + 1], vsh[c], vsh[c + 1]);
      }
      *reinterpret_cast<uint4*>(sa + swz(r, cu, NS / 8)) =
          make_uint4(o4[0], o4[1], o4[2], o4[3]);
    }
    __syncthreads();

    // 3. dx: rows 16 wm.., columns wn NS/2.. of G @ Wd
    {
      float acc[NTW][4] = {};
      const uint32_t sg_u = smem_u32(sg);
#pragma unroll
      for (int s = 0; s < Cfg::KS; ++s) {
        uint32_t a[4];
        ldsm4(a, sg_u + swz(lrow(16 * wm, lane), lcol(2 * s, lane), C));
        if constexpr (NTW == 1) {
          uint32_t bb[2];
          ldsm2t(bb, sw_u + swz(lrow(16 * s, lane), wn, NS / 8));
          mma(acc[0], a, bb[0], bb[1]);
        } else {
#pragma unroll
          for (int np = 0; np < NTW / 2; ++np) {
            uint32_t bb[4];
            ldsm4t(bb, sw_u + swz(lrow(16 * s, lane),
                                  lcol(wn * NTW + 2 * np, lane), NS / 8));
            mma(acc[2 * np], a, bb[0], bb[1]);
            mma(acc[2 * np + 1], a, bb[2], bb[3]);
          }
        }
      }
      // dam = [x scale + shift > 0] da; dx = bf16(dam scale); rows past
      // the grid have G = 0, so da = dam = 0 there
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int cc = wn * NS / 2 + 8 * nt + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wm + g + 8 * h;
          const uint32_t xp = *reinterpret_cast<const uint32_t*>(
              sx + swz(r, cc / 8, NS / 8) + (cc % 8) * 2);
          const float xs[2] = {bf16_lo(xp), bf16_hi(xp)};
          float o[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float pre = __fadd_rn(__fmul_rn(xs[j], scv[nt][j]),
                                        shv[nt][j]);
            const float dam = pre > 0.f ? acc[nt][2 * h + j] : 0.f;
            o[j] = __fmul_rn(dam, scv[nt][j]);
            ds1[nt][j] += dam * xs[j];
            ds2[nt][j] += dam;
          }
          *reinterpret_cast<uint32_t*>(my_st + (g + 8 * h) * Cfg::kPitch +
                                       (8 * nt + 2 * t) * 2) =
              pack_bf16x2(o[0], o[1]);
        }
      }
      __syncwarp();
      const long long m0 = mt0 + 16 * wm;
      for (int u = lane; u < 16 * NTW; u += 32) {
        const int row = u / NTW, cu = u % NTW;
        if (m0 + row < Mb)
          *reinterpret_cast<uint4*>(p.dx + ((size_t)b * Mb + m0 + row) * C2 +
                                    i0 + wn * NS / 2 + cu * 8) =
              *reinterpret_cast<const uint4*>(my_st + row * Cfg::kPitch +
                                              cu * 16);
      }
    }

    // 4. dW^T (rows 2C wm.., columns wn NS/2..) += G^T @ a over the tile
    {
      const uint32_t sg_u = smem_u32(sg);
#pragma unroll
      for (int s = 0; s < kRows / 16; ++s) {
        uint32_t bf[NTW][2];
        if constexpr (NTW == 1) {
          ldsm2t(bf[0], sa_u + swz(lrow(16 * s, lane), wn, NS / 8));
        } else {
#pragma unroll
          for (int np = 0; np < NTW / 2; ++np) {
            uint32_t bb[4];
            ldsm4t(bb, sa_u + swz(lrow(16 * s, lane),
                                  lcol(wn * NTW + 2 * np, lane), NS / 8));
            bf[2 * np][0] = bb[0];
            bf[2 * np][1] = bb[1];
            bf[2 * np + 1][0] = bb[2];
            bf[2 * np + 1][1] = bb[3];
          }
        }
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          // G^T's 16 x 16 block (rows k0.., columns 16 s..) by .trans:
          // matrices (rows 16s.., unit k0/8), (16s.., k0/8 + 1), (16s+8..,
          // k0/8), (16s+8.., k0/8 + 1)
          const int k0 = wm * 2 * C + 16 * mt;
          uint32_t a[4];
          ldsm4t(a, sg_u + swz(16 * s + (lane & 7) + (lane >> 4) * 8,
                               k0 / 8 + ((lane >> 3) & 1), C));
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) mma(dw[mt][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
    }
    __syncthreads();   // the stage, a and the staging are rewritten next
  }

  // the block's row of the partial table
  cp_wait<0>();
  __syncthreads();
  const long long L = up_row(C, p.B);
  float* row = p.part + ((size_t)b * gridDim.x + blockIdx.x) * L;
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = wm * 2 * C + 16 * mt + g + 8 * h;
        const int d = k / C, o = k % C;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = i0 + wn * NS / 2 + 8 * nt + 2 * t + j;
          row[((size_t)(7 - d) * C2 + i) * C + o] = dw[mt][nt][2 * h + j];
        }
      }
  float* rdb = reinterpret_cast<float*>(stages);   // [256][8]
  float* rds = rdb + kBwdThreads * 8;               // [4][2][NS]
#pragma unroll
  for (int e = 0; e < 8; ++e) rdb[tid * 8 + e] = db[e];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float a = group_sum(ds1[nt][j]), c = group_sum(ds2[nt][j]);
      if (g == 0) {
        rds[wm * 2 * NS + wn * NS / 2 + 8 * nt + 2 * t + j] = a;
        rds[wm * 2 * NS + NS + wn * NS / 2 + 8 * nt + 2 * t + j] = c;
      }
    }
  __syncthreads();
  if (blockIdx.z == 0) {
    // threads with tid % (C / 8) == o / 8 hold channel o, in tid order
    for (int o = tid; o < C; o += kBwdThreads) {
      float v = 0.f;
      for (int th = o / 8; th < kBwdThreads; th += C / 8) v += rdb[th * 8 + o % 8];
      row[16LL * C * C + o] = v;
    }
  }
  float* rst = row + 16LL * C * C + C;
  for (int e = tid; e < p.B * 2 * NS; e += kBwdThreads) {
    const int bb = e / (2 * NS), s = (e / NS) % 2, ii = e % NS;
    float v = 0.f;
    if (bb == b) {
      v = rds[s * NS + ii];
#pragma unroll
      for (int w = 1; w < 4; ++w) v += rds[w * 2 * NS + s * NS + ii];
    }
    rst[((size_t)bb * 2 + s) * C2 + i0 + ii] = v;
  }
}

// ---------------------------------------------------------------- down2x bwd

struct DownBwdArgs {
  const __nv_bfloat16* x;    // (B, D, H, W, C) fine: the forward's input
  const __nv_bfloat16* w;    // (8C, 2C) bf16: pack_down_w
  const float* scale;        // (B, C)
  const float* shift;
  const __nv_bfloat16* gy;   // (B, D/2, H/2, W/2, 2C)
  const __nv_bfloat16* y;    // the forward's y (read with gstats only)
  const float* gstats;       // (B, 2, 2C) or null
  __nv_bfloat16* dx;         // (B, D, H, W, C)
  float* part;               // (B * gridDim.x * S, L) block rows, L below
  int B, D2, H2, W2, tiles;
};

// a block's row of the partial table: dW (2, 2, 2, C, 2C) | dbias (2C) |
// dstats (B, 2, C), zeros outside the block's slice and batch element
__host__ __device__ constexpr long long down_row(int C, int B) {
  return 16LL * C * C + 2 * C + 2LL * B * C;
}

// S slices of the 8C gathered columns, one a block (grid z): dW's partial
// (8C / S x 2C) stays in registers (64 a thread at C = 32 and, with four
// slices, at C = 64)
template <int C>
constexpr int down_bwd_slices() { return C == 64 ? 4 : 1; }

template <int C, int S>
struct DownBwdCfg {
  static constexpr int N = 2 * C;          // coarse width: G's and dW's columns
  static constexpr int NF = 8 * C / S;     // the slice's gathered columns
  static constexpr int U = NF / 8;         // its 16-byte units a row
  static constexpr int KS = N / 16;        // dA's k-steps (K = 2C)
  static constexpr int MT = NF / 16, NT = N / 8;   // dW's m16 / n8 tiles
  static constexpr int WM = MT < 8 ? MT : 8, WN = 8 / WM;
  static constexpr int MTW = MT / WM, NTW = NT / WN;   // a warp's
  static constexpr int DCW = NF / 2;       // dA: a warp's columns (2 along)
  static constexpr int kChunks = DCW / 32; // of 4 n8 tiles
  static constexpr int kW = NF * N * 2;    // Wd slice [NF][N] bf16
  static constexpr int kVec = (2 * C + 2 * N) * 4;
  static constexpr int kFixed = kW + kVec;
  static constexpr int kG = kRows * N * 2;
  static constexpr int kX = kRows * NF * 2;
  static constexpr int kStage = 2 * kG + kX;   // gy / G, y, x
  // two blocks an SM where dW takes <= 16 registers a thread (C <= 16)
  static constexpr int kBlocks = NF * N <= 128 * 32 ? 2 : 1;
  static constexpr int kFit = (220 * 1024 / kBlocks - kFixed) / kStage;
  static constexpr int kStages = kFit >= 3 ? 3 : kFit >= 1 ? kFit : 1;
  static constexpr int kSmem = kFixed + kStages * kStage;
  static_assert(kSmem <= kSmemMax, "down2x bwd tile exceeds shared memory");
  static_assert(kStage >= kBwdThreads * 8 * 4 + 8 * 2 * C * 4,
                "reduction scratch");
  static_assert(kChunks >= 1 && NTW >= 1 && MTW >= 1, "tiling");
};

// One block: tiles of batch element blockIdx.y, gathered columns [z NF, (z
// + 1) NF), z = blockIdx.z. Per tile: G = bf16(g') formed in place over
// the staged gy (dbias from its f32 value); dW (NF x 2C) += A^T @ G with
// A = bf16(relu(x scale + shift)) formed on the x tile's fragments (warps
// WM along NF x WN along 2C); then dA = G @ Wd^T in
// chunks of 32 columns (warps 4 along rows x 2 along NF), whose epilogue
// reads pre from the x tile and writes dx over it in place (each element
// by the thread that read it); the tile goes back to the fine grid through
// the gather's inverse.
template <int C, int S>
__global__ void __launch_bounds__(kBwdThreads, (DownBwdCfg<C, S>::kBlocks))
    down2x_bwd_mma_kernel(const DownBwdArgs p) {
  using Cfg = DownBwdCfg<C, S>;
  constexpr int N = Cfg::N, NF = Cfg::NF, U = Cfg::U, KS = Cfg::KS;
  constexpr int WM = Cfg::WM, MTW = Cfg::MTW, NTW = Cfg::NTW;
  constexpr int DCW = Cfg::DCW;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sw = smem;                               // Wd slice [NF][N]
  float* vsc = reinterpret_cast<float*>(sw + Cfg::kW);
  float* vsh = vsc + C;
  float* vg1 = vsh + C;                             // gs1
  float* vg2 = vg1 + N;                             // 2 gs2 (exact)
  uint8_t* stages = reinterpret_cast<uint8_t*>(vg2 + N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, z = blockIdx.z;
  const long long Mb = (long long)p.D2 * p.H2 * p.W2;
  const int ntile = blockIdx.x < p.tiles
                        ? (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                        : 0;
  const bool stats = p.gstats != nullptr;

  // Wd[n][k] = w's row z NF + n (tap, fine channel)
  for (int e = tid; e < NF * N / 8; e += kBwdThreads) {
    const int n = e / (N / 8), ku = e % (N / 8);
    *reinterpret_cast<uint4*>(sw + swz(n, ku, N / 8)) =
        *reinterpret_cast<const uint4*>(p.w + ((size_t)z * NF + n) * N +
                                        ku * 8);
  }
  for (int e = tid; e < C; e += kBwdThreads) {
    vsc[e] = p.scale[(size_t)b * C + e];
    vsh[e] = p.shift[(size_t)b * C + e];
  }
  for (int e = tid; e < N; e += kBwdThreads) {
    vg1[e] = stats ? p.gstats[(size_t)b * 2 * N + e] : 0.f;
    vg2[e] = stats ? 2.f * p.gstats[(size_t)b * 2 * N + N + e] : 0.f;
  }
  __syncthreads();
  // dW: this warp's rows (gathered columns) and their scale/shift
  const int wmw = warp % WM, wnw = warp / WM;
  float sca[MTW][2], sha[MTW][2];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = (16 * (wmw * MTW + mt) + g + 8 * h) % C;
      sca[mt][h] = vsc[c];
      sha[mt][h] = vsh[c];
    }

  auto load = [&](int i) {
    if (i < ntile) {
      uint8_t* st = stages + (i % Cfg::kStages) * Cfg::kStage;
      const long long tile = blockIdx.x + (long long)i * gridDim.x;
      for (int e = tid; e < kRows * N / 8; e += kBwdThreads) {
        const int r = e / (N / 8), cu = e % (N / 8);
        const long long m = tile * kRows + r;
        const bool ok = m < Mb;
        const size_t off = ((size_t)b * Mb + m) * N + cu * 8;
        cp16(smem_u32(st) + swz(r, cu, N / 8), ok ? p.gy + off : p.gy, ok);
        if (stats)
          cp16(smem_u32(st + Cfg::kG) + swz(r, cu, N / 8),
               ok ? p.y + off : p.y, ok);
      }
      gather_tile<C, S>(smem_u32(st + 2 * Cfg::kG), p.x, b, tile, Mb, p.D2,
                        p.H2, p.W2, tid, kBwdThreads, z);
    }
    cp_commit();
  };
  for (int i = 0; i < Cfg::kStages - 1; ++i) load(i);

  float db[8] = {};                        // dbias of channels o0..o0+7
  const int o0 = 8 * (tid % (N / 8));      // this thread's unit column's
  float ds1[C / 8][2] = {}, ds2[C / 8][2] = {};
  float dw[MTW][NTW][4] = {};
  const uint32_t sw_u = smem_u32(sw);
  const int wm = warp & 3, wn = warp >> 2;

  for (int i = 0; i < ntile; ++i) {
    load(i + Cfg::kStages - 1);
    cp_wait<Cfg::kStages - 1>();
    __syncthreads();
    uint8_t* sg = stages + (i % Cfg::kStages) * Cfg::kStage;
    const uint8_t* sy = sg + Cfg::kG;
    uint8_t* sx = sg + 2 * Cfg::kG;
    const uint32_t sg_u = smem_u32(sg), sx_u = smem_u32(sx);
    const long long tile = blockIdx.x + (long long)i * gridDim.x;
    const long long mt0 = tile * kRows;

    // 1. G = bf16(g') in place; dbias from the f32 g' of real rows
    for (int r = tid / (N / 8); r < kRows; r += kBwdThreads / (N / 8)) {
      uint4* pg = reinterpret_cast<uint4*>(sg + swz(r, o0 / 8, N / 8));
      if (mt0 + r >= Mb) {
        *pg = make_uint4(0, 0, 0, 0);
        continue;
      }
      float f[8];
      unpack8(*pg, f);
      if (stats) {
        float yv[8];
        unpack8(*reinterpret_cast<const uint4*>(sy + swz(r, o0 / 8, N / 8)),
                yv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          f[e] = __fadd_rn(__fadd_rn(f[e], vg1[o0 + e]),
                           __fmul_rn(vg2[o0 + e], yv[e]));
        *pg = pack8(f);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) db[e] += f[e];
    }
    __syncthreads();

    // 2. dW (rows 16 MTW wmw.., columns 8 NTW wnw..) += A^T @ G; A's
    // fragments hold one gathered column (one channel) a register
#pragma unroll
    for (int s = 0; s < kRows / 16; ++s) {
      uint32_t bf[NTW][2];
      if constexpr (NTW == 1) {
        ldsm2t(bf[0], sg_u + swz(lrow(16 * s, lane), wnw, N / 8));
      } else {
#pragma unroll
        for (int np = 0; np < NTW / 2; ++np) {
          uint32_t bb[4];
          ldsm4t(bb, sg_u + swz(lrow(16 * s, lane),
                                lcol(wnw * NTW + 2 * np, lane), N / 8));
          bf[2 * np][0] = bb[0];
          bf[2 * np][1] = bb[1];
          bf[2 * np + 1][0] = bb[2];
          bf[2 * np + 1][1] = bb[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) {
        const int m0 = 16 * (wmw * MTW + mt);
        uint32_t a[4];
        ldsm4t(a, sx_u + swz(16 * s + (lane & 7) + (lane >> 4) * 8,
                             m0 / 8 + ((lane >> 3) & 1), U));
        a[0] = act2(a[0], sca[mt][0], sca[mt][0], sha[mt][0], sha[mt][0]);
        a[1] = act2(a[1], sca[mt][1], sca[mt][1], sha[mt][1], sha[mt][1]);
        a[2] = act2(a[2], sca[mt][0], sca[mt][0], sha[mt][0], sha[mt][0]);
        a[3] = act2(a[3], sca[mt][1], sca[mt][1], sha[mt][1], sha[mt][1]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) mma(dw[mt][nt], a, bf[nt][0], bf[nt][1]);
      }
    }
    __syncthreads();   // the x tile is overwritten with dx below

    // 3. dA (rows 16 wm.., columns wn DCW..) = G @ Wd^T in chunks of 32
    // columns; dam = [x scale + shift > 0] dA, dx = bf16(dam scale) over
    // x in place; rows past the grid have G = 0, so dam = 0 there
    {
      uint32_t ga[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s)
        ldsm4(ga[s], sg_u + swz(lrow(16 * wm, lane), lcol(2 * s, lane),
                                N / 8));
#pragma unroll
      for (int ch = 0; ch < Cfg::kChunks; ++ch) {
        const int n0 = wn * DCW + 32 * ch;
        float acc[4][4] = {};
#pragma unroll
        for (int s = 0; s < KS; ++s)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bb[4];
            ldsm4(bb, sw_u + swz(n0 + 16 * np + (lane & 7) + (lane >> 4) * 8,
                                 2 * s + ((lane >> 3) & 1), N / 8));
            mma(acc[2 * np], ga[s], bb[0], bb[1]);
            mma(acc[2 * np + 1], ga[s], bb[2], bb[3]);
          }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int kk = n0 + 8 * nt + 2 * t;   // gathered column (even)
          const int c = kk % C;
          constexpr int Q = C / 8;
          const int q = (4 * ch + nt) % Q;       // c = 8 q + 2 t
          const float sc0 = vsc[c], sc1 = vsc[c + 1];
          const float sh0 = vsh[c], sh1 = vsh[c + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wm + g + 8 * h;
            uint32_t* px = reinterpret_cast<uint32_t*>(
                sx + swz(r, kk / 8, U) + (kk % 8) * 2);
            const uint32_t xp = *px;
            const float xs[2] = {bf16_lo(xp), bf16_hi(xp)};
            const float sc[2] = {sc0, sc1}, sh[2] = {sh0, sh1};
            float o[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float pre = __fadd_rn(__fmul_rn(xs[j], sc[j]), sh[j]);
              const float dam = pre > 0.f ? acc[nt][2 * h + j] : 0.f;
              o[j] = __fmul_rn(dam, sc[j]);
              ds1[q][j] += dam * xs[j];
              ds2[q][j] += dam;
            }
            *px = pack_bf16x2(o[0], o[1]);
          }
        }
      }
    }
    __syncthreads();
    // 4. dx back to the fine grid
    scatter_tile<C, S>(p.dx, sx, b, tile, Mb, p.D2, p.H2, p.W2, tid,
                       kBwdThreads, z);
    __syncthreads();   // the stage is refilled by a later load
  }

  // the block's row of the partial table, in a fixed order
  cp_wait<0>();
  __syncthreads();
  const long long L = down_row(C, p.B);
  float* row = p.part + (((size_t)b * gridDim.x + blockIdx.x) * S + z) * L;
  if constexpr (S > 1)   // the other slices' dW entries
    for (int e = tid; e < 16 * C * C; e += kBwdThreads)
      if (e / N / NF != z) row[e] = 0.f;
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * (wmw * MTW + mt) + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 8 * (wnw * NTW + nt) + 2 * t + j;
          row[((size_t)z * NF + m) * N + n] = dw[mt][nt][2 * h + j];
        }
      }
  float* rdb = reinterpret_cast<float*>(stages);   // [256][8]
  float* rds = rdb + kBwdThreads * 8;               // [8 warps][2][C]
#pragma unroll
  for (int e = 0; e < 8; ++e) rdb[tid * 8 + e] = db[e];
#pragma unroll
  for (int q = 0; q < C / 8; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float a = group_sum(ds1[q][j]), c = group_sum(ds2[q][j]);
      if (g == 0) {
        rds[warp * 2 * C + 8 * q + 2 * t + j] = a;
        rds[warp * 2 * C + C + 8 * q + 2 * t + j] = c;
      }
    }
  __syncthreads();
  // threads with tid % (N / 8) == o / 8 hold channel o, in tid order
  for (int o = tid; o < N; o += kBwdThreads) {
    float v = 0.f;
    if (z == 0)
      for (int th = o / 8; th < kBwdThreads; th += N / 8)
        v += rdb[th * 8 + o % 8];
    row[16LL * C * C + o] = v;
  }
  float* rst = row + 16LL * C * C + N;
  for (int e = tid; e < p.B * 2 * C; e += kBwdThreads) {
    const int bb = e / (2 * C), sc = e % (2 * C);
    float v = 0.f;
    if (bb == b) {
      v = rds[sc];
#pragma unroll
      for (int w = 1; w < kBwdThreads / 32; ++w) v += rds[w * 2 * C + sc];
    }
    rst[e] = v;
  }
}

// ---------------------------------------------------------------- host

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// blocks a batch element: at most `cap` resident blocks an SM over the
// whole grid, rounded down so that no block waits for a second wave
template <typename Kernel>
int blocks_per_batch(Kernel kernel, int threads, int smem, int cap, int B,
                     int slices, int tiles) {
  if (allow_smem(kernel, smem) != cudaSuccess) return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    return 0;
  if (per_sm > cap) per_sm = cap;
  int gx = per_sm * hopper_host::sm_count() / (B * slices);
  if (gx < 1) gx = 1;
  return gx < tiles ? gx : tiles;
}

template <int C>
int down_grid(int B, int tiles) {
  return blocks_per_batch(down2x_mma_kernel<C>, kDownThreads,
                          DownCfg<C>::kSmem, 2, B, 1, tiles);
}

template <int C>
int up_fwd_grid(int B, int tiles) {
  return blocks_per_batch(up2x_mma_kernel<C>, kDownThreads,
                          UpFwdCfg<C>::kSmem, 4, B, 1, tiles);
}

template <int C>
int up_grid(int B, int tiles) {
  constexpr int NS = C == 64 ? 32 : 2 * C;
  return blocks_per_batch(up2x_bwd_mma_kernel<C, NS>, kBwdThreads,
                          UpCfg<C, NS>::kSmem, UpCfg<C, NS>::kBlocks, B,
                          2 * C / NS, tiles);
}

template <int C>
int down_bwd_grid(int B, int tiles) {
  constexpr int S = down_bwd_slices<C>();
  return blocks_per_batch(down2x_bwd_mma_kernel<C, S>, kBwdThreads,
                          DownBwdCfg<C, S>::kSmem, DownBwdCfg<C, S>::kBlocks,
                          B, S, tiles);
}

template <int C>
int down_bwd_launch(const DownBwdArgs& a, float* out, int gx,
                    cudaStream_t st) {
  constexpr int S = down_bwd_slices<C>();
  using Cfg = DownBwdCfg<C, S>;
  cudaError_t err = allow_smem(down2x_bwd_mma_kernel<C, S>, Cfg::kSmem);
  if (err != cudaSuccess) return (int)err;
  down2x_bwd_mma_kernel<C, S>
      <<<dim3(gx, a.B, S), kBwdThreads, Cfg::kSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long L = down_row(C, a.B);
  fixed_sum_kernel<<<dim3((unsigned)((L + 31) / 32), 1), 256, 0, st>>>(
      a.part, out, gx * a.B * S, L);
  return (int)cudaGetLastError();
}

template <int C>
int down_launch(const DownArgs& a, float* stats, int B, int gx,
                cudaStream_t st) {
  using Cfg = DownCfg<C>;
  cudaError_t err = allow_smem(down2x_mma_kernel<C>, Cfg::kSmem);
  if (err != cudaSuccess) return (int)err;
  down2x_mma_kernel<C><<<dim3(gx, B), kDownThreads, Cfg::kSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fixed_sum_kernel<<<dim3((2 * Cfg::N + 31) / 32, B), 256, 0, st>>>(
      a.part, stats, gx, 2 * Cfg::N);
  return (int)cudaGetLastError();
}

template <int C>
int up_fwd_launch(const UpArgs& a, float* stats, int B, int gx,
                  cudaStream_t st) {
  using Cfg = UpFwdCfg<C>;
  cudaError_t err = allow_smem(up2x_mma_kernel<C>, Cfg::kSmem);
  if (err != cudaSuccess) return (int)err;
  up2x_mma_kernel<C><<<dim3(gx, B), kDownThreads, Cfg::kSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fixed_sum_kernel<<<dim3((2 * C + 31) / 32, B), 256, 0, st>>>(a.part, stats,
                                                              gx, 2 * C);
  return (int)cudaGetLastError();
}

template <int C>
int up_launch(const UpBwdArgs& a, float* out, int gx, cudaStream_t st) {
  constexpr int NS = C == 64 ? 32 : 2 * C;
  using Cfg = UpCfg<C, NS>;
  cudaError_t err = allow_smem(up2x_bwd_mma_kernel<C, NS>, Cfg::kSmem);
  if (err != cudaSuccess) return (int)err;
  up2x_bwd_mma_kernel<C, NS>
      <<<dim3(gx, a.B, 2 * C / NS), kBwdThreads, Cfg::kSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long L = up_row(C, a.B);
  fixed_sum_kernel<<<dim3((unsigned)((L + 31) / 32), 1), 256, 0, st>>>(
      a.part, out, gx * a.B, L);
  return (int)cudaGetLastError();
}

template <int C>
int grid_of(int kind, int B, int tiles) {
  switch (kind) {
    case 0: return down_grid<C>(B, tiles);
    case 1: return up_grid<C>(B, tiles);
    case 2: return down_bwd_grid<C>(B, tiles);
    default: return up_fwd_grid<C>(B, tiles);
  }
}

long long tiles_of(int D2, int H2, int W2) {
  return ((long long)D2 * H2 * W2 + kRows - 1) / kRows;
}

}  // namespace

extern "C" {

// Blocks a batch element of a launch (the partial table has B times that
// many rows, times the slices for down2x's backward): kind 0 down2x, 1
// up2x's backward, 2 down2x's backward, 3 up2x, at fine width C over
// `tiles` tiles a batch element; 0 for a width the kernels do not take.
int pcseg_resample_grid(int kind, int B, int C, int tiles) {
  if (B <= 0 || tiles <= 0 || kind < 0 || kind > 3) return 0;
  switch (C) {
    case 8: return grid_of<8>(kind, B, tiles);
    case 16: return grid_of<16>(kind, B, tiles);
    case 32: return grid_of<32>(kind, B, tiles);
    case 64: return grid_of<64>(kind, B, tiles);
    default: return 0;
  }
}

// Slices of down2x's backward at fine width C (grid z; the partial table
// has B gx times that many rows), 0 for a width it does not take.
int pcseg_down2x_bwd_slices(int C) {
  switch (C) {
    case 8: return down_bwd_slices<8>();
    case 16: return down_bwd_slices<16>();
    case 32: return down_bwd_slices<32>();
    case 64: return down_bwd_slices<64>();
    default: return 0;
  }
}

// down2x: x (B, D, H, W, C) bf16 (D, H, W even; 16-byte aligned), w (8C,
// 2C) bf16 (pack_down_w, 16-byte aligned), bias (2C,), scale/shift (B, C)
// f32.
// Writes y (B, D/2, H/2, W/2, 2C) bf16 and stats (B, 2, 2C) f32 through
// part, (B, gx, 2, 2C) f32 scratch; gx from pcseg_resample_grid(0, ...).
int pcseg_down2x_mma(const void* x, const void* w, const void* bias,
                     const void* scale, const void* shift, void* y,
                     void* stats, void* part, int B, int D, int H, int W,
                     int C, int gx, void* stream) {
  if (B <= 0 || gx <= 0 || D <= 0 || H <= 0 || W <= 0 || D % 2 || H % 2 ||
      W % 2)
    return (int)cudaErrorInvalidValue;
  DownArgs a{};
  a.x = (const __nv_bfloat16*)x;
  a.w = (const __nv_bfloat16*)w;
  a.bias = (const float*)bias;
  a.scale = (const float*)scale;
  a.shift = (const float*)shift;
  a.y = (__nv_bfloat16*)y;
  a.part = (float*)part;
  a.D2 = D / 2; a.H2 = H / 2; a.W2 = W / 2;
  a.tiles = (int)tiles_of(a.D2, a.H2, a.W2);
  float* s = (float*)stats;
  const auto st = (cudaStream_t)stream;
  switch (C) {
    case 8: return down_launch<8>(a, s, B, gx, st);
    case 16: return down_launch<16>(a, s, B, gx, st);
    case 32: return down_launch<32>(a, s, B, gx, st);
    case 64: return down_launch<64>(a, s, B, gx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// up2x: x (B, D, H, W, 2C) bf16 coarse (16-byte aligned), w (2C, 8C) bf16
// (pack_up_w, 16-byte aligned), bias (C,), scale/shift (B, 2C) f32. Writes
// y (B, 2D, 2H, 2W, C) bf16 and stats (B, 2, C) f32 through part, (B, gx,
// 2, C) f32 scratch; gx from pcseg_resample_grid(3, ...).
int pcseg_up2x_mma(const void* x, const void* w, const void* bias,
                   const void* scale, const void* shift, void* y, void* stats,
                   void* part, int B, int D, int H, int W, int C, int gx,
                   void* stream) {
  if (B <= 0 || gx <= 0 || D <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  UpArgs a{};
  a.x = (const __nv_bfloat16*)x;
  a.w = (const __nv_bfloat16*)w;
  a.bias = (const float*)bias;
  a.scale = (const float*)scale;
  a.shift = (const float*)shift;
  a.y = (__nv_bfloat16*)y;
  a.part = (float*)part;
  a.D2 = D; a.H2 = H; a.W2 = W;
  a.tiles = (int)tiles_of(D, H, W);
  float* s = (float*)stats;
  const auto st = (cudaStream_t)stream;
  switch (C) {
    case 8: return up_fwd_launch<8>(a, s, B, gx, st);
    case 16: return up_fwd_launch<16>(a, s, B, gx, st);
    case 32: return up_fwd_launch<32>(a, s, B, gx, st);
    case 64: return up_fwd_launch<64>(a, s, B, gx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// up2x's backward: x (B, D, H, W, 2C) bf16 coarse; w (8C, 2C) bf16
// (pack_up_wt);
// scale/shift (B, 2C); gy and y (B, 2D, 2H, 2W, C) bf16 (y unread without
// gstats), gstats (B, 2, C) or null; all grids 16-byte aligned. Writes dx
// (B, D, H, W, 2C) bf16 and out = [dW (2, 2, 2, 2C, C) | dbias (C) |
// dstats (B, 2, 2C)] f32 through part, (B gx, 16 C^2 + C + 4 B C) f32
// scratch; gx from pcseg_resample_grid(1, ...).
int pcseg_up2x_bwd_mma(const void* x, const void* w, const void* scale,
                       const void* shift, const void* gy, const void* y,
                       const void* gstats, void* dx, void* out, void* part,
                       int B, int D, int H, int W, int C, int gx,
                       void* stream) {
  if (B <= 0 || gx <= 0 || D <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  UpBwdArgs a{};
  a.x = (const __nv_bfloat16*)x;
  a.w = (const __nv_bfloat16*)w;
  a.scale = (const float*)scale;
  a.shift = (const float*)shift;
  a.gy = (const __nv_bfloat16*)gy;
  a.y = (const __nv_bfloat16*)y;
  a.gstats = (const float*)gstats;
  a.dx = (__nv_bfloat16*)dx;
  a.part = (float*)part;
  a.B = B; a.D2 = D; a.H2 = H; a.W2 = W;
  a.tiles = (int)tiles_of(D, H, W);
  float* o = (float*)out;
  const auto st = (cudaStream_t)stream;
  switch (C) {
    case 8: return up_launch<8>(a, o, gx, st);
    case 16: return up_launch<16>(a, o, gx, st);
    case 32: return up_launch<32>(a, o, gx, st);
    case 64: return up_launch<64>(a, o, gx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// down2x's backward: x (B, D, H, W, C) bf16 fine (D, H, W even); w (8C,
// 2C) bf16 (pack_down_w); scale/shift (B, C); gy and y (B, D/2, H/2, W/2,
// 2C) bf16
// (y unread without gstats), gstats (B, 2, 2C) or null; all grids 16-byte
// aligned. Writes dx (B, D, H, W, C) bf16 and out = [dW (2, 2, 2, C, 2C) |
// dbias (2C) | dstats (B, 2, C)] f32 through part, (B gx S, 16 C^2 + 2C +
// 2 B C) f32 scratch; gx from pcseg_resample_grid(2, ...), S from
// pcseg_down2x_bwd_slices.
int pcseg_down2x_bwd_mma(const void* x, const void* w, const void* scale,
                         const void* shift, const void* gy, const void* y,
                         const void* gstats, void* dx, void* out, void* part,
                         int B, int D, int H, int W, int C, int gx,
                         void* stream) {
  if (B <= 0 || gx <= 0 || D <= 0 || H <= 0 || W <= 0 || D % 2 || H % 2 ||
      W % 2)
    return (int)cudaErrorInvalidValue;
  DownBwdArgs a{};
  a.x = (const __nv_bfloat16*)x;
  a.w = (const __nv_bfloat16*)w;
  a.scale = (const float*)scale;
  a.shift = (const float*)shift;
  a.gy = (const __nv_bfloat16*)gy;
  a.y = (const __nv_bfloat16*)y;
  a.gstats = (const float*)gstats;
  a.dx = (__nv_bfloat16*)dx;
  a.part = (float*)part;
  a.B = B; a.D2 = D / 2; a.H2 = H / 2; a.W2 = W / 2;
  a.tiles = (int)tiles_of(a.D2, a.H2, a.W2);
  float* o = (float*)out;
  const auto st = (cudaStream_t)stream;
  switch (C) {
    case 8: return down_bwd_launch<8>(a, o, gx, st);
    case 16: return down_bwd_launch<16>(a, o, gx, st);
    case 32: return down_bwd_launch<32>(a, o, gx, st);
    case 64: return down_bwd_launch<64>(a, o, gx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
